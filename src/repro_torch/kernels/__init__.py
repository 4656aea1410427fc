"""Hand-written Hopper kernels of the port, their plain versions
(:mod:`ref`) and their launch counters.

Each kernel wrapper counts its own launches (``<wrapper>.launches``); a run
that resets the counts before it and reads them after shows which kernels
its path really went through.
"""
from repro_torch.kernels.decode_attention import decode_attention_cuda
from repro_torch.kernels.flash_attention import flash_attention_cuda
from repro_torch.kernels.paged_attention import paged_decode_attention_cuda
from repro_torch.kernels.qrlora_bgmv import (
    qrlora_bgmv_cuda,
    qrlora_bgmv_quant_cuda,
    qrlora_bgmv_rows_cuda,
)
from repro_torch.kernels.qrlora_matmul import qrlora_matmul_cuda, qrlora_matmul_quant_cuda

#: kernel name → the wrapper that launches it and holds its count
KERNEL_WRAPPERS = {
    "qrlora_bgmv": qrlora_bgmv_cuda,
    "paged_decode_attention": paged_decode_attention_cuda,
    "qrlora_matmul": qrlora_matmul_cuda,
    "qrlora_bgmv_quant": qrlora_bgmv_quant_cuda,
    "qrlora_matmul_quant": qrlora_matmul_quant_cuda,
    "flash_attention": flash_attention_cuda,
    "decode_attention": decode_attention_cuda,
    "qrlora_bgmv_rows": qrlora_bgmv_rows_cuda,
}


def launch_counts() -> dict:
    return {name: fn.launches for name, fn in KERNEL_WRAPPERS.items()}


def reset_launch_counts() -> None:
    for fn in KERNEL_WRAPPERS.values():
        fn.launches = 0
