"""Flash attention: the Hopper kernel and its wrapper.

Causal or full GQA attention over a sequence in the model layout: q
(B,Sq,H,dh), k/v (B,Sk,KV,dh) → (B,Sq,H,dh); query head h reads kv head
h // (H/KV); the causal mask is top-left (``kpos <= qpos``, also when
Sq ≠ Sk).

Replaces ``repro/kernels/flash_attention.py::flash_attention_kernel``.  By
the H100 SXM data sheet the bf16 work is bound by the tensor cores at long
sequences (≈ 4.9 µs at B=1 × S=2048, smollm-135m's heads) and by reading
q, k, v once at the train shape (≈ 1.9 µs at B=8 × S=256); with few query
rows for the card, the longest block's walk sets the time.  So the CUDA
source (``csrc/flash_attention.cu``) keeps the products on the tensor cores
with nothing but registers between them: one block per (64-row query tile,
head, batch row), longest causal walks first, walks its KV tiles behind a
2-stage ``cp.async`` ring in shared memory; Q·Kᵀ and P·V run as
``mma.sync`` m16n8k16 from ``ldmatrix`` fragments, the online softmax runs
on the fp32 accumulators, P goes to bf16 in registers, and O is written
once; where walks are long, two warp groups split a block's KV tiles and
merge at the end.  KV tiles wholly above the diagonal are never loaded.
float32 runs the first design on the CUDA cores.  The kernel reads q, k and v through
their strides, so the model layout needs no transposes.  PERF.md has its
times beside its bound.

CPU tensors take the plain version (:func:`repro_torch.kernels.ref.
flash_attention_ref`); CUDA tensors launch the kernel or raise.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import flash_attention_ref

_DTYPES = (torch.float32, torch.bfloat16)
HEAD_DIMS = (16, 32, 64, 128)  # csrc/flash_attention.cu instantiations
_lib = None


def _library():
    global _lib
    if _lib is None:
        lib = _build.load("flash_attention")
        lib.flash_attention_launch.argtypes = (
            [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [ctypes.c_longlong] * 12
            + [ctypes.c_float] + [ctypes.c_int] * 3 + [ctypes.c_void_p]
        )
        lib.flash_attention_launch.restype = ctypes.c_int
        lib.flash_attention_error_string.argtypes = [ctypes.c_int]
        lib.flash_attention_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def _check(q, k, v):
    dev = q.device
    for name, t in (("k", k), ("v", v)):
        if t.device != dev:
            raise ValueError(f"flash_attention: {name} on {t.device}, q on {dev}")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention: q/k/v dtypes {q.dtype}/{k.dtype}/{v.dtype}; "
                        f"need one of {_DTYPES} for all three")
    if q.ndim != 4 or k.ndim != 4 or tuple(v.shape) != tuple(k.shape):
        raise ValueError(f"flash_attention: q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)}; need (B,Sq,H,dh) and (B,Sk,KV,dh)")
    B, _, H, dh = q.shape
    if k.shape[0] != B or k.shape[3] != dh or H % k.shape[2]:
        raise ValueError(f"flash_attention: q {tuple(q.shape)} vs k/v {tuple(k.shape)}")
    if dh not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head dim {dh} not in {HEAD_DIMS}")
    if any(t.stride(3) != 1 for t in (q, k, v)):
        raise ValueError("flash_attention: q, k, v need unit stride over the head dim")


def flash_attention_cuda(q, k, v, causal: bool = True) -> torch.Tensor:
    """Launch the flash-attention kernel on CUDA tensors: q (B,Sq,H,dh) and
    k, v (B,Sk,KV,dh) in one of float32/bfloat16, any batch/sequence/head
    strides and unit stride over dh ∈ :data:`HEAD_DIMS`.  Returns
    (B,Sq,H,dh) contiguous in q's dtype.  Adds one to
    ``flash_attention_cuda.launches`` per launch."""
    _check(q, k, v)
    B, Sq, H, dh = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    out = torch.empty((B, Sq, H, dh), dtype=q.dtype, device=q.device)
    per_copy = 16 // q.element_size()  # elements in one 16-byte copy
    vec = all(t.data_ptr() % 16 == 0 and all(s % per_copy == 0 for s in t.stride()[:3])
              for t in (q, k, v))
    lib = _library()
    err = lib.flash_attention_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, Sq, Sk, H, KV, dh,
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *out.stride()[:3],
        float(dh**-0.5), int(causal), int(vec), int(q.dtype == torch.bfloat16),
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    if err:
        raise RuntimeError(
            f"flash_attention launch failed: {lib.flash_attention_error_string(err).decode()}"
        )
    flash_attention_cuda.launches += 1
    return out


flash_attention_cuda.launches = 0


def flash_attention(q, k, v, causal: bool = True) -> torch.Tensor:
    """Flash attention in the model layout: the plain version for CPU
    tensors, the kernel for CUDA tensors (no fallback between the two)."""
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v, causal=causal)
    if q.device.type == "cuda":
        return flash_attention_cuda(q, k, v, causal)
    raise NotImplementedError(f"flash_attention: no kernel for device {q.device}")
