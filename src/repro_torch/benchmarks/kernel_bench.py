"""Kernel and numerics microbenchmarks (port of ``benchmarks/kernel_bench.py``,
same four functions and row names, plus rows at smollm-135m's attention
width).

* pivoted-QR vs SVD factorization time: the paper's §3.2 claim that QR is
  the cheaper basis extractor.  Both are plain torch on the device (neither
  is a kernel of the reference); ``qr_pivoted`` is a loop of small ops with
  a host read of the pivot each column, SVD one library call.  The ratio is
  the datum, whichever way it points.
* the fused QR-LoRA matmul (the one-λ kernel on the card) vs materialising
  ΔW, with the plain formula's time beside it.
* flash / dense decode attention and the one-λ matmul: each kernel's max
  error against its plain version within a stated tolerance, and on the
  card its device time (CUDA events) beside the plain version's.  On the
  CPU the wrappers run the plain versions, so the errors read 0 and the
  times are host times of the plain versions.

Inputs come from ``torch.Generator`` seeds on the device.
"""
from __future__ import annotations

import sys

import torch

from repro_torch.benchmarks import common
from repro_torch.benchmarks.common import emit, timed
from repro_torch.configs import get_config
from repro_torch.core.pivoted_qr import qr_pivoted
from repro_torch.device import resolve_device
from repro_torch.kernels import ops, ref

# (atol, rtol, ptol): |kernel − plain| ≤ atol + rtol·|plain| + ptol·(P·|v|),
# elementwise, where P·|v| is the plain attention of |v| in fp32
# (:func:`abs_v_attention`, :func:`abs_v_paged`).  This is the one statement
# of how close each kernel must be to its plain version; ``chip_smoke.py``
# and the card tests read it from here.
#  * float32: the same fp32 arithmetic in another order.
#  * bfloat16: each side rounds its fp32 output to bf16, one ulp apart at most
#    (≤ 2^-7·|plain|, the rtol), and rounds some probabilities to bf16 before
#    P·V, each by at most 2^-8 of itself, which moves the output by at most
#    2^-8 of P·|v|.  The plain versions round the normalised probabilities;
#    the flash kernel rounds its unnormalised ones as well (2 · 2^-8), the
#    dense and paged decode kernels none (2^-8).  There is no absolute term:
#    late in a long sequence |o| and P·|v| are small, and so is the bound.
#  * the linear kernels (BGMV in its three forms, the one-λ matmul and its
#    quantized twin) and the one-λ backward's dx: float32 the same exact
#    products summed in another order; bfloat16 one ulp where a value
#    straddles a rounding boundary, plus 1e-3 for sums near zero.
_LINEAR = {torch.float32: (1e-4, 1e-5, 0.0), torch.bfloat16: (1e-3, 2.0**-7, 0.0)}
TOL = {
    "flash_attention": {torch.float32: (2e-5, 1e-5, 0.0),
                        torch.bfloat16: (0.0, 2.0**-7, 2.0**-7)},
    "decode_attention": {torch.float32: (2e-5, 1e-5, 0.0),
                         torch.bfloat16: (0.0, 2.0**-7, 2.0**-8)},
    "paged_decode_attention": {torch.float32: (2e-5, 1e-5, 0.0),
                               torch.bfloat16: (0.0, 2.0**-7, 2.0**-8)},
    **{kind: _LINEAR for kind in ("qrlora_matmul", "qrlora_matmul_quant", "qrlora_matmul_dx",
                                  "qrlora_bgmv", "qrlora_bgmv_quant", "qrlora_bgmv_rows")},
}


def abs_v_attention(q, k, v, arg) -> torch.Tensor:
    """P·|v| in fp32, the scale of the probability-rounding term of
    :data:`TOL`: the plain flash attention of |v| for a (B,S,H,dh) query
    (``arg`` is ``causal``), the plain decode attention of |v| for a (B,H,dh)
    one (``arg`` is the length)."""
    q, k, v = q.float(), k.float(), v.float().abs()
    if q.dim() == 4:
        return ref.flash_attention_ref(q, k, v, causal=arg)
    return ref.decode_attention_ref(q, k, v, arg)


def abs_v_paged(q, k_pool, v_pool, block_tbl, lengths) -> torch.Tensor:
    """P·|v| in fp32 for the paged decode kernel: the plain paged attention
    of |v| through the same block table and lengths."""
    return ref.paged_decode_attention_ref(q.float(), k_pool.float(), v_pool.float().abs(),
                                          block_tbl, lengths)


def _time(fn, device) -> float:
    """µs per call: device time on a card, host time of one call on the CPU."""
    if device.type == "cuda":
        return common.device_us(fn)
    return timed(fn, n=1, device=device)[1]


def _randn(gen, shape, dtype=torch.float32, scale=1.0):
    return (torch.randn(shape, generator=gen, device=gen.device) * scale).to(dtype)


def _compare(name, kind, fn, plain, dtype, device, scale=None):
    """One correctness row: the kernel path's error against its plain version
    within TOL, its time, and the plain version's beside it."""
    derived = common.record_error(name, fn(), plain(), TOL[kind][dtype], scale)
    emit(name, _time(fn, device), f"{derived};plain_us={_time(plain, device):.1f}")


def bench_qr_vs_svd(device):
    gen = torch.Generator(device=device).manual_seed(0)
    for d in (256, 768):
        W = _randn(gen, (d, d))
        _, t_qr = timed(lambda: qr_pivoted(W)[0], device=device)
        _, t_svd = timed(lambda: torch.linalg.svd(W, full_matrices=False)[0], device=device)
        emit(f"kernel:pivoted_qr:d={d}", t_qr, f"svd_us={t_svd:.0f};ratio={t_svd/t_qr:.2f}")


def bench_fused_adapter(device):
    """The reference's shapes in float32; the QR factors are bf16, as
    ``init_adapters`` makes them and as the one-λ kernel takes them."""
    M, K, N, r = 512, 768, 768, 160
    gen = torch.Generator(device=device).manual_seed(0)
    x = _randn(gen, (M, K))
    W = _randn(gen, (K, N), scale=0.05)
    B = _randn(gen, (K, r), torch.bfloat16, 0.05)
    A = _randn(gen, (r, N), torch.bfloat16, 0.05)
    lam = _randn(gen, (r,))

    fused = lambda: ops.qrlora_matmul(x, W, B, A, lam)
    plain = lambda: ref.qrlora_matmul_ref(x, W, B, A, lam)
    mat = lambda: x @ (W + (B.float() * lam[None]) @ A.float())
    err = common.record_error("kernel:qrlora_fused_vs_deltaW", fused(), plain(),
                              TOL["qrlora_matmul"][torch.float32])
    t_f, t_m, t_p = (_time(f, device) for f in (fused, mat, plain))
    emit("kernel:qrlora_fused_vs_deltaW", t_f,
         f"materialized_us={t_m:.0f};speedup={t_m/t_f:.2f};plain_us={t_p:.0f};{err}")


def _flash_row(gen, name, B, S, H, KV, dh, dtype, device, bq=512, bk=512):
    q = _randn(gen, (B, S, H, dh), dtype, 0.5)
    k = _randn(gen, (B, S, KV, dh), dtype, 0.5)
    v = _randn(gen, (B, S, KV, dh), dtype, 0.5)
    _compare(name, "flash_attention",
             lambda: ops.flash_attention(q, k, v, causal=True, bq=bq, bk=bk),
             lambda: ref.flash_attention_ref(q, k, v, causal=True), dtype, device,
             abs_v_attention(q, k, v, True))


def _decode_row(gen, name, B, S, H, KV, dh, L, dtype, device, scale=1.0, bk=512):
    """The length is a device int32 scalar, as a decode step holds it."""
    q = _randn(gen, (B, H, dh), dtype, scale)
    kc = _randn(gen, (B, S, KV, dh), dtype, scale)
    vc = _randn(gen, (B, S, KV, dh), dtype, scale)
    length = torch.tensor(L, dtype=torch.int32, device=device)
    _compare(name, "decode_attention",
             lambda: ops.decode_attention(q, kc, vc, length, bk=bk),
             lambda: ref.decode_attention_ref(q, kc, vc, length), dtype, device,
             abs_v_attention(q, kc, vc, length))


def bench_kernel_correctness(device):
    f32 = torch.float32
    gen = torch.Generator(device=device).manual_seed(1)
    # the reference's three cases, at its shapes
    _flash_row(gen, "kernel:flash_attention:interpret", 1, 256, 8, 2, 64, f32, device,
               bq=128, bk=128)
    _decode_row(gen, "kernel:decode_attention:interpret", 2, 512, 8, 2, 64, 300, f32, device,
                bk=128)
    x = _randn(gen, (128, 256), scale=0.3)
    W = _randn(gen, (256, 128), scale=0.1)
    B = _randn(gen, (256, 16), torch.bfloat16, 0.1)
    A = _randn(gen, (16, 128), torch.bfloat16, 0.1)
    lam = _randn(gen, (16,))
    _compare("kernel:qrlora_matmul:interpret", "qrlora_matmul",
             lambda: ops.qrlora_matmul(x, W, B, A, lam, 1.0),
             lambda: ref.qrlora_matmul_ref(x, W, B, A, lam), f32, device)
    # smollm-135m's attention width: the train shape, the published context
    # length, and a decode step over a long cache
    cfg = get_config("smollm-135m")
    H, KV, dh = cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    for dtype in (torch.bfloat16, f32):
        dt = str(dtype).split(".")[1]
        for B_, S in ((8, 256), (1, 2048)):
            _flash_row(gen, f"kernel:flash_attention:smollm-135m:B={B_}:S={S}:{dt}", B_, S, H, KV,
                       dh, dtype, device)
        _decode_row(gen, f"kernel:decode_attention:smollm-135m:B=4:S=2048:L=1000:{dt}", 4, 2048,
                    H, KV, dh, 1000, dtype, device, scale=0.5)


def main(device="cuda"):
    device = resolve_device(device)
    sys.stdout.write("# Kernel microbenchmarks\n")
    bench_qr_vs_svd(device)
    bench_fused_adapter(device)
    bench_kernel_correctness(device)


if __name__ == "__main__":
    main()
