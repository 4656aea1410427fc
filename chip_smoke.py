#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one Hopper card (H100).

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py [--seed N]

It builds the port's CUDA kernels from ``src/repro_torch/kernels/csrc``,
holds each kernel against its plain PyTorch version at the shapes the
serving and training paths give it (and the one-λ matmul's hand-written
backward against autograd through the plain formula), then drives the two
paths at the full width of smollm-135m (30 layers, random weights from
``--seed``, QR-LoRA on ``wq``/``wv`` of the last 4 layers), counting kernel
launches around each:

* serving: 6 tenants through the paged multi-tenant engine (default
  config), the served tokens checked against the merged-weight reference;
* serving on a quantized base: the same weights, tenants and traffic with
  ``base_dtype="int8"`` and ``"fp8"`` (bf16 model) through the quantized
  BGMV kernel, checked against the quantized merged-weight reference, and
  each served stream scored again by the single-tenant forward
  (``Model.apply`` with one λ: the quantized one-λ kernel); in float32 on an
  int8 base, held against the same serve with the plain version in place
  of the kernel;
* training: 30 λ-only steps at batch 8 × seq 256 through
  ``repro_torch.launch.train``'s functions, in bfloat16 and float32, each
  held against the same run with the plain version in place of the kernel.

Planted faults check that each check rejects what it targets.  Without a
CUDA card it exits non-zero before printing any result.

The line before the last holds the card's name and power limit (as
``nvidia-smi`` reports them); the one before that a JSON summary of every
kernel; the last line is ``{"ok": true, "device": {...}}``.  Per-case
details go to ``chiprun_out/chip_smoke.json``.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import math
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))

HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}  # dense bf16 tensor / fp32 non-tensor

# kernel-vs-plain tolerance, |kernel - plain| <= atol + rtol·|plain|:
#  * float32 out: both sum fp32 products, in different orders — ~1e-6 here.
#  * bfloat16 out: both round an fp32 result to bf16; values straddling a
#    rounding boundary split by one bf16 ulp (≤ 2^-7 relative).  The paged
#    plain version also rounds probabilities to bf16 before P·V (the
#    reference's order), the kernel keeps them in fp32: ≤ 2^-8 of |v|.
TOL = {
    "bgmv": {"float32": (1e-4, 1e-5), "bfloat16": (1e-3, 2.0**-7)},
    "paged": {"float32": (2e-5, 1e-5), "bfloat16": (2e-2, 2.0**-7)},
    "matmul": {"float32": (1e-4, 1e-5), "bfloat16": (1e-3, 2.0**-7)},
}
# one-λ matmul backward (hand-written) vs autograd through the plain formula:
# both compute in fp32 from the same inputs, in another order.  dx as
# |Δ| <= atol + rtol·|ref| (bf16: dx rounds to one bf16 ulp); dλ (fp32) as
# |Δ| <= DLAM_RTOL · max|dλ_ref|.
DX_TOL = {"float32": (1e-4, 1e-5), "bfloat16": (2e-2, 2.0**-7)}
DLAM_RTOL = 1e-5
# bf16 serve vs the merged-weight reference, as a fraction of a logits row's
# largest |logit| (the two paths round at different places in every layer).
# Set from full-width readings on an H100 at --seed 0: the sound serve's
# largest is 12.1·2^-9; planted faults (planted_faults below) read 16.6·2^-9
# (decode seg sent to slot 0), 21.6·2^-9 (λ of one layer left out) and
# 118·2^-9 (attend misses the newest K/V).  The bound sits between the sound
# serve and the smallest fault, and every run checks that it rejects all three.
BF16_DRIFT = 14 * 2.0**-9
# fp32 serve vs the merged-weight reference: the bar of the reference's own
# serve_multi driver (tokens must match exactly as well).
FP32_LOGIT_TOL = 1e-3
# The same for a quantized base: the reference dequantizes the engine's
# {q, scale} weights to bf16 and merges there (every wq/wv of all 30 layers
# rounds), the engine scales the x·q sum in fp32.  Set from full-width
# readings on an H100 at --seed 0, in units of 2^-9: int8 sound serve 14.5,
# planted faults 18.6 (decode seg sent to slot 0), 44.2 (dequant scale on the
# adapter term), 81.4 (w_scale dropped for one wq); fp8 sound 16.7, faults
# 17.9, 43.4, 72.1.  Each bound sits between its sound serve and its smallest
# fault (fp8: by 3% either side), and every run plants all three on both.
QUANT_BF16_DRIFT = {"int8": 16 * 2.0**-9, "fp8": 17.25 * 2.0**-9}
# float32 quantized serve vs the quantized merged-weight reference: the bar
# of the reference's serve_multi for a quantized base.  Its merged
# weights are bf16 (dequantized to the factors' dtype), so at full width a
# greedy stream may part where the reference's lead is below this bar (one
# tenant of 6 at --seed 0, lead 0.0052); tokens are exact up to there.
QUANT_FP32_LOGIT_TOL = 5e-2
# rows of a single-tenant scoring forward (a 16-48 token prompt and 15 of
# the served tokens): the quantized one-λ kernel's timed shape
SCORE_ROWS = 64


def _fail(msg: str) -> None:
    sys.stderr.write(f"chip_smoke: FAILED: {msg}\n")
    raise SystemExit(1)


def _check(cond: bool, msg: str) -> None:
    if not cond:
        _fail(msg)


def _device_ms(fn, iters: int = 50, reps: int = 5) -> float:
    """Device time of one call: ``iters`` back-to-back calls captured in a
    CUDA graph, replayed ``reps`` times between CUDA events.  Replaying a
    graph takes the host's launch overhead out, so this is the card's time
    (with warm L2: the operands are the same every call).  A call that
    cannot be captured fails the run."""
    import torch

    torch.cuda.synchronize()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm-up off the default stream, as capture needs
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (iters * reps)


def _eager_ms(fn, iters: int = 100) -> float:
    """Wall time of one eager call, host launch overhead included."""
    import torch

    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / iters


def _bound_ms(n_bytes: float, n_ops: float, dtype: str):
    t_bytes = n_bytes / HBM_BYTES_PER_S
    t_ops = n_ops / PEAK_FLOPS[dtype]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def _max_err(a, b) -> float:
    return float((a.float() - b.float()).abs().max()) if a.numel() else 0.0


def _within(kernel, plain, tol) -> bool:
    atol, rtol = tol
    return bool(((kernel.float() - plain.float()).abs()
                 <= atol + rtol * plain.float().abs()).all())


# ---------------------------------------------------------------------------
# kernel vs plain
# ---------------------------------------------------------------------------


def _bgmv_inputs(gen, M, K, N, r, n_slots, x_dtype):
    import torch

    dev = gen.device
    x = torch.randn((M, K), generator=gen, device=dev).to(x_dtype)
    # a prefill bucket's padding rows: zero input, base slot
    pad = M // 8
    if pad:
        x[M - pad:] = 0
    W = (torch.randn((K, N), generator=gen, device=dev) * K**-0.5).to(x_dtype)
    B = (torch.randn((K, r), generator=gen, device=dev) * K**-0.5).bfloat16()  # QR factors
    A = torch.randn((r, N), generator=gen, device=dev).bfloat16()
    lam = torch.randn((n_slots, r), generator=gen, device=dev) * 0.3
    lam[0] = 0  # slot 0 is the base model
    seg = torch.randint(0, n_slots, (M,), generator=gen, device=dev, dtype=torch.int32)
    seg[0] = 0
    if pad:
        seg[M - pad:] = 0
    return x, W, B, A, lam, seg


def check_bgmv(gen, details):
    import torch
    from repro_torch.kernels.qrlora_bgmv import qrlora_bgmv_cuda
    from repro_torch.kernels.ref import qrlora_bgmv_ref

    K, r, n_slots = 576, 128, 8
    worst = {}
    for x_dt in (torch.bfloat16, torch.float32):
        for M in (4, 37, 4 * 64):
            for N in (576, 192):
                args = _bgmv_inputs(gen, M, K, N, r, n_slots, x_dt)
                y = qrlora_bgmv_cuda(*args)
                torch.cuda.synchronize()
                ref = qrlora_bgmv_ref(*args)
                name = str(x_dt).split(".")[1]
                err = _max_err(y, ref)
                ok = _within(y, ref, TOL["bgmv"][name])
                details.append({"kernel": "qrlora_bgmv", "x": name, "M": M, "N": N,
                                "max_abs_err": err, "ok": ok})
                _check(ok, f"qrlora_bgmv x={x_dt} M={M} N={N}: "
                           f"max|Δ|={err:.3e} over tolerance {TOL['bgmv'][name]}")
                worst[name] = max(worst.get(name, 0.0), err)
    return worst


def _paged_inputs(gen, lengths, dtype, H=9, KV=3, dh=64, bs=16, max_blocks=8):
    """Pools with trash block 0 poisoned, a shuffled table whose entries past
    each lane's length point at other lanes' blocks (stale) or at block 0."""
    import torch

    dev = gen.device
    B = len(lengths)
    n_blocks = 1 + B * max_blocks
    q = torch.randn((B, H, dh), generator=gen, device=dev).to(dtype)
    k_pool = torch.randn((n_blocks, bs, KV, dh), generator=gen, device=dev).to(dtype)
    v_pool = torch.randn((n_blocks, bs, KV, dh), generator=gen, device=dev).to(dtype)
    k_pool[0] = 1e4
    v_pool[0] = 1e4
    perm = torch.randperm(n_blocks - 1, generator=gen, device=dev).to(torch.int32) + 1
    tbl = perm.reshape(B, max_blocks).clone()
    for b, n in enumerate(lengths):
        used = -(-n // bs)
        tbl[b, used::2] = 0  # trash past the length, stale blocks between
    lens = torch.tensor(lengths, dtype=torch.int32, device=dev)
    return q, k_pool, v_pool, tbl, lens


def check_paged(gen, details):
    import torch
    from repro_torch.kernels.paged_attention import paged_decode_attention_cuda
    from repro_torch.kernels.ref import paged_decode_attention_ref

    worst = {}
    for dtype in (torch.bfloat16, torch.float32):
        name = str(dtype).split(".")[1]
        for lengths in ((0, 1, 16, 17), (100, 17, 1, 16)):
            args = _paged_inputs(gen, lengths, dtype)
            o = paged_decode_attention_cuda(*args)
            torch.cuda.synchronize()
            ref = paged_decode_attention_ref(*args)
            err = _max_err(o, ref)
            ok = _within(o, ref, TOL["paged"][name]) and bool(torch.isfinite(o).all())
            zero_ok = all(bool((o[b] == 0).all()) for b, n in enumerate(lengths) if n == 0)
            details.append({"kernel": "paged_decode_attention", "dtype": name,
                            "lengths": list(lengths), "max_abs_err": err,
                            "ok": ok and zero_ok})
            _check(ok, f"paged_decode_attention {name} lengths={lengths}: max|Δ|={err:.3e} "
                       f"over tolerance {TOL['paged'][name]}")
            _check(zero_ok, f"paged_decode_attention {name}: a length-0 lane is not zeros")
            worst[name] = max(worst.get(name, 0.0), err)
    return worst


def _matmul_inputs(gen, M, N, x_dtype, K=576, r=128, rank=100):
    """The training path's adapted projection: x (M,K) and W in the model
    dtype, bf16 QR factors whose columns past the selected ``rank`` are zero
    (as ``qr_lora_init_single`` leaves them), λ (r,) fp32."""
    import torch

    dev = gen.device
    x = torch.randn((M, K), generator=gen, device=dev).to(x_dtype)
    W = (torch.randn((K, N), generator=gen, device=dev) * K**-0.5).to(x_dtype)
    B = torch.randn((K, r), generator=gen, device=dev) * K**-0.5
    A = torch.randn((r, N), generator=gen, device=dev)
    B[:, rank:] = 0
    A[rank:] = 0
    lam = torch.randn((r,), generator=gen, device=dev) * 0.3
    return x, W, B.bfloat16(), A.bfloat16(), lam


def check_matmul(gen, details):
    import torch
    from repro_torch.kernels.qrlora_matmul import qrlora_matmul_cuda
    from repro_torch.kernels.ref import qrlora_matmul_ref

    worst = {}
    for x_dt in (torch.bfloat16, torch.float32):
        name = str(x_dt).split(".")[1]
        for M in (2048, 37):
            for N in (576, 192):
                args = _matmul_inputs(gen, M, N, x_dt)
                y = qrlora_matmul_cuda(*args, scale=0.7)
                torch.cuda.synchronize()
                ref = qrlora_matmul_ref(*args, scale=0.7)
                err = _max_err(y, ref)
                ok = _within(y, ref, TOL["matmul"][name]) and bool(torch.isfinite(y).all())
                details.append({"kernel": "qrlora_matmul", "x": name, "M": M, "N": N,
                                "max_abs_err": err, "ok": ok})
                _check(ok, f"qrlora_matmul x={name} M={M} N={N}: "
                           f"max|Δ|={err:.3e} over tolerance {TOL['matmul'][name]}")
                worst[name] = max(worst.get(name, 0.0), err)
    return worst


def _quantized(W, base_dtype):
    from repro_torch.core.quantize import quantize_weight

    qW = quantize_weight(W.float(), base_dtype)
    return qW["q"], qW["scale"]


def check_bgmv_quant(gen, details):
    """Quantized BGMV against its plain version: int8 and fp8 q, bf16 and
    float32 x, decode (M=4) and prefill-bucket (M=64) rows, seg ids over
    every slot (0 included).  Widening q is exact and so are the products,
    so the two differ by summation order only: the BGMV tolerance."""
    import torch
    from repro_torch.kernels.qrlora_bgmv import qrlora_bgmv_quant_cuda
    from repro_torch.kernels.ref import qrlora_bgmv_quant_ref

    K, r, n_slots = 576, 128, 8
    worst = {}
    for base in ("int8", "fp8"):
        for x_dt in (torch.bfloat16, torch.float32):
            name = str(x_dt).split(".")[1]
            for M in (4, 64):
                for N in (576, 192):
                    x, W, B, A, lam, _ = _bgmv_inputs(gen, M, K, N, r, n_slots, x_dt)
                    seg = torch.arange(M, device=x.device, dtype=torch.int32) % n_slots
                    q, ws = _quantized(W, base)
                    args = (x, q, ws, B, A, lam, seg)
                    y = qrlora_bgmv_quant_cuda(*args, scale=0.7)
                    torch.cuda.synchronize()
                    ref = qrlora_bgmv_quant_ref(*args, scale=0.7)
                    err = _max_err(y, ref)
                    ok = _within(y, ref, TOL["bgmv"][name]) and bool(torch.isfinite(y).all())
                    details.append({"kernel": "qrlora_bgmv_quant", "q": base, "x": name, "M": M,
                                    "N": N, "max_abs_err": err, "ok": ok})
                    _check(ok, f"qrlora_bgmv_quant q={base} x={name} M={M} N={N}: "
                               f"max|Δ|={err:.3e} over tolerance {TOL['bgmv'][name]}")
                    worst[name] = max(worst.get(name, 0.0), err)
    return worst


def check_matmul_quant(gen, details):
    """Quantized one-λ matmul against its plain version at the training
    and a ragged row count, int8 and fp8 q, bf16 and float32 x; the one-λ
    matmul tolerance (exact products, another summation order)."""
    import torch
    from repro_torch.kernels.qrlora_matmul import qrlora_matmul_quant_cuda
    from repro_torch.kernels.ref import qrlora_matmul_quant_ref

    worst = {}
    for base in ("int8", "fp8"):
        for x_dt in (torch.bfloat16, torch.float32):
            name = str(x_dt).split(".")[1]
            for M in (2048, 37):
                for N in (576, 192):
                    x, W, B, A, lam = _matmul_inputs(gen, M, N, x_dt)
                    q, ws = _quantized(W, base)
                    args = (x, q, ws, B, A, lam)
                    y = qrlora_matmul_quant_cuda(*args, scale=0.7)
                    torch.cuda.synchronize()
                    ref = qrlora_matmul_quant_ref(*args, scale=0.7)
                    err = _max_err(y, ref)
                    ok = _within(y, ref, TOL["matmul"][name]) and bool(torch.isfinite(y).all())
                    details.append({"kernel": "qrlora_matmul_quant", "q": base, "x": name,
                                    "M": M, "N": N, "max_abs_err": err, "ok": ok})
                    _check(ok, f"qrlora_matmul_quant q={base} x={name} M={M} N={N}: "
                               f"max|Δ|={err:.3e} over tolerance {TOL['matmul'][name]}")
                    worst[name] = max(worst.get(name, 0.0), err)
    return worst


def matmul_backward_readings(gen, x_dt, N, M=2048, scale=0.7):
    """The autograd.Function (kernel forward, hand-written backward) against
    torch.autograd through the plain formula ``qrlora_matmul_ref`` — which
    shares no code with the hand-written backward — on one random
    cotangent.  Returns the readings and whether each is within bounds."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.kernels.ref import qrlora_matmul_ref

    x, W, B, A, lam = _matmul_inputs(gen, M, N, x_dt)
    cot = torch.randn((M, N), generator=gen, device=gen.device).to(x_dt)
    outs = []
    for fn in (ops.qrlora_matmul, qrlora_matmul_ref):
        xx = x.clone().requires_grad_(True)
        ll = lam.clone().requires_grad_(True)
        y = fn(xx, W, B, A, ll, scale)
        (y.float() * cot.float()).sum().backward()
        outs.append((y.detach(), xx.grad, ll.grad))
    torch.cuda.synchronize()
    (y, dx, dlam), (y_ref, dx_ref, dlam_ref) = outs
    name = str(x_dt).split(".")[1]
    dlam_scale = float(dlam_ref.abs().max())
    row = {"x": name, "M": M, "N": N, "y_err": _max_err(y, y_ref), "dx_err": _max_err(dx, dx_ref),
           "dlam_err": _max_err(dlam, dlam_ref), "dlam_scale": dlam_scale}
    row["dlam_err_over_bound"] = row["dlam_err"] / (DLAM_RTOL * dlam_scale)
    row["ok"] = (_within(y, y_ref, TOL["matmul"][name]) and _within(dx, dx_ref, DX_TOL[name])
                 and row["dlam_err"] <= DLAM_RTOL * dlam_scale
                 and bool(torch.isfinite(dx).all() and torch.isfinite(dlam).all()))
    return row


def check_matmul_backward(gen, details):
    import torch

    rows = [matmul_backward_readings(gen, x_dt, N)
            for x_dt in (torch.bfloat16, torch.float32) for N in (576, 192)]
    details.extend({"kernel": "qrlora_matmul backward", **r} for r in rows)
    return rows


def planted_backward_faults(gen):
    """Controls for the backward check: the hand-written backward with the
    low-rank dx term dropped, and with ``scale`` dropped from dλ.  Each must
    fail :func:`matmul_backward_readings` (scale 0.7, random λ)."""
    import torch
    from repro_torch.kernels import ops

    sound = ops.qrlora_matmul_bwd

    def no_lowrank_dx(x, W, B, A, lam, scale, g, need_dx=True, need_dlam=True):
        dx, dlam = sound(x, W, B, A, lam, scale, g, need_dx, need_dlam)
        if dx is not None:
            g2 = g.reshape(-1, g.shape[-1]).float()
            dx = (g2 @ W.float().T).reshape(x.shape).to(x.dtype)
        return dx, dlam

    def no_scale_in_dlam(x, W, B, A, lam, scale, g, need_dx=True, need_dlam=True):
        dx, dlam = sound(x, W, B, A, lam, scale, g, need_dx, need_dlam)
        return dx, None if dlam is None else dlam / scale

    rows = {}
    for name, fault in (("bwd_lowrank_dx_dropped", no_lowrank_dx),
                        ("bwd_scale_dropped_from_dlam", no_scale_in_dlam)):
        ops.qrlora_matmul_bwd = fault
        try:
            rows[name] = matmul_backward_readings(gen, torch.float32, 576)
        finally:
            ops.qrlora_matmul_bwd = sound
    return rows


# ---------------------------------------------------------------------------
# timing at the serving path's decode shapes and the training path's shapes
# ---------------------------------------------------------------------------


def time_bgmv(gen, N: int):
    """wq (N=576) / wv (N=192) decode projection: 4 lanes, bf16."""
    import torch
    from repro_torch.kernels.qrlora_bgmv import qrlora_bgmv_cuda
    from repro_torch.kernels.ref import qrlora_bgmv_ref

    M, K, r, n_slots = 4, 576, 128, 8
    x, W, B, A, lam, seg = _bgmv_inputs(gen, M, K, N, r, n_slots, torch.bfloat16)
    seg64 = seg.long()
    kernel = lambda: qrlora_bgmv_cuda(x, W, B, A, lam, seg)
    res = {"ms": _device_ms(kernel),
           "plain_ms": _device_ms(lambda: qrlora_bgmv_ref(x, W, B, A, lam, seg)),
           "library_ms": _device_ms(lambda: x @ W + ((x @ B) * lam[seg64].to(x.dtype)) @ A)}
    res["eager_ms"] = _eager_ms(kernel)
    n_bytes = 2 * (M * K + K * N + K * r + r * N + M * N) + 4 * (n_slots * r + M)
    n_ops = 2 * M * K * N + 2 * M * K * r + M * r + 2 * M * r * N
    res["bound_ms"], res["bound_by"] = _bound_ms(n_bytes, n_ops, "bfloat16")
    res["shape"] = {"M": M, "K": K, "N": N, "r": r, "n_slots": n_slots, "dtype": "bfloat16"}
    return res


def time_paged(gen, lengths=(64, 48, 33, 17)):
    """One decode attend of the serving shapes: 4 lanes, 9 heads over 3 kv
    heads, dh 64, block 16, a 4-block attend bound; bf16."""
    import torch
    from repro_torch.kernels.paged_attention import paged_decode_attention_cuda
    from repro_torch.kernels.ref import paged_decode_attention_ref

    H, KV, dh, bs = 9, 3, 64, 16
    q, kp, vp, tbl, lens = _paged_inputs(gen, lengths, torch.bfloat16, H, KV, dh, bs, 8)
    tbl = tbl[:, :4]  # the engine's attend bound: a column slice of the table
    kernel = lambda: paged_decode_attention_cuda(q, kp, vp, tbl, lens)
    res = {"library_ms": None,  # no single PyTorch call attends through a block table
           "ms": _device_ms(kernel),
           "plain_ms": _device_ms(lambda: paged_decode_attention_ref(q, kp, vp, tbl, lens))}
    res["eager_ms"] = _eager_ms(kernel)
    toks = sum(lengths)
    n_bytes = 2 * (2 * q.numel() + 2 * toks * KV * dh) + 4 * (len(lengths) + sum(
        -(-n // bs) for n in lengths))
    n_ops = 4 * toks * H * dh + 5 * toks * H
    res["bound_ms"], res["bound_by"] = _bound_ms(n_bytes, n_ops, "bfloat16")
    res["shape"] = {"B": len(lengths), "H": H, "KV": KV, "dh": dh, "block_size": bs,
                    "lengths": list(lengths), "attend_blocks": 4, "dtype": "bfloat16"}
    return res


def time_matmul(gen, N: int):
    """wq (N=576) / wv (N=192) projection of a training step: batch 8 ×
    seq 256 = 2048 rows, bf16."""
    import torch
    from repro_torch.kernels.qrlora_matmul import qrlora_matmul_cuda
    from repro_torch.kernels.ref import qrlora_matmul_ref

    M, K, r = 2048, 576, 128
    x, W, B, A, lam = _matmul_inputs(gen, M, N, torch.bfloat16, K, r, rank=r)
    lam16 = lam.bfloat16()
    kernel = lambda: qrlora_matmul_cuda(x, W, B, A, lam)
    res = {"ms": _device_ms(kernel),
           "plain_ms": _device_ms(lambda: qrlora_matmul_ref(x, W, B, A, lam)),
           "library_ms": _device_ms(lambda: x @ W + ((x @ B) * lam16) @ A)}
    res["eager_ms"] = _eager_ms(kernel)
    n_bytes = 2 * (M * K + K * N + K * r + r * N + M * N) + 4 * r
    n_ops = 2 * M * K * N + 2 * M * K * r + M * r + 2 * M * r * N
    res["bound_ms"], res["bound_by"] = _bound_ms(n_bytes, n_ops, "bfloat16")
    res["shape"] = {"M": M, "K": K, "N": N, "r": r, "dtype": "bfloat16"}
    return res


def time_bgmv_quant(gen, N: int, base: str):
    """wq (N=576) / wv (N=192) decode projection on a quantized base: 4
    lanes, bf16 x, int8 or fp8 q.  Bytes count q at one byte an element."""
    import torch
    from repro_torch.kernels.qrlora_bgmv import qrlora_bgmv_quant_cuda
    from repro_torch.kernels.ref import qrlora_bgmv_quant_ref

    M, K, r, n_slots = 4, 576, 128, 8
    x, W, B, A, lam, seg = _bgmv_inputs(gen, M, K, N, r, n_slots, torch.bfloat16)
    q, ws = _quantized(W, base)
    seg64, ws16 = seg.long(), ws.bfloat16()
    kernel = lambda: qrlora_bgmv_quant_cuda(x, q, ws, B, A, lam, seg)
    res = {"ms": _device_ms(kernel),
           "plain_ms": _device_ms(lambda: qrlora_bgmv_quant_ref(x, q, ws, B, A, lam, seg)),
           # the widening cast is part of each call: torch has no int8/fp8 × bf16 product
           "library_ms": _device_ms(
               lambda: (x @ q.to(x.dtype)) * ws16 + ((x @ B) * lam[seg64].to(x.dtype)) @ A)}
    res["eager_ms"] = _eager_ms(kernel)
    n_bytes = 2 * (M * K + K * r + r * N + M * N) + K * N + 4 * (N + n_slots * r + M)
    n_ops = 2 * M * K * N + 2 * M * K * r + M * r + 2 * M * r * N + M * N
    res["bound_ms"], res["bound_by"] = _bound_ms(n_bytes, n_ops, "bfloat16")
    res["shape"] = {"M": M, "K": K, "N": N, "r": r, "n_slots": n_slots, "x": "bfloat16",
                    "q": base}
    return res


def time_matmul_quant(gen, M: int, N: int, base: str):
    """The one-λ projection on a quantized base: M rows (a scoring forward's
    sequence, or 2048), bf16 x, int8 or fp8 q."""
    import torch
    from repro_torch.kernels.qrlora_matmul import qrlora_matmul_quant_cuda
    from repro_torch.kernels.ref import qrlora_matmul_quant_ref

    K, r = 576, 128
    x, W, B, A, lam = _matmul_inputs(gen, M, N, torch.bfloat16, K, r, rank=r)
    q, ws = _quantized(W, base)
    lam16, ws16 = lam.bfloat16(), ws.bfloat16()
    kernel = lambda: qrlora_matmul_quant_cuda(x, q, ws, B, A, lam)
    res = {"ms": _device_ms(kernel),
           "plain_ms": _device_ms(lambda: qrlora_matmul_quant_ref(x, q, ws, B, A, lam)),
           "library_ms": _device_ms(lambda: (x @ q.to(x.dtype)) * ws16 + ((x @ B) * lam16) @ A)}
    res["eager_ms"] = _eager_ms(kernel)
    n_bytes = 2 * (M * K + K * r + r * N + M * N) + K * N + 4 * (N + r)
    n_ops = 2 * M * K * N + 2 * M * K * r + M * r + 2 * M * r * N + M * N
    res["bound_ms"], res["bound_by"] = _bound_ms(n_bytes, n_ops, "bfloat16")
    res["shape"] = {"M": M, "K": K, "N": N, "r": r, "x": "bfloat16", "q": base}
    return res


def _device_busy(prof, wall_us: float):
    """Union of the device-kernel intervals of a torch.profiler run: busy
    time, idle share of ``wall_us``, kernel count and the top kernels by
    device time."""
    from torch.autograd import DeviceType

    spans, by_name = [], {}
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            continue
        a, b = e.time_range.start, e.time_range.end
        spans.append((a, b))
        by_name[e.name] = by_name.get(e.name, 0.0) + (b - a)
    busy, end = 0.0, float("-inf")
    for a, b in sorted(spans):
        if b > end:
            busy += b - max(a, end)
            end = b
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    return {"wall_ms": wall_us / 1e3, "device_busy_ms": busy / 1e3,
            "device_idle_share": 1 - busy / wall_us, "kernels": len(spans),
            "top_kernels_ms": [(n, t / 1e3) for n, t in top]}


# ---------------------------------------------------------------------------
# the serving path at full width
# ---------------------------------------------------------------------------


def serve(dtype: str, seed: int, n_tenants: int = 6, gen_len: int = 16,
          base_dtype: str = "bf16", params=None):
    """Serve one request per tenant through the default engine (with
    ``base_dtype``, on ``params`` when given); returns the engine, the
    tenants' λ trees and timings.  The tenants and the traffic depend on
    ``seed`` only."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.serving import EngineConfig, MultiTenantEngine, random_lambda

    cfg = get_config("smollm-135m").replace(dtype=dtype)
    t0 = time.perf_counter()
    engine = MultiTenantEngine(
        cfg, EngineConfig(seed=seed, collect_logits=True, base_dtype=base_dtype), params=params)
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    gen = torch.Generator(device="cuda")
    lams = {}
    for i in range(n_tenants):
        lams[f"tenant{i}"] = random_lambda(gen.manual_seed(seed + 1000 + i), engine.params, 0.3)
        engine.add_tenant(f"tenant{i}", lams[f"tenant{i}"])
    rng = np.random.default_rng(seed)
    for tenant in lams:
        n = int(rng.integers(16, 49))
        engine.submit(tenant, rng.integers(2, cfg.vocab_size, size=n), gen_len)
    t0 = time.perf_counter()
    done = engine.run()
    torch.cuda.synchronize()
    t_serve = time.perf_counter() - t0
    return cfg, engine, lams, done, t_init, t_serve


def profile_serve(engine, seed: int, n_tenants: int = 6, gen_len: int = 16):
    """The same traffic served again (weights and kernels warm) under
    torch.profiler: wall time, the union of device-kernel intervals (busy
    time) and device time by kernel name."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    for i in range(n_tenants):
        n = int(rng.integers(16, 49))
        engine.submit(f"tenant{i}", rng.integers(2, engine.cfg.vocab_size, size=n), gen_len)
    steps0, toks0 = engine.steps, engine.decoded_tokens
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        engine.run()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    return {**_device_busy(prof, wall_us), "steps": engine.steps - steps0,
            "tokens": engine.decoded_tokens - toks0}


def verify(cfg, engine, lams, done, gen_len: int, drift: float = BF16_DRIFT):
    """Free-running check: every tenant's tokens and logits against greedy
    decoding of the merged-weight reference.  ``parted_at`` is the first
    position where the two token streams differ (None: identical); logits
    are compared up to and including it, where both saw the same context.
    ``parting_margin`` is the reference's lead of its own token over the
    engine's there, ``parting_bound`` ``drift`` of that row's largest
    |logit|."""
    import numpy as np
    from repro_torch.serving import reference_decode

    rows = []
    for uid in sorted(done):
        req = done[uid]
        toks, logits = reference_decode(cfg, engine.params, lams[req.tenant], req.prompt,
                                        gen_len, engine.max_len)
        t = next((i for i, (a, b) in enumerate(zip(req.tokens, toks)) if a != b), None)
        upto = gen_len if t is None else t + 1
        row = {"tenant": req.tenant, "prompt_len": int(req.prompt.size),
               "tokens_match": t is None, "parted_at": t,
               "max_abs_dlogits": float(np.abs(np.stack(req.logits)[:upto] - logits[:upto]).max())}
        if t is not None:
            row["parting_margin"] = float(logits[t].max() - logits[t][req.tokens[t]])
            row["parting_bound"] = float(drift * np.abs(logits[t]).max())
        rows.append(row)
    return rows


@contextlib.contextmanager
def swapped(module, attr: str, fn):
    """Run with ``module.attr`` replaced by ``fn``."""
    sound = getattr(module, attr)
    setattr(module, attr, fn)
    try:
        yield
    finally:
        setattr(module, attr, sound)


def planted_faults(cfg, engine, lams, done):
    """Controls for the bf16 checks: tenant0's request served again under
    three planted faults, each of which the teacher-forced check must
    reject.  Returns each fault's row of :func:`verify_forced`."""
    import numpy as np
    from repro_torch.kernels import ops

    req0 = next(r for r in done.values() if r.tenant == "tenant0")
    lam0 = lams["tenant0"]

    def serve_one(tenant):
        engine.submit(tenant, req0.prompt, len(req0.tokens))
        return verify_forced(cfg, engine, {tenant: lam0}, engine.run())[0]

    rows = {}
    # the decode step's seg sends the tenant's lane to slot 0, the base model
    engine.scheduler.batch_composition = lambda: np.zeros((engine.n_lanes,), np.int32)
    try:
        rows["decode_seg_to_slot0"] = serve_one("tenant0")
    finally:
        del engine.scheduler.batch_composition
    # the tenant's λ left out of its last adapted layer
    last = cfg.n_layers - 1
    lam_cut = {mod: {p: l.clone() for p, l in projs.items()} for mod, projs in lam0.items()}
    for projs in lam_cut.values():
        for lam in projs.values():
            lam[last] = 0
    engine.add_tenant("fault_lam", lam_cut)
    rows["lam_of_last_layer_left_out"] = serve_one("fault_lam")
    # the decode attend misses the newest token's K/V
    paged = ops.paged_decode_attention
    with swapped(ops, "paged_decode_attention",
                 lambda q, kp, vp, tbl, lens: paged(q, kp, vp, tbl, lens - 1)):
        rows["attend_misses_newest_kv"] = serve_one("tenant0")
    return rows


def verify_forced(cfg, engine, lams, done, drift: float = BF16_DRIFT):
    """Teacher-forced check for bfloat16, where merged weights round
    differently from the fused adapter path and greedy streams may part at
    near-ties: the merged-weight reference runs one forward over each
    tenant's prompt plus the engine's own tokens, so both see the same
    context.  At every generated position the engine's logits must agree
    with the reference's within ``drift`` of the row's largest |logit|, and
    the engine's token must be within that margin of the reference's best."""
    import numpy as np
    import torch
    from repro_torch.models import build_model
    from repro_torch.serving import merge_tenant_params

    model = build_model(cfg, engine.device)
    rows = []
    for uid in sorted(done):
        req = done[uid]
        P = req.prompt.size
        seq = np.concatenate([req.prompt, np.asarray(req.tokens[:-1], np.int32)])
        merged = merge_tenant_params(engine.params, cfg, lams[req.tenant])
        with torch.no_grad():
            ref = model.apply(merged, torch.from_numpy(seq).to(engine.device)[None])[0, P - 1:]
        ref = ref.float().cpu().numpy()
        got = np.stack(req.logits)
        bound = drift * np.abs(ref).max(axis=1)
        margin = ref.max(axis=1) - ref[np.arange(len(req.tokens)), req.tokens]
        dlog = np.abs(got - ref).max(axis=1)
        rows.append({"tenant": req.tenant, "prompt_len": int(P),
                     "max_abs_dlogits": float(dlog.max()),
                     "max_dlogits_over_bound": float((dlog / bound).max()),
                     "max_token_margin_over_bound": float((margin / bound).max()),
                     "argmax_agree": int((margin == 0).sum()),
                     "finite": bool(np.isfinite(got).all()),
                     "ok": bool(np.isfinite(got).all() and (dlog <= bound).all()
                                and (margin <= bound).all())})
    return rows


# ---------------------------------------------------------------------------
# the quantized base on the serving path at full width
# ---------------------------------------------------------------------------


def planted_quant_faults(cfg, engine, lams, done, drift: float):
    """Controls for the quantized serve's teacher-forced check: tenant0's
    request served again under three faults, each of which must be
    rejected — w_scale dropped for the last layer's wq, the dequant scale
    applied to the adapter term as well (``(acc + P·A·s)·w_scale``), and
    the decode step's seg sent to slot 0."""
    import numpy as np
    import torch
    from repro_torch.kernels import qrlora_bgmv as bg

    req0 = next(r for r in done.values() if r.tenant == "tenant0")
    lam0 = lams["tenant0"]
    sound = bg.qrlora_bgmv_quant
    last, n_q = cfg.n_layers - 1, cfg.n_heads * cfg.d_head

    def serve_one():
        engine.submit("tenant0", req0.prompt, len(req0.tokens))
        return verify_forced(cfg, engine, {"tenant0": lam0}, engine.run(), drift)[0]

    def no_scale_last_wq(x, q, ws, B, A, lam, seg, scale=1.0):
        # layer l's scale is the view at storage offset l·N of the stacked leaf
        if q.shape[1] == n_q and ws.storage_offset() == last * ws.shape[0]:
            ws = torch.ones_like(ws)
        return sound(x, q, ws, B, A, lam, seg, scale)

    def scale_on_adapter_term(x, q, ws, B, A, lam, seg, scale=1.0):
        xf = x.float()
        low = ((xf @ B.float()) * lam[seg.long()]) @ A.float()
        return ((xf @ q.float() + low * scale) * ws).to(x.dtype)

    rows = {}
    for name, fn in (("w_scale_dropped_last_wq", no_scale_last_wq),
                     ("dequant_scale_on_adapter_term", scale_on_adapter_term)):
        with swapped(bg, "qrlora_bgmv_quant", fn):
            rows[name] = serve_one()
    engine.scheduler.batch_composition = lambda: np.zeros((engine.n_lanes,), np.int32)
    try:
        rows["decode_seg_to_slot0"] = serve_one()
    finally:
        del engine.scheduler.batch_composition
    return rows


def matched_context_drift(done, done_ref):
    """Largest |Δlogits| of each tenant's stream against another serve of the
    same request (by tenant), over the positions whose contexts agree: up to
    and including the first position where the two token streams part."""
    import numpy as np

    ref = {r.tenant: r for r in done_ref.values()}
    rows = {}
    for req in done.values():
        other = ref[req.tenant]
        t = next((i for i, (a, b) in enumerate(zip(req.tokens, other.tokens)) if a != b), None)
        upto = len(req.tokens) if t is None else t + 1
        rows[req.tenant] = {"parted_at": t, "max_abs_dlogits": float(
            np.abs(np.stack(req.logits)[:upto] - np.stack(other.logits)[:upto]).max())}
    return rows


def tenant_params(params, lam_tree):
    """The engine's params with one tenant's λ in every adapter: the
    single-tenant deployment without merging (the one-λ path)."""
    groups = dict(params["groups"])
    groups["adapters"] = {
        mod: {proj: {**leaf, "lam": lam_tree[mod][proj]} for proj, leaf in projs.items()}
        for mod, projs in params["groups"]["adapters"].items()}
    return {**params, "groups": groups}


def score_forward(engine, lams, done, drift=None, atol=None):
    """The single-tenant forward on the engine's quantized params: each
    served stream scored teacher-forced by ``Model.apply`` with its tenant's
    λ (the quantized one-λ kernel), against the logits the engine collected
    (the quantized BGMV kernel).  bf16 rows must agree within ``drift`` of
    their largest |logit|; float32 within ``atol``.  Launches are counted
    per forward."""
    import numpy as np
    import torch
    from repro_torch import kernels

    rows, total = [], {name: 0 for name in kernels.KERNEL_WRAPPERS}
    for uid in sorted(done):
        req = done[uid]
        P = req.prompt.size
        seq = np.concatenate([req.prompt, np.asarray(req.tokens[:-1], np.int32)])
        view = tenant_params(engine.params, lams[req.tenant])
        kernels.reset_launch_counts()
        with torch.no_grad():
            out = engine.model.apply(view, torch.from_numpy(seq).to(engine.device)[None])
        torch.cuda.synchronize()
        counts = kernels.launch_counts()
        total = {k: total[k] + v for k, v in counts.items()}
        got = out[0, P - 1:].float().cpu().numpy()
        want = np.stack(req.logits)
        dlog = np.abs(got - want).max(axis=1)
        row = {"tenant": req.tenant, "rows": int(seq.size), "launches": counts,
               "adapted_projections": 2 * engine.cfg.n_layers,
               "max_abs_dlogits": float(dlog.max()), "finite": bool(np.isfinite(got).all())}
        if drift is not None:
            row["max_dlogits_over_bound"] = float((dlog / (drift * np.abs(want).max(axis=1))).max())
            row["ok"] = row["finite"] and row["max_dlogits_over_bound"] <= 1
        else:
            row["ok"] = row["finite"] and row["max_abs_dlogits"] <= atol
        rows.append(row)
    return rows, total


def quant_serve_phase(base: str, seed: int, params, done_unquantized):
    """The bf16 serve on a ``base``-quantized copy of ``params`` (the bf16
    serve's weights), launches counted around it; teacher-forced and
    free-running checks against the quantized merged-weight reference, the
    drift against the unquantized serve (reported), planted faults, and the
    single-tenant forward on the same quantized params."""
    import torch
    from repro_torch import kernels
    from repro_torch.core.quantize import resident_base_bytes

    kernels.reset_launch_counts()
    cfg, engine, lams, done, t_init, t_serve = serve("bfloat16", seed, base_dtype=base,
                                                     params=params)
    out = {"init_s": t_init, "serve_s": t_serve, "tokens": engine.decoded_tokens,
           "steps": engine.steps, "tok_per_s": engine.decoded_tokens / t_serve,
           "launches": kernels.launch_counts()}
    out["resident_bytes"], out["resident_bytes_bf16"] = resident_base_bytes(engine.params)
    _check(engine.base_dtype == base, f"serve {base}: engine base_dtype {engine.base_dtype}")
    _check(len(done) == 6 and all(len(r.tokens) == 16 for r in done.values()),
           f"serve {base}: not every tenant got its 16 tokens")
    drift = QUANT_BF16_DRIFT[base]
    out["verify_forced"] = verify_forced(cfg, engine, lams, done, drift)
    out["verify_free"] = verify(cfg, engine, lams, done, 16, drift)
    out["drift_vs_unquantized"] = matched_context_drift(done, done_unquantized)
    out["planted_faults"] = planted_quant_faults(cfg, engine, lams, done, drift)
    out["score_forward"], out["score_launches"] = score_forward(engine, lams, done, drift=drift)
    return engine, out


def check_quant_serve(base: str, out: dict) -> None:
    launches = out["launches"]
    _check(launches["qrlora_bgmv_quant"] > 0 and launches["paged_decode_attention"] > 0,
           f"serve {base}: the quantized BGMV or the paged kernel never launched: {launches}")
    _check(launches["qrlora_bgmv"] == 0,
           f"serve {base}: an adapted projection went through the unquantized BGMV: {launches}")
    _check(all(r["ok"] for r in out["verify_forced"]),
           f"serve {base} disagrees with the teacher-forced quantized merged-weight reference")
    for r in out["verify_free"]:
        _check(r["tokens_match"] or r["parting_margin"] <= r["parting_bound"],
               f"serve {base}: {r['tenant']} parts from the quantized merged-weight reference "
               f"at position {r['parted_at']}, where the reference's lead is above the bound")
    for name, row in out["planted_faults"].items():
        _check(not row["ok"], f"serve {base}: the check let the planted fault {name} through")
    for r in out["score_forward"]:
        _check(r["launches"]["qrlora_matmul_quant"] == r["adapted_projections"]
               and r["launches"]["qrlora_matmul"] == 0,
               f"serve {base}: a single-tenant forward launched {r['launches']}, want "
               f"{r['adapted_projections']} qrlora_matmul_quant (wq, wv of every layer) and no "
               "qrlora_matmul")
        _check(r["ok"], f"serve {base}: the single-tenant forward disagrees with the served "
                        f"logits: {r}")


def quant_fp32_phase(seed: int, params):
    """The float32 int8 serve, against a twin engine that runs the plain
    version in place of the quantized BGMV kernel (tokens identical, logits
    within FP32_LOGIT_TOL), against the quantized merged-weight reference at
    serve_multi's bar (free-running, up to a parting at a near-tie below the
    bar), and scored by the single-tenant forward."""
    import numpy as np
    from repro_torch import kernels
    from repro_torch.kernels import qrlora_bgmv as bg
    from repro_torch.kernels.ref import qrlora_bgmv_quant_ref

    kernels.reset_launch_counts()
    cfg, engine, lams, done, t_init, t_serve = serve("float32", seed, base_dtype="int8",
                                                     params=params)
    out = {"serve_s": t_serve, "tokens": engine.decoded_tokens, "launches": kernels.launch_counts()}
    kernels.reset_launch_counts()
    with swapped(bg, "qrlora_bgmv_quant", qrlora_bgmv_quant_ref):
        _, _, _, twin, _, _ = serve("float32", seed, base_dtype="int8", params=params)
    out["twin_launches"] = kernels.launch_counts()
    twin = {r.tenant: r for r in twin.values()}
    out["twin"] = [{"tenant": r.tenant, "tokens_match": r.tokens == twin[r.tenant].tokens,
                    "max_abs_dlogits": float(np.abs(np.stack(r.logits)
                                                    - np.stack(twin[r.tenant].logits)).max())}
                   for r in done.values()]
    out["verify"] = verify(cfg, engine, lams, done, 16)
    out["score_forward"], out["score_launches"] = score_forward(
        engine, lams, done, atol=FP32_LOGIT_TOL)
    return out


def check_quant_fp32(out: dict) -> None:
    _check(out["launches"]["qrlora_bgmv_quant"] > 0 and out["launches"]["qrlora_bgmv"] == 0,
           f"fp32 int8 serve: launches {out['launches']}")
    _check(out["twin_launches"]["qrlora_bgmv_quant"] == 0,
           f"fp32 int8 twin launched the quantized kernel: {out['twin_launches']}")
    _check(all(r["tokens_match"] and r["max_abs_dlogits"] <= FP32_LOGIT_TOL for r in out["twin"]),
           f"fp32 int8 serve disagrees with its plain-version twin: {out['twin']}")
    for r in out["verify"]:
        _check(r["max_abs_dlogits"] < QUANT_FP32_LOGIT_TOL
               and (r["tokens_match"] or r["parting_margin"] <= QUANT_FP32_LOGIT_TOL),
               f"fp32 int8 serve diverged from the quantized merged-weight reference: {r}")
    for r in out["score_forward"]:
        _check(r["launches"]["qrlora_matmul_quant"] == r["adapted_projections"]
               and r["launches"]["qrlora_matmul"] == 0,
               f"fp32 int8: a single-tenant forward launched {r['launches']}")
        _check(r["ok"], f"fp32 int8: the single-tenant forward disagrees with the served "
                        f"logits: {r}")


# ---------------------------------------------------------------------------
# the training path at full width
# ---------------------------------------------------------------------------

TRAIN_STEPS, TRAIN_BATCH, TRAIN_SEQ, TRAIN_LR = 30, 8, 256, 3e-3
# A train through the kernel against the same train with the plain version
# in place of the kernel (same params, batches and backward): the largest
# per-step |Δloss|, and the largest |Δλ| over the twin's largest |λ|.  Set
# from full-width readings on an H100 at --seed 0 (PERF.md, Findings):
#  * float32: the two differ by summation order only — |Δloss| 9.5e-7,
#    |Δλ| 5.2e-6 of max|λ|.  The planted fault (λ of the last layer's wq left
#    out of the kernel's forward) reads |Δloss| 4.8e-6 and |Δλ| 1.3e-3 of
#    max|λ|: the λ bound, 19× above the sound reading, rejects it.
#  * bfloat16: rounding differences grow through Adam's sign-like early
#    steps — |Δloss| 1.1e-3, |Δλ| 4.3% of max|λ|; the planted fault reads the
#    same, so the bf16 twin check bounds drift only, and the float32 check
#    carries the fault.
TRAIN_TOL = {"float32": {"dloss": 1e-5, "dlam_rel": 1e-4},
             "bfloat16": {"dloss": 1e-2, "dlam_rel": 0.25}}


def train_model(dtype: str, seed: int):
    """Full-width smollm-135m and its random params (QR-LoRA init on the
    card) through the train launcher's own ``build``."""
    import torch
    from repro_torch.launch import train as tl

    model = tl.build("smollm-135m", False, "cuda", dtype)
    t0 = time.perf_counter()
    params = model.init(torch.Generator(device="cuda").manual_seed(seed))
    torch.cuda.synchronize()
    return model, params, time.perf_counter() - t0


def train_run(model, params, seed: int, log_every: int = 0):
    """TRAIN_STEPS λ-only steps from λ = 0 through the train launcher's
    functions; returns (state, per-step history)."""
    from repro_torch.launch import train as tl
    from repro_torch.training import init_train_state

    state = init_train_state(model, params=params)
    step_fn = tl.make_step(model, TRAIN_LR, TRAIN_STEPS)
    data = tl.batches(model.cfg, TRAIN_BATCH, TRAIN_SEQ, seed, model.device)
    return tl.train(step_fn, state, data, TRAIN_STEPS, log_every=log_every, log=print)


def profile_train(model, state, seed: int, steps: int = 3):
    """Further steps of a trained state under torch.profiler: wall time,
    device busy time and idle share, device time by kernel."""
    import torch
    from repro_torch.launch import train as tl

    step_fn = tl.make_step(model, TRAIN_LR, TRAIN_STEPS)
    data = tl.batches(model.cfg, TRAIN_BATCH, TRAIN_SEQ, seed + 1, model.device)
    batches = [next(data) for _ in range(steps)]
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for b in batches:
            state, m = step_fn(state, b)
            float(m["loss"])
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    return {**_device_busy(prof, wall_us), "steps": steps}


def plain_forward(x, W, B, A, lam, scale=1.0):
    from repro_torch.kernels.ref import qrlora_matmul_ref

    return qrlora_matmul_ref(x, W, B, A, lam, scale)


def last_wq_lam_dropped(cfg):
    """Planted fault: the kernel's forward with λ of the last layer's wq
    left out (layer ``n_layers - 1`` is the λ view at that storage offset of
    the stacked leaf; wq is the projection of width n_heads · d_head)."""
    import torch
    from repro_torch.kernels.qrlora_matmul import qrlora_matmul

    last, n_q = cfg.n_layers - 1, cfg.n_heads * cfg.d_head

    def fwd(x, W, B, A, lam, scale=1.0):
        if lam.storage_offset() == last * lam.shape[0] and W.shape[1] == n_q:
            lam = torch.zeros_like(lam)
        return qrlora_matmul(x, W, B, A, lam, scale)

    return fwd


def compare_trains(run, twin):
    from repro_torch.tree import tree_leaves

    (state, hist), (state_t, hist_t) = run, twin
    lam, lam_t = tree_leaves(state["trainable"]), tree_leaves(state_t["trainable"])
    scale = max(float(l.detach().abs().max()) for l in lam_t)
    dlam = max(_max_err(a.detach(), b.detach()) for a, b in zip(lam, lam_t))
    return {"max_dloss": max(abs(a["loss"] - b["loss"]) for a, b in zip(hist, hist_t)),
            "max_dlam": dlam, "max_lam": scale, "dlam_rel": dlam / scale,
            "finite": all(math.isfinite(h["loss"]) for h in hist + hist_t)}


def within_train_tol(r, dtype: str) -> bool:
    tol = TRAIN_TOL[dtype]
    return r["finite"] and r["max_dloss"] <= tol["dloss"] and r["dlam_rel"] <= tol["dlam_rel"]


def lam_outside_selection(params, state):
    """Nonzero λ entries outside the selected layers and ranks, nonzero
    entries inside them, and the selected ranks of each projection."""
    outside = inside = 0
    ranks = {}
    for mod, projs in params["groups"]["adapters"].items():
        for proj, leaf in projs.items():
            lam = state["trainable"]["groups"]["adapters"][mod][proj]["lam"].detach()
            ranks[proj] = leaf["ranks"].tolist()
            for l, r in enumerate(ranks[proj]):
                outside += int((lam[l, r:] != 0).sum())
                inside += int((lam[l, :r] != 0).sum())
    return outside, inside, ranks


def train_phase(dtype: str, seed: int, log_every: int = 0):
    """The train, its plain-version twin and the planted forward fault, at
    one dtype; the bfloat16 train is also profiled."""
    import torch
    from repro_torch import kernels
    from repro_torch.core.adapter_api import partition
    from repro_torch.kernels import qrlora_matmul as mm
    from repro_torch.launch import train as tl
    from repro_torch.tree import tree_leaves

    model, params, t_init = train_model(dtype, seed)
    frozen = [t.clone() for t in tree_leaves(partition(params, model.trainable_mask(params))[1])]
    out = {"init_s": t_init}
    runs = {}
    for name, fwd in (("kernel", None), ("plain_twin", plain_forward),
                      ("fault_last_wq_lam_dropped", last_wq_lam_dropped(model.cfg))):
        kernels.reset_launch_counts()
        if fwd is None:
            runs[name] = train_run(model, params, seed, log_every)
        else:
            with swapped(mm, "qrlora_matmul", fwd):  # the backward stays the hand-written one
                runs[name] = train_run(model, params, seed)
        torch.cuda.synchronize()
        out[f"launches_{name}"] = kernels.launch_counts()
    state, hist = runs["kernel"]
    out["losses"] = [h["loss"] for h in hist]
    out.update(tl.summary(hist, TRAIN_BATCH * TRAIN_SEQ))
    out["twin"] = compare_trains(runs["kernel"], runs["plain_twin"])
    out["fault_last_wq_lam_dropped"] = compare_trains(runs["fault_last_wq_lam_dropped"],
                                                      runs["plain_twin"])
    out["frozen_unchanged"] = all(
        torch.equal(a, b) for a, b in zip(frozen, tree_leaves(state["frozen"])))
    (out["lam_nonzero_outside_selection"], out["lam_nonzero_inside_selection"],
     out["selected_ranks"]) = lam_outside_selection(params, state)
    out["n_layers"] = model.cfg.n_layers
    if dtype == "bfloat16":
        out["profile"] = profile_train(model, state, seed)
    out["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 2**30
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        _fail("torch.cuda.is_available() is False — this smoke test needs the card")
    cap = torch.cuda.get_device_capability(0)
    _check(cap == (9, 0), f"needs compute capability (9, 0) (Hopper), found {cap}")
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch import kernels
    from repro_torch.kernels import _build

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(f"card: {smi}  torch {torch.__version__} cuda {torch.version.cuda}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False  # fp32 references stay fp32
    torch.backends.cudnn.allow_tf32 = False

    t0 = time.perf_counter()
    logs = _build.build(verbose=True)
    print(f"built {sorted(_build.SOURCES)} in {time.perf_counter() - t0:.1f} s")
    for name, text in logs.items():
        for line in text.splitlines():
            if "registers" in line or "smem" in line or "spill" in line:
                print(f"  {name}: {line.strip()}")

    report = {"card": smi, "cases": []}
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    bgmv_err = check_bgmv(gen, report["cases"])
    paged_err = check_paged(gen, report["cases"])
    matmul_err = check_matmul(gen, report["cases"])
    bgmv_quant_err = check_bgmv_quant(gen, report["cases"])
    matmul_quant_err = check_matmul_quant(gen, report["cases"])
    print(f"kernel vs plain: qrlora_bgmv max|Δ| {bgmv_err}, "
          f"paged_decode_attention max|Δ| {paged_err}, qrlora_matmul max|Δ| {matmul_err}, "
          f"qrlora_bgmv_quant max|Δ| {bgmv_quant_err}, qrlora_matmul_quant max|Δ| "
          f"{matmul_quant_err} (int8 and fp8; all within tolerance)")

    # -- the one-λ matmul's backward against autograd of the plain formula ---
    bwd_rows = check_matmul_backward(gen, report["cases"])
    for row in bwd_rows:
        print(f"  qrlora_matmul backward {row}")
    bwd_faults = planted_backward_faults(gen)
    for name, row in bwd_faults.items():
        print(f"  planted fault {name}: {row}")
    report["backward_faults"] = bwd_faults
    _check(all(r["ok"] for r in bwd_rows),
           "the hand-written backward disagrees with autograd through the plain formula")
    for name, row in bwd_faults.items():
        _check(not row["ok"], f"the backward check let the planted fault {name} through")
    print("qrlora_matmul backward: agrees with autograd of the plain formula; "
          f"{len(bwd_faults)} planted backward faults rejected")

    timings = {"qrlora_bgmv_wq": time_bgmv(gen, 576), "qrlora_bgmv_wv": time_bgmv(gen, 192),
               "paged_decode_attention": time_paged(gen),
               "qrlora_matmul_wq": time_matmul(gen, 576), "qrlora_matmul_wv": time_matmul(gen, 192)}
    for base in ("int8", "fp8"):
        for proj, N in (("wq", 576), ("wv", 192)):
            timings[f"qrlora_bgmv_quant_{proj}_{base}"] = time_bgmv_quant(gen, N, base)
            for M in (SCORE_ROWS, 2048):
                timings[f"qrlora_matmul_quant_{proj}_M{M}_{base}"] = time_matmul_quant(
                    gen, M, N, base)
    for name, t in timings.items():
        print(f"{name}: kernel {t['ms']:.5f} ms (eager call {t['eager_ms']:.5f} ms), plain "
              f"{t['plain_ms']:.5f} ms, library {t['library_ms']} ms, bound "
              f"{t['bound_ms']:.6f} ms ({t['bound_by']}) at {t['shape']} on {smi}; "
              f"timed by CUDA-graph replay")
    report["timings"] = timings

    # -- the main path: full-width bf16 serve, launches counted -------------
    kernels.reset_launch_counts()
    cfg, engine, lams, done, t_init, t_serve = serve("bfloat16", args.seed)
    launches = kernels.launch_counts()
    n_tok, n_steps = engine.decoded_tokens, engine.steps
    print(f"serve bf16: init {t_init:.1f} s (random weights + QR-LoRA on the card); "
          f"{n_tok} tokens for {len(done)} tenants in {t_serve:.3f} s = "
          f"{n_tok / t_serve:.1f} tok/s over {engine.steps} decode steps; launches {launches}")
    for name in ("qrlora_bgmv", "paged_decode_attention"):
        _check(launches[name] > 0, f"kernel {name} never launched on the serving path")
    _check(len(done) == 6 and all(len(r.tokens) == 16 for r in done.values()),
           "not every tenant got its 16 tokens")
    rows_bf16 = verify_forced(cfg, engine, lams, done)
    free_bf16 = verify(cfg, engine, lams, done, 16)
    for row, free in zip(rows_bf16, free_bf16):
        print(f"  bf16 {row} free-running: {free}")
    _check(all(r["ok"] for r in rows_bf16),
           "bf16 serve disagrees with the teacher-forced merged-weight reference")
    # free-running: token-identical to the reference, except that a stream
    # may part where the reference's own choice leads the engine's by no
    # more than the drift bound (a near-tie)
    for r in free_bf16:
        _check(r["tokens_match"] or r["parting_margin"] <= r["parting_bound"],
               f"bf16 {r['tenant']} parts from the merged-weight reference at position "
               f"{r['parted_at']}, where the reference's lead is above the drift bound")
    n_same = sum(r["tokens_match"] for r in free_bf16)
    print(f"bf16 free-running: {n_same} of {len(free_bf16)} tenants token-identical to the "
          f"merged-weight reference, the rest part at a near-tie within the drift bound")
    prof = profile_serve(engine, args.seed + 1)
    print(f"profiled bf16 serve: {prof}")
    faults = planted_faults(cfg, engine, lams, done)
    sound = max(r["max_dlogits_over_bound"] for r in rows_bf16)
    for name, row in faults.items():
        print(f"  planted fault {name}: {row}")
    print(f"bf16 drift readings (|Δlogits| over bound): sound serve {sound:.4f}, planted faults "
          + ", ".join(f"{n} {r['max_dlogits_over_bound']:.4f}" for n, r in faults.items()))
    for name, row in faults.items():
        _check(not row["ok"], f"the bf16 check let the planted fault {name} through")
    report["serve_bf16"] = {"init_s": t_init, "serve_s": t_serve, "tokens": n_tok, "profile": prof,
                            "steps": n_steps, "tok_per_s": n_tok / t_serve,
                            "launches": launches, "verify_forced": rows_bf16,
                            "verify_free": free_bf16, "planted_faults": faults}
    params_bf16, done_bf16 = engine.params, done
    del engine
    torch.cuda.empty_cache()

    # -- the quantized base: the bf16 serve's weights in int8, then fp8 ------
    report["serve_quant"] = {}
    for base in ("int8", "fp8"):
        engine, qs = quant_serve_phase(base, args.seed, params_bf16, done_bf16)
        report["serve_quant"][base] = qs
        print(f"serve bf16 on a {base} base: {qs['tokens']} tokens in {qs['serve_s']:.3f} s = "
              f"{qs['tok_per_s']:.1f} tok/s over {qs['steps']} decode steps; launches "
              f"{qs['launches']}; adapted projections resident at {qs['resident_bytes']} B "
              f"(bf16: {qs['resident_bytes_bf16']} B)")
        for row, free in zip(qs["verify_forced"], qs["verify_free"]):
            print(f"  {base} {row} free-running: {free}")
        sound_q = max(r["max_dlogits_over_bound"] for r in qs["verify_forced"])
        print(f"{base} drift readings (|Δlogits| over the bound {QUANT_BF16_DRIFT[base] / 2**-9:.1f}"
              f"·2^-9 of each row's max): sound serve {sound_q:.4f}"
              + "".join(f", planted fault {n} {r['max_dlogits_over_bound']:.4f}"
                        for n, r in qs["planted_faults"].items()))
        print(f"  {base} vs the unquantized bf16 serve at matched context (reported, no bound): "
              f"{qs['drift_vs_unquantized']}")
        print(f"  {base} single-tenant forward (Model.apply, one λ) vs served logits: "
              f"{qs['score_forward']}")
        if base == "int8":
            qs["profile"] = profile_serve(engine, args.seed + 1)
            print(f"profiled {base} serve: {qs['profile']}")
        check_quant_serve(base, qs)
        del engine
        torch.cuda.empty_cache()
    del params_bf16
    score_launches = report["serve_quant"]["int8"]["score_launches"]

    # -- the same path in float32: token-identical to the merged reference ---
    cfg, engine, lams, done, t_init, t_serve = serve("float32", args.seed)
    rows_f32 = verify(cfg, engine, lams, done, 16)
    for row in rows_f32:
        print(f"  fp32 {row}")
    report["serve_fp32"] = {"init_s": t_init, "serve_s": t_serve,
                            "tokens": engine.decoded_tokens, "verify": rows_f32}
    _check(all(r["tokens_match"] and r["max_abs_dlogits"] < FP32_LOGIT_TOL for r in rows_f32),
           "fp32 serve diverged from the merged-weight reference")
    params_f32 = engine.params
    del engine
    torch.cuda.empty_cache()

    # -- float32 on an int8 base: the plain-version twin and the reference ---
    q32 = quant_fp32_phase(args.seed, params_f32)
    report["serve_fp32_int8"] = q32
    print(f"serve fp32 on an int8 base: launches {q32['launches']} (twin {q32['twin_launches']})")
    for name in ("twin", "verify", "score_forward"):
        for row in q32[name]:
            print(f"  fp32 int8 {name} {row}")
    check_quant_fp32(q32)
    del params_f32
    torch.cuda.empty_cache()

    # -- the training path: full-width λ-only trains, launches counted -------
    want_launches = {name: 0 for name in kernels.KERNEL_WRAPPERS}
    report["train"] = {}
    for dtype in ("bfloat16", "float32"):
        torch.cuda.reset_peak_memory_stats()
        tr = train_phase(dtype, args.seed, log_every=10 if dtype == "bfloat16" else 0)
        report["train"][dtype] = tr
        print(f"train {dtype}: {TRAIN_STEPS} steps at batch {TRAIN_BATCH} × seq {TRAIN_SEQ}, "
              f"init {tr['init_s']:.1f} s; median step {tr['median_step_ms']:.1f} ms; "
              f"{tr['tokens_per_s']:.0f} train tokens/s; peak memory {tr['peak_mem_gb']:.2f} GiB; "
              f"launches {tr['launches_kernel']}")
        print(f"  loss curve: {' '.join(f'{x:.4f}' for x in tr['losses'])}")
        print(f"  vs plain twin: {tr['twin']} (bound {TRAIN_TOL[dtype]}); planted fault "
              f"last_wq_lam_dropped vs twin: {tr['fault_last_wq_lam_dropped']}")
        print(f"  frozen leaves unchanged: {tr['frozen_unchanged']}; λ nonzero outside the "
              f"selected layers/ranks: {tr['lam_nonzero_outside_selection']}, inside: "
              f"{tr['lam_nonzero_inside_selection']} of "
              f"{sum(sum(r) for r in tr['selected_ranks'].values())} selected "
              f"(ranks {tr['selected_ranks']})")
        if "profile" in tr:
            print(f"  profiled {tr['profile']['steps']} further steps: {tr['profile']}")
        matmuls = 2 * tr["n_layers"] * TRAIN_STEPS  # wq and wv of every layer, every step
        _check(tr["launches_kernel"] == {**want_launches, "qrlora_matmul": matmuls},
               f"train {dtype}: launches {tr['launches_kernel']}, want {matmuls} qrlora_matmul "
               f"and no other kernel")
        _check(tr["launches_plain_twin"] == want_launches,
               f"train {dtype}: the plain twin launched {tr['launches_plain_twin']}")
        _check(all(math.isfinite(x) for x in tr["losses"]), f"train {dtype}: non-finite loss")
        _check(tr["frozen_unchanged"], f"train {dtype}: a frozen leaf changed")
        _check(tr["lam_nonzero_outside_selection"] == 0 and tr["lam_nonzero_inside_selection"] > 0,
               f"train {dtype}: λ moved outside the selected layers and ranks, or not inside")
        _check(within_train_tol(tr["twin"], dtype),
               f"train {dtype} disagrees with its plain-version twin: {tr['twin']}")
    _check(not within_train_tol(report["train"]["float32"]["fault_last_wq_lam_dropped"],
                                "float32"),
           "the float32 train check let the planted fault last_wq_lam_dropped through")
    train_launches = report["train"]["bfloat16"]["launches_kernel"]

    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "chip_smoke.json"), "w") as f:
        json.dump(report, f, indent=1, default=str)

    entries = []
    quant_launches = report["serve_quant"]["int8"]["launches"]
    for name, key, err, src, replaces, n in (
        ("qrlora_bgmv", "qrlora_bgmv_wq", bgmv_err["bfloat16"],
         "src/repro_torch/kernels/csrc/qrlora_bgmv.cu",
         "src/repro/kernels/qrlora_bgmv.py:172", launches["qrlora_bgmv"]),
        ("paged_decode_attention", "paged_decode_attention", paged_err["bfloat16"],
         "src/repro_torch/kernels/csrc/paged_attention.cu",
         "src/repro/kernels/paged_attention.py:116", launches["paged_decode_attention"]),
        ("qrlora_matmul", "qrlora_matmul_wq", matmul_err["bfloat16"],
         "src/repro_torch/kernels/csrc/qrlora_matmul.cu",
         "src/repro/kernels/qrlora_matmul.py:161", train_launches["qrlora_matmul"]),
        ("qrlora_matmul_quant", f"qrlora_matmul_quant_wq_M{SCORE_ROWS}_int8",
         matmul_quant_err["bfloat16"], "src/repro_torch/kernels/csrc/qrlora_matmul.cu",
         "src/repro/kernels/qrlora_matmul.py:110", score_launches["qrlora_matmul_quant"]),
        ("qrlora_bgmv_quant", "qrlora_bgmv_quant_wq_int8", bgmv_quant_err["bfloat16"],
         "src/repro_torch/kernels/csrc/qrlora_bgmv.cu", "src/repro/kernels/qrlora_bgmv.py:270",
         quant_launches["qrlora_bgmv_quant"]),
    ):
        t = timings[key]
        entries.append({"name": name, "route": "cuda", "source": src, "replaces": replaces,
                        "launches": n, "max_abs_err": err, "ms": t["ms"],
                        "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
                        "bound_by": t["bound_by"], "library_ms": t["library_ms"]})
    print(json.dumps({"kernels": entries}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
