#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one Hopper card (H100).

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py [--seed N]

It builds the port's CUDA kernels from ``src/repro_torch/kernels/csrc``,
holds each kernel against its plain PyTorch version at the shapes the
serving, training, GLUE and kernel-bench paths give it (and the one-λ
matmul's hand-written backward against autograd through the plain
formula), then drives the paths, counting kernel launches around each; the
decoder paths at the full width of smollm-135m (30 layers, random weights
from ``--seed``, QR-LoRA on ``wq``/``wv`` of the last 4 layers):

* serving: 6 tenants through the paged multi-tenant engine (default
  config), the served tokens checked against the merged-weight reference;
* serving on a quantized base: the same weights, tenants and traffic with
  ``base_dtype="int8"`` and ``"fp8"`` (bf16 model) through the quantized
  BGMV kernel, checked against the quantized merged-weight reference, and
  each served stream scored again by the single-tenant forward
  (``Model.apply`` with one λ: the quantized one-λ kernel); in float32 on an
  int8 base, held against the same serve with the plain version in place
  of the kernel;
* the sharded serve: ``shard_lam`` on the bf16, int8 and (with
  ``shard_ba``) float32 serves' weights, tenants and traffic, in a NCCL
  world of one, through the rows BGMV kernel — token-identical to the
  replicated serves, float32 logits bit for bit;
* the serving posture: full-width qwen2-0.5b (24 layers, d 896, 14 heads
  over 2, QKV bias, vocab 151936; random weights and biases from
  ``--seed``, QR-LoRA on ``wq``/``wv`` of the last 4 layers) under
  ``EngineConfig.serving()`` (prefix sharing, chunked prefill at 32 tokens a
  step, a watermark of one block), 4 tenants, 8 requests — six on a
  48-token system prefix, two of 160 and 220 tokens that stream in chunks
  — with one CoW fork forced, in float32 and bfloat16, each against the
  same traffic unshared and monolithic, float32 against the merged-weight
  reference, three planted faults (a family key without the λ digest,
  chunks that attend only to themselves, no CoW fork);
* the request API and telemetry on the posture's weights and traffic:
  ``stream()`` against ``run()`` (float32, bitwise) and exactly once under
  block-pressure preemption; ``step_finish(step_begin())`` against
  ``step()`` with the decode dispatch under sync debug mode "error";
  telemetry on against off (tokens, float32 logits, launches, CUDA calls;
  bf16 tokens/s, medians of three alternating serves); ``cancel``
  of a queued and an active request; a prefill and a prefix shipped
  between two engines on the card; three planted faults (no exactly-once
  guard, a cancel that keeps the lane's blocks, an import written from the
  payload's first block); the step-phase breakdown and TTFT/TBT chunked
  against monolithic (bf16);
* training: 30 λ-only steps at batch 8 × seq 256 through
  ``repro_torch.launch.train``'s functions, in bfloat16 and float32, each
  held against the same run with the plain version in place of the kernel;
* the kernel bench (``repro_torch.benchmarks.run --only kernel``, in
  process): pivoted QR against SVD, the fused adapter against ΔW, and the
  flash-attention, dense decode-attention and one-λ kernels against their
  plain versions at the reference's shapes and smollm-135m's attention
  width, every row within its tolerance;
* the GLUE path: full-width RoBERTa-base (12 layers, d 768, vocab 50265,
  random weights from ``--seed``, float32) on mrpc through
  ``repro_torch.benchlib.run_glue_method`` in qr_lora, lora, svd_lora and
  ft at batch 16 × seq 128 (a few warm-up FT steps, a few adapter steps,
  two eval batches), every adapted projection through the one-λ kernel's
  float32 route, each mode held against the same run with the plain
  version in place of the kernel.

The BGMV and paged kernels are also checked at qwen2-0.5b's shapes (K 896,
N 896 and 128, r 160; 14 heads over 2 with length-0 lanes).  The one-λ
kernel is also checked at the encoder's shapes (float32 x,
M = 2048, 768 and a ragged 100, K = N = 768, r = 256 and 2), its backward
with LoRA's dB and dA against autograd, and ``qr_pivoted`` at 768 × 768
captured whole in one CUDA graph, replayed bitwise.

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
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))

HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}  # dense bf16 tensor / fp32 non-tensor

# Kernel-vs-plain limits, |kernel - plain| <= atol + rtol·|plain| (+ a
# probability-rounding term for attention), are stated once, in
# repro_torch.benchmarks.kernel_bench.TOL, and read through _tol; the card
# tests read the same table.
# one-λ matmul backward (hand-written) vs autograd through the plain formula:
# both compute in fp32 from the same inputs, in another order; dx is held to
# TOL["qrlora_matmul_dx"], dλ (fp32) as |Δ| <= DLAM_RTOL · max|dλ_ref|.
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


def _kernel_name(nvcc: str, mangled: str) -> str:
    """A kernel's name with its template arguments and without its
    parameters, demangled by the toolkit's ``cu++filt`` (the mangled name
    where that fails)."""
    filt = os.path.join(os.path.dirname(nvcc), "cu++filt")
    try:
        name = subprocess.run([filt, mangled], capture_output=True, text=True,
                              check=True).stdout.strip()
    except (OSError, subprocess.CalledProcessError):
        return mangled
    for long, short in (("void ", ""), ("<unnamed>::", ""), ("(anonymous namespace)::", ""),
                        ("(int)", ""), ("(bool)0", "false"), ("(bool)1", "true")):
        name = name.replace(long, short)
    return name[:name.find(">(") + 1] if ">(" in name else name.split("(")[0]


def _bound_ms(n_bytes: float, n_ops: float, dtype: str):
    t_bytes = n_bytes / HBM_BYTES_PER_S
    t_ops = n_ops / PEAK_FLOPS[dtype]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def _max_err(a, b) -> float:
    return float((a.float() - b.float()).abs().max()) if a.numel() else 0.0


def _tol(kind: str, dtype) -> tuple:
    """(atol, rtol) of ``kind``'s kernel-vs-plain limit at ``dtype`` (a
    torch dtype or its name), from kernel_bench.TOL."""
    import torch
    from repro_torch.benchmarks.kernel_bench import TOL

    dtype = getattr(torch, dtype) if isinstance(dtype, str) else dtype
    return TOL[kind][dtype][:2]


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


def _replayed(fn):
    """fn's output from one captured call replayed, and from an eager call."""
    import torch

    eager = fn()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = fn()
    out.zero_()
    graph.replay()
    torch.cuda.synchronize()
    return out, eager


def check_bgmv(gen, details):
    """The BGMV kernel against its plain version: bf16 and float32 x, decode
    (M=1, 4), prefill-bucket (16, 64) and ragged (37, 256) rows, wq and wv,
    one row's slot outside the table (a zero adapter term: the plain
    version reads a zero row appended to the table); a second call and a
    captured call replayed bitwise the first."""
    import torch
    from repro_torch.kernels.qrlora_bgmv import qrlora_bgmv_cuda
    from repro_torch.kernels.ref import qrlora_bgmv_ref

    K, r, n_slots = 576, 128, 8
    worst = {}
    for x_dt in (torch.bfloat16, torch.float32):
        for M in (1, 4, 16, 37, 64, 4 * 64):
            for N in (576, 192):
                x, W, B, A, lam, seg = _bgmv_inputs(gen, M, K, N, r, n_slots, x_dt)
                seg[M // 2] = n_slots  # no such slot
                fn = lambda: qrlora_bgmv_cuda(x, W, B, A, lam, seg, 0.7)
                y, again = fn(), fn()
                replayed, _ = _replayed(fn) if M in (4, 64) else (y, y)
                torch.cuda.synchronize()
                padded = torch.cat([lam, torch.zeros_like(lam[:1])])
                ref = qrlora_bgmv_ref(x, W, B, A, padded, seg, 0.7)
                name = str(x_dt).split(".")[1]
                err = _max_err(y, ref)
                ok = (_within(y, ref, _tol("qrlora_bgmv", x_dt)) and bool(torch.isfinite(y).all())
                      and torch.equal(y, again) and torch.equal(y, replayed))
                details.append({"kernel": "qrlora_bgmv", "x": name, "M": M, "N": N,
                                "max_abs_err": err, "bitwise_again_and_replayed": ok, "ok": ok})
                _check(ok, f"qrlora_bgmv x={x_dt} M={M} N={N}: max|Δ|={err:.3e} over tolerance "
                           f"{_tol('qrlora_bgmv', x_dt)}, or a second or replayed call differs")
                worst[name] = max(worst.get(name, 0.0), err)
    return worst


def planted_bgmv_faults(gen):
    """Controls for the BGMV checks, as fractions of the kernel-vs-plain
    bound at wq (bf16: decode and a 64-row bucket; float32 decode), each
    of which must be rejected (> 1): one cluster rank's partials dropped —
    ``ref.qrlora_bgmv_split_ref`` without that rank, cut as the kernel's own
    plan (``qrlora_bgmv_plan``) cuts K, worst and least over the ranks —
    and the kernel itself run with every row's λ taken from slot 0 (seg
    all zeros).  The sound kernel reads ≤ 1."""
    import torch
    from repro_torch.benchmarks.common import err_over_bound
    from repro_torch.kernels.qrlora_bgmv import qrlora_bgmv_cuda, qrlora_bgmv_plan
    from repro_torch.kernels.ref import qrlora_bgmv_ref, qrlora_bgmv_split_ref

    K, N, r, n_slots = 576, 576, 128, 8
    out = {}
    for x_dt, M in ((torch.bfloat16, 4), (torch.bfloat16, 64), (torch.float32, 4)):
        x, W, B, A, lam, seg = _bgmv_inputs(gen, M, K, N, r, n_slots, x_dt)
        seg = torch.arange(M, device=x.device, dtype=torch.int32) % (n_slots - 1) + 1
        plan = qrlora_bgmv_plan(M, K, N, r, x_dt)
        ranks = plan["cluster"]
        _check(plan["k_slice"] == -(-K // (8 * ranks)) * 8,
               f"qrlora_bgmv_plan cuts K as the split mirror does not: {plan}")
        tol = (*_tol("qrlora_bgmv", x_dt), 0.0)
        ref = qrlora_bgmv_ref(x, W, B, A, lam, seg, 0.7)
        rows = lam[seg.long()]
        dropped = [err_over_bound(qrlora_bgmv_split_ref(x, W, B, A, rows, 0.7, ranks=ranks,
                                                        skip_ranks=(c,)), ref, tol)
                   for c in range(ranks)]
        slot0 = qrlora_bgmv_cuda(x, W, B, A, lam, torch.zeros_like(seg), 0.7)
        sound = qrlora_bgmv_cuda(x, W, B, A, lam, seg, 0.7)
        torch.cuda.synchronize()
        out[f"{str(x_dt).split('.')[1]}_M{M}"] = {
            "sound": err_over_bound(sound, ref, tol),
            "rank_dropped_least": min(dropped), "rank_dropped_worst": max(dropped),
            "lam_slot0": err_over_bound(slot0, ref, tol), "plan": plan}
    return out


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


# (lengths, H, KV, dh, table columns, columns attended): the serve's heads
# through a whole table and through the engine's 4-column slice (its
# attend bound), the reduced config's heads (dh 16, one query head a kv
# head), and a 64-column table (1024 positions: a cluster of 8 ranks
# folding several chunks each), whole and as a 48-column slice
PAGED_CASES = (((0, 1, 16, 17), 9, 3, 64, 8, 8), ((100, 17, 1, 16), 9, 3, 64, 8, 8),
               ((64, 48, 33, 17), 9, 3, 64, 8, 4), ((0, 1, 16, 100), 3, 3, 16, 8, 8),
               ((1000, 0, 513, 64), 9, 3, 64, 64, 64), ((1000, 1, 999, 257), 9, 3, 64, 64, 48))
# the device lengths written between replays of one captured call
PAGED_REPLAY_LENGTHS = ((1, 0, 64, 40), (64, 63, 17, 0), (64, 48, 33, 17))


def _paged_over(o, args, tol) -> float:
    """|kernel − plain| over the attention-form bound (see check_paged)."""
    from repro_torch.benchmarks.common import err_over_bound
    from repro_torch.benchmarks.kernel_bench import abs_v_paged
    from repro_torch.kernels.ref import paged_decode_attention_ref

    return err_over_bound(o, paged_decode_attention_ref(*args), tol, abs_v_paged(*args))


def check_paged(gen, details):
    """Each case of PAGED_CASES against the plain version within the bench's
    attention-form limit (2⁻⁷·|ref| + 2⁻⁸·P·|v| in bf16), length-0 lanes
    zeros, a second call bitwise the first; an out-of-range table entry
    inside the length (negative, past the pool) against the plain version
    over the table with that column removed and the length cut by one
    block; one captured call replayed after each of PAGED_REPLAY_LENGTHS is
    written into the device lengths, bitwise an eager call at those lengths.
    Planted faults, each of which must fail the limit: in bf16 the kernel
    with the longest lane's last block dropped (its length cut to the block
    before) on the first two cases, and one split's partial dropped from
    the merge on the 64-column table (``ref.paged_decode_attention_split_ref``
    without that rank, cut as the kernel's plan cuts the table; the least
    over the ranks).  Returns the worst |Δ| and |Δ|/bound of each dtype and
    the planted faults' least |Δ|/bound."""
    import torch
    from repro_torch.benchmarks.kernel_bench import TOL as BENCH_TOL
    from repro_torch.kernels.paged_attention import paged_decode_attention_cuda, paged_decode_plan
    from repro_torch.kernels.ref import (paged_decode_attention_ref,
                                         paged_decode_attention_split_ref)

    worst, faults = {}, {"last_block_dropped": [], "split_dropped": []}
    for dtype in (torch.bfloat16, torch.float32):
        name, tol = str(dtype).split(".")[1], BENCH_TOL["paged_decode_attention"][dtype]
        w = worst.setdefault(name, {"max_abs_err": 0.0, "err_over_bound": 0.0})
        for n_case, (lengths, H, KV, dh, mb, cols) in enumerate(PAGED_CASES):
            q, kp, vp, tbl, lens = _paged_inputs(gen, lengths, dtype, H, KV, dh, 16, mb)
            args = (q, kp, vp, tbl[:, :cols], torch.clamp(lens, max=cols * 16))
            o = paged_decode_attention_cuda(*args)
            again = paged_decode_attention_cuda(*args)
            torch.cuda.synchronize()
            err, over = _max_err(o, paged_decode_attention_ref(*args)), _paged_over(o, args, tol)
            ok = over <= 1.0 and bool(torch.isfinite(o).all())
            zero_ok = all(bool((o[b] == 0).all()) for b in range(len(lengths))
                          if int(args[4][b]) == 0)
            bitwise = torch.equal(o, again)
            details.append({"kernel": "paged_decode_attention", "dtype": name,
                            "lengths": list(lengths), "H": H, "KV": KV, "dh": dh,
                            "columns": cols, "max_abs_err": err, "err_over_bound": over,
                            "bitwise_again": bitwise, "ok": ok and zero_ok and bitwise})
            _check(ok, f"paged_decode_attention {name} {(lengths, H, KV, dh, mb, cols)}: "
                       f"max|Δ|={err:.3e}, {over:.3f} of the bound {tol}")
            _check(zero_ok, f"paged_decode_attention {name}: a length-0 lane is not zeros")
            _check(bitwise, f"paged_decode_attention {name}: a second call differs")
            w["max_abs_err"] = max(w["max_abs_err"], err)
            w["err_over_bound"] = max(w["err_over_bound"], over)
            if dtype == torch.bfloat16 and n_case < 2:
                b = max(range(len(lengths)), key=lambda i: lengths[i])
                cut = lens.clone()
                cut[b] = (lengths[b] - 1) // kp.shape[1] * kp.shape[1]
                planted = paged_decode_attention_cuda(q, kp, vp, tbl, cut)
                torch.cuda.synchronize()
                faults["last_block_dropped"].append(_paged_over(planted, args, tol))
            if dtype == torch.bfloat16 and mb == cols == 64:
                plan = paged_decode_plan(len(lengths), H, KV, dh, 16, mb, dtype)
                dropped = [_paged_over(paged_decode_attention_split_ref(
                    *args, plan["chunk"], ranks=plan["cluster"], skip_ranks=(r,)), args, tol)
                    for r in range(plan["cluster"])]
                sound = _paged_over(paged_decode_attention_split_ref(
                    *args, plan["chunk"], ranks=plan["cluster"]), args, tol)
                faults["split_dropped"].append(min(dropped))
                details.append({"kernel": "paged_decode_attention", "planted_fault":
                                "one_split_partial_dropped", "lengths": list(lengths),
                                "plan": plan, "sound_mirror": sound,
                                "err_over_bound_by_rank": dropped})
                _check(sound <= 1.0, f"paged_decode_attention: the split mirror is off the "
                                     f"plain version: {sound}")
        # an out-of-range entry inside the length contributes nothing
        q, kp, vp, tbl, lens = _paged_inputs(gen, (100, 70, 40, 64), dtype)
        cut = torch.cat([tbl[:, :1], tbl[:, 2:], tbl[:, :1]], dim=1).contiguous()
        for entry in (-3, kp.shape[0] + 5):
            bad = tbl.clone()
            bad[:, 1] = entry
            o = paged_decode_attention_cuda(q, kp, vp, bad, lens)
            torch.cuda.synchronize()
            over = _paged_over(o, (q, kp, vp, cut, lens - 16), tol)
            details.append({"kernel": "paged_decode_attention", "dtype": name,
                            "out_of_range_entry": int(entry), "err_over_bound": over})
            _check(over <= 1.0 and bool(torch.isfinite(o).all()),
                   f"paged_decode_attention {name}: an out-of-range entry ({entry}) "
                   f"contributed: {over:.3f} of the bound")
        # one captured call replayed after new device lengths
        for mb in (4, 64):
            q, kp, vp, tbl, lens = _paged_inputs(gen, PAGED_REPLAY_LENGTHS[-1], dtype,
                                                 max_blocks=mb)
            fn = lambda: paged_decode_attention_cuda(q, kp, vp, tbl, lens)
            side = torch.cuda.Stream()
            side.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(side):
                fn()
            torch.cuda.current_stream().wait_stream(side)
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph):
                out = fn()
            for new in PAGED_REPLAY_LENGTHS:
                lens.copy_(torch.tensor(new, dtype=torch.int32))
                graph.replay()
                eager = fn()
                torch.cuda.synchronize()
                over = _paged_over(out, (q, kp, vp, tbl, lens), tol)
                same = torch.equal(out, eager)
                details.append({"kernel": "paged_decode_attention", "dtype": name,
                                "graph_replay": list(new), "columns": mb,
                                "bitwise_eager": same, "err_over_bound": over})
                _check(same and over <= 1.0,
                       f"paged_decode_attention {name}: a replay at lengths {new} over {mb} "
                       f"columns differs from the eager call ({same}) or reads {over:.3f}")
    least = {k: min(v) for k, v in faults.items()}
    _check(min(least.values()) > 1.0,
           f"paged_decode_attention bf16: the check let a planted fault through: {faults}")
    return worst, least


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


# (M, K, N, r) of the one-λ checks besides the training step's: the 64-row
# scoring forward, a ragged M and M = 1 (few output tiles: K split over a
# cluster), the kernel bench's fused adapter, and K = 208, whose last K step
# is partial and whose steps divide unevenly over the cluster's ranks.
MATMUL_SHAPES = [(M, 576, N, 128) for M in (2048, 64, 37, 1) for N in (576, 192)] + [
    (512, 768, 768, 160), (64, 208, 192, 24)]


def _matmul_case(gen, kind, x_dt, M, K, N, r, base=None, rank=None):
    """One one-λ case: the kernel twice (bitwise the same), against the
    plain version within the unchanged limit; the factors' columns past
    ``rank`` (default min(100, r)) are zero.  Returns the details row."""
    import torch
    from repro_torch.benchmarks.common import err_over_bound
    from repro_torch.kernels.qrlora_matmul import qrlora_matmul_cuda, qrlora_matmul_quant_cuda
    from repro_torch.kernels.ref import qrlora_matmul_quant_ref, qrlora_matmul_ref

    x, W, B, A, lam = _matmul_inputs(gen, M, N, x_dt, K=K, r=r,
                                     rank=min(100, r) if rank is None else rank)
    if base is None:
        args, kernel, plain = (x, W, B, A, lam), qrlora_matmul_cuda, qrlora_matmul_ref
    else:
        q, ws = _quantized(W, base)
        args, kernel, plain = (x, q, ws, B, A, lam), qrlora_matmul_quant_cuda, qrlora_matmul_quant_ref
    y, y2 = kernel(*args, scale=0.7), kernel(*args, scale=0.7)
    torch.cuda.synchronize()
    ref = plain(*args, scale=0.7)
    tol = _tol(kind, x_dt)
    row = {"kernel": kind, "x": str(x_dt).split(".")[1], "M": M, "K": K, "N": N, "r": r,
           "max_abs_err": _max_err(y, ref), "err_over_bound": err_over_bound(y, ref, (*tol, 0.0)),
           "bitwise_repeat": torch.equal(y, y2)}
    if base is not None:
        row["q"] = base
    row["ok"] = (_within(y, ref, tol) and bool(torch.isfinite(y).all()) and row["bitwise_repeat"])
    return row


def check_matmul(gen, details):
    """The one-λ kernel against its plain version at the shapes above, bf16
    and float32 x; every case also bitwise the same on a second call."""
    import torch

    worst = {}
    for x_dt in (torch.bfloat16, torch.float32):
        for M, K, N, r in MATMUL_SHAPES:
            row = _matmul_case(gen, "qrlora_matmul", x_dt, M, K, N, r)
            details.append(row)
            _check(row["ok"], f"qrlora_matmul x={row['x']} M={M} K={K} N={N} r={r}: "
                              f"max|Δ|={row['max_abs_err']:.3e} ({row['err_over_bound']:.3f} of "
                              f"the bound), bitwise on a second call: {row['bitwise_repeat']}")
            worst[row["x"]] = max(worst.get(row["x"], 0.0), row["max_abs_err"])
    return worst


# (M, K, N, r) of the encoder's adapted projections (RoBERTa-base, float32):
# batch 16 × seq 128 = 2048 rows (the GLUE phase, REPRO_BENCH_SCALE=paper),
# 768 rows and a ragged 100, K = N = 768; r = 256 (QR-LoRA's rank cap at
# d = 768) and 2 (LoRA, SVD-LoRA), every rank column live.
ENCODER_SHAPES = [(M, 768, 768, r) for M in (2048, 768, 100) for r in (256, 2)]


def check_matmul_encoder(gen, details):
    """The one-λ kernel's float32 route at the encoder's shapes against its
    plain version within TOL, bitwise on a second call and under CUDA-graph
    replay.  Returns the worst max |Δ|."""
    import torch
    from repro_torch.kernels.qrlora_matmul import qrlora_matmul_cuda

    worst = 0.0
    for M, K, N, r in ENCODER_SHAPES:
        row = _matmul_case(gen, "qrlora_matmul", torch.float32, M, K, N, r, rank=r)
        x, W, B, A, lam = _matmul_inputs(gen, M, N, torch.float32, K=K, r=r, rank=r)
        out, eager = _replayed(lambda: qrlora_matmul_cuda(x, W, B, A, lam, 0.7))
        row.update(encoder=True, bitwise_replay=torch.equal(out, eager))
        details.append(row)
        _check(row["ok"] and row["bitwise_replay"],
               f"qrlora_matmul float32 encoder shape M={M} K={K} N={N} r={r}: "
               f"max|Δ|={row['max_abs_err']:.3e} ({row['err_over_bound']:.3f} of the bound), "
               f"bitwise on a second call {row['bitwise_repeat']}, under replay "
               f"{row['bitwise_replay']}")
        worst = max(worst, row["max_abs_err"])
    return worst


def _quantized(W, base_dtype):
    from repro_torch.core.quantize import quantize_weight

    qW = quantize_weight(W.float(), base_dtype)
    return qW["q"], qW["scale"]


def check_bgmv_quant(gen, details):
    """Quantized BGMV against its plain version: int8 and fp8 q, bf16 and
    float32 x, decode (M=4) and prefill-bucket (M=64) rows, seg ids over
    every slot (0 included).  Widening q is exact and so are the products,
    so the two differ by summation order only: the BGMV tolerance.  A
    second call and a captured call replayed are bitwise the first."""
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
                    fn = lambda: qrlora_bgmv_quant_cuda(*args, scale=0.7)
                    y, again = fn(), fn()
                    replayed, _ = _replayed(fn)
                    torch.cuda.synchronize()
                    ref = qrlora_bgmv_quant_ref(*args, scale=0.7)
                    err = _max_err(y, ref)
                    within = (_within(y, ref, _tol("qrlora_bgmv_quant", x_dt))
                              and bool(torch.isfinite(y).all()))
                    bitwise = torch.equal(y, again) and torch.equal(y, replayed)
                    details.append({"kernel": "qrlora_bgmv_quant", "q": base, "x": name, "M": M,
                                    "N": N, "max_abs_err": err,
                                    "bitwise_again_and_replayed": bitwise,
                                    "ok": within and bitwise})
                    _check(within, f"qrlora_bgmv_quant q={base} x={name} M={M} N={N}: "
                                   f"max|Δ|={err:.3e} over tolerance "
                                   f"{_tol('qrlora_bgmv_quant', x_dt)}")
                    _check(bitwise, f"qrlora_bgmv_quant q={base} x={name} M={M} N={N}: a second "
                                    "or replayed call differs from the first")
                    worst[name] = max(worst.get(name, 0.0), err)
    return worst


def planted_bgmv_quant_faults(gen):
    """Controls for the quantized BGMV checks at wq, as fractions of the
    kernel-vs-plain bound (int8 and fp8; bf16 at decode and a 64-row bucket,
    float32 at decode), each of which must be rejected (> 1): one cluster
    rank's partials dropped (``ref.qrlora_bgmv_split_ref`` with w_scale,
    without that rank, cut as the kernel's plan cuts K; least and worst over
    the ranks), and the kernel itself run with every λ row from slot 0 (seg
    all zeros) and with w_scale dropped (all ones); and w_scale applied to
    the adapter term as well (the split mirror without w_scale, times it).
    The sound kernel reads ≤ 1."""
    import torch
    from repro_torch.benchmarks.common import err_over_bound
    from repro_torch.kernels.qrlora_bgmv import qrlora_bgmv_plan, qrlora_bgmv_quant_cuda
    from repro_torch.kernels.ref import qrlora_bgmv_quant_ref, qrlora_bgmv_split_ref

    K, N, r, n_slots = 576, 576, 128, 8
    out = {}
    for base in ("int8", "fp8"):
        for x_dt, M in ((torch.bfloat16, 4), (torch.bfloat16, 64), (torch.float32, 4)):
            x, W, B, A, lam, _ = _bgmv_inputs(gen, M, K, N, r, n_slots, x_dt)
            seg = torch.arange(M, device=x.device, dtype=torch.int32) % (n_slots - 1) + 1
            q, ws = _quantized(W, base)
            plan = qrlora_bgmv_plan(M, K, N, r, x_dt, q.dtype)
            ranks = plan["cluster"]
            _check(plan["k_slice"] == -(-K // (8 * ranks)) * 8,
                   f"qrlora_bgmv_plan cuts K as the split mirror does not on a q: {plan}")
            tol = (*_tol("qrlora_bgmv_quant", x_dt), 0.0)
            ref = qrlora_bgmv_quant_ref(x, q, ws, B, A, lam, seg, 0.7)
            rows = lam[seg.long()]
            dropped = [err_over_bound(qrlora_bgmv_split_ref(x, q, B, A, rows, 0.7, w_scale=ws,
                                                            ranks=ranks, skip_ranks=(c,)),
                                      ref, tol) for c in range(ranks)]
            on_adapter = (qrlora_bgmv_split_ref(x, q, B, A, rows, 0.7, ranks=ranks).float()
                          * ws).to(x_dt)
            sound = qrlora_bgmv_quant_cuda(x, q, ws, B, A, lam, seg, 0.7)
            slot0 = qrlora_bgmv_quant_cuda(x, q, ws, B, A, lam, torch.zeros_like(seg), 0.7)
            unscaled = qrlora_bgmv_quant_cuda(x, q, torch.ones_like(ws), B, A, lam, seg, 0.7)
            torch.cuda.synchronize()
            out[f"{base}_{str(x_dt).split('.')[1]}_M{M}"] = {
                "sound": err_over_bound(sound, ref, tol),
                "rank_dropped_least": min(dropped), "rank_dropped_worst": max(dropped),
                "lam_slot0": err_over_bound(slot0, ref, tol),
                "w_scale_dropped": err_over_bound(unscaled, ref, tol),
                "w_scale_on_adapter": err_over_bound(on_adapter, ref, tol), "plan": plan}
    return out


def check_bgmv_rows(gen, details):
    """The rows kernel against its plain version for W in x's dtype (bf16
    or float32, no w_scale) and int8/fp8 q, bf16 and float32 x, decode
    (M=4), ragged (M=37) and prefill-bucket (M=256) rows, within the BGMV
    limit; with rows = Λ[seg] bitwise equal to the BGMV kernel or its
    quantized twin; and one λ row sent to slot 0 (the base model) rejected
    by the limit.  Returns the worst max|Δ| of each x dtype."""
    import torch
    from repro_torch.kernels.qrlora_bgmv import (
        qrlora_bgmv_cuda,
        qrlora_bgmv_quant_cuda,
        qrlora_bgmv_rows_cuda,
    )
    from repro_torch.benchmarks.common import err_over_bound
    from repro_torch.kernels.ref import qrlora_bgmv_rows_ref, qrlora_bgmv_split_ref

    K, r, n_slots = 576, 128, 8
    worst = {}
    for w_kind in ("x", "int8", "fp8"):
        for x_dt in (torch.bfloat16, torch.float32):
            name, tol = str(x_dt).split(".")[1], _tol("qrlora_bgmv_rows", x_dt)
            for M in (4, 37, 256):
                for N in (576, 192):
                    x, W, B, A, lam, seg = _bgmv_inputs(gen, M, K, N, r, n_slots, x_dt)
                    seg[1] = n_slots - 1  # the row the planted fault sends to slot 0
                    if w_kind == "x":
                        ws = None
                        twin = qrlora_bgmv_cuda(x, W, B, A, lam, seg, 0.7)
                    else:
                        W, ws = _quantized(W, w_kind)
                        twin = qrlora_bgmv_quant_cuda(x, W, ws, B, A, lam, seg, 0.7)
                    rows = lam[seg.long()]
                    y = qrlora_bgmv_rows_cuda(x, W, ws, B, A, rows, 0.7)
                    planted = rows.clone()
                    planted[1] = lam[0]
                    y_fault = qrlora_bgmv_rows_cuda(x, W, ws, B, A, planted, 0.7)
                    torch.cuda.synchronize()
                    ref = qrlora_bgmv_rows_ref(x, W, ws, B, A, rows, 0.7)
                    err = _max_err(y, ref)
                    row = {"kernel": "qrlora_bgmv_rows", "W": w_kind, "x": name, "M": M,
                           "N": N, "max_abs_err": err,
                           "within": _within(y, ref, tol) and bool(torch.isfinite(y).all()),
                           "bitwise_bgmv": torch.equal(y, twin),
                           "planted_row_to_slot0_err": _max_err(y_fault, ref),
                           "planted_rejected": not _within(y_fault, ref, tol)}
                    if w_kind == "x":  # the one-launch kernel without one cluster rank
                        row["planted_rank_dropped_over_bound"] = min(err_over_bound(
                            qrlora_bgmv_split_ref(x, W, B, A, rows, 0.7, skip_ranks=(c,)), ref,
                            (*tol, 0.0)) for c in range(8))
                        row["planted_rejected"] &= row["planted_rank_dropped_over_bound"] > 1.0
                    row["ok"] = row["within"] and row["bitwise_bgmv"] and row["planted_rejected"]
                    details.append(row)
                    _check(row["within"], f"qrlora_bgmv_rows W={w_kind} x={name} M={M} N={N}: "
                                          f"max|Δ|={err:.3e} over tolerance {tol}")
                    _check(row["bitwise_bgmv"], f"qrlora_bgmv_rows W={w_kind} x={name} M={M} "
                                                f"N={N}: not bitwise the BGMV kernel with "
                                                f"rows = Λ[seg] (max|Δ| {_max_err(y, twin):.3e})")
                    _check(row["planted_rejected"], f"qrlora_bgmv_rows W={w_kind} x={name} "
                                                    f"M={M} N={N}: the check let a λ row sent "
                                                    "to slot 0 (or a dropped cluster rank) "
                                                    "through")
                    worst[name] = max(worst.get(name, 0.0), err)
    return worst


def check_matmul_quant(gen, details):
    """Quantized one-λ matmul against its plain version at the training, the
    scoring and ragged row counts, int8 and fp8 q, bf16 and float32 x, the
    one-λ matmul tolerance (exact products, another summation order); every
    case also bitwise the same on a second call."""
    import torch

    worst = {}
    for base in ("int8", "fp8"):
        for x_dt in (torch.bfloat16, torch.float32):
            for M, K, N, r in MATMUL_SHAPES[:8] + MATMUL_SHAPES[9:]:
                row = _matmul_case(gen, "qrlora_matmul_quant", x_dt, M, K, N, r, base)
                details.append(row)
                _check(row["ok"], f"qrlora_matmul_quant q={base} x={row['x']} M={M} K={K} N={N} "
                                  f"r={r}: max|Δ|={row['max_abs_err']:.3e} "
                                  f"({row['err_over_bound']:.3f} of the bound), bitwise on a "
                                  f"second call: {row['bitwise_repeat']}")
                worst[row["x"]] = max(worst.get(row["x"], 0.0), row["max_abs_err"])
    return worst


def check_matmul_replay(gen):
    """A captured one-λ call (the main pass a programmatic dependent of the
    P pass in the graph too) replayed, bitwise the eager call, for bf16,
    int8 and fp8 at the training and scoring row counts.  Returns the rows."""
    import torch
    from repro_torch.kernels.qrlora_matmul import qrlora_matmul_cuda, qrlora_matmul_quant_cuda

    rows = []
    for base in ("bf16", "int8", "fp8"):
        for M, N in ((2048, 576), (SCORE_ROWS, 576), (SCORE_ROWS, 192)):
            x, W, B, A, lam = _matmul_inputs(gen, M, N, torch.bfloat16)
            if base == "bf16":
                fn = lambda: qrlora_matmul_cuda(x, W, B, A, lam, 0.7)
            else:
                q, ws = _quantized(W, base)
                fn = lambda: qrlora_matmul_quant_cuda(x, q, ws, B, A, lam, 0.7)
            eager = fn()
            side = torch.cuda.Stream()
            side.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(side):
                fn()
            torch.cuda.current_stream().wait_stream(side)
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph):
                out = fn()
            out.zero_()
            graph.replay()
            torch.cuda.synchronize()
            rows.append({"base": base, "M": M, "N": N, "bitwise": torch.equal(out, eager)})
    return rows


def planted_matmul_faults(gen):
    """Controls for the one-λ checks, each what a kernel that drops part of
    its K loop would give (``ref.qrlora_matmul_split_ref`` with those steps
    left out), read as a fraction of the bf16 bound against the plain
    version; each must be rejected (> 1).  One x·W step of the training
    wq projection; the last P step of each half at full rank; at 64 rows
    on an int8 base, every step of one cluster rank (rank 1, an x·q rank),
    as the kernel's own plan (``qrlora_matmul_plan``) gives that rank's
    steps."""
    import torch
    from repro_torch.benchmarks.common import err_over_bound
    from repro_torch.kernels.qrlora_matmul import qrlora_matmul_cuda, qrlora_matmul_plan
    from repro_torch.kernels.qrlora_matmul import qrlora_matmul_quant_cuda
    from repro_torch.kernels.ref import (
        qrlora_matmul_quant_ref,
        qrlora_matmul_ref,
        qrlora_matmul_split_ref,
    )

    K, r = 576, 128
    nkx, nkr = K // 64, r // 64
    out = {}
    x, W, B, A, lam = _matmul_inputs(gen, 2048, 576, torch.bfloat16, K, r, rank=r)
    ref = qrlora_matmul_ref(x, W, B, A, lam, 0.7)
    tol = (*_tol("qrlora_matmul", torch.bfloat16), 0.0)
    out["sound_wq"] = err_over_bound(qrlora_matmul_cuda(x, W, B, A, lam, 0.7), ref, tol)
    for name, skip in (("x_step_dropped", (3,)),
                       ("last_p_step_dropped", (nkx + nkr - 1, nkx + 2 * nkr - 1))):
        out[name] = err_over_bound(
            qrlora_matmul_split_ref(x, W, None, B, A, lam, 0.7, skip_steps=skip), ref, tol)
    x, W, B, A, lam = _matmul_inputs(gen, SCORE_ROWS, 576, torch.bfloat16, K, r, rank=r)
    q, ws = _quantized(W, "int8")
    ref = qrlora_matmul_quant_ref(x, q, ws, B, A, lam, 0.7)
    tol = (*_tol("qrlora_matmul_quant", torch.bfloat16), 0.0)
    plan = qrlora_matmul_plan(SCORE_ROWS, K, 576, r)
    _check(plan["cluster"] > 1, f"the 64-row projection does not split K: {plan}")
    skip = plan["steps"][1]
    out["sound_int8_M64"] = err_over_bound(qrlora_matmul_quant_cuda(x, q, ws, B, A, lam, 0.7),
                                           ref, tol)
    out["split_rank_dropped"] = err_over_bound(
        qrlora_matmul_split_ref(x, q, ws, B, A, lam, 0.7, skip_steps=skip), ref, tol)
    out["plan_M64"], out["rank1_steps"] = plan, skip
    torch.cuda.synchronize()
    return out


def _attention_inputs(gen, q_shape, kv_shape, dtype, scale=0.5):
    import torch

    return tuple((torch.randn(s, generator=gen, device=gen.device) * scale).to(dtype)
                 for s in (q_shape, kv_shape, kv_shape))


# (B, Sq, Sk, H, KV, dh, causal): the kernel bench's cases — the reference's
# (1, 256, 8/2 heads, 64), smollm-135m's train shape and its published
# context length — plus a non-causal and a Sq ≠ Sk case, sequences that are
# not a multiple of the 64-row tiles, and head dims 16, 32 and 128, each
# with walks under 8 KV tiles (one warp group a block) and from 8 on (two)
FLASH_CASES = ((1, 256, 256, 8, 2, 64, True), (8, 256, 256, 9, 3, 64, True),
               (1, 2048, 2048, 9, 3, 64, True), (8, 256, 256, 9, 3, 64, False),
               (2, 100, 300, 9, 3, 64, True), (2, 300, 100, 9, 3, 64, True),
               (2, 333, 333, 9, 3, 64, True), (2, 100, 600, 9, 3, 64, False),
               (1, 200, 200, 8, 2, 16, True), (1, 520, 520, 8, 2, 16, False),
               (1, 200, 200, 8, 2, 32, False), (1, 700, 700, 8, 2, 32, True),
               (1, 333, 333, 8, 2, 128, True), (1, 600, 600, 8, 2, 128, False))
# (B, S, H, KV, dh, length): the bench's cases, a length of one and of
# zero, both sides of the split kernel's 64-position chunk edges (bf16, dh
# 64), the last position and the whole cache
DECODE_CASES = ((2, 512, 8, 2, 64, 300), (4, 2048, 9, 3, 64, 1000), (4, 2048, 9, 3, 64, 1),
                (4, 128, 9, 3, 64, 0), (4, 2048, 9, 3, 64, 63), (4, 2048, 9, 3, 64, 64),
                (4, 2048, 9, 3, 64, 65), (4, 2048, 9, 3, 64, 2047), (4, 2048, 9, 3, 64, 2048))
# graph replays of one captured decode call: the device length between them
DECODE_REPLAY_LENGTHS = (1000, 37, 0, 2048)


def _worst(details, kernel: str) -> dict:
    """dtype → the largest max|Δ| and |Δ|/bound of a kernel's checked cases."""
    rows = [d for d in details if d["kernel"] == kernel and "dtype" in d]
    return {dt: {key: max(d[key] for d in rows if d["dtype"] == dt)
                 for key in ("max_abs_err", "err_over_bound")}
            for dt in dict.fromkeys(d["dtype"] for d in rows)}


def _dropped_tile_delta(q, k, v, tile: int = 64):
    """fp32 change of causal attention when keys S−2·tile … S−tile−1 are
    hidden from the last ``tile`` query rows: what a flash kernel that skips
    the last KV tile below the diagonal of its last query tile (the
    tensor-core P·V path, with no mask) would give instead."""
    import torch

    B, S, H, dh = q.shape
    rep = H // k.shape[2]
    kk, vv = (t.float().repeat_interleave(rep, dim=2) for t in (k, v))
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), kk) * dh**-0.5
    pos = torch.arange(S, device=q.device)
    seen = pos[None, :] <= pos[:, None]
    hidden = ((pos[None, :] >= S - 2 * tile) & (pos[None, :] < S - tile)
              & (pos[:, None] >= S - tile))

    def attend(mask):
        p = torch.softmax(s.masked_fill(~mask, float("-inf")), dim=-1)
        return torch.einsum("bhqk,bkhd->bqhd", p, vv)

    return attend(seen & ~hidden) - attend(seen)


def _strided_flash_inputs(gen, dtype, pad: int, B=2, S=300, H=9, KV=3, dh=64):
    """Views in the model layout: q from a (B,H,S,dh) tensor, k and v slices
    of one packed (B,S,2·KV,dh+pad) buffer; pad 1 makes every stride odd, so
    the kernel stages its tiles element by element (no 16-byte copies)."""
    import torch

    dev = gen.device
    q = (torch.randn((B, H, S, dh), generator=gen, device=dev) * 0.5).to(dtype).transpose(1, 2)
    kv = (torch.randn((B, S, 2 * KV, dh + pad), generator=gen, device=dev) * 0.5).to(dtype)
    return q, kv[:, :, :KV, :dh], kv[:, :, KV:, :dh]


def check_flash(gen, details):
    """Each case, and the strided layouts with and without 16-byte copies,
    against the plain version within the bench's limits; at S = 2048 in bf16
    the kernel's own output, with one KV tile's share taken out of its last
    query tile (:func:`_dropped_tile_delta`), must fail them.  Returns the
    worst |Δ| and |Δ|/bound of each dtype and the planted fault's
    |Δ|/bound."""
    import torch
    from repro_torch.benchmarks.common import err_over_bound
    from repro_torch.benchmarks.kernel_bench import TOL as BENCH_TOL, abs_v_attention
    from repro_torch.kernels.flash_attention import flash_attention_cuda
    from repro_torch.kernels.ref import flash_attention_ref

    fault = None
    for dtype in (torch.bfloat16, torch.float32):
        name, tol = str(dtype).split(".")[1], BENCH_TOL["flash_attention"][dtype]
        cases = [(c, _attention_inputs(gen, (c[0], c[1], c[3], c[5]), (c[0], c[2], c[4], c[5]),
                                       dtype)) for c in FLASH_CASES]
        cases += [((2, S, S, 9, 3, 64, True, f"strided_pad{pad}"),
                   _strided_flash_inputs(gen, dtype, pad, S=S)) for pad in (0, 1)
                  for S in (300, 600)]
        for case, (q, k, v) in cases:
            B, Sq, Sk, H, KV, dh, causal = case[:7]
            o = flash_attention_cuda(q, k, v, causal)
            torch.cuda.synchronize()
            ref = flash_attention_ref(q, k, v, causal=causal)
            pv = abs_v_attention(q, k, v, causal)
            err, over = _max_err(o, ref), err_over_bound(o, ref, tol, pv)
            ok = over <= 1.0 and bool(torch.isfinite(o).all())
            details.append({"kernel": "flash_attention", "dtype": name, "B": B, "Sq": Sq,
                            "Sk": Sk, "H": H, "KV": KV, "dh": dh, "causal": causal,
                            "layout": case[7] if len(case) > 7 else "contiguous",
                            "max_abs_err": err, "err_over_bound": over, "ok": ok})
            _check(ok, f"flash_attention {name} {case}: "
                       f"max|Δ|={err:.3e}, {over:.3f} of the bound {tol}")
            if dtype == torch.bfloat16 and Sq == Sk == 2048:
                planted = (o.float() + _dropped_tile_delta(q, k, v)).to(dtype)
                fault = {"max_abs_err": _max_err(planted, ref),
                         "err_over_bound": err_over_bound(planted, ref, tol, pv)}
                details.append({"kernel": "flash_attention", "planted_fault":
                                "last_kv_tile_dropped_from_last_q_tile", "S": Sq, **fault})
    _check(fault is not None and fault["err_over_bound"] > 1.0,
           f"flash_attention bf16: the check let a dropped KV tile through: {fault}")
    return _worst(details, "flash_attention"), fault


def _decode_replays(gen, dtype, tol, B=4, S=2048, H=9, KV=3, dh=64):
    """One decode call captured in a CUDA graph, replayed after each length
    of DECODE_REPLAY_LENGTHS is written into the device length tensor; each
    replay's |Δ|/bound against the plain version at that length."""
    import torch
    from repro_torch.benchmarks.common import err_over_bound
    from repro_torch.benchmarks.kernel_bench import abs_v_attention
    from repro_torch.kernels.decode_attention import decode_attention_cuda
    from repro_torch.kernels.ref import decode_attention_ref

    q, kc, vc = _attention_inputs(gen, (B, H, dh), (B, S, KV, dh), dtype)
    length = torch.tensor(DECODE_REPLAY_LENGTHS[0], dtype=torch.int32, device=q.device)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        decode_attention_cuda(q, kc, vc, length)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = decode_attention_cuda(q, kc, vc, length)
    overs = {}
    for L in DECODE_REPLAY_LENGTHS:
        length.fill_(L)
        graph.replay()
        torch.cuda.synchronize()
        ref = decode_attention_ref(q, kc, vc, L)
        overs[L] = err_over_bound(out, ref, tol, abs_v_attention(q, kc, vc, L))
        if L == 0 and not bool((out == 0).all()):
            overs[L] = float("inf")
    return overs


def check_decode(gen, details):
    """Each case twice: the length as a Python int and as an int32 scalar on
    the card; positions past it hold 1e4 and must never count.  Then one
    captured call replayed with new device lengths (:func:`_decode_replays`),
    and in bf16 at L = 1000 the planted fault of a merge that drops the last
    valid chunk: the kernel at the length cut back to that chunk's start
    computes exactly that, and must fail the limit at the full length.
    Returns the worst |Δ| and |Δ|/bound of each dtype, the replays' and the
    planted fault's |Δ|/bound."""
    import torch
    from repro_torch.benchmarks.common import err_over_bound
    from repro_torch.benchmarks.kernel_bench import TOL as BENCH_TOL, abs_v_attention
    from repro_torch.kernels.decode_attention import decode_attention_chunk, decode_attention_cuda
    from repro_torch.kernels.ref import decode_attention_ref

    replays, fault = {}, None
    for dtype in (torch.bfloat16, torch.float32):
        name, tol = str(dtype).split(".")[1], BENCH_TOL["decode_attention"][dtype]
        for B, S, H, KV, dh, L in DECODE_CASES:
            q, kc, vc = _attention_inputs(gen, (B, H, dh), (B, S, KV, dh), dtype)
            kc[:, L:] = vc[:, L:] = 1e4
            for length in (L, torch.tensor(L, dtype=torch.int32, device=q.device)):
                o = decode_attention_cuda(q, kc, vc, length)
                torch.cuda.synchronize()
                ref = decode_attention_ref(q, kc, vc, length)
                err = _max_err(o, ref)
                over = err_over_bound(o, ref, tol, abs_v_attention(q, kc, vc, length))
                ok = (over <= 1.0 and bool(torch.isfinite(o).all())
                      and (L > 0 or bool((o == 0).all())))
                details.append({"kernel": "decode_attention", "dtype": name, "B": B, "S": S,
                                "H": H, "KV": KV, "dh": dh, "length": L,
                                "length_on_card": isinstance(length, torch.Tensor),
                                "max_abs_err": err, "err_over_bound": over, "ok": ok})
                _check(ok, f"decode_attention {name} {(B, S, H, KV, dh, L)}: max|Δ|={err:.3e}, "
                           f"{over:.3f} of the bound {tol} (or a length-0 row not zeros)")
                if dtype == torch.bfloat16 and (S, L) == (2048, 1000) and fault is None:
                    chunk = decode_attention_chunk(dh, dtype)
                    dropped = decode_attention_cuda(q, kc, vc, (L - 1) // chunk * chunk)
                    torch.cuda.synchronize()
                    fault = {"max_abs_err": _max_err(dropped, ref), "chunk": chunk,
                             "err_over_bound": err_over_bound(dropped, ref, tol,
                                                              abs_v_attention(q, kc, vc, L))}
                    details.append({"kernel": "decode_attention", "planted_fault":
                                    "last_valid_chunk_dropped_by_the_merge", "length": L, **fault})
        replays[name] = _decode_replays(gen, dtype, tol)
        details.append({"kernel": "decode_attention", "graph_replays": name,
                        "err_over_bound": replays[name]})
        _check(all(o <= 1.0 for o in replays[name].values()),
               f"decode_attention {name}: a graph replay after a new device length disagrees "
               f"with the plain version: {replays[name]} of the bound")
    _check(fault is not None and fault["err_over_bound"] > 1.0,
           f"decode_attention bf16: the check let a dropped chunk through: {fault}")
    return _worst(details, "decode_attention"), replays, fault


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
    row["ok"] = (_within(y, y_ref, _tol("qrlora_matmul", x_dt))
                 and _within(dx, dx_ref, _tol("qrlora_matmul_dx", x_dt))
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


def matmul_factor_backward_readings(gen, M, r, scale=0.7):
    """LoRA / SVD-LoRA through the one-λ kernel: the autograd.Function's dx,
    dB and dA (kernel forward, hand-written backward) against
    torch.autograd through the plain formula, float32 x at the encoder's
    width (K = N = 768), bf16 factors (the model's) that both require grad,
    λ one.  dx is held to TOL["qrlora_matmul_dx"] in float32; dB and dA are
    bf16 leaves, each side's fp32 sum rounded once, so they are held to its
    bf16 limit (one ulp where a sum straddles a rounding boundary, 1e-3 near
    zero).  A gradient left out reads as zeros."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.kernels.ref import qrlora_matmul_ref

    x, W, B, A, _ = _matmul_inputs(gen, M, 768, torch.float32, K=768, r=r, rank=r)
    lam = torch.ones((r,), device=gen.device)
    cot = torch.randn((M, 768), generator=gen, device=gen.device)
    outs = []
    for fn in (ops.qrlora_matmul, qrlora_matmul_ref):
        xx, BB, AA = (t.clone().requires_grad_(True) for t in (x, B, A))
        y = fn(xx, W, BB, AA, lam, scale)
        (y * cot).sum().backward()
        outs.append([y.detach()] + [torch.zeros_like(t) if t.grad is None else t.grad
                                    for t in (xx, BB, AA)])
    torch.cuda.synchronize()
    (y, dx, dB, dA), (y_ref, dx_ref, dB_ref, dA_ref) = outs
    row = {"x": "float32", "M": M, "K": 768, "N": 768, "r": r, "y_err": _max_err(y, y_ref),
           "dx_err": _max_err(dx, dx_ref), "dB_err": _max_err(dB, dB_ref),
           "dA_err": _max_err(dA, dA_ref)}
    bf16_tol = _tol("qrlora_matmul_dx", torch.bfloat16)
    row["ok"] = (_within(y, y_ref, _tol("qrlora_matmul", torch.float32))
                 and _within(dx, dx_ref, _tol("qrlora_matmul_dx", torch.float32))
                 and dB.dtype == dA.dtype == torch.bfloat16
                 and _within(dB, dB_ref, bf16_tol) and _within(dA, dA_ref, bf16_tol)
                 and bool(dB.abs().max() > 0 and dA.abs().max() > 0))
    return row


def planted_factor_backward_fault(gen):
    """Control for the factor check: the hand-written backward with dA
    dropped (None, as the reference's custom VJP's zeros would leave it);
    it must fail :func:`matmul_factor_backward_readings`."""
    from repro_torch.kernels import ops

    sound = ops.qrlora_matmul_bwd_factors

    def no_dA(*args, **kw):
        return sound(*args, **kw)[0], None

    ops.qrlora_matmul_bwd_factors = no_dA
    try:
        return matmul_factor_backward_readings(gen, 2048, 2)
    finally:
        ops.qrlora_matmul_bwd_factors = sound


# ---------------------------------------------------------------------------
# timing at the serving path's decode shapes and the training path's shapes
# ---------------------------------------------------------------------------


def time_bgmv(gen, N: int, M: int = 4, K: int = 576, r: int = 128):
    """wq (N=576) / wv (N=192) projection, bf16: 4 decode lanes, or a
    prefill bucket of M rows (smollm-135m's K and rank cap unless given)."""
    import torch
    from repro_torch.benchmarks.common import eager_ms, graph_ms, launch_us
    from repro_torch.kernels.qrlora_bgmv import qrlora_bgmv_cuda
    from repro_torch.kernels.ref import qrlora_bgmv_ref

    n_slots = 8
    x, W, B, A, lam, seg = _bgmv_inputs(gen, M, K, N, r, n_slots, torch.bfloat16)
    seg64 = seg.long()
    kernel = lambda: qrlora_bgmv_cuda(x, W, B, A, lam, seg)
    res = {"ms": graph_ms(kernel),
           "plain_ms": graph_ms(lambda: qrlora_bgmv_ref(x, W, B, A, lam, seg)),
           "library_ms": graph_ms(lambda: x @ W + ((x @ B) * lam[seg64].to(x.dtype)) @ A)}
    res["eager_ms"] = eager_ms(kernel)
    res["launch_us"] = launch_us(kernel)  # one launch
    n_bytes = 2 * (M * K + K * N + K * r + r * N + M * N) + 4 * (n_slots * r + M)
    n_ops = 2 * M * K * N + 2 * M * K * r + M * r + 2 * M * r * N
    res["bound_ms"], res["bound_by"] = _bound_ms(n_bytes, n_ops, "bfloat16")
    res["shape"] = {"M": M, "K": K, "N": N, "r": r, "n_slots": n_slots, "dtype": "bfloat16"}
    return res


def _paged_bound(q, lengths, KV, dh, bs):
    """(bound ms, what bounds it) of one paged attend: q read and out
    written, the valid K/V rows and table entries and the lengths read once
    (bf16), against the products and the softmax's operations."""
    B, H = q.shape[:2]
    toks = sum(lengths)
    n_bytes = 2 * (2 * q.numel() + 2 * toks * KV * dh) + 4 * (B + sum(-(-n // bs)
                                                                      for n in lengths))
    return _bound_ms(n_bytes, 4 * toks * H * dh + 5 * toks * H, "bfloat16")


def time_paged(gen, lengths=(64, 48, 33, 17), H: int = 9, KV: int = 3, cols: int = 4,
               max_blocks: int = 8):
    """One decode attend of the serving shapes: 4 lanes, dh 64, block 16,
    bf16; smollm-135m's 9 heads over 3 through a 4-block attend bound unless
    given."""
    import torch
    from repro_torch.benchmarks.common import eager_ms, graph_ms, launch_us
    from repro_torch.kernels.paged_attention import paged_decode_attention_cuda
    from repro_torch.kernels.ref import paged_decode_attention_ref

    dh, bs = 64, 16
    q, kp, vp, tbl, lens = _paged_inputs(gen, lengths, torch.bfloat16, H, KV, dh, bs, max_blocks)
    tbl = tbl[:, :cols]  # the engine's attend bound: a column slice of the table
    kernel = lambda: paged_decode_attention_cuda(q, kp, vp, tbl, lens)
    res = {"library_ms": None,  # no single PyTorch call attends through a block table
           "ms": graph_ms(kernel),
           "plain_ms": graph_ms(lambda: paged_decode_attention_ref(q, kp, vp, tbl, lens))}
    res["eager_ms"] = eager_ms(kernel)
    res["launch_us"] = launch_us(kernel)  # one launch
    res["bound_ms"], res["bound_by"] = _paged_bound(q, lengths, KV, dh, bs)
    res["shape"] = {"B": len(lengths), "H": H, "KV": KV, "dh": dh, "block_size": bs,
                    "lengths": list(lengths), "attend_blocks": cols, "dtype": "bfloat16"}
    return res


def time_paged_long(gen, L: int = 1000, B: int = 4):
    """B lanes of length L through a 64-column table of 16-position blocks
    (a cluster of 8 ranks, 2 chunks each), bf16, beside the dense decode
    kernel (#8) over a (B, 2048) cache at the same length: the same K/V
    bytes but for the table.  Timed in turns (paged, dense, dense, paged),
    each by CUDA-graph replay; ``ms`` and ``dense_ms`` are the means of
    each one's two readings."""
    import torch
    from repro_torch.benchmarks.common import eager_ms, graph_ms, launch_us
    from repro_torch.kernels.decode_attention import decode_attention_cuda
    from repro_torch.kernels.paged_attention import paged_decode_attention_cuda
    from repro_torch.kernels.ref import paged_decode_attention_ref

    H, KV, dh, bs, mb = 9, 3, 64, 16, 64
    lengths = (L,) * B
    q, kp, vp, tbl, lens = _paged_inputs(gen, lengths, torch.bfloat16, H, KV, dh, bs, mb)
    qd, kc, vc = _attention_inputs(gen, (B, H, dh), (B, 2048, KV, dh), torch.bfloat16)
    length = torch.tensor(L, dtype=torch.int32, device=q.device)
    kernel = lambda: paged_decode_attention_cuda(q, kp, vp, tbl, lens)
    dense = lambda: decode_attention_cuda(qd, kc, vc, length)
    turns = [graph_ms(f) for f in (kernel, dense, dense, kernel)]
    res = {"library_ms": None, "ms": (turns[0] + turns[3]) / 2,
           "dense_ms": (turns[1] + turns[2]) / 2, "turns_ms": turns,
           "plain_ms": graph_ms(lambda: paged_decode_attention_ref(q, kp, vp, tbl, lens))}
    res["over_dense"] = res["ms"] / res["dense_ms"]
    res["eager_ms"] = eager_ms(kernel)
    res["launch_us"] = launch_us(kernel)
    res["bound_ms"], res["bound_by"] = _paged_bound(q, lengths, KV, dh, bs)
    res["shape"] = {"B": B, "H": H, "KV": KV, "dh": dh, "block_size": bs, "lengths": [L] * B,
                    "attend_blocks": mb, "dtype": "bfloat16"}
    return res


def time_matmul(gen, N: int):
    """wq (N=576) / wv (N=192) projection of a training step: batch 8 ×
    seq 256 = 2048 rows, bf16."""
    import torch
    from repro_torch.benchmarks.common import eager_ms, graph_ms, launch_us
    from repro_torch.kernels.qrlora_matmul import qrlora_matmul_cuda
    from repro_torch.kernels.ref import qrlora_matmul_ref

    M, K, r = 2048, 576, 128
    x, W, B, A, lam = _matmul_inputs(gen, M, N, torch.bfloat16, K, r, rank=r)
    lam16 = lam.bfloat16()
    kernel = lambda: qrlora_matmul_cuda(x, W, B, A, lam)
    res = {"ms": graph_ms(kernel),
           "plain_ms": graph_ms(lambda: qrlora_matmul_ref(x, W, B, A, lam)),
           "library_ms": graph_ms(lambda: x @ W + ((x @ B) * lam16) @ A)}
    res["eager_ms"] = eager_ms(kernel)
    res["launch_us"] = launch_us(kernel)  # the P pass and the main pass
    n_bytes = 2 * (M * K + K * N + K * r + r * N + M * N) + 4 * r
    n_ops = 2 * M * K * N + 2 * M * K * r + M * r + 2 * M * r * N
    res["bound_ms"], res["bound_by"] = _bound_ms(n_bytes, n_ops, "bfloat16")
    res["shape"] = {"M": M, "K": K, "N": N, "r": r, "dtype": "bfloat16"}
    return res


def time_matmul_f32(gen, M: int, r: int):
    """The one-λ kernel's float32 route at an encoder projection: M rows
    (2048 = batch 16 × seq 128, or 768), K = N = 768, rank r (256, QR-LoRA's
    cap; 2, LoRA) with every rank column live.  Library: ``x@W +
    ((x@B)*λ)@A`` in fp32 (TF32 off) on fp32 copies of the factors made
    outside the timed call.  Bound: fp32 operations over the card's
    non-tensor fp32 peak against the bytes."""
    import torch
    from repro_torch.benchmarks.common import eager_ms, graph_ms, launch_us
    from repro_torch.kernels.qrlora_matmul import qrlora_matmul_cuda
    from repro_torch.kernels.ref import qrlora_matmul_ref

    K = N = 768
    x, W, B, A, lam = _matmul_inputs(gen, M, N, torch.float32, K, r, rank=r)
    B32, A32 = B.float(), A.float()
    kernel = lambda: qrlora_matmul_cuda(x, W, B, A, lam)
    res = {"ms": graph_ms(kernel),
           "plain_ms": graph_ms(lambda: qrlora_matmul_ref(x, W, B, A, lam)),
           "library_ms": graph_ms(lambda: x @ W + ((x @ B32) * lam) @ A32)}
    res["eager_ms"] = eager_ms(kernel)
    res["launch_us"] = launch_us(kernel)  # the P pass and the main pass
    n_bytes = 4 * (M * K + K * N + M * N) + 2 * (K * r + r * N) + 4 * r
    n_ops = 2 * M * K * N + 2 * M * K * r + M * r + 2 * M * r * N
    res["bound_ms"], res["bound_by"] = _bound_ms(n_bytes, n_ops, "float32")
    res["shape"] = {"M": M, "K": K, "N": N, "r": r, "dtype": "float32"}
    return res


def time_bgmv_quant(gen, N: int, base: str, M: int = 4):
    """wq (N=576) / wv (N=192) projection on a quantized base: 4 decode
    lanes (or a prefill bucket of M rows), bf16 x, int8 or fp8 q.  Bytes
    count q at one byte an element."""
    import torch
    from repro_torch.benchmarks.common import eager_ms, graph_ms, launch_us
    from repro_torch.kernels.qrlora_bgmv import qrlora_bgmv_quant_cuda
    from repro_torch.kernels.ref import qrlora_bgmv_quant_ref

    K, r, n_slots = 576, 128, 8
    x, W, B, A, lam, seg = _bgmv_inputs(gen, M, K, N, r, n_slots, torch.bfloat16)
    q, ws = _quantized(W, base)
    seg64, ws16 = seg.long(), ws.bfloat16()
    kernel = lambda: qrlora_bgmv_quant_cuda(x, q, ws, B, A, lam, seg)
    res = {"ms": graph_ms(kernel),
           "plain_ms": graph_ms(lambda: qrlora_bgmv_quant_ref(x, q, ws, B, A, lam, seg)),
           # the widening cast is part of each call: torch has no int8/fp8 × bf16 product
           "library_ms": graph_ms(
               lambda: (x @ q.to(x.dtype)) * ws16 + ((x @ B) * lam[seg64].to(x.dtype)) @ A)}
    res["eager_ms"] = eager_ms(kernel)
    res["launch_us"] = launch_us(kernel)  # one launch
    n_bytes = 2 * (M * K + K * r + r * N + M * N) + K * N + 4 * (N + n_slots * r + M)
    n_ops = 2 * M * K * N + 2 * M * K * r + M * r + 2 * M * r * N + M * N
    res["bound_ms"], res["bound_by"] = _bound_ms(n_bytes, n_ops, "bfloat16")
    res["shape"] = {"M": M, "K": K, "N": N, "r": r, "n_slots": n_slots, "x": "bfloat16",
                    "q": base}
    return res


def time_bgmv_rows(gen, N: int, base: str, M: int = 4):
    """The sharded serve's projection: 4 decode lanes (or a prefill bucket
    of M rows), bf16 x, pre-gathered fp32 λ rows, W bf16 (``base`` "bf16",
    no w_scale) or int8/fp8 q.  The library yardstick is
    ``x@W + ((x@B)*rows)@A`` (``x@q·ws + …`` with q widened in the call)."""
    import torch
    from repro_torch.benchmarks.common import eager_ms, graph_ms, launch_us
    from repro_torch.kernels.qrlora_bgmv import qrlora_bgmv_rows_cuda
    from repro_torch.kernels.ref import qrlora_bgmv_rows_ref

    K, r, n_slots = 576, 128, 8
    x, W, B, A, lam, seg = _bgmv_inputs(gen, M, K, N, r, n_slots, torch.bfloat16)
    rows = lam[seg.long()]
    rows16 = rows.bfloat16()
    if base == "bf16":
        ws = None
        library = lambda: x @ W + ((x @ B) * rows16) @ A
    else:
        W, ws = _quantized(W, base)
        ws16 = ws.bfloat16()
        library = lambda: (x @ W.to(x.dtype)) * ws16 + ((x @ B) * rows16) @ A
    kernel = lambda: qrlora_bgmv_rows_cuda(x, W, ws, B, A, rows)
    res = {"ms": graph_ms(kernel),
           "plain_ms": graph_ms(lambda: qrlora_bgmv_rows_ref(x, W, ws, B, A, rows)),
           "library_ms": graph_ms(library)}
    res["eager_ms"] = eager_ms(kernel)
    res["launch_us"] = launch_us(kernel)
    n_bytes = (2 * (M * K + K * r + r * N + M * N) + K * N * W.element_size()
               + 4 * (M * r + (N if ws is not None else 0)))
    n_ops = (2 * M * K * N + 2 * M * K * r + M * r + 2 * M * r * N
             + (M * N if ws is not None else 0))
    res["bound_ms"], res["bound_by"] = _bound_ms(n_bytes, n_ops, "bfloat16")
    res["shape"] = {"M": M, "K": K, "N": N, "r": r, "x": "bfloat16", "W": base}
    return res


def time_matmul_quant(gen, M: int, N: int, base: str):
    """The one-λ projection on a quantized base: M rows (a scoring forward's
    sequence, or 2048), bf16 x, int8 or fp8 q."""
    import torch
    from repro_torch.benchmarks.common import eager_ms, graph_ms, launch_us
    from repro_torch.kernels.qrlora_matmul import qrlora_matmul_quant_cuda
    from repro_torch.kernels.ref import qrlora_matmul_quant_ref

    K, r = 576, 128
    x, W, B, A, lam = _matmul_inputs(gen, M, N, torch.bfloat16, K, r, rank=r)
    q, ws = _quantized(W, base)
    lam16, ws16 = lam.bfloat16(), ws.bfloat16()
    kernel = lambda: qrlora_matmul_quant_cuda(x, q, ws, B, A, lam)
    res = {"ms": graph_ms(kernel),
           "plain_ms": graph_ms(lambda: qrlora_matmul_quant_ref(x, q, ws, B, A, lam)),
           "library_ms": graph_ms(lambda: (x @ q.to(x.dtype)) * ws16 + ((x @ B) * lam16) @ A)}
    res["eager_ms"] = eager_ms(kernel)
    res["launch_us"] = launch_us(kernel)  # the P pass and the main pass
    n_bytes = 2 * (M * K + K * r + r * N + M * N) + K * N + 4 * (N + r)
    n_ops = 2 * M * K * N + 2 * M * K * r + M * r + 2 * M * r * N + M * N
    res["bound_ms"], res["bound_by"] = _bound_ms(n_bytes, n_ops, "bfloat16")
    res["shape"] = {"M": M, "K": K, "N": N, "r": r, "x": "bfloat16", "q": base}
    return res


def time_flash(gen, B: int, S: int):
    """Causal flash attention at smollm-135m's heads (9 over 3, dh 64), bf16:
    B=8 × S=256 (the train shape) or B=1 × S=2048.  The library yardstick is
    ``scaled_dot_product_attention`` on the same values in its own (B,H,S,dh)
    layout, made before the timed calls."""
    import torch
    from repro_torch.benchmarks.common import eager_ms, graph_ms
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import flash_attention_cuda
    from repro_torch.kernels.ref import flash_attention_ref

    H, KV, dh = 9, 3, 64
    q, k, v = _attention_inputs(gen, (B, S, H, dh), (B, S, KV, dh), torch.bfloat16)
    qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    kernel = lambda: flash_attention_cuda(q, k, v, True)
    res = {"ms": graph_ms(kernel),
           "plain_ms": graph_ms(lambda: flash_attention_ref(q, k, v, causal=True)),
           "library_ms": graph_ms(lambda: F.scaled_dot_product_attention(
               qt, kt, vt, is_causal=True, enable_gqa=True))}
    res["eager_ms"] = eager_ms(kernel)
    pairs = S * (S + 1) // 2  # (query, key) pairs under the causal mask
    n_bytes = 2 * (2 * q.numel() + k.numel() + v.numel())
    n_ops = 4 * B * H * dh * pairs
    res["bound_ms"], res["bound_by"] = _bound_ms(n_bytes, n_ops, "bfloat16")
    res["shape"] = {"B": B, "S": S, "H": H, "KV": KV, "dh": dh, "causal": True,
                    "dtype": "bfloat16"}
    return res


def time_decode(gen, B: int = 4, S: int = 2048, L: int = 1000):
    """One decode step over a dense cache at smollm-135m's heads, bf16, the
    length an int32 scalar on the card.  The library yardstick is
    ``scaled_dot_product_attention`` with a length mask over all S positions."""
    import torch
    from repro_torch.benchmarks.common import eager_ms, graph_ms
    import torch.nn.functional as F
    from repro_torch.kernels.decode_attention import decode_attention_cuda
    from repro_torch.kernels.ref import decode_attention_ref

    H, KV, dh = 9, 3, 64
    q, kc, vc = _attention_inputs(gen, (B, H, dh), (B, S, KV, dh), torch.bfloat16)
    length = torch.tensor(L, dtype=torch.int32, device=q.device)
    q4, kt, vt = q[:, :, None], kc.transpose(1, 2).contiguous(), vc.transpose(1, 2).contiguous()
    mask = (torch.arange(S, device=q.device) < length)[None, None, None, :]
    kernel = lambda: decode_attention_cuda(q, kc, vc, length)
    res = {"ms": graph_ms(kernel),
           "plain_ms": graph_ms(lambda: decode_attention_ref(q, kc, vc, length)),
           "library_ms": graph_ms(lambda: F.scaled_dot_product_attention(
               q4, kt, vt, attn_mask=mask, enable_gqa=True))}
    res["eager_ms"] = eager_ms(kernel)
    n_bytes = 2 * (2 * q.numel() + 2 * B * L * KV * dh) + 4
    n_ops = 4 * B * H * L * dh
    res["bound_ms"], res["bound_by"] = _bound_ms(n_bytes, n_ops, "bfloat16")
    res["shape"] = {"B": B, "S": S, "length": L, "H": H, "KV": KV, "dh": dh,
                    "dtype": "bfloat16"}
    return res


# the port's CUDA kernels (the __global__ functions of csrc/*.cu), by name
PORT_KERNELS = ("bgmv_cluster_kernel", "paged_decode_kernel", "tc_kernel", "fp32_tile_kernel",
                "flash_bf16_kernel", "flash_f32_kernel", "decode_split_kernel",
                "decode_combine_kernel")


def _device_busy(prof, wall_us: float, api_calls: bool = False):
    """Union of the device-kernel intervals of a torch.profiler run: busy
    time, idle share of ``wall_us``, kernel count, the top kernels by device
    time, the device time and share of busy of each of the port's own
    kernels (:data:`PORT_KERNELS`), and the top host
    operations by self time (ms, calls): where a host-bound run spends its
    host.  With ``api_calls``, also the count of every CUDA API call
    (``cuda*`` and ``cu*``: launches, copies, syncs): the device work the
    run asked for, exactly (the device records themselves can drop a few)."""
    from torch.autograd import DeviceType

    spans, by_name, host = [], {}, {}
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            t, n = host.get(e.name, (0.0, 0))
            host[e.name] = (t + e.self_cpu_time_total, n + 1)
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
    port = {}
    for n, t in by_name.items():
        short = n.removeprefix("void ").removeprefix("(anonymous namespace)::").split("(")[0]
        if short.split("<")[0] in PORT_KERNELS:
            port[short] = (t / 1e3, t / busy)
    top_host = sorted(host.items(), key=lambda kv: -kv[1][0])[:8]
    out = {"wall_ms": wall_us / 1e3, "device_busy_ms": busy / 1e3,
           "device_idle_share": 1 - busy / wall_us, "kernels": len(spans),
           "top_kernels_ms": [(n, t / 1e3) for n, t in top],
           "port_kernels_ms": port,
           "top_host_ops_ms": [(n, t / 1e3, c) for n, (t, c) in top_host]}
    if api_calls:
        out["cuda_api_calls"] = {n: c for n, (_, c) in sorted(host.items())
                                 if n.startswith("cu")}
    return out


# ---------------------------------------------------------------------------
# the serving path at full width
# ---------------------------------------------------------------------------


def serve(dtype: str, seed: int, n_tenants: int = 6, gen_len: int = 16,
          base_dtype: str = "bf16", params=None, **shard):
    """Serve one request per tenant through the default engine (with
    ``base_dtype`` and the ``shard_lam``/``shard_ba`` flags in ``shard``, on
    ``params`` when given); returns the engine, the tenants' λ trees and
    timings.  The tenants and the traffic depend on ``seed`` only."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.serving import EngineConfig, MultiTenantEngine, random_lambda

    cfg = get_config("smollm-135m").replace(dtype=dtype)
    t0 = time.perf_counter()
    engine = MultiTenantEngine(
        cfg, EngineConfig(seed=seed, collect_logits=True, base_dtype=base_dtype, **shard),
        params=params)
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
    return engine, out, done


def _check_no_bench_kernels(launches: dict, where: str) -> None:
    """The flash and dense decode attention kernels are the kernel bench's
    alone: no serve, forward or train path may launch either."""
    _check(launches["flash_attention"] == launches["decode_attention"] == 0,
           f"{where}: an attention kernel of the kernel bench launched: {launches}")


def check_quant_serve(base: str, out: dict) -> None:
    launches = out["launches"]
    _check_no_bench_kernels(launches, f"serve {base}")
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
        _check_no_bench_kernels(r["launches"], f"serve {base}: a single-tenant forward")
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
    _check_no_bench_kernels(out["launches"], "fp32 int8 serve")
    _check_no_bench_kernels(out["twin_launches"], "fp32 int8 twin")
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
        _check_no_bench_kernels(r["launches"], "fp32 int8: a single-tenant forward")
        _check(r["launches"]["qrlora_matmul_quant"] == r["adapted_projections"]
               and r["launches"]["qrlora_matmul"] == 0,
               f"fp32 int8: a single-tenant forward launched {r['launches']}")
        _check(r["ok"], f"fp32 int8: the single-tenant forward disagrees with the served "
                        f"logits: {r}")


# ---------------------------------------------------------------------------
# the sharded serve (shard_lam, shard_ba) in a world of one
# ---------------------------------------------------------------------------


def sharded_serve_phase(dtype: str, seed: int, params, done_ref, base_dtype: str = "bf16",
                        shard_ba: bool = False, profile: bool = False):
    """The serve with ``shard_lam`` (and ``shard_ba``) on the default process
    group — a world of one on the card, so the all-reduce and all-gather are
    exact copies and the rows kernel does all the work — on a replicated
    phase's ``params``, tenants and traffic, with launches and collectives
    counted around it; each stream held against the replicated serve's
    (``done_ref``)."""
    import numpy as np
    from repro_torch import kernels
    from repro_torch.kernels import qrlora_bgmv as bg

    kernels.reset_launch_counts()
    bg.reset_collective_counts()
    cfg, engine, lams, done, t_init, t_serve = serve(dtype, seed, base_dtype=base_dtype,
                                                     params=params, shard_lam=True,
                                                     shard_ba=shard_ba)
    out = {"dtype": dtype, "base_dtype": base_dtype, "shard_ba": shard_ba, "serve_s": t_serve,
           "tokens": engine.decoded_tokens, "steps": engine.steps,
           "tok_per_s": engine.decoded_tokens / t_serve, "launches": kernels.launch_counts(),
           "collectives": dict(bg.COLLECTIVES),
           "forwards": engine.steps + len(done) + engine.preemptions,
           "adapted_projections": 2 * cfg.n_layers,
           "table_bytes_per_rank": engine.lam_store.table_bytes(per_rank=True),
           "table_bytes": engine.lam_store.table_bytes(),
           "factor_rank_local": int(engine.params["groups"]["adapters"]["attn"]["wq"]["B"]
                                    .shape[-1])}
    ref = {r.tenant: r for r in done_ref.values()}
    out["streams"] = []
    for r in done.values():
        got, want = np.stack(r.logits), np.stack(ref[r.tenant].logits)
        out["streams"].append({"tenant": r.tenant, "tokens_match": r.tokens == ref[r.tenant].tokens,
                               "logits_bitwise": bool(np.array_equal(got, want)),
                               "max_abs_dlogits": float(np.abs(got - want).max())})
    if profile:
        out["profile"] = profile_serve(engine, seed + 1)
    return out


def check_sharded(label: str, out: dict, bitwise: bool) -> None:
    """Launches: the rows kernel once per adapted projection of every
    forward, no BGMV kernel; collectives: one all-reduce per projection, and
    two all-gathers under shard_ba; every stream token-identical to the
    replicated serve (and, with ``bitwise``, logits bit for bit)."""
    launches, coll = out["launches"], out["collectives"]
    per_fwd = out["adapted_projections"]
    want_rows = per_fwd * out["forwards"]
    _check_no_bench_kernels(launches, label)
    _check(launches["qrlora_bgmv_rows"] == want_rows and launches["qrlora_bgmv"] == 0
           and launches["qrlora_bgmv_quant"] == 0 and launches["paged_decode_attention"] > 0,
           f"{label}: launches {launches}, want {want_rows} qrlora_bgmv_rows "
           f"({per_fwd} × {out['forwards']} forwards) and no BGMV kernel")
    want_coll = {"all_reduce": want_rows, "all_gather": 2 * want_rows * out["shard_ba"]}
    _check(coll == want_coll, f"{label}: collectives {coll}, want {want_coll}")
    _check(all(r["tokens_match"] for r in out["streams"]),
           f"{label}: a stream differs from the replicated serve: {out['streams']}")
    if bitwise:
        _check(all(r["logits_bitwise"] for r in out["streams"]),
               f"{label}: logits not bitwise the replicated serve's: {out['streams']}")


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


def wq_lam_dropped(cfg, layer: int):
    """Planted fault: the kernel's forward with λ of ``layer``'s wq left out
    (the layer's λ is the view at that storage offset of the stacked leaf;
    wq is the projection of width n_heads · d_head, the only adapted one of
    that width where this is planted)."""
    import torch
    from repro_torch.kernels.qrlora_matmul import qrlora_matmul

    n_q = cfg.n_heads * cfg.d_head

    def fwd(x, W, B, A, lam, scale=1.0):
        if lam.storage_offset() == layer * lam.shape[0] and W.shape[1] == n_q:
            lam = torch.zeros_like(lam)
        return qrlora_matmul(x, W, B, A, lam, scale)

    return fwd


def last_wq_lam_dropped(cfg):
    """:func:`wq_lam_dropped` at the last layer."""
    return wq_lam_dropped(cfg, cfg.n_layers - 1)


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


def check_qr_graph(gen, d: int = 768):
    """``qr_pivoted`` of a d × d weight captured whole in one CUDA graph (the
    capture raises on any host sync), replayed: bitwise the eager result,
    ``perm`` identical to the CPU's.  Times one eager call, one replay and
    ``torch.linalg.svd`` of the same weight (CUDA events)."""
    import torch
    from repro_torch.core.pivoted_qr import qr_pivoted

    # a decaying spectrum, as a warmed-up weight has
    W = torch.randn((d, d), generator=gen, device="cuda") * torch.linspace(
        1.0, 0.05, d, device="cuda")[None, :]
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    eager = qr_pivoted(W)
    end.record()
    torch.cuda.synchronize()
    eager_ms = start.elapsed_time(end)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm-up off the default stream, as capture needs
        qr_pivoted(W)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = qr_pivoted(W)
    for t in out:
        t.fill_(-1)
    times = []
    for _ in range(3):
        start.record()
        graph.replay()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    svd_ms = []
    for _ in range(3):
        start.record()
        torch.linalg.svd(W, full_matrices=False)
        end.record()
        torch.cuda.synchronize()
        svd_ms.append(start.elapsed_time(end))
    cpu = qr_pivoted(W.cpu())
    return {"d": d, "bitwise": all(torch.equal(a, b) for a, b in zip(out, eager)),
            "perm_equals_cpu": torch.equal(out.perm.cpu(), cpu.perm),
            "q_vs_cpu": _max_err(out.Q.cpu(), cpu.Q), "eager_ms": eager_ms,
            "replay_ms": min(times), "svd_ms": min(svd_ms)}


# the GLUE phase: full-width RoBERTa-base (12 layers, d 768, vocab 50265,
# random weights from --seed) on mrpc through run_glue_method at the paper
# scale's batch 16 × seq 128, a few warm-up FT steps, a few adapter steps and
# two eval batches, in each mode.  Each adapted projection (wq of the last 4
# layers; the stacked λ/B/A of all 12 go through the kernel) runs the one-λ
# kernel's float32 route in every adapter mode.
GLUE_TASK, GLUE_BATCH, GLUE_SEQ = "mrpc", 16, 128
GLUE_WARMUP, GLUE_STEPS, GLUE_EVAL = 3, 5, 2
# The reference's warm-up lr (1e-3), for 3 steps from random weights, throws
# the encoder into a saturated state (its loss rises; the phase reports that
# run) where the adapters' gradients sit at Adam's ε; 1e-4 keeps it out.
GLUE_WARMUP_LR = 1e-4
# A GLUE run against its plain twin: losses as the float32 train
# (TRAIN_TOL["float32"]["dloss"]), and the largest |Δ| of the eval outputs
# (2 batches × 16 logits, max |logit| ≈ 0.7).  Set from full-width readings
# on an H100 at --seed 0 (mrpc, the task hash pinned): sound twins |Δloss|
# ≤ 6.0e-7, |Δout| ≤ 1.3e-6; LoRA with λ of its first adapted layer (8)
# dropped from the kernel's forward reads |Δloss| 8.3e-6 and |Δout| 1.6e-4,
# so the output bound carries the fault.  The λ of QR-LoRA moves ≈ 2.5e-3
# in these 5 steps: dropping one layer's (|Δout| 1.4e-6) is below what the
# run can resolve (reported), and QR-LoRA faults are the kernel checks'.
GLUE_OUT_TOL = 1e-5
GLUE_FAULT_LAYER = 8  # the first of the last 4 layers
GLUE_MODES = ("qr_lora", "lora", "svd_lora", "ft")


def glue_run(mode: str, seed: int, fwd=None, warmup_lr: float = GLUE_WARMUP_LR):
    """One full-width ``run_glue_method`` in ``mode``, the one-λ kernel's
    forward replaced by ``fwd`` if given (its backward stays the
    hand-written one); launches counted from 0 around it, peak memory."""
    import torch
    from repro_torch import kernels
    from repro_torch.benchlib import run_glue_method
    from repro_torch.kernels import qrlora_matmul as mm

    kernels.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    with swapped(mm, "qrlora_matmul", fwd) if fwd else contextlib.nullcontext():
        r = run_glue_method(GLUE_TASK, mode, seed=seed, reduced=False, train_steps=GLUE_STEPS,
                            warmup_steps=GLUE_WARMUP, eval_batches=GLUE_EVAL, batch=GLUE_BATCH,
                            seq=GLUE_SEQ, warmup_lr=warmup_lr, device="cuda")
    torch.cuda.synchronize()
    r["launches"] = kernels.launch_counts()
    r["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 2**30
    return r


def _glue_fp32_trained(params):
    """The float32 trained leaves a GLUE run compares, in two groups: λ of
    every adapted projection (empty in ft), and the task head."""
    lams = [leaf["lam"] for projs in params["groups"].get("adapters", {}).values()
            for leaf in projs.values()]
    return [g for g in (lams, [params[k] for k in ("cls_w", "cls_b", "pooler")]) if g]


def compare_glue(run, twin):
    """A GLUE run against its twin: the largest per-step |Δloss| over both
    phases and |Δ| of the eval outputs (bounded), and the largest |Δ| of a
    float32 trained leaf over the twin's largest entry in its group (λ, the
    head; reported: QR-LoRA's small λ gradients sit near Adam's ε, where
    the last bits of a gradient move its update, 1.3e-3 of max|λ| read)."""
    rel, dlam = 0.0, 0.0
    for a, b in zip(_glue_fp32_trained(run["params"]), _glue_fp32_trained(twin["params"])):
        d = max(_max_err(x, y) for x, y in zip(a, b))
        rel = max(rel, d / max(max(float(t.abs().max()) for t in b), 1e-30))
        dlam = max(dlam, d)
    losses = run["warmup_losses"] + run["losses"]
    twin_losses = twin["warmup_losses"] + twin["losses"]
    return {"max_dloss": max(abs(x - y) for x, y in zip(losses, twin_losses)),
            "max_dout": float(abs(run["outputs"] - twin["outputs"]).max()),
            "max_dlam": dlam, "dlam_rel": rel,
            "finite": all(math.isfinite(x) for x in losses + twin_losses),
            "metric_equal": run["metric"] == twin["metric"],
            "trainable_equal": run["trainable"] == twin["trainable"]}


def within_glue_tol(c) -> bool:
    return (c["finite"] and c["max_dloss"] <= TRAIN_TOL["float32"]["dloss"]
            and c["max_dout"] <= GLUE_OUT_TOL and c["metric_equal"] and c["trainable_equal"])


def _task_hash(name: str) -> int:
    """The GLUE data's task seed: the reference seeds each task with
    ``hash(name)``, which changes with every process's PYTHONHASHSEED; the
    phase pins it to the name's CRC-32 so that its runs are repeatable."""
    import zlib

    return zlib.crc32(name.encode())


def profile_glue_steps(result, seed: int, steps: int = 3):
    """Further adapter steps of a qr_lora GLUE run's trained params under
    torch.profiler, with the runner's own step: wall time, device busy time
    and idle share."""
    import torch
    from repro_torch.benchlib import glue_runner
    from repro_torch.configs import get_config
    from repro_torch.data import make_task
    from repro_torch.models import build_model
    from repro_torch.optim import AdamWConfig

    cfg = get_config("roberta_base")
    cfg = cfg.replace(adapter=cfg.adapter.replace(mode="qr_lora", targets=("wq",)))
    model = build_model(cfg, "cuda")
    params = result["params"]
    step = glue_runner._make_step(model, AdamWConfig(lr=2e-3))
    batches = make_task(GLUE_TASK, vocab=cfg.vocab_size, seq=GLUE_SEQ, seed=seed + 1).batches(
        "train", GLUE_BATCH)
    mask = model.trainable_mask(params)
    glue_runner._train(step, params, mask, batches, 1, model.device)  # warm
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        glue_runner._train(step, params, mask, batches, steps, model.device)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    return {**_device_busy(prof, wall_us), "steps": steps}


def glue_phase(seed: int):
    """The GLUE path in every mode, each against its plain-version twin; the
    planted fault (λ of layer GLUE_FAULT_LAYER's wq left out of the kernel's
    forward) in lora and qr_lora against their twins; the qr_lora run's
    further steps profiled.  The task hash is pinned (:func:`_task_hash`)."""
    from repro_torch.configs import get_config
    from repro_torch.data import synthetic

    synthetic.hash = _task_hash
    try:
        return _glue_phase(seed, get_config("roberta_base"))
    finally:
        del synthetic.hash


def _glue_phase(seed: int, cfg):
    out = {}
    for mode in GLUE_MODES:
        run, twin = glue_run(mode, seed), glue_run(mode, seed, plain_forward)
        out[mode] = {k: run[k] for k in ("metric", "metric_name", "accuracy", "trainable",
                                          "adapter_init_s", "losses", "warmup_losses",
                                          "launches", "peak_mem_gb")}
        out[mode]["median_step_ms"] = statistics.median(run["step_ms"][1:])
        out[mode]["median_warmup_step_ms"] = statistics.median(run["warmup_step_ms"][1:])
        out[mode]["twin_launches"] = twin["launches"]
        out[mode]["twin"] = compare_glue(run, twin)
        if mode in ("lora", "qr_lora"):
            fault = glue_run(mode, seed, wq_lam_dropped(cfg, GLUE_FAULT_LAYER))
            out[mode]["fault_wq_lam_dropped"] = compare_glue(fault, twin)
        if mode == "qr_lora":
            out[mode]["max_lam"] = max(float(leaf["lam"].abs().max()) for leaf in
                                       run["params"]["groups"]["adapters"]["attn"].values())
            out[mode]["profile"] = profile_glue_steps(run, seed)
            # reported: the same run at the reference's warm-up lr
            ref = glue_run(mode, seed, warmup_lr=1e-3)
            out[mode]["at_reference_warmup_lr"] = {
                "warmup_losses": ref["warmup_losses"], "losses": ref["losses"],
                "max_lam": max(float(leaf["lam"].abs().max()) for leaf in
                               ref["params"]["groups"]["adapters"]["attn"].values())}
    return out


def check_glue(glue: dict, want_launches: dict):
    """Print and check the GLUE phase's readings: launches per mode (the
    one-λ kernel only, on every adapted projection of every forward; none in
    ft and in the twins), each mode within the float32 train tolerance of
    its twin with the same metric and trainable count, the planted fault
    rejected.  Returns (readings, the one-λ kernel's launches over all
    modes)."""
    from repro_torch.configs import get_config

    per_forward = get_config("roberta_base").n_layers  # the stacked wq of every layer
    for mode, g in glue.items():
        print(f"glue {GLUE_TASK} {mode}: trainable {g['trainable']}, adapter init "
              f"{g['adapter_init_s']:.3f} s, median adapter step {g['median_step_ms']:.1f} ms "
              f"(warm-up FT step {g['median_warmup_step_ms']:.1f} ms) at batch {GLUE_BATCH} × "
              f"seq {GLUE_SEQ}, {g['metric_name']} {g['metric']:.4f}, peak memory "
              f"{g['peak_mem_gb']:.2f} GiB; launches {g['launches']}")
        print(f"  losses: warm-up {' '.join(f'{x:.5f}' for x in g['warmup_losses'])}; adapter "
              f"{' '.join(f'{x:.5f}' for x in g['losses'])}")
        print(f"  vs plain twin: {g['twin']} (bounds |Δloss| {TRAIN_TOL['float32']['dloss']}, "
              f"|Δout| {GLUE_OUT_TOL})")
        want = per_forward * (GLUE_STEPS + GLUE_EVAL) if mode != "ft" else 0
        _check(g["launches"] == {**want_launches, "qrlora_matmul": want},
               f"glue {mode}: launches {g['launches']}, want {want} qrlora_matmul and no other")
        _check(g["twin_launches"] == want_launches,
               f"glue {mode}: the plain twin launched {g['twin_launches']}")
        _check(within_glue_tol(g["twin"]),
               f"glue {mode} disagrees with its plain-version twin: {g['twin']}")
    for mode in ("lora", "qr_lora"):
        print(f"  glue {mode} planted fault: λ of layer {GLUE_FAULT_LAYER}'s wq dropped, vs twin: "
              f"{glue[mode]['fault_wq_lam_dropped']}")
    _check(not within_glue_tol(glue["lora"]["fault_wq_lam_dropped"]),
           "the GLUE check let the planted fault (LoRA, one layer's λ dropped) through")
    print(f"  qr_lora max|λ| after {GLUE_STEPS} steps {glue['qr_lora']['max_lam']:.3e}; at the "
          f"reference's warm-up lr 1e-3: {glue['qr_lora']['at_reference_warmup_lr']}")
    print(f"  profiled {glue['qr_lora']['profile']['steps']} further qr_lora adapter steps: "
          f"{glue['qr_lora']['profile']}")
    print(f"adapter init on the warmed-up weights (4 × wq, 768 × 768): QR-LoRA "
          f"{glue['qr_lora']['adapter_init_s']:.3f} s against SVD-LoRA "
          f"{glue['svd_lora']['adapter_init_s']:.3f} s, LoRA {glue['lora']['adapter_init_s']:.3f} s")
    glue_launches = sum(g["launches"]["qrlora_matmul"] for g in glue.values())
    return glue, glue_launches


# ---------------------------------------------------------------------------
# the serving posture at full width: qwen2-0.5b under EngineConfig.serving()
# ---------------------------------------------------------------------------

QWEN = "qwen2-0.5b"
# the posture's engine: block 16, watermark 1, chunks of 32 tokens a step
QWEN_ENGINE = {"n_lanes": 4, "n_slots": 8, "max_len": 384, "collect_logits": True}
QWEN_GEN = 16
QWEN_PREFIX = 48  # a system prompt of 3 full blocks
QWEN_TAILS = (8, 12, 16, 10, 14, 24)  # six requests on the prefix, tenants 0 and 1 in turn
QWEN_LONG = (160, 220)  # tenants 2 and 3: prompts that stream in chunks
# Chunked against monolithic prefill on the card: the same arithmetic on
# other GEMM shapes (a 32-row chunk where the monolithic pass has the 64- or
# 256-row bucket), where cuBLAS picks another kernel and sums in another
# order, so the two are not bitwise (3 and 5 of 8 streams were, float32 and
# bf16, on an H100 at --seed 0).  float32: identical tokens and |Δlogits|
# within 2e-5, about 5 times the sound reading (4.05e-6 on an H100 at --seed
# 0) and far below the planted faults (0.42, 3.3 and more).
# bfloat16: BF16_DRIFT, the bar a bf16 serve is held to against a path that
# rounds at other places, as a fraction of each row's largest |logit| up to
# a parting, which may only fall where the monolithic stream's own lead is
# within it (read 0.525 of it and one parting at a near-tie; the planted
# fault 24).  Prefix sharing itself is held bitwise: between serves whose
# requests take the same prefill path (a cached prefix sends a short prompt
# down the chunked path, so under the posture a hit may not).
QWEN_CHUNK_FP32_TOL = 2e-5
QWEN_CHUNK_BF16_DRIFT = BF16_DRIFT
# #1 at qwen2-0.5b's wq (N 896) and wv (N 128), K 896, rank cap 160: 4 decode
# lanes, a 32-row prefill chunk, the 64-row bucket of a short prompt that
# misses the prefix cache, and the 128- and 256-row buckets of the
# monolithic serves
QWEN_BGMV_SHAPES = [(M, 896, N, 160) for M in (4, 32, 64, 128, 256) for N in (896, 128)]
# #2 at 14 heads over 2 (7 query heads a group), dh 64: (lengths, columns of
# a 24-column table); length-0 lanes, the serve's attend bounds of 8 columns
# (short lanes only; a cluster of 2) and 16 (a long lane decoding; 4), a
# 4-column bound (one CTA a group pair, no cluster) and the whole table
QWEN_PAGED_CASES = (((0, 1, 17, 240), 16), ((240, 100, 0, 33), 24), ((0, 0, 16, 15), 16),
                    ((0, 57, 80, 128), 8), ((72, 0, 96, 65), 8), ((64, 0, 3, 49), 4))


def check_qwen_kernels(gen, details):
    """#1 and #2 against their plain versions at qwen2-0.5b's shapes:
    :data:`QWEN_BGMV_SHAPES` in bf16 and float32 x (8 slots, a quarter of
    the rows padding in slot 0), :data:`QWEN_PAGED_CASES` in bf16 and
    float32 (trash block poisoned, stale entries past the lengths), a
    length-0 lane zeros; a second call bitwise the first.  Returns the
    worst |Δ| of each kernel and dtype (paged: and |Δ|/bound)."""
    import torch
    from repro_torch.benchmarks.kernel_bench import TOL as BENCH_TOL
    from repro_torch.kernels.paged_attention import paged_decode_attention_cuda
    from repro_torch.kernels.qrlora_bgmv import qrlora_bgmv_cuda
    from repro_torch.kernels.ref import paged_decode_attention_ref, qrlora_bgmv_ref

    worst = {}
    for dt in (torch.bfloat16, torch.float32):
        name = str(dt).split(".")[1]
        for M, K, N, r in QWEN_BGMV_SHAPES:
            x, W, B, A, lam, seg = _bgmv_inputs(gen, M, K, N, r, 8, dt)
            y = qrlora_bgmv_cuda(x, W, B, A, lam, seg, 0.7)
            again = qrlora_bgmv_cuda(x, W, B, A, lam, seg, 0.7)
            torch.cuda.synchronize()
            ref = qrlora_bgmv_ref(x, W, B, A, lam, seg, 0.7)
            err = _max_err(y, ref)
            ok = (_within(y, ref, _tol("qrlora_bgmv", dt)) and bool(torch.isfinite(y).all())
                  and torch.equal(y, again))
            details.append({"kernel": "qrlora_bgmv", "arch": QWEN, "x": name, "M": M, "K": K,
                            "N": N, "r": r, "max_abs_err": err, "ok": ok})
            _check(ok, f"qrlora_bgmv at {QWEN} x={name} M={M} K={K} N={N} r={r}: max|Δ|="
                       f"{err:.3e} over {_tol('qrlora_bgmv', dt)}, or a second call differs")
            worst[f"qrlora_bgmv_{name}"] = max(worst.get(f"qrlora_bgmv_{name}", 0.0), err)
        tol = BENCH_TOL["paged_decode_attention"][dt]
        for lengths, cols in QWEN_PAGED_CASES:
            q, kp, vp, tbl, lens = _paged_inputs(gen, lengths, dt, 14, 2, 64, 16, 24)
            args = (q, kp, vp, tbl[:, :cols], torch.clamp(lens, max=cols * 16))
            o = paged_decode_attention_cuda(*args)
            again = paged_decode_attention_cuda(*args)
            torch.cuda.synchronize()
            err, over = _max_err(o, paged_decode_attention_ref(*args)), _paged_over(o, args, tol)
            zero = all(bool((o[b] == 0).all()) for b, n in enumerate(lengths) if n == 0)
            ok = over <= 1.0 and bool(torch.isfinite(o).all()) and zero and torch.equal(o, again)
            details.append({"kernel": "paged_decode_attention", "arch": QWEN, "dtype": name,
                            "H": 14, "KV": 2, "lengths": list(lengths), "columns": cols,
                            "max_abs_err": err, "err_over_bound": over, "ok": ok})
            _check(ok, f"paged_decode_attention at {QWEN} {name} lengths {lengths} over {cols} "
                       f"columns: {over:.3f} of the bound, a length-0 lane not zeros, or a "
                       f"second call differs")
            w = worst.setdefault(f"paged_decode_attention_{name}",
                                 {"max_abs_err": 0.0, "err_over_bound": 0.0})
            w["max_abs_err"] = max(w["max_abs_err"], err)
            w["err_over_bound"] = max(w["err_over_bound"], over)
    return worst


def qwen_traffic(seed: int, vocab: int):
    """(tenant, prompt) pairs: six requests of tenants 0 and 1 on one
    48-token system prefix with 8-24-token tails, and the 160- and
    220-token prompts of tenants 2 and 3 among them."""
    import numpy as np

    rng = np.random.default_rng(seed)
    prefix = rng.integers(2, vocab, size=QWEN_PREFIX).astype(np.int32)
    pfx = [(f"tenant{i % 2}", np.concatenate([prefix, rng.integers(2, vocab, size=n).astype(
        np.int32)])) for i, n in enumerate(QWEN_TAILS)]
    long = [(f"tenant{2 + i}", rng.integers(2, vocab, size=n).astype(np.int32))
            for i, n in enumerate(QWEN_LONG)]
    return [pfx[0], pfx[1], long[0], pfx[2], pfx[3], long[1], pfx[4], pfx[5]]


def qwen_engine(dtype: str, seed: int, params=None, **overrides):
    """qwen2-0.5b at full width under ``EngineConfig.serving(**QWEN_ENGINE,
    **overrides)``, 4 tenants registered (λ from ``seed``).  Without
    ``params``: random weights from ``seed`` (QR-LoRA built on the card),
    the QKV biases drawn too (the config's init leaves them zero).  Returns
    (cfg, engine, λ trees)."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.serving import EngineConfig, MultiTenantEngine, random_lambda

    cfg = get_config(QWEN).replace(dtype=dtype)
    engine = MultiTenantEngine(
        cfg, EngineConfig.serving(seed=seed, **{**QWEN_ENGINE, **overrides}), params=params)
    gen = torch.Generator(device="cuda")
    if params is None:
        gen.manual_seed(seed + 3000)
        for name in ("bq", "bk", "bv"):
            leaf = engine.params["groups"]["attn"][name]
            leaf.copy_(torch.randn(leaf.shape, generator=gen, device=leaf.device) * 0.5)
    lams = {}
    for i in range(4):
        lams[f"tenant{i}"] = random_lambda(gen.manual_seed(seed + 2000 + i), engine.params, 0.3)
        engine.add_tenant(f"tenant{i}", lams[f"tenant{i}"])
    return cfg, engine, lams


def qwen_serve(engine, traffic, fork_tail: bool = False) -> dict:
    """Serve ``traffic`` (16 tokens a request) to the end.  With ``fork_tail``, once the first
    request decodes, take a reference on its private tail block as another
    owner would, so that its next write must fork a copy; after the run
    ``tail_kept`` says whether that block still holds what it held then.
    Returns the readings (``done``: uid → request)."""
    import torch

    pc, al = engine.prefix_cache, engine.allocator
    hits0, misses0 = (pc.hits, pc.misses) if pc is not None else (0, 0)
    counters = ("cow_forks", "preemptions", "chunked_admissions", "chunk_dispatches", "steps",
                "decoded_tokens")
    before0 = {name: getattr(engine, name) for name in counters}
    done, tail, kept = {}, None, None
    reqs = [engine.submit(t, p, QWEN_GEN) for t, p in traffic]
    t0 = time.perf_counter()
    while engine.scheduler.has_work:
        for r in engine.step():
            done[r.uid] = r
        if fork_tail and tail is None and reqs[0].tokens:
            tail = engine._lane_blocks[reqs[0].lane][-1]
            al.incref(tail)
            a = engine.cache["layers"]["attn"]
            before = (a["k"][:, tail].clone(), a["v"][:, tail].clone())
    torch.cuda.synchronize()
    serve_s = time.perf_counter() - t0
    if tail is not None:
        a = engine.cache["layers"]["attn"]
        kept = torch.equal(before[0], a["k"][:, tail]) and torch.equal(before[1], a["v"][:, tail])
        al.decref(tail)
    counts = {name: getattr(engine, name) - before0[name] for name in counters}
    tokens = counts.pop("decoded_tokens")
    return {"done": done, "serve_s": serve_s, "tokens": tokens, "tok_per_s": tokens / serve_s,
            "prefix_hits": (pc.hits - hits0) if pc is not None else 0,
            "prefix_misses": (pc.misses - misses0) if pc is not None else 0,
            "pool_peak": al.peak_in_use, "pool_capacity": al.capacity,
            "kv_cache_bytes": engine.kv_cache_bytes(), "tail_kept": kept,
            "all_served": len(done) == len(traffic) and all(
                len(r.tokens) == QWEN_GEN for r in done.values()), **counts}


def _by_request(done):
    return {(r.tenant, r.prompt.tobytes()): r for r in done.values()}


def compare_streams(run, ref_run, drift=None):
    """Each request of qwen_serve's ``run`` against the same request (tenant
    and prompt) of ``ref_run``: whether both prefilled it by the same path
    (chunked or not), logits bitwise equal or not, where the token streams
    first part (None: never) and the largest |Δlogits| up to and including
    that position (the same context until there).  With ``drift``: that
    largest over the bound ``drift``·max|logit| of each row, and at a
    parting the reference stream's lead of its own token over ``run``'s,
    over the bound."""
    import numpy as np

    ref = _by_request(ref_run["done"])
    rows = []
    for uid in sorted(run["done"]):
        req = run["done"][uid]
        key = (req.tenant, req.prompt.tobytes())
        other = ref[key]
        a, b = np.stack(req.logits), np.stack(other.logits)
        t = next((i for i, (x, y) in enumerate(zip(req.tokens, other.tokens)) if x != y), None)
        upto = len(req.tokens) if t is None else t + 1
        d = np.abs(a[:upto] - b[:upto]).max(axis=1)
        row = {"tenant": req.tenant, "prompt_len": int(req.prompt.size),
               "same_path": (req.prefill_chunks > 0) == (other.prefill_chunks > 0),
               "bitwise": bool(a.shape == b.shape and np.array_equal(a, b)), "parted_at": t,
               "max_abs_dlogits": float(d.max())}
        if drift is not None:
            bound = drift * np.abs(b[:upto]).max(axis=1)
            row["max_dlogits_over_bound"] = float((d / bound).max())
            if t is not None:
                row["parting_margin_over_bound"] = float(
                    (b[t].max() - b[t][req.tokens[t]]) / bound[-1])
        rows.append(row)
    return rows


def chunk_rows_ok(rows, dtype: str) -> bool:
    """The chunked-against-monolithic bar of ``dtype`` over compare_streams
    rows (bf16 rows carry the drift readings)."""
    if dtype == "float32":
        return all(r["parted_at"] is None and r["max_abs_dlogits"] <= QWEN_CHUNK_FP32_TOL
                   for r in rows)
    return all(r["max_dlogits_over_bound"] <= 1.0 and (
        r["parted_at"] is None or r["parting_margin_over_bound"] <= 1.0) for r in rows)


def sharing_rows_ok(rows, dtype: str) -> bool:
    """Shared against unshared: bitwise where both serves prefilled a
    request by the same path, else the chunked-prefill bar."""
    return all(r["bitwise"] for r in rows if r["same_path"]) and chunk_rows_ok(
        [r for r in rows if not r["same_path"]], dtype)


def qwen_faults(dtype: str, seed: int, params, traffic, runs) -> dict:
    """Planted faults, each served on a fresh engine with the same weights
    under the posture and held to the check it targets: the family key
    without the λ digest (tenants 0 and 1 of different λ share the prefix
    blocks; against the unshared serve, bitwise), chunks that attend only to
    themselves (the view's ``read_ids`` dropped; the long prompts against
    the monolithic serve, at the dtype's chunk bar) and, in float32, no CoW
    fork (the forced extra owner of a tail block; its content must stay)."""
    from repro_torch.serving import engine as engine_mod

    drift = QWEN_CHUNK_BF16_DRIFT if dtype == "bfloat16" else None
    out = {}
    if dtype == "float32":
        _, eng, _ = qwen_engine(dtype, seed, params=params)
        eng._family_key = lambda tenant, n: engine_mod._bucket_len(
            n, eng.max_len, eng._prefill_floor).to_bytes(4, "little")
        run = qwen_serve(eng, traffic[:2])
        rows = compare_streams(run, runs["unshared"])
        out["family_key_without_digest"] = {
            "prefix_hits": run["prefix_hits"], "rows": rows,
            "rejected": not sharing_rows_ok(rows, dtype)}
        _, eng, _ = qwen_engine(dtype, seed, params=params)
        eng.allocator.is_shared = lambda b: False
        run = qwen_serve(eng, traffic[:1], fork_tail=True)
        out["no_cow_fork"] = {"cow_forks": run["cow_forks"], "tail_kept": run["tail_kept"],
                              "rejected": not (run["cow_forks"] == 1 and run["tail_kept"])}
    _, eng, _ = qwen_engine(dtype, seed, params=params)
    view = eng.model.paged_prefill_view
    eng.model.paged_prefill_view = lambda cache, write_ids, read_ids=None: view(cache, write_ids)
    run = qwen_serve(eng, [t for t in traffic if t[1].size > 2 * eng.prefill_chunk])
    rows = compare_streams(run, runs["monolithic"], drift)
    out["chunk_attends_only_itself"] = {"chunk_dispatches": run["chunk_dispatches"], "rows": rows,
                                        "rejected": not chunk_rows_ok(rows, dtype)}
    return out


def profile_qwen(engine, traffic) -> dict:
    """The posture's traffic served again on the same engine (weights warm,
    the prefix cache holding the first serve's blocks) under torch.profiler:
    wall time, device busy and idle share, kernels by device time."""
    import torch

    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        run = qwen_serve(engine, traffic)
        wall_us = (time.perf_counter() - t0) * 1e6
    del run["done"]
    return {**_device_busy(prof, wall_us), "serve": run}


def serving_posture_phase(seed: int, keep: dict = None) -> dict:
    """qwen2-0.5b at full width (24 layers, d 896, 14 heads over 2, QKV
    bias, vocab 151936) under ``EngineConfig.serving()``, in float32 and
    bfloat16: the posture's serve (launches counted, one CoW fork forced),
    the same traffic unshared, monolithic, and both; float32 against the
    merged-weight reference; the planted faults; bf16 profiled.  Returns
    every reading (without the request objects); check_serving_posture
    holds them to the bars.  With ``keep``, each dtype's weights go into it
    (``keep[dtype]``) for the request-API phase."""
    import torch
    from repro_torch import kernels

    out = {}
    for dtype in ("float32", "bfloat16"):
        t0 = time.perf_counter()
        cfg, engine, lams = qwen_engine(dtype, seed)
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        traffic = qwen_traffic(seed, cfg.vocab_size)
        kernels.reset_launch_counts()
        runs = {"serving": qwen_serve(engine, traffic, fork_tail=True)}
        runs["serving"]["launches"] = kernels.launch_counts()
        runs["serving"]["init_s"] = init_s
        params = engine.params
        for name, kw in (("unshared", {"share_prefix": False}),
                         ("monolithic", {"prefill_chunk": None}),
                         ("monolithic_unshared", {"share_prefix": False, "prefill_chunk": None})):
            _, eng, _ = qwen_engine(dtype, seed, params=params, **kw)
            runs[name] = qwen_serve(eng, traffic)
            del eng
        drift = QWEN_CHUNK_BF16_DRIFT if dtype == "bfloat16" else None
        res = {
            "shared_vs_unshared": compare_streams(runs["serving"], runs["unshared"], drift),
            "shared_vs_unshared_monolithic": compare_streams(
                runs["monolithic"], runs["monolithic_unshared"], drift),
            "chunked_vs_monolithic": compare_streams(runs["serving"], runs["monolithic"],
                                                     drift),
            "chunked_vs_monolithic_unshared": compare_streams(
                runs["unshared"], runs["monolithic_unshared"], drift),
        }
        if dtype == "float32":
            res["verify"] = verify(cfg, engine, lams, runs["serving"]["done"], QWEN_GEN)
        res["faults"] = qwen_faults(dtype, seed, params, traffic, runs)
        if dtype == "bfloat16":
            res["profile"] = profile_qwen(engine, traffic)
        for run in runs.values():
            del run["done"]
        res["runs"] = runs
        out[dtype] = res
        if keep is not None:
            keep[dtype] = params
        del engine, params
        torch.cuda.empty_cache()
    return out


def print_serving_posture(out: dict, smi: str) -> None:
    for dtype, res in out.items():
        for name, run in res["runs"].items():
            print(f"{QWEN} {dtype} {name}: {run['tokens']} tokens in {run['serve_s']:.3f} s = "
                  f"{run['tok_per_s']:.1f} tok/s over {run['steps']} decode steps; prefix hits "
                  f"{run['prefix_hits']} (blocks saved), misses {run['prefix_misses']}, CoW forks "
                  f"{run['cow_forks']}, chunked admissions {run['chunked_admissions']}, chunk "
                  f"dispatches {run['chunk_dispatches']}, preemptions {run['preemptions']}, pool "
                  f"peak {run['pool_peak']}/{run['pool_capacity']}, KV cache {run['kv_cache_bytes']} B"
                  + (f"; init {run['init_s']:.1f} s; launches {run['launches']}; forced tail "
                     f"block kept {run['tail_kept']}" if "launches" in run else "") + f" on {smi}")
        for name in ("shared_vs_unshared", "shared_vs_unshared_monolithic",
                     "chunked_vs_monolithic", "chunked_vs_monolithic_unshared"):
            rows = res[name]
            print(f"  {dtype} {name}: bitwise {sum(r['bitwise'] for r in rows)}/{len(rows)} "
                  f"(same prefill path {sum(r['same_path'] for r in rows)}), "
                  f"parted {[r['parted_at'] for r in rows]}, max|Δlogits| "
                  f"{max(r['max_abs_dlogits'] for r in rows):.3e}"
                  + (f", over the bf16 bound {max(r['max_dlogits_over_bound'] for r in rows):.4f}"
                     if "max_dlogits_over_bound" in rows[0] else ""))
        if "verify" in res:
            for row in res["verify"]:
                print(f"  {dtype} vs the merged-weight reference: {row}")
        for name, f in res["faults"].items():
            print(f"  {dtype} planted fault {name}: rejected {f['rejected']}; {f}")
        if "profile" in res:
            print(f"  profiled {dtype} serve (warm prefix cache): {res['profile']}")


def check_serving_posture(out: dict) -> None:
    for dtype, res in out.items():
        main = res["runs"]["serving"]
        for name in ("qrlora_bgmv", "paged_decode_attention"):
            _check(main["launches"][name] > 0, f"{QWEN} {dtype}: {name} never launched")
        _check_no_bench_kernels(main["launches"], f"{QWEN} {dtype} serve")
        for name, run in res["runs"].items():
            _check(run["all_served"], f"{QWEN} {dtype} {name}: not every request got its tokens")
        _check(main["prefix_hits"] > 0 and main["chunked_admissions"] >= 2
               and main["cow_forks"] == 1 and main["tail_kept"],
               f"{QWEN} {dtype}: the posture's serve shows no prefix hit, fewer than 2 chunked "
               f"admissions, or not one CoW fork that left the shared block as it was: {main}")
        _check(all(r["same_path"] and r["bitwise"] for r in res["shared_vs_unshared_monolithic"]),
               f"{QWEN} {dtype}: prefix sharing changed logits of a monolithic serve: "
               f"{res['shared_vs_unshared_monolithic']}")
        _check(sharing_rows_ok(res["shared_vs_unshared"], dtype),
               f"{QWEN} {dtype}: prefix sharing under the posture changed logits where the "
               f"prefill path was the same, or is over the chunked bar where it was not: "
               f"{res['shared_vs_unshared']}")
        for name in ("chunked_vs_monolithic", "chunked_vs_monolithic_unshared"):
            _check(chunk_rows_ok(res[name], dtype),
                   f"{QWEN} {dtype} {name}: over the chunked-prefill bar: {res[name]}")
        if "verify" in res:
            _check(all(r["tokens_match"] and r["max_abs_dlogits"] < FP32_LOGIT_TOL
                       for r in res["verify"]),
                   f"{QWEN} {dtype} serve diverged from the merged-weight reference")
        for name, f in res["faults"].items():
            _check(f["rejected"], f"{QWEN} {dtype}: the check let the planted fault {name} through")


# ---------------------------------------------------------------------------
# the request API and telemetry at full width: qwen2-0.5b under the posture
# ---------------------------------------------------------------------------

# the block-pressure serve: two lanes, a pool of 5 blocks, two 16-token
# prompts that each grow to 3 blocks (48 positions), so the younger lane is
# preempted when both cross position 32
API_PRESSURE = {"n_lanes": 2, "n_blocks": 1 + 5}
API_PRESSURE_GEN = 32
# an injected prefill against the same request served whole: the same
# monolithic prefill and decode kernels, so a float32 difference above this
# means the shipped K/V or the adopted lane is wrong
API_INJECT_TOL = 1e-5
API_ROUNDS = 3  # alternating bf16 serves: telemetry on, off, and monolithic


def stream_serve(engine, traffic, gen: int = QWEN_GEN, drive: str = "stream") -> dict:
    """Submit ``traffic`` (``gen`` tokens a request) and drain it: through
    ``stream()`` (each event's host time recorded), ``run()``, or
    ``step_finish(step_begin())`` (``drive``).  Returns the requests,
    events, their times and the port's kernel launches of the serve."""
    import torch
    from repro_torch import kernels

    reqs = [engine.submit(t, p, gen) for t, p in traffic]
    events, times = [], []
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    if drive == "stream":
        for ev in engine.stream():
            events.append(ev)
            times.append(time.perf_counter())
    elif drive == "run":
        engine.run()
    else:
        while engine.scheduler.has_work:
            engine.step_finish(engine.step_begin())
    torch.cuda.synchronize()
    serve_s = time.perf_counter() - t0
    tokens = sum(len(r.tokens) for r in reqs)
    return {"reqs": reqs, "events": events, "times": times, "t0": t0, "serve_s": serve_s,
            "tok_per_s": tokens / serve_s, "launches": kernels.launch_counts()}


def delivered_once(run) -> dict:
    """Whether ``run``'s events deliver each request's tokens exactly once,
    in order (indexes 0, 1, … with the request's own tokens)."""
    per, dup = {}, 0
    for ev in run["events"]:
        got = per.setdefault(ev.uid, [])
        if ev.index != len(got):
            dup += 1
            continue
        got.append(ev.token)
    ok = dup == 0 and all(per.get(r.uid) == r.tokens and r.delivered == len(r.tokens)
                          for r in run["reqs"])
    return {"ok": ok, "events": len(run["events"]), "out_of_order_or_repeated": dup,
            "tokens": sum(len(r.tokens) for r in run["reqs"]),
            "preemptions": sum(r.preemptions for r in run["reqs"])}


def same_streams(reqs, ref_reqs, tol: float) -> dict:
    """Each request of ``reqs`` against the request of the same tenant and
    prompt in ``ref_reqs``: tokens equal and float32 |Δlogits| within
    ``tol``; how many are bitwise."""
    import numpy as np

    ref = {(r.tenant, r.prompt.tobytes()): r for r in ref_reqs}
    worst, bitwise, ok = 0.0, 0, True
    for r in reqs:
        o = ref[(r.tenant, r.prompt.tobytes())]
        a, b = np.stack(r.logits), np.stack(o.logits)
        same = r.tokens == o.tokens and a.shape == b.shape
        ok &= same
        if same:
            worst = max(worst, float(np.abs(a - b).max()))
            bitwise += bool(np.array_equal(a, b))
    return {"ok": ok and worst <= tol, "requests": len(reqs), "bitwise": bitwise,
            "max_abs_dlogits": worst, "tol": tol}


def latency_readings(runs) -> dict:
    """TTFT (submit → first event) and TBT (gap between a request's
    events), ms on the host clock, pooled over ``runs``: count, mean, p50,
    p99."""
    import numpy as np

    ttft, tbt = [], []
    for run in runs:
        last = {}
        for ev, t in zip(run["events"], run["times"]):
            if ev.uid in last:
                tbt.append((t - last[ev.uid]) * 1e3)
            else:
                ttft.append((t - run["t0"]) * 1e3)
            last[ev.uid] = t

    def summary(xs):
        xs = np.asarray(xs)
        return {"count": int(xs.size), "mean": float(xs.mean()),
                "p50": float(np.percentile(xs, 50)), "p99": float(np.percentile(xs, 99))}

    return {"ttft_ms": summary(ttft), "tbt_ms": summary(tbt)}


def histogram_readings(snap, name: str) -> dict:
    """Each series of the histogram ``name`` of a metrics snapshot: count,
    sum (ms), mean and the p50/p99 bucket bounds."""
    out = {}
    for series in snap[name]["series"]:
        label = ",".join(f"{v}" for v in series["labels"].values()) or name
        n, total = series["count"], series["sum"]
        bound = lambda q: next((float(le) if le != "+Inf" else float("inf")
                                for le, cum in series["buckets"] if cum >= q * n), 0.0)
        out[label] = {"count": n, "sum_ms": total, "mean_ms": total / n if n else 0.0,
                      "p50_le_ms": bound(0.5), "p99_le_ms": bound(0.99)}
    return out


def sync_checked(fn):
    """``fn`` run under ``torch.cuda.set_sync_debug_mode("error")``: any
    call in it that would make the host wait for the card raises.  Counts
    its calls in ``.calls``."""
    import torch

    def wrapped(*a, **kw):
        torch.cuda.set_sync_debug_mode("error")
        try:
            return fn(*a, **kw)
        finally:
            torch.cuda.set_sync_debug_mode("default")
            wrapped.calls += 1

    wrapped.calls = 0
    return wrapped


def sync_mode_catches_a_sync() -> bool:
    """Control: a planted host read of a device value under the mode raises."""
    import torch

    x = torch.ones(1, device="cuda")
    try:
        sync_checked(lambda: x.item())()
    except RuntimeError:
        return True
    return False


def blocks_held(engine) -> int:
    """Distinct blocks the active lanes and the prefix cache hold."""
    held = {b for blocks in engine._lane_blocks.values() for b in blocks}
    if engine.prefix_cache is not None:
        held |= set(engine.prefix_cache._entries.values())
    return len(held)


def cancel_serve(engine, traffic, faulty: bool = False) -> dict:
    """The posture's traffic; once the first request has decoded two tokens
    while requests still queue, cancel it (active, mid-decode) and the last
    queued request, then run the rest.  ``faulty`` plants a cancel that
    leaves the lane's blocks referenced."""
    reqs = [engine.submit(t, p, QWEN_GEN) for t, p in traffic]
    while engine.scheduler.has_work and not (len(reqs[0].tokens) >= 2 and engine.scheduler.queue):
        engine.step()
    _check(reqs[0].lane >= 0 and engine.scheduler.queue,
           f"{QWEN} cancel: the first request finished before requests stopped queueing")
    active, queued = reqs[0], engine.scheduler.queue[-1]
    if faulty:
        for b in engine._lane_blocks[active.lane]:
            engine.allocator.incref(b)
    engine.cancel(active)
    engine.cancel(queued)
    out = {"cancelled_tokens": len(active.tokens), "blocks_in_use": engine.blocks_in_use(),
           "blocks_held": blocks_held(engine), "queue": len(engine.scheduler.queue)}
    out["ok_after_cancel"] = out["blocks_in_use"] == out["blocks_held"]
    if faulty:
        return out
    engine.run()
    out["rest"] = [r for r in reqs if r is not active and r is not queued]
    out["end_blocks_in_use"] = engine.blocks_in_use()
    out["end_cached"] = engine.prefix_cache.cached_blocks
    out["released"] = engine.release_prefix_cache()
    out["ok_at_end"] = (out["end_blocks_in_use"] == out["end_cached"] == out["released"]
                        and engine.blocks_in_use() == 0)
    return out


def handoff_phase(seed: int, params, traffic, whole, faulty: bool = False) -> dict:
    """Two engines on the one card (float32).  Request: engine A admits
    traffic[0] (one step: its monolithic prefill and first token), exports
    its state and cancels it; engine B injects it and serves it to the end,
    against the same request served whole (``whole``).  Prefix: A serves
    traffic[4] (tenant 1: no entry of its family in B's cache yet); B serves
    a prompt sharing its first block (same tenant and bucket), imports A's
    export of traffic[4]'s prefix (the two blocks past the local match) and
    serves traffic[4], a prefix hit, against A's serve at the chunked bar.  ``faulty`` plants an import that writes the
    shipped blocks from the payload's first block."""
    import numpy as np

    _, a, _ = qwen_engine("float32", seed, params=params)
    _, b, _ = qwen_engine("float32", seed, params=params)
    if faulty:
        write = b._write_imported_blocks
        b._write_imported_blocks = lambda ids, payload, skip: write(ids, payload, skip=0)
    out = {}
    if not faulty:
        tenant, p0 = traffic[0]
        r = a.submit(tenant, p0, QWEN_GEN)
        a.step()
        state = a.export_request_state(r)
        a.cancel(r)
        out["a_blocks_after_cancel"] = a.blocks_in_use()
        inj = b.inject_prefilled(tenant, p0, QWEN_GEN, state)
        b.run()
        out["inject"] = same_streams([inj], whole, API_INJECT_TOL)
        # no prompt forward ran on B: no bucket prefilled, no chunk
        out["inject"]["prefilled_on_b"] = len(b.prefill_buckets) + inj.prefill_chunks
        out["payload_bytes"] = int(state["k"].nbytes + state["v"].nbytes)
    tenant, p = traffic[4]
    rng = np.random.default_rng(seed + 4000)
    q = np.concatenate([p[:16], rng.integers(2, a.cfg.vocab_size, size=32).astype(np.int32),
                        p[48:]])
    ra = a.submit(tenant, p, QWEN_GEN)
    a.run()
    rq = b.submit(tenant, q, 2)
    b.run()
    payload = a.export_prefix(tenant, p)
    local = len(b.prefix_cache.match(b._family_key(tenant, p.size), p))
    hits0 = b.prefix_cache.hits
    out["imported"] = b.import_prefix(tenant, p, payload)
    out["local_match"] = local
    out["shipped_blocks"] = payload["n_blocks"]
    rb = b.submit(tenant, p, QWEN_GEN)
    b.run()
    out["b_prefix_hits"] = b.prefix_cache.hits - hits0
    out["b_chunked"] = rb.prefill_chunks > 0
    out["prefix"] = same_streams([rb], [ra], QWEN_CHUNK_FP32_TOL)
    out["q_tokens"] = len(rq.tokens)
    return out


def request_api_phase(seed: int, params: dict) -> dict:
    """qwen2-0.5b at full width under ``EngineConfig.serving(n_lanes=4,
    n_slots=8, max_len=384)`` on the posture phase's weights and traffic:
    stream against run, exactly once under block-pressure preemption,
    telemetry on against off, the split step under sync debug mode
    "error", cancel, the handoff between two engines, the planted faults,
    and the step-phase, TTFT/TBT and telemetry-cost readings (bf16).
    Returns every reading; check_request_api holds them to the bars."""
    import numpy as np
    import torch

    p32 = params["float32"]
    out = {"seconds": {}}
    t0 = time.perf_counter()

    def lap(name):
        nonlocal t0
        now = time.perf_counter()
        out["seconds"][name] = now - t0
        t0 = now

    # -- float32: run, stream, split step, telemetry off ----------------------
    cfg, eng, _ = qwen_engine("float32", seed, params=p32)
    traffic = qwen_traffic(seed, cfg.vocab_size)
    run = stream_serve(eng, traffic, drive="run")
    _, eng, _ = qwen_engine("float32", seed, params=p32)
    st = stream_serve(eng, traffic)
    out["stream_vs_run"] = {**same_streams(st["reqs"], run["reqs"], 0.0),
                            **{"delivered_once": delivered_once(st)}}
    _, eng, _ = qwen_engine("float32", seed, params=p32)
    eng._dispatch_decode = sync_checked(eng._dispatch_decode)
    eng._grow_lanes = sync_checked(eng._grow_lanes)
    split = stream_serve(eng, traffic, drive="split")
    out["split_vs_step"] = {**same_streams(split["reqs"], run["reqs"], 0.0),
                            "dispatches_sync_checked": eng._dispatch_decode.calls,
                            "grows_sync_checked": eng._grow_lanes.calls,
                            "planted_sync_caught": sync_mode_catches_a_sync()}
    _, eng, _ = qwen_engine("float32", seed, params=p32, telemetry=False)
    off = stream_serve(eng, traffic, drive="run")
    out["telemetry_off_vs_on_fp32"] = {**same_streams(off["reqs"], run["reqs"], 0.0),
                                       "launches_on": run["launches"],
                                       "launches_off": off["launches"]}

    lap("fp32_streams")
    # -- block pressure: exactly once under preemption -------------------------
    rng = np.random.default_rng(seed + 5000)
    pressure = [(f"tenant{i}", rng.integers(2, cfg.vocab_size, size=16).astype(np.int32))
                for i in range(2)]
    runs = {}
    for name, kw in (("pressure", API_PRESSURE), ("roomy", {"n_lanes": 2}),
                     ("pressure_no_guard", API_PRESSURE)):
        _, eng, _ = qwen_engine("float32", seed, params=p32, **kw)
        if name == "pressure_no_guard":  # planted: the delivered guard gone
            emit = eng._emit
            eng._emit = lambda req, row, fin: (setattr(req, "delivered", 0), emit(req, row, fin))
        runs[name] = stream_serve(eng, pressure, gen=API_PRESSURE_GEN)
    out["pressure"] = {**delivered_once(runs["pressure"]),
                       "vs_roomy": same_streams(runs["pressure"]["reqs"],
                                                runs["roomy"]["reqs"], QWEN_CHUNK_FP32_TOL)}
    fault = delivered_once(runs["pressure_no_guard"])
    out["fault_no_delivered_guard"] = {**fault, "rejected": not fault["ok"]}

    lap("pressure")
    # -- cancel ----------------------------------------------------------------
    _, eng, _ = qwen_engine("float32", seed, params=p32)
    c = cancel_serve(eng, traffic)
    rest = c.pop("rest")
    c["rest_vs_run"] = same_streams(rest, run["reqs"], QWEN_CHUNK_FP32_TOL)
    out["cancel"] = c
    _, eng, _ = qwen_engine("float32", seed, params=p32)
    fault = cancel_serve(eng, traffic, faulty=True)
    out["fault_cancel_keeps_blocks"] = {**fault, "rejected": not fault["ok_after_cancel"]}

    lap("cancel")
    # -- the handoff between two engines ---------------------------------------
    out["handoff"] = handoff_phase(seed, p32, traffic, run["reqs"])
    fault = handoff_phase(seed, p32, traffic, run["reqs"], faulty=True)
    out["fault_import_from_skip_0"] = {**fault, "rejected": not fault["prefix"]["ok"]}
    del eng, run, st, split, off, runs
    torch.cuda.empty_cache()

    lap("handoff")
    # -- bf16: telemetry on, off and monolithic in alternating rounds ----------
    p16 = params["bfloat16"]
    engines = {"on": qwen_engine("bfloat16", seed, params=p16)[1],
               "off": qwen_engine("bfloat16", seed, params=p16, telemetry=False)[1],
               "monolithic": qwen_engine("bfloat16", seed, params=p16, prefill_chunk=None)[1]}
    rounds = {name: [] for name in engines}
    for _ in range(API_ROUNDS):
        for name, eng in engines.items():
            eng.release_prefix_cache()
            rounds[name].append(stream_serve(eng, traffic))
    toks = {name: [[r.tokens for r in run["reqs"]] for run in rs] for name, rs in rounds.items()}
    out["telemetry_bf16"] = {
        "tokens_identical": all(t == toks["on"][0] for t in toks["on"] + toks["off"]),
        "launches_identical": all(run["launches"] == rounds["on"][0]["launches"]
                                  for run in rounds["on"] + rounds["off"]),
        "launches": rounds["on"][0]["launches"],
        "tok_per_s": {name: [run["tok_per_s"] for run in rs] for name, rs in rounds.items()},
        "median_tok_per_s": {name: statistics.median(run["tok_per_s"] for run in rs)
                             for name, rs in rounds.items()},
    }
    snap = engines["on"].metrics()
    out["phases_bf16"] = histogram_readings(snap, "serve_step_phase_ms")
    out["latency_bf16"] = {
        "chunked": latency_readings(rounds["on"]),
        "monolithic": latency_readings(rounds["monolithic"]),
        "chunked_histograms": {n: histogram_readings(snap, n)[n]
                               for n in ("serve_ttft_ms", "serve_tbt_ms")},
        "monolithic_histograms": {n: histogram_readings(engines["monolithic"].metrics(), n)[n]
                                  for n in ("serve_ttft_ms", "serve_tbt_ms")},
        "steps": {name: eng.steps // API_ROUNDS for name, eng in engines.items()},
    }
    # one more serve of each, telemetry on and off, under torch.profiler: the
    # same CUDA calls.  The CUDA activity alone records the kernels and the
    # CUDA API calls; the host's own operators (most of the events, slow to
    # parse) are left out
    prof = {}
    for name in ("on", "off"):
        eng = engines[name]
        eng.release_prefix_cache()
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as p:
            t0 = time.perf_counter()
            stream_serve(eng, traffic)
            wall_us = (time.perf_counter() - t0) * 1e6
        prof[name] = _device_busy(p, wall_us, api_calls=True)
    out["profile_bf16"] = prof
    lap("bf16")
    del engines
    torch.cuda.empty_cache()
    return out


def print_request_api(out: dict, smi: str) -> None:
    for name in ("stream_vs_run", "split_vs_step", "telemetry_off_vs_on_fp32", "pressure",
                 "fault_no_delivered_guard", "cancel", "fault_cancel_keeps_blocks", "handoff",
                 "fault_import_from_skip_0", "telemetry_bf16", "seconds"):
        print(f"  {QWEN} request API {name}: {out[name]}")
    for phase, r in out["phases_bf16"].items():
        print(f"  {QWEN} bf16 step phase {phase}: {r['count']} steps, {r['sum_ms']:.1f} ms in all, "
              f"mean {r['mean_ms']:.3f} ms, p50 ≤ {r['p50_le_ms']} ms, p99 ≤ {r['p99_le_ms']} ms "
              f"(host clock, over {API_ROUNDS} serves) on {smi}")
    lat = out["latency_bf16"]
    for path in ("chunked", "monolithic"):
        for name in ("ttft_ms", "tbt_ms"):
            r = lat[path][name]
            print(f"  {QWEN} bf16 {path} {name}: {r['count']} readings, mean {r['mean']:.2f}, "
                  f"p50 {r['p50']:.2f}, p99 {r['p99']:.2f} (stream event times, host clock, "
                  f"{API_ROUNDS} serves); histogram {lat[path + '_histograms']['serve_' + name]} "
                  f"on {smi}")
    print(f"  {QWEN} bf16 decode steps a serve: {lat['steps']}")
    t = out["telemetry_bf16"]["median_tok_per_s"]
    print(f"  {QWEN} bf16 tokens/s, median of {API_ROUNDS} alternating serves: telemetry on "
          f"{t['on']:.2f}, off {t['off']:.2f} ({t['on'] / t['off']:.4f}×), monolithic "
          f"{t['monolithic']:.2f} on {smi}")
    for name, p in out["profile_bf16"].items():
        print(f"  {QWEN} bf16 profiled serve, telemetry {name}: {p}")
    pr = out["profile_bf16"]
    print(f"  {QWEN} bf16 telemetry on against off: CUDA calls identical "
          f"{pr['on']['cuda_api_calls'] == pr['off']['cuda_api_calls']}; device records "
          f"{pr['on']['kernels']} against {pr['off']['kernels']} (the profiler may drop a few)")


def check_request_api(out: dict) -> None:
    for name in ("stream_vs_run", "split_vs_step", "telemetry_off_vs_on_fp32"):
        r = out[name]
        _check(r["ok"] and r["bitwise"] == r["requests"],
               f"{QWEN} request API {name}: streams differ from run(): {r}")
    _check(out["stream_vs_run"]["delivered_once"]["ok"],
           f"{QWEN} stream(): a token delivered twice, skipped or out of order: {out['stream_vs_run']}")
    s = out["split_vs_step"]
    _check(s["dispatches_sync_checked"] > 0 and s["grows_sync_checked"] > 0
           and s["planted_sync_caught"],
           f"{QWEN} split step: the decode dispatch did not run under sync debug mode, or the "
           f"mode did not catch a planted sync: {s}")
    t = out["telemetry_off_vs_on_fp32"]
    _check(t["launches_on"] == t["launches_off"],
           f"{QWEN} telemetry on launches other kernels than off (float32): {t}")
    for name in ("qrlora_bgmv", "paged_decode_attention"):
        _check(t["launches_on"][name] > 0 and out["telemetry_bf16"]["launches"][name] > 0,
               f"{QWEN} request API: {name} never launched")
    _check_no_bench_kernels(out["telemetry_bf16"]["launches"], f"{QWEN} request API bf16")
    p = out["pressure"]
    _check(p["ok"] and p["preemptions"] >= 1 and p["vs_roomy"]["ok"],
           f"{QWEN} block-pressure stream: no preemption, a token delivered twice, or the "
           f"streams differ from the roomy pool's: {p}")
    c = out["cancel"]
    _check(c["ok_after_cancel"] and c["ok_at_end"] and c["rest_vs_run"]["ok"],
           f"{QWEN} cancel: blocks still held, or the other streams changed: {c}")
    h = out["handoff"]
    _check(h["inject"]["ok"] and h["inject"]["prefilled_on_b"] == 0,
           f"{QWEN} inject_prefilled: not the request served whole: {h}")
    _check(h["imported"] == h["shipped_blocks"] - h["local_match"] > 0 and h["local_match"] > 0
           and h["b_prefix_hits"] == h["shipped_blocks"] and h["prefix"]["ok"],
           f"{QWEN} import_prefix: no hit of every shipped block, or the serve differs: {h}")
    tb = out["telemetry_bf16"]
    _check(tb["tokens_identical"] and tb["launches_identical"],
           f"{QWEN} bf16 telemetry on against off: tokens or launches differ: {tb}")
    pr = out["profile_bf16"]
    _check(pr["on"]["cuda_api_calls"] == pr["off"]["cuda_api_calls"]
           and pr["on"]["cuda_api_calls"].get("cudaLaunchKernel", 0) > 0,
           f"{QWEN} bf16 telemetry on made other CUDA calls than off: "
           f"{pr['on']['cuda_api_calls']} against {pr['off']['cuda_api_calls']}")
    for name in ("fault_no_delivered_guard", "fault_cancel_keeps_blocks",
                 "fault_import_from_skip_0"):
        _check(out[name]["rejected"], f"{QWEN}: the check let the planted fault {name} through")


def kernel_bench_phase():
    """The port's kernel bench on the card, in process, launches counted
    around it; its rows go into the report."""
    import io
    from repro_torch import kernels
    from repro_torch.benchmarks import common, run

    buf = io.StringIO()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(buf):
            errors = run.main(["--only", "kernel"])
    except SystemExit:
        sys.stdout.write(buf.getvalue())
        _fail(f"the kernel bench failed or a row is over its tolerance: {common.errors()}")
    return {"launches": kernels.launch_counts(), "errors": errors, "rows": common.rows(),
            "s": time.perf_counter() - t0}


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
    from repro_torch.launch.serve_multi import process_group

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
        kernel = ""
        for line in text.splitlines():
            if "Compiling entry function" in line:
                kernel = _kernel_name(_build.nvcc_path(), line.split("'")[1])
            elif "registers" in line or "smem" in line or "spill" in line:
                print(f"  {name} {kernel}: {line.strip()}")

    report = {"card": smi, "cases": []}
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    bgmv_err = check_bgmv(gen, report["cases"])
    bgmv_faults = planted_bgmv_faults(gen)
    report["bgmv_faults"] = bgmv_faults
    for name, f in bgmv_faults.items():
        print(f"qrlora_bgmv {name}, |Δ| over the bound: sound {f['sound']:.3f}; planted faults: "
              f"one cluster rank dropped {f['rank_dropped_least']:.1f}-"
              f"{f['rank_dropped_worst']:.1f} (least-worst of {f['plan']['cluster']} ranks), "
              f"every λ row from slot 0 {f['lam_slot0']:.1f}; plan {f['plan']}")
        _check(f["sound"] <= 1.0 and f["rank_dropped_least"] > 1.0 and f["lam_slot0"] > 1.0,
               f"qrlora_bgmv {name}: a planted fault went through, or the sound kernel did "
               f"not: {f}")
    paged_err, paged_fault = check_paged(gen, report["cases"])
    qwen_err = check_qwen_kernels(gen, report["cases"])
    print(f"qrlora_bgmv and paged_decode_attention at {QWEN}'s shapes (BGMV {QWEN_BGMV_SHAPES}; "
          f"paged 14 heads over 2, dh 64, {QWEN_PAGED_CASES}): {qwen_err}, within tolerance, "
          f"length-0 lanes zeros, bitwise on a second call")
    matmul_err = check_matmul(gen, report["cases"])
    matmul_enc_err = check_matmul_encoder(gen, report["cases"])
    print(f"qrlora_matmul float32 route at the encoder's shapes {ENCODER_SHAPES}: max|Δ| "
          f"{matmul_enc_err:.3e}, within tolerance, bitwise on a second call and under replay")
    bgmv_quant_err = check_bgmv_quant(gen, report["cases"])
    bgmv_quant_faults = planted_bgmv_quant_faults(gen)
    report["bgmv_quant_faults"] = bgmv_quant_faults
    for name, f in bgmv_quant_faults.items():
        print(f"qrlora_bgmv_quant {name}, |Δ| over the bound: sound {f['sound']:.3f}; planted "
              f"faults: one cluster rank dropped {f['rank_dropped_least']:.1f}-"
              f"{f['rank_dropped_worst']:.1f} (least-worst of {f['plan']['cluster']} ranks), "
              f"every λ row from slot 0 {f['lam_slot0']:.1f}, w_scale dropped "
              f"{f['w_scale_dropped']:.1f}, w_scale on the adapter term "
              f"{f['w_scale_on_adapter']:.1f}; plan {f['plan']}")
        _check(f["sound"] <= 1.0 and min(f[k] for k in (
            "rank_dropped_least", "lam_slot0", "w_scale_dropped", "w_scale_on_adapter")) > 1.0,
               f"qrlora_bgmv_quant {name}: a planted fault went through, or the sound kernel "
               f"did not: {f}")
    matmul_quant_err = check_matmul_quant(gen, report["cases"])
    replays = check_matmul_replay(gen)
    report["matmul_replays"] = replays
    print(f"one-λ kernels: a captured call replayed is bitwise the eager call: {replays}")
    _check(all(r["bitwise"] for r in replays), f"a replayed one-λ call differs from eager: {replays}")
    mm_faults = planted_matmul_faults(gen)
    report["matmul_faults"] = mm_faults
    print(f"one-λ kernels, |Δ| over the bf16 bound: sound wq {mm_faults['sound_wq']:.3f} "
          f"(M=2048), sound int8 {mm_faults['sound_int8_M64']:.3f} (M={SCORE_ROWS}, plan "
          f"{mm_faults['plan_M64']}); planted faults: an x·W step dropped "
          f"{mm_faults['x_step_dropped']:.1f}, the last P step of each half dropped "
          f"{mm_faults['last_p_step_dropped']:.1f}, cluster rank 1's steps "
          f"{mm_faults['rank1_steps']} dropped {mm_faults['split_rank_dropped']:.1f} (rejected)")
    for name in ("x_step_dropped", "last_p_step_dropped", "split_rank_dropped"):
        _check(mm_faults[name] > 1.0, f"the one-λ check let the planted fault {name} through: "
                                      f"{mm_faults[name]}")
    bgmv_rows_err = check_bgmv_rows(gen, report["cases"])
    flash_err, flash_fault = check_flash(gen, report["cases"])
    decode_err, decode_replays, decode_fault = check_decode(gen, report["cases"])
    print(f"kernel vs plain: qrlora_bgmv max|Δ| {bgmv_err}, "
          f"paged_decode_attention max|Δ| {paged_err}, qrlora_matmul max|Δ| {matmul_err}, "
          f"qrlora_bgmv_quant max|Δ| {bgmv_quant_err} (int8 and fp8; bitwise again and "
          f"replayed), qrlora_matmul_quant max|Δ| "
          f"{matmul_quant_err} (int8 and fp8; both bitwise on a second call), qrlora_bgmv_rows max|Δ| {bgmv_rows_err} (W in "
          f"x's dtype, int8 and fp8; bitwise the BGMV kernels with rows = Λ[seg], a λ row sent "
          f"to slot 0 rejected), flash_attention {flash_err}, decode_attention {decode_err} "
          f"(all within tolerance)")
    print(f"flash_attention bf16: a KV tile dropped from the last query tile at S=2048 reads "
          f"{flash_fault} (rejected: over 1 of the bound)")
    print(f"decode_attention: one captured call replayed at device lengths "
          f"{DECODE_REPLAY_LENGTHS} reads {decode_replays} of the bound; a merge that drops the "
          f"last valid chunk at L=1000 (bf16) reads {decode_fault} (rejected)")
    print(f"paged_decode_attention: worst |Δ| and |Δ|/bound {paged_err} over {len(PAGED_CASES)} "
          f"cases (dh 64 and 16, lengths 0-1000, whole tables and column slices), out-of-range "
          f"entries contributing nothing, bitwise on a second call and under graph replay at "
          f"device lengths {PAGED_REPLAY_LENGTHS}; planted faults (bf16, least |Δ|/bound): the "
          f"longest lane's last block dropped {paged_fault['last_block_dropped']:.3f}, one "
          f"split's partial dropped {paged_fault['split_dropped']:.3f} (rejected)")

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
    factor_rows = [matmul_factor_backward_readings(gen, M, r) for M, r in ((2048, 2), (768, 256))]
    factor_fault = planted_factor_backward_fault(gen)
    report["cases"].extend({"kernel": "qrlora_matmul factor backward", **r} for r in factor_rows)
    report["factor_backward_fault"] = factor_fault
    for row in factor_rows:
        print(f"  qrlora_matmul backward with dB, dA (LoRA) {row}")
    print(f"  planted fault dA dropped: {factor_fault}")
    _check(all(r["ok"] for r in factor_rows),
           "the factor gradients disagree with autograd through the plain formula")
    _check(not factor_fault["ok"], "the factor backward check let a dropped dA through")

    # -- pivoted QR without host reads: one CUDA graph at 768 × 768 ----------
    qr_graph = check_qr_graph(gen)
    report["qr_graph"] = qr_graph
    print(f"qr_pivoted 768 × 768 captured in one CUDA graph: {qr_graph}")
    _check(qr_graph["bitwise"] and qr_graph["perm_equals_cpu"],
           f"qr_pivoted under graph replay differs from eager, or perm from the CPU's: {qr_graph}")

    timings = {"qrlora_bgmv_wq": time_bgmv(gen, 576), "qrlora_bgmv_wv": time_bgmv(gen, 192),
               "qrlora_bgmv_wq_M64": time_bgmv(gen, 576, 64),
               "paged_decode_attention": time_paged(gen),
               "paged_decode_attention_long": time_paged_long(gen),
               "qrlora_matmul_wq": time_matmul(gen, 576), "qrlora_matmul_wv": time_matmul(gen, 192),
               "qrlora_bgmv_qwen2_wq": time_bgmv(gen, 896, 4, K=896, r=160),
               "qrlora_bgmv_qwen2_wv": time_bgmv(gen, 128, 4, K=896, r=160),
               "qrlora_bgmv_qwen2_wq_M32": time_bgmv(gen, 896, 32, K=896, r=160),
               "paged_decode_attention_qwen2": time_paged(gen, (72, 64, 230, 200), H=14, KV=2,
                                                          cols=16, max_blocks=24)}
    for base in ("int8", "fp8"):
        for proj, N in (("wq", 576), ("wv", 192)):
            timings[f"qrlora_bgmv_quant_{proj}_{base}"] = time_bgmv_quant(gen, N, base)
            for M in (SCORE_ROWS, 2048):
                timings[f"qrlora_matmul_quant_{proj}_M{M}_{base}"] = time_matmul_quant(
                    gen, M, N, base)
        timings[f"qrlora_bgmv_quant_wq_M64_{base}"] = time_bgmv_quant(gen, 576, base, 64)
    for base in ("bf16", "int8", "fp8"):
        timings[f"qrlora_bgmv_rows_wq_{base}"] = time_bgmv_rows(gen, 576, base)
        timings[f"qrlora_bgmv_rows_wv_{base}"] = time_bgmv_rows(gen, 192, base)
        timings[f"qrlora_bgmv_rows_wq_M64_{base}"] = time_bgmv_rows(gen, 576, base, 64)
    for M in (2048, 768):
        for r in (256, 2):
            timings[f"qrlora_matmul_f32_M{M}_r{r}"] = time_matmul_f32(gen, M, r)
    for B, S in ((8, 256), (1, 2048)):
        timings[f"flash_attention_B{B}_S{S}"] = time_flash(gen, B, S)
    timings["decode_attention"] = time_decode(gen)
    for name, t in timings.items():
        print(f"{name}: kernel {t['ms']:.5f} ms (eager call {t['eager_ms']:.5f} ms), plain "
              f"{t['plain_ms']:.5f} ms, library {t['library_ms']} ms, bound "
              f"{t['bound_ms']:.6f} ms ({t['bound_by']}) at {t['shape']} on {smi}; "
              f"timed by CUDA-graph replay")
        if "launch_us" in t:
            print(f"  {name} device µs per launch (torch.profiler, eager calls): "
                  + "; ".join(f"{k} {us:.3f}" for k, us in t["launch_us"].items()))
    long = timings["paged_decode_attention_long"]
    print(f"paged_decode_attention_long: {long['ms']:.5f} ms beside the dense decode kernel's "
          f"{long['dense_ms']:.5f} ms at the same length ({long['over_dense']:.3f}×; turns "
          f"paged, dense, dense, paged {long['turns_ms']}) on {smi}")
    report["timings"] = timings

    # -- the kernel bench: flash and dense decode attention's path ----------
    kb = kernel_bench_phase()
    report["kernel_bench"] = kb
    for row in kb["rows"]:
        print(f"  bench {row}")
    print(f"kernel bench: {len(kb['rows'])} rows in {kb['s']:.1f} s, every error row within "
          f"tolerance; launches {kb['launches']}")
    for name in ("flash_attention", "decode_attention", "qrlora_matmul"):
        _check(kb["launches"][name] > 0, f"kernel bench: {name} never launched: {kb['launches']}")
    _check(len(kb["errors"]) == len(kb["rows"]) - 2  # every row but pivoted QR's two
           and all(e["ok"] for e in kb["errors"].values()),
           f"kernel bench: error rows {kb['errors']}")

    # the sharded serves' default process group: NCCL, a world of one on card
    # 0; one collective now creates the communicator outside the timed serves
    group = contextlib.ExitStack()
    group.enter_context(process_group("cuda"))
    torch.distributed.all_reduce(torch.zeros(1, device="cuda"))
    torch.cuda.synchronize()

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
    _check_no_bench_kernels(launches, "serve bf16")
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

    # -- the sharded serve: shard_lam on the same weights and traffic --------
    sh = sharded_serve_phase("bfloat16", args.seed, params_bf16, done_bf16, profile=True)
    report["serve_sharded"] = {"bf16": sh}
    print(f"serve bf16 shard_lam (world of one): {sh['tokens']} tokens in {sh['serve_s']:.3f} s "
          f"= {sh['tok_per_s']:.1f} tok/s over {sh['steps']} decode steps; launches "
          f"{sh['launches']}; collectives {sh['collectives']} over {sh['forwards']} forwards; "
          f"λ tables {sh['table_bytes_per_rank']} B/rank of {sh['table_bytes']} B")
    print(f"  vs the replicated bf16 serve: {sh['streams']}")
    print(f"profiled sharded bf16 serve: {sh['profile']}")
    check_sharded("serve bf16 shard_lam", sh, bitwise=False)

    # -- the quantized base: the bf16 serve's weights in int8, then fp8 ------
    report["serve_quant"] = {}
    for base in ("int8", "fp8"):
        engine, qs, done_q = quant_serve_phase(base, args.seed, params_bf16, done_bf16)
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
        if base == "int8":
            sh = sharded_serve_phase("bfloat16", args.seed, params_bf16, done_q, base_dtype=base)
            report["serve_sharded"][base] = sh
            print(f"serve bf16 on an {base} base, shard_lam: {sh['tok_per_s']:.1f} tok/s; "
                  f"launches {sh['launches']}; collectives {sh['collectives']}; vs the "
                  f"replicated {base} serve: {sh['streams']}")
            check_sharded(f"serve {base} shard_lam", sh, bitwise=False)
    del params_bf16
    score_launches = report["serve_quant"]["int8"]["score_launches"]

    # -- the same path in float32: token-identical to the merged reference ---
    kernels.reset_launch_counts()
    cfg, engine, lams, done, t_init, t_serve = serve("float32", args.seed)
    _check_no_bench_kernels(kernels.launch_counts(), "serve fp32")
    rows_f32 = verify(cfg, engine, lams, done, 16)
    for row in rows_f32:
        print(f"  fp32 {row}")
    report["serve_fp32"] = {"init_s": t_init, "serve_s": t_serve,
                            "tokens": engine.decoded_tokens, "verify": rows_f32}
    _check(all(r["tokens_match"] and r["max_abs_dlogits"] < FP32_LOGIT_TOL for r in rows_f32),
           "fp32 serve diverged from the merged-weight reference")
    params_f32, done_f32 = engine.params, done
    del engine
    torch.cuda.empty_cache()
    sh = sharded_serve_phase("float32", args.seed, params_f32, done_f32, shard_ba=True)
    report["serve_sharded"]["fp32"] = sh
    print(f"serve fp32 shard_lam + shard_ba: {sh['tok_per_s']:.1f} tok/s; launches "
          f"{sh['launches']}; collectives {sh['collectives']}; factor rank dim "
          f"{sh['factor_rank_local']} a rank; vs the replicated fp32 serve: {sh['streams']}")
    check_sharded("serve fp32 shard_lam + shard_ba", sh, bitwise=True)
    group.close()
    print("sharded serves: token-identical to the replicated serves (float32 logits bitwise), "
          "the rows kernel on every adapted projection")

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

    # -- the serving posture: qwen2-0.5b under EngineConfig.serving() --------
    t0 = time.perf_counter()
    qwen_params = {}
    posture = serving_posture_phase(args.seed, keep=qwen_params)
    report["serving_posture"] = posture
    print_serving_posture(posture, smi)
    check_serving_posture(posture)
    print(f"{QWEN} under EngineConfig.serving() in float32 and bf16: shared bitwise unshared, "
          f"chunked within the bar of monolithic, float32 token-identical to the merged-weight "
          f"reference, every planted fault rejected ({time.perf_counter() - t0:.1f} s)")

    # -- the request API and telemetry on the posture's weights and traffic ---
    t0 = time.perf_counter()
    api = request_api_phase(args.seed, qwen_params)
    report["request_api"] = api
    print_request_api(api, smi)
    check_request_api(api)
    print(f"{QWEN} request API: stream equals run (float32 bitwise), each token delivered once "
          f"under preemption, the split step's decode dispatch free of syncs, telemetry on "
          f"equals off, cancel and the handoff between engines hold, every planted fault "
          f"rejected ({time.perf_counter() - t0:.1f} s)")
    del qwen_params
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

    # -- the GLUE path: full-width RoBERTa-base in every mode, launches counted
    report["glue"], glue_launches = check_glue(glue_phase(args.seed), want_launches)

    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "chip_smoke.json"), "w") as f:
        json.dump(report, f, indent=1, default=str)

    entries = []
    quant_launches = report["serve_quant"]["int8"]["launches"]
    for name, key, err, src, replaces, n in (
        ("qrlora_bgmv", "qrlora_bgmv_wq", bgmv_err["bfloat16"],
         "src/repro_torch/kernels/csrc/qrlora_bgmv.cu",
         "src/repro/kernels/qrlora_bgmv.py:172", launches["qrlora_bgmv"]),
        ("paged_decode_attention", "paged_decode_attention",
         paged_err["bfloat16"]["max_abs_err"],
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
        ("flash_attention", "flash_attention_B8_S256", flash_err["bfloat16"]["max_abs_err"],
         "src/repro_torch/kernels/csrc/flash_attention.cu",
         "src/repro/kernels/flash_attention.py:69", kb["launches"]["flash_attention"]),
        ("decode_attention", "decode_attention", decode_err["bfloat16"]["max_abs_err"],
         "src/repro_torch/kernels/csrc/decode_attention.cu",
         "src/repro/kernels/decode_attention.py:68", kb["launches"]["decode_attention"]),
        ("qrlora_bgmv_rows", "qrlora_bgmv_rows_wq_bf16", bgmv_rows_err["bfloat16"],
         "src/repro_torch/kernels/csrc/qrlora_bgmv.cu", "src/repro/kernels/qrlora_bgmv.py:375",
         report["serve_sharded"]["bf16"]["launches"]["qrlora_bgmv_rows"]),
        # the float32 route, on the GLUE path (launches over its four modes)
        ("qrlora_matmul_f32_encoder", "qrlora_matmul_f32_M2048_r256", matmul_enc_err,
         "src/repro_torch/kernels/csrc/qrlora_matmul.cu",
         "src/repro/kernels/qrlora_matmul.py:161", glue_launches),
        # qwen2-0.5b's serve under the posture (bf16), at its shapes
        ("qrlora_bgmv_qwen2", "qrlora_bgmv_qwen2_wq", qwen_err["qrlora_bgmv_bfloat16"],
         "src/repro_torch/kernels/csrc/qrlora_bgmv.cu", "src/repro/kernels/qrlora_bgmv.py:172",
         posture["bfloat16"]["runs"]["serving"]["launches"]["qrlora_bgmv"]),
        ("paged_decode_attention_qwen2", "paged_decode_attention_qwen2",
         qwen_err["paged_decode_attention_bfloat16"]["max_abs_err"],
         "src/repro_torch/kernels/csrc/paged_attention.cu",
         "src/repro/kernels/paged_attention.py:116",
         posture["bfloat16"]["runs"]["serving"]["launches"]["paged_decode_attention"]),
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
