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
* the serving posture: full-width qwen2-0.5b cut to 6 of its 24 layers
  (d 896, 14 heads over 2, QKV bias, vocab 151936; random weights and
  biases from ``--seed``, QR-LoRA on ``wq``/``wv`` of the last 4 layers) under
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
  bf16 tokens/s, medians of two alternating serves); ``cancel``
  of a queued and an active request; a prefill and a prefix shipped
  between two engines on the card; three planted faults (no exactly-once
  guard, a cancel that keeps the lane's blocks, an import written from the
  payload's first block); the step-phase breakdown and TTFT/TBT chunked
  against monolithic (bf16);
* the oracle-dense layout on the same weights and traffic:
  ``EngineConfig.oracle_dense(n_lanes=2)`` in float32 and bfloat16, every
  decode dispatch under sync debug mode "error", against the merged-weight
  reference (float32; bf16 teacher-forced), the same with ``quantum=4``
  (bitwise the unsliced serve) and the paged serve of the same traffic;
  two planted faults (a snapshot restored into the other lane, a snapshot
  without its last written position);
* two replicas on the one card behind the adapter-locality router
  (float32): routed against one engine in the paged posture and the
  oracle-dense layout, one replica behind the router, a spill to the
  sibling that imports the home replica's prefix, a replica killed
  mid-serve, and prefill/decode disaggregation; two planted faults (a
  spill import written from the payload's first block, an injected request
  that emits the previous request's first-token row);
* speculative decoding on the same weights and traffic (``speculate_k=4``):
  the paged posture with monolithic prefill in float32 and bf16, the
  truncated-λ drafter (``draft_lam_rank=8``) and the oracle-dense layout
  with ``quantum=4``, each beside its ``speculate_k=0`` twin (float32
  tokens equal, logits within 2e-5; bf16 teacher-forced), base-tenant
  acceptance 1, one shared block forced into a window (its bytes kept,
  the window capped before it), every block with another owner unchanged
  across every step, lanes holding no block past their K/V, the pool
  drained, the draft, verify and commit under sync debug mode "error";
  three planted faults (a window committed whole, rejected both by the
  logits bar and by the acceptance counters of a sound serve of the same
  traffic; the draft's write limit removed; the rollback skipped);
* the λ-store's cold tier on the same weights:
  ``EngineConfig.serving(n_lanes=4, n_slots=3, cold_slots=16)`` (2 usable
  hot slots), 12 tenants, 16 requests of 16 tokens, in float32 and bf16,
  each beside the same traffic on an all-hot engine (13 slots; float32
  tokens equal and logits within 2e-5, bf16 within the drift bar and
  teacher-forced against the merged-weight reference), promotions, spills
  and deferrals counted, every admission gate (promotion and spill) under
  sync debug mode "error", ``lam_cold_bytes`` the cold tenants' bytes; a
  restart on an mmap ``cold_path`` (the second engine finds the same cold
  tenants and digests, promotes their rows bitwise, serves the same
  tokens); three planted faults (a promotion that skips its device write,
  one that returns another slot than it wrote, a gate that takes no
  hot-slot pin);
* the audio family: full-width musicgen-medium (48 layers, d 1536, 24
  heads over 24, d_ff 6144, vocab 2048; random weights from ``--seed``,
  QR-LoRA on ``wq``/``wv`` of the last 4 layers): 4 tenants through the
  default engine in float32 and bf16 against the merged-weight reference
  (bf16 teacher-forced), the bf16 serve profiled; frame embeddings through
  ``apply(embeds=)`` against a prefill and a decode of the same frames; 4
  λ-only bf16 train steps on frame embeddings (batch 4 × seq 256) beside
  their plain twin;
* the moe family: full-width, full-depth moonshot-v1-16b-a3b (48 layers,
  d 2048, 16 heads over 16 of dh 128, 64 experts top-6 of d_ff 1408, vocab
  163840; ≈ 28 B random bf16 weights from ``--seed`` drawn layer by layer on
  the card, the router float32, QR-LoRA on ``wq``/``wv`` of the last 4
  layers): one layer's routed FFN on the card against the CPU at 64 rows
  with drops (the same slots, bitwise run to run); the expert matmuls'
  bf16 route (float32 output, its backward) against autograd of the
  float32 upcast, with a planted fault (a backward from the wrong expert);
  the shipped serve (capacity factor 1.25, the default engine, 4 tenants)
  twice bitwise, its dropped copies per prefill and decode step, profiled;
  its drop-free twin (capacity factor 11) in bf16 teacher-forced against
  the merged-weight reference routed as the engine routed (routed freely,
  bf16 rounding flips near-tie experts and the flips compound over 48
  random layers: the flips are counted), over the whole depth and over the
  adapted layers run on the engine's own residual stream, the drift read
  layer by layer, with two planted faults (decode seg to slot 0,
  unrenormalised top-k gates); 2 λ-only bf16 train steps at batch 8 × seq
  256 in 8 microbatches beside their plain twin (routed as the kernel's
  run; the loss held); then, the bf16 tree freed, the drop-free twin in
  float32 on its last 8 of the 48 layers against the merged-weight
  reference token for token (its routing flips counted), with the same
  two planted faults, and 4 float32 λ-only train steps on the last of
  those layers beside their plain twin and a planted fault (λ of the last
  layer's wq dropped), loss and λ held;
* the vlm family: full-width, full-depth llama-3.2-vision-11b (40 layers
  in 8 groups of 4 self layers and a gated cross layer, d 4096, 32 heads
  over 8, d_ff 14336, vocab 128256, 1600 image rows of width 1280; ≈ 9.8 B
  random bf16 weights from ``--seed``, QR-LoRA on ``wq``/``wv`` of the last
  4 self and the last 4 cross layers, timed; nonzero gates and one random
  λ, both of which start at zero): 4 lanes with 4 distinct stub images
  through ``repro_torch.launch.serve.generate`` (prompts of 32, 16 tokens;
  launches counted), teacher-forced against the merged-weight plain path,
  with three planted faults (the lanes' images permuted, a causal cross
  mask, the cross wv adapter dropped); the same weights on an int8 base; a
  profiled decode step; a float32 twin on the last 2 groups token for
  token against the plain path, with the same faults; 2 λ-only train steps
  with images in 4 microbatches beside their plain twin, in bf16 at full
  depth (the loss held) and in float32 on the 2 groups (the loss and the
  first step's λ gradients held, with a planted fault);
* the recurrent families: full-width, full-depth xlstm-125m (12 layers of
  alternating mLSTM and sLSTM blocks, d 768, 4 heads, vocab 50304; random
  bf16 weights from ``--seed``, QR-LoRA on ``x_qkv`` of the last 4 blocks of
  each kind) through the default engine (the dense layout: no KV cache), 4
  tenants, prompts in buckets 32 and 64, 16 new tokens: float32 (the same
  weights upcast) token for token against the merged-weight reference with
  three planted faults (decode seg sent to slot 0, the mLSTM v adapter
  dropped, the bucket padding left in the recurrent state), bf16
  teacher-forced and profiled, a 2-lane ``quantum=3`` serve bitwise the
  unsliced one; 2 λ-only train steps at batch 8 × seq 256 in bf16 beside a
  plain twin and a float32 twin that holds the loss; one Mamba layer at
  jamba-1.5-large-398b's width (d 8192, d_in 16384) in float32 and bf16, a
  4-lane bucketed prefill and decode steps against the step recurrence;
  reduced jamba (one group of 8 layers) through the engine in the dense
  and paged layouts, float32, token for token against the merged-weight
  reference and paged against dense;
* training: 10 λ-only steps at batch 8 × seq 256 through
  ``repro_torch.launch.train``'s functions, in bfloat16 and float32, each
  held against the same run with the plain version in place of the kernel;
  every train of the script remats its layer groups (``cfg.remat``, the
  default), and its launches are split into the forwards' and the
  recompute's (each group's forward once more in the backward);
* the fault-tolerant train on the bf16 train's model and params: 6 steps
  through ``repro_torch.runtime.TrainLoopRunner`` saving every 2 steps
  (``repro_torch.checkpoint.CheckpointManager``), straight, with a planted
  crash at step 3 (replayed from step 2) and with a SIGTERM at step 4
  resumed to 6 by a new runner, λ and Adam's m and v bitwise the straight
  run's; 2 steps with remat on and off (loss and λ bitwise; peak memory,
  step ms and #3's launches a step each); ``compressed_grad_sync`` on the
  step's λ gradients in a NCCL world of one bitwise the same call on the
  CPU in a gloo world of one; a blocking save, an async save and a restore
  of the whole train state, timed;
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
N 896 and 128, r 160, the BGMV at 2-256 rows; 14 heads over 2 with length-0
lanes) and at musicgen-medium's (K = N = 1536, r 128 at 4 and 64 rows; 24
heads over 24), the one-λ kernel at its train step's (1024 × 1536 × 1536,
r 128, bf16); all three at moonshot-v1-16b-a3b's (K = N = 2048, r 160; 16
heads over 16, dh 128; 256 × 2048 × 2048), and the BGMV and paged kernels
at mixtral-8x22b's (K 6144, N 6144 and 1024, r 256; 48 heads over 8, dh
128), whose 141 B parameters no single card holds; the one-λ kernel and
its quantized twin at llama-3.2-vision-11b's (K 4096, r 256: a 4-lane
decode wq, a cross layer's wv over 6400 image rows, a 1024-row wq).  The one-λ
kernel is also checked at the encoder's shapes (float32 x,
M = 2048, 768 and a ragged 100, K = N = 768, r = 256 and 2), its backward
with LoRA's dB and dA against autograd, and ``qr_pivoted`` at 768 × 768
captured whole in one CUDA graph, replayed bitwise.  The BGMV kernel is
checked at xlstm-125m's x_qkv (K 1536 × N 4608 and K 768 × N 3072, r 160)
and jamba-1.5-large's wq/wv (K 8192, N 8192 and 1024, r 256), the paged
kernel at jamba's 64 heads over 8 (dh 128), the one-λ kernel at the xlstm
train step's x_qkv, and both adapter kernels on the mLSTM v projection, a
column slice read by row stride (bitwise the contiguous call; rows read N
apart rejected).

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
import gc
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


def _strided(t, ld: int):
    """``t`` (rows, N) as the last N columns of a (rows, ld) matrix whose
    other columns hold 1e3 (a kernel that reads them is far off): the same
    values, rows ld apart."""
    import torch

    rows, N = t.shape
    wide = torch.full((rows, ld), 1e3, dtype=t.dtype, device=t.device)
    wide[:, ld - N:] = t
    return wide[:, ld - N:]


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


def time_bgmv(gen, N: int, M: int = 4, K: int = 576, r: int = 128, ld: int = 0):
    """wq (N=576) / wv (N=192) projection, bf16: 4 decode lanes, or a
    prefill bucket of M rows (smollm-135m's K and rank cap unless given);
    with ``ld`` W and A are the last N columns of (·, ld) matrices (rows
    read by stride, as the xLSTM v projection's)."""
    import torch
    from repro_torch.benchmarks.common import eager_ms, graph_ms, launch_us
    from repro_torch.kernels.qrlora_bgmv import qrlora_bgmv_cuda
    from repro_torch.kernels.ref import qrlora_bgmv_ref

    n_slots = 8
    x, W, B, A, lam, seg = _bgmv_inputs(gen, M, K, N, r, n_slots, torch.bfloat16)
    if ld:
        W, A = _strided(W, ld), _strided(A, ld)
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
    res["shape"] = {"M": M, "K": K, "N": N, "r": r, "n_slots": n_slots, "dtype": "bfloat16",
                    "ld": ld or N}
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
               max_blocks: int = 8, dh: int = 64):
    """One decode attend of the serving shapes: 4 lanes, block 16, bf16;
    smollm-135m's 9 heads over 3 of dh 64 through a 4-block attend bound
    unless given."""
    import torch
    from repro_torch.benchmarks.common import eager_ms, graph_ms, launch_us
    from repro_torch.kernels.paged_attention import paged_decode_attention_cuda
    from repro_torch.kernels.ref import paged_decode_attention_ref

    bs = 16
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


def time_matmul(gen, N: int, M: int = 2048, K: int = 576, r: int = 128, ld: int = 0):
    """wq (N=576) / wv (N=192) projection of a training step: batch 8 ×
    seq 256 = 2048 rows, bf16 (smollm-135m's K and rank cap unless given);
    ``ld`` as :func:`time_bgmv`'s."""
    import torch
    from repro_torch.benchmarks.common import eager_ms, graph_ms, launch_us
    from repro_torch.kernels.qrlora_matmul import qrlora_matmul_cuda
    from repro_torch.kernels.ref import qrlora_matmul_ref

    x, W, B, A, lam = _matmul_inputs(gen, M, N, torch.bfloat16, K, r, rank=r)
    if ld:
        W, A = _strided(W, ld), _strided(A, ld)
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
    res["shape"] = {"M": M, "K": K, "N": N, "r": r, "dtype": "bfloat16", "ld": ld or N}
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


def time_matmul_quant(gen, M: int, N: int, base: str, K: int = 576, r: int = 128):
    """The one-λ projection on a quantized base: M rows (a scoring forward's
    sequence, or 2048), bf16 x, int8 or fp8 q (smollm-135m's K and rank cap
    unless given)."""
    import torch
    from repro_torch.benchmarks.common import eager_ms, graph_ms, launch_us
    from repro_torch.kernels.qrlora_matmul import qrlora_matmul_quant_cuda
    from repro_torch.kernels.ref import qrlora_matmul_quant_ref

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


def _union(spans):
    """The disjoint cover of ``spans`` ((start, end) pairs), in order."""
    out = []
    for a, b in sorted(spans):
        if out and a <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], b))
        else:
            out.append((a, b))
    return out


# names torch.profiler's own event list leaves out (its _filter_name)
_UNLISTED_EVENTS = frozenset((
    "[memory]", "[OutOfMemory]", "profiler::_record_function_enter",
    "profiler::_record_function_enter_new", "profiler::_record_function_exit",
    "aten::is_leaf", "aten::output_nr", "aten::_version"))


def _profile_events(prof):
    """The events of a finished torch.profiler run as (name, on the device,
    start µs, end µs, self host µs) tuples, read straight from its kineto
    results: the records and host self times ``prof.events()`` gives, without
    building its per-event objects and call tree (minutes over a whole
    script's profiles).  A host event's self time is its span less its
    direct children's on the same thread, a CUDA runtime call counted on the
    thread of the operator that made it; asynchronous and device events have
    none, as in ``FunctionEvent.self_cpu_time_total``."""
    from torch.autograd import DeviceType

    res = prof.profiler.kineto_results
    t0 = res.trace_start_ns()
    rows, front, linked = [], {}, []
    for k in res.events():
        name = k.name()
        if name in _UNLISTED_EVENTS or getattr(k, "is_hidden_event", lambda: False)():
            continue
        dev = k.device_type()
        tid = k.start_thread_id()
        is_async = k.is_async() or tid != k.end_thread_id()
        row = [name, dev == DeviceType.CUDA, (k.start_ns() - t0) / 1000,
               (k.end_ns() - t0) / 1000, tid, dev == DeviceType.CPU and not is_async]
        rows.append(row)
        corr = k.linked_correlation_id()
        if corr > 0:
            linked.append((corr, row))
        elif row[5]:
            front.setdefault(k.correlation_id(), row)
    for corr, row in linked:
        op = front.get(corr)
        if op is not None:
            row[4] = op[4]
    child = [0.0] * len(rows)
    nested = sorted((i for i, r in enumerate(rows) if r[5]),
                    key=lambda i: (rows[i][4], rows[i][2], -rows[i][3]))
    stack, thread = [], None
    for i in nested:
        _, _, a, b, tid, _ = rows[i]
        if tid != thread:
            stack, thread = [], tid
        while stack and (a >= rows[stack[-1]][3] or b > rows[stack[-1]][3]):
            stack.pop()
        if stack:
            child[stack[-1]] += b - a
        stack.append(i)
    return [(r[0], r[1], r[2], r[3], (r[3] - r[2] - child[i]) if r[5] else 0.0)
            for i, r in enumerate(rows)]


def _device_busy(prof, wall_us: float, api_calls: bool = False, skip=(), events=None):
    """Union of the device-kernel intervals of a torch.profiler run: busy
    time, idle share of ``wall_us``, kernel count, the top kernels by device
    time, the device time and share of busy of each of the port's own
    kernels (:data:`PORT_KERNELS`), and the top host
    operations by self time (ms, calls): where a host-bound run spends its
    host.  With ``api_calls``, also the count of every CUDA API call
    (``cuda*`` and ``cu*``: launches, copies, syncs): the device work the
    run asked for, exactly (the device records themselves can drop a few).
    Device events named in ``skip`` (the device side of
    ``record_function`` ranges) are not kernels and are left out.
    ``events``: :func:`_profile_events` of ``prof`` where the caller has
    read them already."""
    spans, by_name, host = [], {}, {}
    for name, on_device, a, b, self_us in events or _profile_events(prof):
        if on_device and name in skip:
            continue
        if not on_device:
            t, n = host.get(name, (0.0, 0))
            host[name] = (t + self_us, n + 1)
            continue
        spans.append((a, b))
        by_name[name] = by_name.get(name, 0.0) + (b - a)
    busy = sum(b - a for a, b in _union(spans))
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
          base_dtype: str = "bf16", params=None, arch: str = "smollm-135m",
          cfg_overrides=None, **shard):
    """Serve one request per tenant through the default engine (``arch``
    at full width, its config's ``cfg_overrides`` applied, with
    ``base_dtype`` and the ``shard_lam``/``shard_ba`` flags in ``shard``, on
    ``params`` when given); returns the engine, the tenants' λ trees and
    timings.  The tenants and the traffic depend on ``seed`` only."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.serving import EngineConfig, MultiTenantEngine, random_lambda

    cfg = get_config(arch).replace(dtype=dtype, **(cfg_overrides or {}))
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


# the profiled smollm-135m serves take 3 of the 6 tenants' requests, to keep
# the whole script within its time limit (PERF.md §4)
SMOLLM_PROFILE_TENANTS = 3


def profile_serve(engine, seed: int, n_tenants: int = SMOLLM_PROFILE_TENANTS,
                  gen_len: int = 16, host_ops: bool = True):
    """The same traffic served again (weights and kernels warm) under
    torch.profiler: wall time, the union of device-kernel intervals (busy
    time) and device time by kernel name; without ``host_ops`` the CUDA
    activity alone (kernels and CUDA API calls: far fewer events to
    parse)."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    for i in range(n_tenants):
        n = int(rng.integers(16, 49))
        engine.submit(f"tenant{i}", rng.integers(2, engine.cfg.vocab_size, size=n), gen_len)
    steps0, toks0 = engine.steps, engine.decoded_tokens
    acts = [torch.profiler.ProfilerActivity.CUDA]
    if host_ops:
        acts.append(torch.profiler.ProfilerActivity.CPU)
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


#: True while a ``Tensor.backward`` runs under :func:`recompute_launches`
_IN_BACKWARD = [False]


@contextlib.contextmanager
def recompute_launches(out: dict):
    """Run with ``Tensor.backward`` adding into ``out`` the kernel launches
    it makes.  The one-λ matmul's hand-written backward launches no kernel,
    so these are remat's recompute of the forward (``cfg.remat``), and a
    train's launches less these are its forwards'."""
    import torch
    from repro_torch import kernels

    backward = torch.Tensor.backward
    for name in kernels.KERNEL_WRAPPERS:
        out.setdefault(name, 0)

    def counted(self, *args, **kw):
        before = kernels.launch_counts()
        _IN_BACKWARD[0] = True
        try:
            return backward(self, *args, **kw)
        finally:
            _IN_BACKWARD[0] = False
            for name, n in kernels.launch_counts().items():
                out[name] += n - before[name]

    with swapped(torch.Tensor, "backward", counted):
        yield out


def check_train_launches(where: str, tr: dict, matmuls: int, nested: bool = False) -> None:
    """A train's launches (``tr["launches_kernel"]``, its recompute's
    ``tr["launches_recompute"]``, its plain twin's): the forwards launch
    #3 ``matmuls`` times and no other kernel, the twin none.  Remat's
    backward recomputes each group's forward once (``matmuls`` again) or,
    where positions are checkpointed inside the group (``nested``: vlm,
    ssm, hybrid), once more for a position whose saved tensors its own
    backward needs: between ``matmuls`` and twice that."""
    zero = {name: 0 for name in tr["launches_kernel"]}
    rec = tr["launches_recompute"]
    fwd = {k: n - rec[k] for k, n in tr["launches_kernel"].items()}
    n_rec = rec["qrlora_matmul"]
    rec_ok = matmuls <= n_rec <= 2 * matmuls if nested else n_rec == matmuls
    _check(fwd == {**zero, "qrlora_matmul": matmuls} and rec_ok
           and rec == {**zero, "qrlora_matmul": n_rec}
           and tr["launches_plain_twin"] == zero,
           f"{where}: launches {tr['launches_kernel']}, {rec} of them in the backward's "
           f"recompute (twin {tr['launches_plain_twin']}); want {matmuls} qrlora_matmul in "
           f"the forwards, {'up to twice ' if nested else ''}as many recomputed, and no "
           f"other kernel")


def planted_faults(cfg, engine, lams, done, drift: float = BF16_DRIFT):
    """Controls for the bf16 checks: tenant0's request served again under
    three planted faults, each of which the teacher-forced check (at
    ``drift``) must reject.  Returns each fault's row of
    :func:`verify_forced`."""
    import numpy as np
    from repro_torch.kernels import ops

    req0 = next(r for r in done.values() if r.tenant == "tenant0")
    lam0 = lams["tenant0"]

    def serve_one(tenant):
        engine.submit(tenant, req0.prompt, len(req0.tokens))
        return verify_forced(cfg, engine, {tenant: lam0}, engine.run(), drift)[0]

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


def verify_forced(cfg, engine, lams, done, drift: float = BF16_DRIFT, forward=None):
    """Teacher-forced check for bfloat16, where merged weights round
    differently from the fused adapter path and greedy streams may part at
    near-ties: the merged-weight reference runs one forward over each
    tenant's prompt plus the engine's own tokens, so both see the same
    context.  At every generated position the engine's logits must agree
    with the reference's within ``drift`` of the row's largest |logit|, and
    the engine's token must be within that margin of the reference's best.
    ``forward(req, merged, tokens)`` → logits (1, S, V), when given, stands
    in for the reference's forward (the moe phase forces the engine's
    routing there, or runs only the adapted layers)."""
    import numpy as np
    import torch
    from repro_torch.models import build_model
    from repro_torch.serving import merge_tenant_params

    if forward is None:
        model = build_model(cfg, engine.device)
        forward = lambda req, merged, tokens: model.apply(merged, tokens)
    rows = []
    for uid in sorted(done):
        req = done[uid]
        P = req.prompt.size
        seq = np.concatenate([req.prompt, np.asarray(req.tokens[:-1], np.int32)])
        merged = merge_tenant_params(engine.params, cfg, lams[req.tenant])
        with torch.no_grad():
            ref = forward(req, merged, torch.from_numpy(seq).to(engine.device)[None])[0, P - 1:]
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
    if profile:  # the CUDA activity alone (PERF.md §4)
        out["profile"] = profile_serve(engine, seed + 1, host_ops=False)
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

# 10 steps: cut from 30 (15 since the audio phase, 10 since the moe phase)
# so that the whole script stays within its time limit (PERF.md §4)
TRAIN_STEPS, TRAIN_BATCH, TRAIN_SEQ, TRAIN_LR = 10, 8, 256, 3e-3
# A train through the kernel against the same train with the plain version
# in place of the kernel (same params, batches and backward): the largest
# per-step |Δloss|, and the largest |Δλ| over the twin's largest |λ|.  Set
# from full-width readings of 30 steps on an H100 at --seed 0 (PERF.md,
# Findings):
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


def train_run(model, params, seed: int, log_every: int = 0, steps: int = TRAIN_STEPS):
    """``steps`` λ-only steps from λ = 0 through the train launcher's
    functions; returns (state, per-step history)."""
    from repro_torch.launch import train as tl
    from repro_torch.training import init_train_state

    state = init_train_state(model, params=params)
    step_fn = tl.make_step(model, TRAIN_LR, TRAIN_STEPS)
    data = tl.batches(model.cfg, TRAIN_BATCH, TRAIN_SEQ, seed, model.device)
    return tl.train(step_fn, state, data, steps, log_every=log_every, log=print)


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


def train_phase(dtype: str, seed: int, log_every: int = 0, keep: dict = None):
    """The train, its plain-version twin and the planted forward fault, at
    one dtype; the bfloat16 train is also profiled.  ``keep`` (a dict)
    receives the model and its params for the fault-tolerant train."""
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
            with recompute_launches(out.setdefault("launches_recompute", {})):
                runs[name] = train_run(model, params, seed, log_every)
        else:
            with swapped(mm, "qrlora_matmul", fwd):  # the backward stays the hand-written one
                runs[name] = train_run(model, params, seed)
        torch.cuda.synchronize()
        out[f"launches_{name}"] = kernels.launch_counts()
    if keep is not None:
        keep.update(model=model, params=params)
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


# ---------------------------------------------------------------------------
# the fault-tolerant train: checkpoints, crash and preemption, remat,
# compressed gradients (full-width bf16 smollm-135m, the train phase's)
# ---------------------------------------------------------------------------

# 6 steps saved every 2: a crash at step 3 replays from step 2, a
# preemption at step 4 leaves step 4 for a new runner to resume to 6
FT_STEPS, FT_SAVE_EVERY, FT_CRASH_AT, FT_PREEMPT_AT = 6, 2, 3, 4
REMAT_STEPS = 2


class _RunawayRestarts(BaseException):
    """Raised past ``TrainLoopRunner``'s catch (it catches Exception): a run
    restarted more often than its planted faults ask."""


def ft_run(model, params, seed: int, root: str, total: int = FT_STEPS, crash_at=None,
           preempt_at=None, restarts_allowed: int = 0):
    """A ``TrainLoopRunner`` (save every FT_SAVE_EVERY, ``CheckpointManager``
    keep 3 under ``root``) over the train launcher's step and batches from λ
    = 0, run to ``total`` steps; a planted crash (RuntimeError) the first
    time step ``crash_at`` starts, a SIGTERM to this process when step
    ``preempt_at`` starts.  Returns (runner, state, step)."""
    import signal
    import threading

    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.launch import train as tl
    from repro_torch.runtime import TrainLoopRunner
    from repro_torch.training import init_train_state

    crashed = []

    def inject(step):
        if runner.restarts > restarts_allowed:
            raise _RunawayRestarts(f"{runner.restarts} restarts, {restarts_allowed} planted")
        if step == crash_at and not crashed:
            crashed.append(step)
            raise RuntimeError(f"planted failure at step {step}")
        if step == preempt_at:
            _check(threading.current_thread() is threading.main_thread(),
                   "the preemption drill needs the main thread (its SIGTERM handler)")
            signal.raise_signal(signal.SIGTERM)

    runner = TrainLoopRunner(
        tl.make_step(model, TRAIN_LR, FT_STEPS),
        lambda start: tl.batches(model.cfg, TRAIN_BATCH, TRAIN_SEQ, seed, model.device, start),
        CheckpointManager(root, keep=3), save_every=FT_SAVE_EVERY, log_every=total + 1,
        failure_injector=inject, log_fn=lambda line: print(f"  {line}"))
    state, step, _ = runner.run(init_train_state(model, params=params), total)
    return runner, state, step


def ft_leaves(state):
    """λ, Adam's m and v: the leaves a resumed run must match bitwise."""
    from repro_torch.tree import tree_leaves

    return (tree_leaves(state["trainable"]) + tree_leaves(state["opt"]["m"])
            + tree_leaves(state["opt"]["v"]))


def ft_bitwise(a, b) -> bool:
    return a["opt"]["step"] == b["opt"]["step"] and all(
        torch_equal(x, y) for x, y in zip(ft_leaves(a), ft_leaves(b)))


def torch_equal(a, b) -> bool:
    import torch

    return a.shape == b.shape and a.dtype == b.dtype and torch.equal(a.detach(), b.detach())


def _dir_bytes(path: str) -> int:
    return sum(os.path.getsize(os.path.join(d, f)) for d, _, fs in os.walk(path) for f in fs)


def ft_checkpoint_cost(state, root: str) -> dict:
    """One blocking save, one async save (the caller's return and the
    write's end) and one restore of the whole train state, the frozen base
    included, as the launcher saves it; the restore bitwise the state."""
    import torch
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.tree import tree_leaves

    ckpt = CheckpointManager(root, keep=3)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ckpt.save(1, state, blocking=True)
    t_block = time.perf_counter() - t0
    t0 = time.perf_counter()
    ckpt.save(2, state, blocking=False)
    t_call = time.perf_counter() - t0
    ckpt.wait()
    t_async = time.perf_counter() - t0
    t0 = time.perf_counter()
    restored, meta = ckpt.restore(state)
    torch.cuda.synchronize()
    t_restore = time.perf_counter() - t0
    return {"bytes": _dir_bytes(ckpt.path(2)), "save_blocking_s": t_block,
            "save_async_call_s": t_call, "save_async_total_s": t_async,
            "restore_s": t_restore, "meta_step": meta["step"],
            "restore_bitwise": ft_bitwise(restored, state) and all(
                torch_equal(x, y) for x, y in zip(tree_leaves(restored["frozen"]),
                                                  tree_leaves(state["frozen"])))}


def remat_twins(model, params, seed: int) -> dict:
    """REMAT_STEPS steps from λ = 0 with ``cfg.remat`` on (the default) and
    off, on the same params and batches: the losses and λ, peak device
    memory above what the run started with (``max_memory_allocated`` after
    ``reset_peak_memory_stats``), median step ms and #3's launches a step."""
    import torch
    from repro_torch import kernels
    from repro_torch.models import build_model
    from repro_torch.tree import tree_leaves

    out, runs = {}, {}
    for remat in (True, False):
        m = build_model(model.cfg.replace(remat=remat), model.device)
        gc.collect()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        start = torch.cuda.memory_allocated()
        kernels.reset_launch_counts()
        runs[remat] = train_run(m, params, seed, steps=REMAT_STEPS)
        torch.cuda.synchronize()
        launches = kernels.launch_counts()
        hist = runs[remat][1]
        out[f"remat_{remat}"] = {
            "peak_bytes": torch.cuda.max_memory_allocated(),
            "peak_above_start_bytes": torch.cuda.max_memory_allocated() - start,
            "start_bytes": start, "step_ms": [h["ms"] for h in hist],
            "median_step_ms": statistics.median(h["ms"] for h in hist),
            "qrlora_matmul_per_step": launches["qrlora_matmul"] / REMAT_STEPS,
            "launches": launches}
    (s_on, h_on), (s_off, h_off) = runs[True], runs[False]
    out["losses_bitwise"] = [a["loss"] for a in h_on] == [b["loss"] for b in h_off]
    out["lam_bitwise"] = all(torch_equal(a, b) for a, b in zip(
        tree_leaves(s_on["trainable"]), tree_leaves(s_off["trainable"])))
    out["losses"] = [h["loss"] for h in h_on]
    return out


def compressed_sync_twins(model, params, seed: int) -> dict:
    """``compressed_grad_sync`` twice (the second with the first's residual)
    on one step's λ gradients in a NCCL world of one on the card, and on the
    same gradients copied to the CPU in a gloo world of one: synced
    gradients and residuals bitwise; the first sync within half a
    quantization step of the gradients."""
    import torch
    from repro_torch.launch import train as tl
    from repro_torch.launch.serve_multi import process_group
    from repro_torch.optim.compression import compressed_grad_sync
    from repro_torch.training import init_train_state
    from repro_torch.tree import tree_leaves, tree_map

    state = init_train_state(model, params=params)
    step_fn = tl.make_step(model, TRAIN_LR, FT_STEPS)
    step_fn(state, next(tl.batches(model.cfg, TRAIN_BATCH, TRAIN_SEQ, seed, model.device)))
    # the step left its gradients on the first state's λ leaves
    grads = tree_map(lambda p: p.grad.detach().clone(), state["trainable"])
    outs = []
    for device in (model.device.type, "cpu"):
        g = tree_map(lambda t: t.to(device), grads)
        with process_group(device):
            backend = torch.distributed.get_backend()
            s1, e1 = compressed_grad_sync(g, None)
            s2, e2 = compressed_grad_sync(g, e1)
        outs.append((backend, [tree_leaves(t) for t in (s1, e1, s2, e2)]))
    (b_card, card), (b_cpu, cpu) = outs
    bitwise = all(torch_equal(a.cpu(), b) for xs, ys in zip(card, cpu) for a, b in zip(xs, ys))
    g_leaves = tree_leaves(grads)
    scale = [float(t.abs().max()) / 127 for t in g_leaves]
    err = max(float((s.cpu() - g.cpu()).abs().max()) / sc
              for s, g, sc in zip(card[0], g_leaves, scale))
    return {"backends": [b_card, b_cpu], "bitwise": bitwise, "leaves": len(g_leaves),
            "elements": sum(t.numel() for t in g_leaves),
            "first_sync_err_over_scale": err}


def ft_phase(seed: int, model, params) -> dict:
    """The fault-tolerant train on the train phase's full-width bf16
    smollm-135m: a straight run, a crashed one and a preempted one resumed
    by a new runner (λ, m, v bitwise the straight run's), the remat twins,
    the compressed sync on NCCL against gloo, and the checkpoint's cost."""
    import shutil
    import tempfile

    import torch
    from repro_torch import kernels

    out, t_phase = {}, time.perf_counter()
    root = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    try:
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        r, straight, step = ft_run(model, params, seed, os.path.join(root, "straight"))
        out["straight"] = {"step": step, "restarts": r.restarts, "s": time.perf_counter() - t0,
                           "saved": r.ckpt.all_steps()}
        t0 = time.perf_counter()
        r, crashed, step = ft_run(model, params, seed, os.path.join(root, "crash"),
                                  crash_at=FT_CRASH_AT, restarts_allowed=1)
        out["crash"] = {"step": step, "restarts": r.restarts, "s": time.perf_counter() - t0,
                        "bitwise": ft_bitwise(crashed, straight)}
        t0 = time.perf_counter()
        r, _, step = ft_run(model, params, seed, os.path.join(root, "preempt"),
                            preempt_at=FT_PREEMPT_AT)
        out["preempt"] = {"step": step, "latest_step": r.ckpt.latest_step(),
                          "restarts": r.restarts}
        r, resumed, step = ft_run(model, params, seed, os.path.join(root, "preempt"))
        out["preempt"].update(resumed_step=step, resumed_restarts=r.restarts,
                              s=time.perf_counter() - t0,
                              bitwise=ft_bitwise(resumed, straight))
        torch.cuda.synchronize()
        out["launches"] = kernels.launch_counts()
        # every step of the four runs: the straight run's, the crashed run's
        # up to its crash and again from its last save, the preempted run's
        # and its resumption's
        last_save = FT_CRASH_AT // FT_SAVE_EVERY * FT_SAVE_EVERY
        out["steps_run"] = FT_STEPS + FT_CRASH_AT + (FT_STEPS - last_save) + FT_STEPS
        out["remat"] = remat_twins(model, params, seed)
        out["compressed_sync"] = compressed_sync_twins(model, params, seed)
        out["checkpoint"] = ft_checkpoint_cost(straight, os.path.join(root, "cost"))
    finally:
        shutil.rmtree(root, ignore_errors=True)
    out["s"] = time.perf_counter() - t_phase
    return out


def print_ft(ft: dict, smi: str) -> None:
    c, p = ft["crash"], ft["preempt"]
    print(f"fault-tolerant train (smollm-135m bf16, batch {TRAIN_BATCH} × seq {TRAIN_SEQ}, "
          f"{FT_STEPS} steps saved every {FT_SAVE_EVERY}): straight {ft['straight']}; crash at "
          f"step {FT_CRASH_AT}: {c}; SIGTERM at step {FT_PREEMPT_AT} then a new runner: {p}; "
          f"launches {ft['launches']} over {ft['steps_run']} steps")
    for on in (True, False):
        r = ft["remat"][f"remat_{on}"]
        print(f"  remat {'on ' if on else 'off'}: peak {r['peak_bytes'] / 1e9:.3f} GB "
              f"({r['peak_above_start_bytes'] / 1e9:.3f} GB above the {r['start_bytes'] / 1e9:.3f}"
              f" GB held at the start); median step {r['median_step_ms']:.1f} ms (steps "
              f"{r['step_ms']}); qrlora_matmul {r['qrlora_matmul_per_step']:.0f} a step; on {smi}")
    print(f"  remat on against off: losses bitwise {ft['remat']['losses_bitwise']}, λ bitwise "
          f"{ft['remat']['lam_bitwise']} ({ft['remat']['losses']})")
    print(f"  compressed_grad_sync, NCCL world of one against gloo: {ft['compressed_sync']}")
    k = ft["checkpoint"]
    print(f"  checkpoint of the whole train state: {k['bytes']} B; save blocking "
          f"{k['save_blocking_s']:.3f} s, async {k['save_async_call_s']:.3f} s to return and "
          f"{k['save_async_total_s']:.3f} s to the write's end; restore {k['restore_s']:.3f} s "
          f"(bitwise {k['restore_bitwise']}); the phase {ft['s']:.1f} s")


def check_ft(ft: dict, n_layers: int) -> None:
    st, c, p = ft["straight"], ft["crash"], ft["preempt"]
    _check(st["step"] == FT_STEPS and st["restarts"] == 0
           and st["saved"] == list(range(FT_SAVE_EVERY, FT_STEPS + 1, FT_SAVE_EVERY))[-3:],
           f"fault-tolerant train: the straight run {st}")
    _check(c["step"] == FT_STEPS and c["restarts"] == 1 and c["bitwise"],
           f"fault-tolerant train: the crashed run is not the straight run, bitwise: {c}")
    _check(p["step"] == p["latest_step"] == FT_PREEMPT_AT and p["restarts"] == 0
           and p["resumed_step"] == FT_STEPS and p["resumed_restarts"] == 0 and p["bitwise"],
           f"fault-tolerant train: the preempted and resumed run is not the straight run: {p}")
    zero = {name: 0 for name in ft["launches"]}
    # a forward and remat's recompute: wq and wv of every layer, twice
    _check(ft["launches"] == {**zero, "qrlora_matmul": 4 * n_layers * ft["steps_run"]},
           f"fault-tolerant train: launches {ft['launches']} over {ft['steps_run']} steps")
    rm = ft["remat"]
    _check(rm["losses_bitwise"] and rm["lam_bitwise"]
           and rm["remat_True"]["qrlora_matmul_per_step"] == 4 * n_layers
           and rm["remat_False"]["qrlora_matmul_per_step"] == 2 * n_layers,
           f"remat changed the train, or #3 did not recompute: {rm}")
    cs = ft["compressed_sync"]
    _check(cs["backends"] == ["nccl", "gloo"] and cs["bitwise"]
           and cs["first_sync_err_over_scale"] <= 0.5 * (1 + 1e-5),
           f"compressed_grad_sync on NCCL is not the gloo sync bitwise: {cs}")
    k = ft["checkpoint"]
    _check(k["restore_bitwise"] and k["meta_step"] == 2 and k["bytes"] > 0,
           f"checkpoint save/restore: {k}")


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
# its depth here: 6 of its 24 layers at the published widths (the 4 adapted
# ones and 2 below them), a run-length cut that keeps the script's
# qwen2-0.5b phases (posture, request API, dense layout, router, speculation,
# cold tier: 418 s of 1,029 at 24 layers on an H100) well inside its time
# limit (PERF.md §4)
QWEN_LAYERS = 6
# the posture's engine: block 16, watermark 1, chunks of 32 tokens a step
QWEN_ENGINE = {"n_lanes": 4, "n_slots": 8, "max_len": 384, "collect_logits": True}
# the oracle-dense layout's engine: 2 lanes, each a (384, 2, 64) K/V region
DENSE_ENGINE = {"n_lanes": 2, "n_slots": 8, "max_len": 384, "collect_logits": True}
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
# lanes, the speculative verify's 4 lanes × 5 window rows, a 32-row prefill
# chunk, the 64-row bucket of a short prompt that misses the prefix cache,
# and the 128- and 256-row buckets of the monolithic serves
QWEN_BGMV_SHAPES = [(M, 896, N, 160) for M in (4, 20, 32, 64, 128, 256) for N in (896, 128)]
# #2 at 14 heads over 2 (7 query heads a group), dh 64: (lengths, columns of
# a 24-column table); length-0 lanes, the serve's attend bounds of 8 columns
# (short lanes only; a cluster of 2) and 16 (a long lane decoding; 4), a
# 4-column bound (one CTA a group pair, no cluster) and the whole table; the
# same bounds over the 1-lane spill replicas and the 2-lane paged serve
QWEN_PAGED_CASES = (((0, 1, 17, 240), 16), ((240, 100, 0, 33), 24), ((0, 0, 16, 15), 16),
                    ((0, 57, 80, 128), 8), ((72, 0, 96, 65), 8), ((64, 0, 3, 49), 4),
                    ((57,), 8), ((88,), 8), ((161,), 16), ((236,), 16), ((49,), 4),
                    ((57, 80), 8), ((0, 72), 8), ((236, 64), 16), ((0, 161), 16),
                    ((33, 49), 4))


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


def qwen_cfg(dtype: str):
    """qwen2-0.5b's config at its widths, :data:`QWEN_LAYERS` deep."""
    from repro_torch.configs import get_config

    return get_config(QWEN).replace(dtype=dtype, n_layers=QWEN_LAYERS)


def qwen_config(seed: int, dense: bool = False, **overrides):
    """The posture's ``EngineConfig.serving(**QWEN_ENGINE, **overrides)``,
    or with ``dense`` ``EngineConfig.oracle_dense(**DENSE_ENGINE,
    **overrides)``."""
    from repro_torch.serving import EngineConfig

    if dense:
        return EngineConfig.oracle_dense(seed=seed, **{**DENSE_ENGINE, **overrides})
    return EngineConfig.serving(seed=seed, **{**QWEN_ENGINE, **overrides})


def qwen_engine(dtype: str, seed: int, params=None, dense: bool = False, **overrides):
    """qwen2-0.5b at full width under :func:`qwen_config`, 4 tenants
    registered (λ from ``seed``).  Without ``params``: random weights from
    ``seed`` (QR-LoRA built on the card), the QKV biases drawn too (the
    config's init leaves them zero).  Returns (cfg, engine, λ trees)."""
    import torch
    from repro_torch.serving import MultiTenantEngine, random_lambda

    cfg = qwen_cfg(dtype)
    engine = MultiTenantEngine(cfg, qwen_config(seed, dense, **overrides), params=params)
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
    """Serve ``traffic`` (16 tokens a request) to the end (a paged or a
    dense engine; the pool readings are None on a dense one).  With
    ``fork_tail``, once the first
    request decodes, take a reference on its private tail block as another
    owner would, so that its next write must fork a copy; after the run
    ``tail_kept`` says whether that block still holds what it held then.
    Returns the readings (``done``: uid → request)."""
    import torch

    pc, al = engine.prefix_cache, engine.allocator
    hits0, misses0 = (pc.hits, pc.misses) if pc is not None else (0, 0)
    counters = ("cow_forks", "preemptions", "chunked_admissions", "chunk_dispatches", "steps",
                "slice_preemptions", "decoded_tokens")
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
            "pool_peak": al.peak_in_use if al is not None else None,
            "pool_capacity": al.capacity if al is not None else None,
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
    """qwen2-0.5b at full width (6 of 24 layers, d 896, 14 heads over 2, QKV
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
# alternating bf16 serves: telemetry on, off, and monolithic (3 rounds
# before the whole script needed the time; PERF.md §4)
API_ROUNDS = 2


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
    # parse) are left out.  An engine of an earlier phase that is garbage (its
    # telemetry callbacks make reference cycles) frees its pinned input
    # buffers when the collector reaches it, and each such free records a
    # CUDA event: collect before each serve and keep the collector off inside
    # it, so that the calls counted are the serve's own
    prof = {}
    for name in ("on", "off"):
        eng = engines[name]
        eng.release_prefix_cache()
        gc.collect()
        gc.disable()
        try:
            with torch.profiler.profile(
                    activities=[torch.profiler.ProfilerActivity.CUDA]) as p:
                t0 = time.perf_counter()
                stream_serve(eng, traffic)
                wall_us = (time.perf_counter() - t0) * 1e6
        finally:
            gc.enable()
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


# ---------------------------------------------------------------------------
# the oracle-dense layout, time-slicing and the router at full width:
# qwen2-0.5b on the posture phase's weights and traffic
# ---------------------------------------------------------------------------

DENSE_QUANTUM = 4
# #1 at the decode steps of this phase's 1- and 2-lane engines (the spill
# replicas; the dense, paged and routed dense serves) and at the 2-lane
# dense speculative verify's 2 × 5 window rows, qwen2-0.5b's wq and wv
DENSE_BGMV_SHAPES = [(M, 896, N, 160) for M in (1, 2, 10) for N in (896, 128)]
# a spilled or failed-over stream against one engine's: bitwise where both
# took the same path, else identical tokens and float32 |Δlogits| within the
# chunked-prefill bar (another prefill path, or another attend bound of #2
# where other lanes share the step, round differently); disaggregated
# streams are held bitwise, routed ones too unless the router spilled a
# request: a spill leaves the tenant's prefix uncached on its primary, so a
# later request of that tenant may take another prefill path there, and
# such a stream is held as a spilled one
ROUTE_FP32_TOL = QWEN_CHUNK_FP32_TOL


def check_dense_bgmv(gen, details):
    """#1 against its plain version at :data:`DENSE_BGMV_SHAPES` in bf16 and
    float32 x (8 slots, the last row on slot 7 so that a 1-row step is
    adapted), through kernel_bench.TOL; a second call bitwise the first.
    Returns the worst |Δ| by dtype."""
    import torch
    from repro_torch.kernels.qrlora_bgmv import qrlora_bgmv_cuda
    from repro_torch.kernels.ref import qrlora_bgmv_ref

    worst = {}
    for dt in (torch.bfloat16, torch.float32):
        name = str(dt).split(".")[1]
        for M, K, N, r in DENSE_BGMV_SHAPES:
            x, W, B, A, lam, seg = _bgmv_inputs(gen, M, K, N, r, 8, dt)
            seg[-1] = 7
            y = qrlora_bgmv_cuda(x, W, B, A, lam, seg, 0.7)
            again = qrlora_bgmv_cuda(x, W, B, A, lam, seg, 0.7)
            torch.cuda.synchronize()
            ref = qrlora_bgmv_ref(x, W, B, A, lam, seg, 0.7)
            err = _max_err(y, ref)
            ok = (_within(y, ref, _tol("qrlora_bgmv", dt)) and bool(torch.isfinite(y).all())
                  and torch.equal(y, again))
            details.append({"kernel": "qrlora_bgmv", "arch": QWEN, "path": "1-2 lane decode",
                            "x": name, "M": M, "K": K, "N": N, "r": r, "max_abs_err": err,
                            "ok": ok})
            _check(ok, f"qrlora_bgmv at {QWEN}'s {M}-lane step x={name} N={N}: max|Δ| "
                       f"{err:.3e} over {_tol('qrlora_bgmv', dt)}, or a second call differs")
            worst[name] = max(worst.get(name, 0.0), err)
    return worst


def bitwise_rows_ok(rows) -> bool:
    """A time-sliced, routed or disaggregated serve against the serve it
    must reproduce: bitwise."""
    return all(r["bitwise"] for r in rows)


def routed_rows_ok(rows, spills: int) -> bool:
    """A routed serve against one engine's (float32): bitwise, or, where the
    router spilled (``spills`` requests), :func:`route_rows_ok` for the
    streams that took another prefill path."""
    return all(r["bitwise"] or (spills > 0 and not r["same_path"] and route_rows_ok([r]))
               for r in rows)


def route_rows_ok(rows) -> bool:
    """A spilled or failed-over serve against one engine's (float32):
    bitwise where both took the same path, else :data:`ROUTE_FP32_TOL` with
    equal tokens."""
    return all(r["bitwise"] or (r["parted_at"] is None and r["max_abs_dlogits"] <= ROUTE_FP32_TOL)
               for r in rows)


def dense_faults(seed: int, params, traffic, dense_run) -> dict:
    """Planted faults of the time-sliced serve (float32), each held to the
    sliced-against-unsliced check: a snapshot restored into the other lane,
    and a snapshot missing its last written position (K and V zeroed
    there)."""
    from repro_torch.serving import engine as engine_mod

    extract, restore = engine_mod.extract_lane, engine_mod.restore_lane

    def tagged(state, axes, lane, host=False):
        snap = extract(state, axes, lane, host=host)
        if host:
            snap["sliced"] = True  # restore_lane walks the state's keys only
        return snap

    def other_lane(state, axes, lane, snap):
        return restore(state, axes, (lane + 1) % DENSE_ENGINE["n_lanes"] if "sliced" in snap
                       else lane, snap)

    def last_dropped(state, axes, lane, host=False):
        snap = extract(state, axes, lane, host=host)
        if host:
            a = snap["layers"]["attn"]
            last = int(a["idx"][0, 0]) - 1
            a["k"][:, :, last] = 0
            a["v"][:, :, last] = 0
        return snap

    out = {}
    for name, patches in (("restored_into_the_other_lane",
                           (("extract_lane", tagged), ("restore_lane", other_lane))),
                          ("snapshot_without_its_last_position",
                           (("extract_lane", last_dropped),))):
        with contextlib.ExitStack() as stack:
            for attr, fn in patches:
                stack.enter_context(swapped(engine_mod, attr, fn))
            _, eng, _ = qwen_engine("float32", seed, params=params, dense=True,
                                    quantum=DENSE_QUANTUM)
            run = qwen_serve(eng, traffic)
        rows = compare_streams(run, dense_run)
        out[name] = {"slice_preemptions": run["slice_preemptions"],
                     "bitwise": sum(r["bitwise"] for r in rows),
                     "parted": [r["parted_at"] for r in rows],
                     "rejected": not bitwise_rows_ok(rows)}
    return out


def dense_phase(seed: int, params: dict) -> dict:
    """qwen2-0.5b at full width under ``EngineConfig.oracle_dense(n_lanes=2,
    n_slots=8, max_len=384)`` on the posture's weights and traffic, float32
    and bf16: the dense serve (launches counted, every decode dispatch under
    sync debug mode "error"), the same with ``quantum`` 4, and the paged
    serve of the same traffic (2 lanes, monolithic, unshared); float32
    against the merged-weight reference, bf16 teacher-forced; the planted
    faults (float32).  Returns every reading (without the requests)."""
    import torch
    from repro_torch import kernels

    out = {}
    for dtype in ("float32", "bfloat16"):
        p = params[dtype]
        cfg, eng, lams = qwen_engine(dtype, seed, params=p, dense=True)
        traffic = qwen_traffic(seed, cfg.vocab_size)
        eng._dispatch_decode = sync_checked(eng._dispatch_decode)
        kernels.reset_launch_counts()
        runs = {"dense": qwen_serve(eng, traffic)}
        runs["dense"]["launches"] = kernels.launch_counts()
        runs["dense"]["dispatches_sync_checked"] = eng._dispatch_decode.calls
        _, sl, _ = qwen_engine(dtype, seed, params=p, dense=True, quantum=DENSE_QUANTUM)
        runs["sliced"] = qwen_serve(sl, traffic)
        _, pg, _ = qwen_engine(dtype, seed, params=p, n_lanes=DENSE_ENGINE["n_lanes"],
                               share_prefix=False, prefill_chunk=None)
        runs["paged"] = qwen_serve(pg, traffic)
        a = pg.cache["layers"]["attn"]
        block_bytes = sum(a[n][:, 0].numel() * a[n].element_size() for n in ("k", "v"))
        drift = BF16_DRIFT if dtype == "bfloat16" else None
        res = {"sliced_vs_dense": compare_streams(runs["sliced"], runs["dense"]),
               "dense_vs_paged": compare_streams(runs["dense"], runs["paged"], drift),
               "kv_bytes": {"dense_cache": eng.kv_cache_bytes(),
                            "paged_cache": pg.kv_cache_bytes(),
                            "paged_peak_blocks": runs["paged"]["pool_peak"],
                            "paged_peak_bytes": runs["paged"]["pool_peak"] * block_bytes}}
        if dtype == "float32":
            res["verify"] = verify(cfg, eng, lams, runs["dense"]["done"], QWEN_GEN)
            res["faults"] = dense_faults(seed, p, traffic, runs["dense"])
        else:
            res["verify_forced"] = verify_forced(cfg, eng, lams, runs["dense"]["done"])
        for run in runs.values():
            del run["done"]
        res["runs"] = runs
        out[dtype] = res
        del eng, sl, pg
        torch.cuda.empty_cache()
    return out


def print_dense(out: dict, smi: str) -> None:
    for dtype, res in out.items():
        for name, run in res["runs"].items():
            print(f"{QWEN} {dtype} {name}: {run['tokens']} tokens in {run['serve_s']:.3f} s = "
                  f"{run['tok_per_s']:.1f} tok/s over {run['steps']} decode steps; slice "
                  f"preemptions {run['slice_preemptions']}, KV cache {run['kv_cache_bytes']} B"
                  + (f"; launches {run['launches']}; decode dispatches under sync debug mode "
                     f"'error' {run['dispatches_sync_checked']}" if "launches" in run else "")
                  + f" on {smi}")
        for name in ("sliced_vs_dense", "dense_vs_paged"):
            rows = res[name]
            print(f"  {dtype} {name}: bitwise {sum(r['bitwise'] for r in rows)}/{len(rows)}, "
                  f"parted {[r['parted_at'] for r in rows]}, max|Δlogits| "
                  f"{max(r['max_abs_dlogits'] for r in rows):.3e}"
                  + (f", over the bf16 bound {max(r['max_dlogits_over_bound'] for r in rows):.4f}"
                     if "max_dlogits_over_bound" in rows[0] else ""))
        print(f"  {dtype} KV bytes: {res['kv_bytes']}")
        for row in res.get("verify", []):
            print(f"  {dtype} dense vs the merged-weight reference: {row}")
        for row in res.get("verify_forced", []):
            print(f"  {dtype} dense vs the teacher-forced merged-weight reference: {row}")
        for name, f in res.get("faults", {}).items():
            print(f"  {dtype} planted fault {name}: rejected {f['rejected']}; {f}")


def check_dense(out: dict) -> None:
    for dtype, res in out.items():
        dense, sliced = res["runs"]["dense"], res["runs"]["sliced"]
        _check(dense["launches"]["qrlora_bgmv"] > 0
               and dense["launches"]["paged_decode_attention"] == 0,
               f"{QWEN} {dtype} dense serve: #1 never launched, or #2 launched on the dense "
               f"attend: {dense['launches']}")
        _check_no_bench_kernels(dense["launches"], f"{QWEN} {dtype} dense serve")
        _check(dense["dispatches_sync_checked"] == dense["steps"] > 0,
               f"{QWEN} {dtype}: not every dense decode dispatch ran under sync debug mode: "
               f"{dense['dispatches_sync_checked']} of {dense['steps']}")
        for name, run in res["runs"].items():
            _check(run["all_served"], f"{QWEN} {dtype} {name}: not every request got its tokens")
        _check(sliced["slice_preemptions"] >= 4 and dense["slice_preemptions"] == 0,
               f"{QWEN} {dtype}: the quantum serve time-sliced fewer than 4 times: {sliced}")
        _check(bitwise_rows_ok(res["sliced_vs_dense"]),
               f"{QWEN} {dtype}: the time-sliced serve is not bitwise the unsliced one: "
               f"{res['sliced_vs_dense']}")
        if dtype == "float32":
            _check(all(r["parted_at"] is None and r["max_abs_dlogits"] <= QWEN_CHUNK_FP32_TOL
                       for r in res["dense_vs_paged"]),
                   f"{QWEN} float32 dense against paged: tokens differ or over "
                   f"{QWEN_CHUNK_FP32_TOL}: {res['dense_vs_paged']}")
            _check(all(r["tokens_match"] and r["max_abs_dlogits"] < FP32_LOGIT_TOL
                       for r in res["verify"]),
                   f"{QWEN} float32 dense serve diverged from the merged-weight reference")
            for name, f in res["faults"].items():
                _check(f["rejected"] and f["slice_preemptions"] > 0,
                       f"{QWEN}: the sliced check let the planted fault {name} through: {f}")
        else:
            _check(chunk_rows_ok(res["dense_vs_paged"], dtype),
                   f"{QWEN} bf16 dense against paged: over the bf16 bar: {res['dense_vs_paged']}")
            _check(all(r["ok"] for r in res["verify_forced"]),
                   f"{QWEN} bf16 dense serve disagrees with the teacher-forced merged-weight "
                   f"reference: {res['verify_forced']}")


def routed_serve(router, traffic, gen: int = QWEN_GEN) -> dict:
    """Submit ``traffic`` through ``router`` and run it to the end; the
    readings of :func:`qwen_serve` that apply (``done``: the engines'
    requests by router uid)."""
    import torch

    routed = [router.submit(t, p, gen) for t, p in traffic]
    t0 = time.perf_counter()
    router.run()
    torch.cuda.synchronize()
    serve_s = time.perf_counter() - t0
    tokens = sum(len(r.tokens) for r in routed)
    return {"routed": routed, "done": {r.uid: r.engine_req for r in routed},
            "serve_s": serve_s, "tokens": tokens, "tok_per_s": tokens / serve_s,
            "placement_hit_rate": router.placement_hit_rate(),
            "transport": router.transport.stats(),
            "replicas": {r.name: r.engine.decoded_tokens for r in router.replicas},
            "all_served": all(r.finished and len(r.tokens) == gen for r in routed)}


def _routed_readings(run) -> dict:
    return {k: v for k, v in run.items() if k not in ("routed", "done")}


def spill_serve(cfg, seed: int, params, lam, prompt, faulty: bool = False) -> dict:
    """Two replicas of one lane each, spill threshold 0: the home replica
    serves ``prompt`` and caches its 3 prefix blocks; then the same prompt
    twice, the second spilling to the sibling, which imports the home
    replica's blocks first.  ``faulty`` plants an import that writes the
    payload's first block into every adopted block."""
    import numpy as np
    from repro_torch.serving import Router, build_replicas

    replicas = build_replicas(cfg, qwen_config(seed, n_lanes=1), 2, params=params)
    router = Router(replicas, spill_threshold=0)
    router.add_tenant("tenant0", lam)
    home = router.owner_of(router.digest("tenant0"))
    sibling = next(r for r in router.replicas if r is not home)
    if faulty:
        write = sibling.engine._write_imported_blocks

        def first_block_only(ids, payload, skip):
            n = payload["n_blocks"]
            rep = {**payload, "k": np.repeat(payload["k"][:, :1], n, axis=1),
                   "v": np.repeat(payload["v"][:, :1], n, axis=1)}
            return write(ids, rep, skip=skip)

        sibling.engine._write_imported_blocks = first_block_only
    first = router.submit("tenant0", prompt, QWEN_GEN)
    router.run()
    primary = router.submit("tenant0", prompt, QWEN_GEN)
    spill = router.submit("tenant0", prompt, QWEN_GEN)
    stats = router.transport.stats()
    router.run()
    rows = compare_streams({"done": {0: spill.engine_req}}, {"done": {0: primary.engine_req}})
    return {"first_home": first.replica is home, "primary_home": primary.replica is home,
            "spilled_to_sibling": spill.replica is sibling,
            "imports": router.registry.snapshot()["router_prefix_imports_total"]["series"][0][
                "value"],
            "shipped_bytes": stats["bytes"].get("prefix", 0),
            "sibling_cached_blocks": len(sibling.engine.prefix_cache),
            "placement_hit_rate": router.placement_hit_rate(),
            "spill_vs_primary": rows, "done": {0: spill.engine_req},
            "rejected": not (rows[0]["bitwise"] or (rows[0]["parted_at"] is None and rows[0][
                "max_abs_dlogits"] <= ROUTE_FP32_TOL))}


def disaggregated_serve(cfg, seed: int, params, lams, traffic, faulty: bool = False) -> dict:
    """Two replicas under ``disaggregate=True`` (r0 prefills, r1 decodes) on
    ``traffic``; each shipped first-token row is recorded.  ``faulty`` plants
    an inject whose admission emits the previous request's row."""
    import numpy as np
    from repro_torch.serving import Router, build_replicas

    replicas = build_replicas(cfg, qwen_config(seed), 2, params=params)
    router = Router(replicas, disaggregate=True)
    router.add_tenants(lams)
    shipped = {}
    ship = router.transport.ship

    def recording(payload, src, dst, kind):
        if kind == "prefill":
            shipped[payload["prompt"].tobytes()] = payload["logits"]
        return ship(payload, src, dst, kind)

    router.transport.ship = recording
    decode = router.replicas[1]
    if faulty:
        adopt, last = decode.engine._adopt_prefilled, [None]

        def previous_row(req, payload):
            row = adopt(req, payload)
            prev, last[0] = last[0], row
            return row if prev is None else prev

        decode.engine._adopt_prefilled = previous_row
    run = routed_serve(router, traffic)
    first_rows = [np.array_equal(r.engine_req.logits[0], shipped[r.prompt.tobytes()])
                  for r in run["routed"]]
    run.update({
        "roles": [r.role for r in router.replicas],
        "on_decode": all(r.replica is decode and r.placements == 2 for r in run["routed"]),
        "decode_prefill_buckets": len(decode.engine.prefill_buckets),
        "decode_chunk_dispatches": decode.engine.chunk_dispatches,
        "first_rows_shipped_bitwise": sum(first_rows),
        "shipments": run["transport"]["shipments"].get("prefill", 0)})
    return run


def router_phase(seed: int, params: dict) -> dict:
    """Two replicas on the one card (float32, the posture's weights and
    traffic), built with ``build_replicas`` on one shared params tree:
    routed against one engine in both layouts (launches counted), one
    replica behind the router, spillover with a prefix import, a replica
    killed mid-serve, and prefill/decode disaggregation; the planted faults
    of the spill import and the disaggregated inject."""
    import torch
    from repro_torch import kernels
    from repro_torch.serving import Router, build_replicas

    p = params["float32"]
    out = {}
    singles = {}
    for layout, dense in (("paged", False), ("oracle_dense", True)):
        cfg, single, lams = qwen_engine("float32", seed, params=p, dense=dense)
        traffic = qwen_traffic(seed, cfg.vocab_size)
        singles[layout] = qwen_serve(single, traffic)
        replicas = build_replicas(cfg, single.config, 2, params=p)
        _check(all(r.engine.params is p for r in replicas),
               f"{QWEN} router: a replica copied the weights")
        router = Router(replicas)
        router.add_tenants(lams)
        kernels.reset_launch_counts()
        run = routed_serve(router, traffic)
        run["launches"] = kernels.launch_counts()
        run["spills"] = sum(r.replica is not router.owner_of(router.digest(r.tenant))
                            for r in run["routed"])
        rows = compare_streams(run, singles[layout])
        out[layout] = {"single": {k: v for k, v in singles[layout].items() if k != "done"},
                       "routed": _routed_readings(run), "rows": rows}
        del router, replicas, single
    one = Router(build_replicas(cfg, qwen_config(seed), 1, params=p))
    one.add_tenants(lams)
    out["paged"]["one_replica"] = _routed_readings(routed_serve(one, traffic))
    del one

    tenant, prompt = traffic[0]
    out["spill"] = spill_serve(cfg, seed, p, lams[tenant], prompt)
    out["spill"]["vs_single"] = compare_streams({"done": out["spill"].pop("done")},
                                                singles["paged"])
    out["fault_spill_import_first_block_only"] = {
        k: v for k, v in spill_serve(cfg, seed, p, lams[tenant], prompt, faulty=True).items()
        if k != "done"}

    # a replica killed mid-serve: its requests re-place on the survivor
    replicas = build_replicas(cfg, qwen_config(seed), 2, params=p)
    router = Router(replicas)
    router.add_tenants(lams)
    routed = [router.submit(t, q, QWEN_GEN) for t, q in traffic]
    for _ in range(2):
        router.step()
    on = lambda i: [r for r in routed if r.replica.replica_id == i and not r.finished]
    victim = 1 if on(1) else 0
    orphans = on(victim)
    replaced = router.kill_replica(victim)
    router.run()
    rows = compare_streams({"done": {r.uid: r.engine_req for r in routed}}, singles["paged"])
    out["failover"] = {"victim": victim, "orphans": len(orphans), "replaced": replaced,
                       "placements": [r.placements for r in orphans],
                       "all_on_survivors": all(r.finished and r.replica.alive for r in routed),
                       "rows": rows}
    del router, replicas

    run = disaggregated_serve(cfg, seed, p, lams, traffic)
    out["disaggregated"] = {**_routed_readings(run),
                            "rows": compare_streams(run, singles["paged"])}
    fault = disaggregated_serve(cfg, seed, p, lams, traffic, faulty=True)
    fault_rows = compare_streams(fault, singles["paged"])
    out["fault_inject_previous_row"] = {
        "first_rows_shipped_bitwise": fault["first_rows_shipped_bitwise"],
        "parted": [r["parted_at"] for r in fault_rows],
        "rejected": not (fault["first_rows_shipped_bitwise"] == len(traffic)
                         and bitwise_rows_ok(fault_rows))}
    torch.cuda.empty_cache()
    return out


def print_router(out: dict, smi: str) -> None:
    for layout in ("paged", "oracle_dense"):
        r = out[layout]
        print(f"{QWEN} float32 {layout}: one engine {r['single']['tok_per_s']:.1f} tok/s over "
              f"{r['single']['steps']} steps; 2 replicas routed {r['routed']['tok_per_s']:.1f} "
              f"tok/s ({r['routed']['replicas']} tokens), placement hit rate "
              f"{r['routed']['placement_hit_rate']:.3f}, transport {r['routed']['transport']}, "
              f"launches {r['routed']['launches']} on {smi}")
        rows = r["rows"]
        print(f"  routed vs one engine ({layout}, {r['routed']['spills']} spilled): bitwise "
              f"{sum(x['bitwise'] for x in rows)}/{len(rows)} (same prefill path "
              f"{sum(x['same_path'] for x in rows)}), parted "
              f"{[x['parted_at'] for x in rows]}, max|Δlogits| "
              f"{max(x['max_abs_dlogits'] for x in rows):.3e}")
    o = out["paged"]["one_replica"]
    print(f"{QWEN} float32 paged, one replica behind the router: {o['tok_per_s']:.1f} tok/s, "
          f"placement hit rate {o['placement_hit_rate']:.3f} on {smi}")
    print(f"  spillover: {out['spill']}")
    print(f"  planted fault spill_import_first_block_only: rejected "
          f"{out['fault_spill_import_first_block_only']['rejected']}; "
          f"{out['fault_spill_import_first_block_only']}")
    f = out["failover"]
    print(f"  replica {f['victim']} killed mid-serve: {f['orphans']} orphans re-placed "
          f"({f['replaced']}), placements {f['placements']}; vs one engine bitwise "
          f"{sum(x['bitwise'] for x in f['rows'])}/{len(f['rows'])}, parted "
          f"{[x['parted_at'] for x in f['rows']]}, max|Δlogits| "
          f"{max(x['max_abs_dlogits'] for x in f['rows']):.3e}")
    d = out["disaggregated"]
    print(f"  disaggregated ({d['roles']}): {d['tok_per_s']:.1f} tok/s, {d['shipments']} "
          f"handoffs, transport {d['transport']}, decode replica prefill buckets "
          f"{d['decode_prefill_buckets']} and chunks {d['decode_chunk_dispatches']}, first rows "
          f"bitwise the shipped ones {d['first_rows_shipped_bitwise']}/{len(d['rows'])}; vs one "
          f"engine bitwise {sum(x['bitwise'] for x in d['rows'])}/{len(d['rows'])}, parted "
          f"{[x['parted_at'] for x in d['rows']]}, max|Δlogits| "
          f"{max(x['max_abs_dlogits'] for x in d['rows']):.3e} on {smi}")
    print(f"  planted fault inject_previous_row: rejected "
          f"{out['fault_inject_previous_row']['rejected']}; {out['fault_inject_previous_row']}")


def check_router(out: dict) -> None:
    for layout in ("paged", "oracle_dense"):
        r = out[layout]
        _check(r["routed"]["all_served"] and r["single"]["all_served"],
               f"{QWEN} routed {layout}: not every request got its tokens")
        _check(set(r["routed"]["replicas"].values()) != {0},
               f"{QWEN} routed {layout}: no replica decoded: {r['routed']['replicas']}")
        _check(routed_rows_ok(r["rows"], r["routed"]["spills"]),
               f"{QWEN} routed {layout} ({r['routed']['spills']} spilled): not one {layout} "
               f"engine's streams: {r['rows']}")
        _check(r["routed"]["launches"]["qrlora_bgmv"] > 0,
               f"{QWEN} routed {layout}: #1 never launched")
        _check_no_bench_kernels(r["routed"]["launches"], f"{QWEN} routed {layout}")
    _check(out["oracle_dense"]["routed"]["launches"]["paged_decode_attention"] == 0
           and out["paged"]["routed"]["launches"]["paged_decode_attention"] > 0,
           f"{QWEN} routed: #2 launched on the dense replicas or not on the paged ones")
    s = out["spill"]
    _check(s["first_home"] and s["primary_home"] and s["spilled_to_sibling"] and s["imports"] >= 1
           and s["shipped_bytes"] > 0 and not s["rejected"] and route_rows_ok(s["vs_single"]),
           f"{QWEN} spillover: no spill, no prefix import, or the spilled stream differs: {s}")
    f = out["failover"]
    _check(f["orphans"] > 0 and f["replaced"] == f["orphans"] and f["all_on_survivors"]
           and all(n == 2 for n in f["placements"]) and route_rows_ok(f["rows"]),
           f"{QWEN} replica failure: orphans not re-placed once, or their streams differ: {f}")
    d = out["disaggregated"]
    _check(d["all_served"] and d["roles"] == ["prefill", "decode"] and d["on_decode"]
           and d["shipments"] == len(d["rows"]) and d["decode_prefill_buckets"] == 0
           and d["decode_chunk_dispatches"] == 0
           and d["first_rows_shipped_bitwise"] == len(d["rows"]) and bitwise_rows_ok(d["rows"]),
           f"{QWEN} disaggregation: a handoff missing, the prompt recomputed on the decode "
           f"replica, a first row not the shipped one, or streams differ: {d}")
    for name in ("fault_spill_import_first_block_only", "fault_inject_previous_row"):
        _check(out[name]["rejected"], f"{QWEN}: the check let the planted fault {name} through")


# ---------------------------------------------------------------------------
# speculative decoding at full width: qwen2-0.5b on the posture's weights
# ---------------------------------------------------------------------------

SPEC_K = 4
# the profiled bf16 serves (speculative and its twin) take the first 2 of the
# 8 requests: parsing a profile of the whole traffic took most of the phase
SPEC_PROFILE_REQUESTS = 2
SPEC_DRAFT_RANK = 8  # the truncated-λ drafter keeps each slot's top 8 |λ| of 160
# the posture's paged engine (prefix sharing, watermark 1) with monolithic
# prefill, which speculation needs; the oracle-dense layout time-sliced
SPEC_PAGED = {"prefill_chunk": None, "speculate_k": SPEC_K}
SPEC_DENSE = {"quantum": DENSE_QUANTUM, "speculate_k": SPEC_K}
# the device work of a speculative step, each run under sync debug mode
# "error": the step's only host syncs are the draft tokens and the verify
# logits, read between these calls
SPEC_CHECKED = ("_dispatch_draft", "_dispatch_verify", "_commit_window")


def lanes_cover_their_kv(engine) -> bool:
    """The paged invariant every step restores: each active lane holds
    exactly the blocks its committed K/V (``idx`` positions) spans, none
    past an accepted frontier."""
    bs = engine.block_size
    return all(len(engine._lane_blocks[r.lane]) == -(-(r.prompt.size + len(r.tokens) - 1) // bs)
               for r in engine.scheduler.active())


def _block_kv(engine, b: int):
    a = engine.cache["layers"]["attn"]
    return a["k"][:, b].clone(), a["v"][:, b].clone()


def _kv_kept(engine, b: int, saved) -> bool:
    import torch

    a = engine.cache["layers"]["attn"]
    return torch.equal(saved[0], a["k"][:, b]) and torch.equal(saved[1], a["v"][:, b])


def _shared_blocks(engine) -> list:
    """The blocks the lanes and the prefix cache hold that have more than
    one owner."""
    held = {b for blocks in engine._lane_blocks.values() for b in blocks}
    if engine.prefix_cache is not None:
        held |= set(engine.prefix_cache._entries.values())
    return sorted(b for b in held if engine.allocator.is_shared(b))


def force_shared_headroom(engine) -> dict:
    """Rig: after the first growth that gives a lane a block past its write
    block that its k draft steps would reach, take an extra reference on
    that block, as another owner would.  The window must cap before it
    (``cap`` against ``room``, the positions left in the write block) and
    its bytes must stay as they were.  Returns the rig's record (``block``
    None until it fires); :func:`spec_serve` reads and releases it."""
    rig = {"block": None}
    grow = engine._grow_lanes
    bs, k = engine.block_size, engine.speculate_k

    def forced(window=1):
        grow(window)
        if rig["block"] is not None:
            return
        for req in engine.scheduler.active():
            wp = req.prompt.size + len(req.tokens) - 1
            nxt = wp // bs + 1
            blocks = engine._lane_blocks[req.lane]
            if len(blocks) > nxt and wp + k - 1 >= nxt * bs:
                b = blocks[nxt]
                engine.allocator.incref(b)
                rig.update(block=b, uid=req.uid, room=nxt * bs - wp,
                           cap=engine._spec_window_cap(req), saved=_block_kv(engine, b))
                return

    engine._grow_lanes = forced
    return rig


def spec_serve(engine, traffic, gen: int = QWEN_GEN, force_shared: bool = False,
               sync_check: bool = False) -> dict:
    """Serve ``traffic`` (``gen`` tokens a request) to the end through a
    speculative engine or its plain twin, watching every step of a paged
    one: the bytes of each block with more than one owner across the draft,
    verify and commit, and after the step that every lane's blocks cover
    its K/V and no more (:func:`lanes_cover_their_kv`).  With
    ``force_shared`` the :func:`force_shared_headroom` rig; with
    ``sync_check`` the draft, verify and commit under sync debug mode
    "error" (the card only), counted.  Kernel launches and #1's row counts
    are counted over the serve; then the prefix cache is released and the
    pool read.  Returns the readings (``done``: uid → request)."""
    import collections

    import torch
    from repro_torch import kernels
    from repro_torch.kernels import qrlora_bgmv as bgmv_mod

    paged = engine.paged
    checked = {}
    if sync_check:
        for name in SPEC_CHECKED:
            checked[name] = sync_checked(getattr(engine, name))
            setattr(engine, name, checked[name])
    rig = force_shared_headroom(engine) if force_shared else None
    draft, commit = engine._dispatch_draft, engine._commit_window
    watch = {"saved": {}, "changed": set(), "covers": True}

    def watched_draft(*a, **kw):
        watch["saved"] = {b: _block_kv(engine, b) for b in _shared_blocks(engine)} if paged else {}
        return draft(*a, **kw)

    def watched_commit(*a, **kw):
        commit(*a, **kw)
        watch["changed"] |= {b for b, s in watch["saved"].items() if not _kv_kept(engine, b, s)}

    engine._dispatch_draft, engine._commit_window = watched_draft, watched_commit
    # #1's rows by call, counted at its dispatcher (one launch a call on the
    # card); the wrapper keeps its own launch count
    rows = collections.Counter()
    real = bgmv_mod.qrlora_bgmv

    def counting(x, *a, **kw):
        rows[x.shape[0]] += 1
        return real(x, *a, **kw)

    names = ("spec_steps", "drafted_tokens", "accepted_drafts", "steps", "preemptions",
             "cow_forks", "slice_preemptions", "decoded_tokens")
    before = {n: getattr(engine, n) for n in names}
    reqs = [engine.submit(t, p, gen) for t, p in traffic]
    done = {}
    kernels.reset_launch_counts()
    with swapped(bgmv_mod, "qrlora_bgmv", counting):
        t0 = time.perf_counter()
        while engine.scheduler.has_work:
            for r in engine.step():
                done[r.uid] = r
            if paged:
                watch["covers"] = watch["covers"] and lanes_cover_their_kv(engine)
        if engine.device.type == "cuda":
            torch.cuda.synchronize()
        serve_s = time.perf_counter() - t0
    out = {name: getattr(engine, name) - before[name] for name in names}
    tokens = out.pop("decoded_tokens")
    out.update(done=done, serve_s=serve_s, tokens=tokens, tok_per_s=tokens / serve_s,
               acceptance=(out["accepted_drafts"] / out["drafted_tokens"]
                           if out["drafted_tokens"] else None),
               launches=kernels.launch_counts(), bgmv_rows=dict(sorted(rows.items())),
               all_served=len(done) == len(reqs) and all(
                   len(r.tokens) == gen for r in done.values()),
               sync_checked={n: f.calls for n, f in checked.items()},
               shared_changed=sorted(watch["changed"]) if paged else None,
               covers=watch["covers"] if paged else None, forced=None, drained=None)
    if rig is not None and rig["block"] is not None:
        b = rig["block"]
        out["forced"] = {"block": b, "room": rig["room"], "cap": rig["cap"],
                         "kept": _kv_kept(engine, b, rig["saved"])}
        engine.allocator.decref(b)
    if paged:
        engine.release_prefix_cache()
        out["drained"] = engine.allocator.n_free == engine.allocator.capacity
        out["pool_peak"] = engine.allocator.peak_in_use
    return out


def spec_blocks_ok(run) -> bool:
    """A paged speculative serve's block checks: no block with another
    owner changed across any step, every step's lanes cover their K/V and
    no more, the pool drains, and a forced shared block (where the rig ran)
    capped its lane's window and kept its bytes."""
    forced = run["forced"]
    return (not run["shared_changed"] and run["covers"] and run["drained"]
            and (forced is None or (forced["cap"] <= forced["room"] and forced["kept"])))


def spec_rows_ok(rows) -> bool:
    """A float32 speculative serve against its plain twin: tokens equal,
    logits within the chunked bar (the verify attends in plain torch where
    the paged decode runs #2, and reduces over other shapes)."""
    return all(r["parted_at"] is None and r["max_abs_dlogits"] <= QWEN_CHUNK_FP32_TOL
               for r in rows)


SPEC_COUNTERS = ("spec_steps", "drafted_tokens", "accepted_drafts")


def spec_counters(run) -> dict:
    """A speculative serve's acceptance bookkeeping."""
    return {n: run[n] for n in SPEC_COUNTERS}


def spec_faults(seed: int, params, traffic, plain_run, sound_run) -> dict:
    """Planted faults of the speculative serve (float32, paged), each on a
    fresh engine and held to the check it targets: every window committed
    whole (a rejected draft left committed), the draft's write limit removed
    (the forced shared block's bytes), and the rollback skipped (the
    blocks-cover-the-K/V check; the forced block lies past its lane's
    accepted frontier, so the rollback must release it).  A skipped rollback
    leaks nothing by the end of a serve (retirement frees every block of a
    lane), so the drain alone cannot see it.

    A whole window is held to two checks, each of which must reject it:
    the plain twin's tokens and logits, and the sound serve's acceptance
    counters on the same traffic (``sound_run``: the same engine config, no
    rig).  On random weights the target's next token barely depends on the
    draft it follows, so the fault's tokens can all equal the twin's; only
    its logits and its counters part."""
    out = {}
    _, eng, _ = qwen_engine("float32", seed, params=params, **SPEC_PAGED)
    eng._accept = lambda decoding, window, greedy, n_valid: n_valid.copy()
    run = spec_serve(eng, traffic)
    rows = compare_streams(run, plain_run)
    by_logits = not spec_rows_ok(rows)
    by_counters = spec_counters(run) != spec_counters(sound_run)
    out["window_committed_whole"] = {
        "acceptance": run["acceptance"], "parted": [r["parted_at"] for r in rows],
        "max_abs_dlogits": max(r["max_abs_dlogits"] for r in rows),
        "counters": spec_counters(run), "sound_counters": spec_counters(sound_run),
        "rejected_by_logits": by_logits, "rejected_by_counters": by_counters,
        "rejected": by_logits and by_counters}
    _, eng, _ = qwen_engine("float32", seed, params=params, **SPEC_PAGED)
    sound = eng._draft_cache

    def unlimited(nv):
        view = sound(nv)
        del view["layers"]["attn"]["write_limit"]
        return view

    eng._draft_cache = unlimited
    run = spec_serve(eng, traffic, force_shared=True)
    out["draft_write_limit_removed"] = {"forced": run["forced"],
                                        "shared_changed": run["shared_changed"],
                                        "rejected": not spec_blocks_ok(run)}
    _, eng, _ = qwen_engine("float32", seed, params=params, **SPEC_PAGED)
    eng._rollback_window_blocks = lambda decoding, adv: None
    run = spec_serve(eng, traffic, force_shared=True)
    out["rollback_skipped"] = {"covers": run["covers"], "drained": run["drained"],
                               "rejected": not spec_blocks_ok(run)}
    return out


def profile_spec(engine, traffic) -> dict:
    """The traffic served again on the same engine under torch.profiler,
    the draft and the verify each timed as a range that ends once its
    device work has (a synchronize inside the range): wall time, device busy
    and idle share over the serve, and each phase's host time and device
    busy time (kernel intervals inside its ranges)."""
    import torch

    def ranged(name, fn):
        def wrapped(*a, **kw):
            with torch.profiler.record_function(name):
                out = fn(*a, **kw)
                torch.cuda.synchronize()
            return out
        return wrapped

    draft, verify = engine._dispatch_draft, engine._dispatch_verify
    engine._dispatch_draft = ranged("spec_draft", draft)
    engine._dispatch_verify = ranged("spec_verify", verify)
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    try:
        with torch.profiler.profile(activities=acts) as prof:
            t0 = time.perf_counter()
            run = spec_serve(engine, traffic)
            wall_us = (time.perf_counter() - t0) * 1e6
    finally:
        engine._dispatch_draft, engine._dispatch_verify = draft, verify
    ranges = {"spec_draft": [], "spec_verify": []}
    kernels_ = []
    events = _profile_events(prof)
    for name, on_device, a, b, _ in events:
        if name in ranges:  # the range's host side; its device side is no kernel
            if not on_device:
                ranges[name].append((a, b))
        elif on_device:
            kernels_.append((a, b))
    phases = {}
    for name, spans in ranges.items():
        busy = sum(b - a for a, b in _union([(max(a, s), min(b, t)) for s, t in spans
                                             for a, b in kernels_ if a < t and b > s]))
        phases[name.removeprefix("spec_")] = {
            "calls": len(spans), "host_ms": sum(t - s for s, t in spans) / 1e3,
            "device_busy_ms": busy / 1e3}
    del run["done"]
    return {**_device_busy(prof, wall_us, skip=ranges, events=events), "phases": phases,
            "serve": run}


def speculative_phase(seed: int, params: dict) -> dict:
    """qwen2-0.5b at full width on the posture's weights and traffic with
    ``speculate_k=4``: the paged posture with monolithic prefill in float32
    (one shared block forced into a window; the draft, verify and commit
    under sync debug mode "error"; again without the rig, the planted
    faults' sound side) and bf16, the truncated-λ drafter
    (``draft_lam_rank=8``, float32) and the oracle-dense layout with
    ``quantum=4`` (float32), each beside its ``speculate_k=0`` twin; the
    float32 serve's engine again on base-tenant requests (acceptance 1);
    the bf16 serve against the teacher-forced merged-weight reference and
    profiled beside its twin; the planted faults.  Returns every reading
    (without the requests); check_speculative holds them to the bars."""
    import torch
    from repro_torch.serving import BASE_TENANT

    out = {"seconds": {}}
    t0 = time.perf_counter()

    def lap(name):
        nonlocal t0
        now = time.perf_counter()
        out["seconds"][name] = now - t0
        t0 = now

    p32 = params["float32"]
    cfg, eng, _ = qwen_engine("float32", seed, params=p32, **SPEC_PAGED)
    traffic = qwen_traffic(seed, cfg.vocab_size)
    runs = {"paged": spec_serve(eng, traffic, force_shared=True, sync_check=True)}
    runs["paged_base_tenant"] = spec_serve(eng, [(BASE_TENANT, p) for _, p in traffic[:4]])
    _, eng, _ = qwen_engine("float32", seed, params=p32, **SPEC_PAGED)
    runs["paged_unforced"] = spec_serve(eng, traffic)  # the faults' sound side
    _, eng, _ = qwen_engine("float32", seed, params=p32, **{**SPEC_PAGED, "speculate_k": 0})
    runs["paged_plain"] = spec_serve(eng, traffic)
    _, eng, _ = qwen_engine("float32", seed, params=p32, **SPEC_PAGED,
                            draft_lam_rank=SPEC_DRAFT_RANK)
    runs["paged_truncated"] = spec_serve(eng, traffic, sync_check=True)
    _, eng, _ = qwen_engine("float32", seed, params=p32, dense=True, **SPEC_DENSE)
    runs["dense"] = spec_serve(eng, traffic, sync_check=True)
    _, eng, _ = qwen_engine("float32", seed, params=p32, dense=True,
                            **{**SPEC_DENSE, "speculate_k": 0})
    runs["dense_plain"] = spec_serve(eng, traffic)
    res = {"float32": {
        "paged_vs_plain": compare_streams(runs["paged"], runs["paged_plain"]),
        "unforced_vs_plain": compare_streams(runs["paged_unforced"], runs["paged_plain"]),
        "truncated_vs_plain": compare_streams(runs["paged_truncated"], runs["paged_plain"]),
        "dense_vs_plain": compare_streams(runs["dense"], runs["dense_plain"])}}
    lap("float32")
    res["float32"]["faults"] = spec_faults(seed, p32, traffic, runs["paged_plain"],
                                           runs["paged_unforced"])
    lap("faults")
    p16 = params["bfloat16"]
    cfg16, eng16, lams16 = qwen_engine("bfloat16", seed, params=p16, **SPEC_PAGED)
    runs["paged_bf16"] = spec_serve(eng16, traffic, sync_check=True)
    _, twin16, _ = qwen_engine("bfloat16", seed, params=p16, **{**SPEC_PAGED, "speculate_k": 0})
    runs["paged_plain_bf16"] = spec_serve(twin16, traffic)
    res["bfloat16"] = {
        "verify_forced": verify_forced(cfg16, eng16, lams16, runs["paged_bf16"]["done"]),
        "paged_vs_plain": compare_streams(runs["paged_bf16"], runs["paged_plain_bf16"],
                                          BF16_DRIFT),
        "profile": profile_spec(eng16, traffic[:SPEC_PROFILE_REQUESTS]),
        "profile_plain": profile_spec(twin16, traffic[:SPEC_PROFILE_REQUESTS])}
    lap("bfloat16")
    res["planted_sync_caught"] = sync_mode_catches_a_sync()
    for run in runs.values():
        del run["done"]
    res["runs"] = runs
    del eng, eng16, twin16
    torch.cuda.empty_cache()
    return {**out, **res}


def print_speculative(out: dict, smi: str) -> None:
    k_rows = {"paged": QWEN_ENGINE["n_lanes"] * (SPEC_K + 1),
              "dense": DENSE_ENGINE["n_lanes"] * (SPEC_K + 1)}
    for name, run in out["runs"].items():
        print(f"{QWEN} speculative {name}: {run['tokens']} tokens in {run['serve_s']:.3f} s = "
              f"{run['tok_per_s']:.1f} tok/s over {run['steps']} steps ({run['spec_steps']} "
              f"speculative); drafted {run['drafted_tokens']}, accepted "
              f"{run['accepted_drafts']} (acceptance {run['acceptance']}); launches "
              f"{run['launches']}; #1 launches by row count {run['bgmv_rows']} (verify rows "
              f"{k_rows['dense' if name.startswith('dense') else 'paged']}); slice preemptions "
              f"{run['slice_preemptions']}, preemptions {run['preemptions']}, CoW forks "
              f"{run['cow_forks']}; sync-checked calls {run['sync_checked']}; shared blocks "
              f"changed {run['shared_changed']}, lanes cover their K/V {run['covers']}, pool "
              f"drained {run['drained']}, forced shared block {run['forced']} on {smi}")
    for dtype in ("float32", "bfloat16"):
        for name, rows in out[dtype].items():
            if not name.endswith("_vs_plain"):
                continue
            print(f"  {dtype} {name}: bitwise {sum(r['bitwise'] for r in rows)}/{len(rows)}, "
                  f"parted {[r['parted_at'] for r in rows]}, max|Δlogits| "
                  f"{max(r['max_abs_dlogits'] for r in rows):.3e}"
                  + (f", over the bf16 bound {max(r['max_dlogits_over_bound'] for r in rows):.4f}"
                     if "max_dlogits_over_bound" in rows[0] else ""))
    for row in out["bfloat16"]["verify_forced"]:
        print(f"  bf16 speculative vs the teacher-forced merged-weight reference: {row}")
    for name in ("profile", "profile_plain"):
        print(f"  profiled bf16 {name} (a second serve): {out['bfloat16'][name]}")
    for name, f in out["float32"]["faults"].items():
        print(f"  float32 planted fault {name}: rejected {f['rejected']}; {f}")
    print(f"  a planted host read under sync debug mode raises: {out['planted_sync_caught']}; "
          f"seconds {out['seconds']}")


def check_speculative(out: dict) -> None:
    runs = out["runs"]
    for name, run in runs.items():
        _check(run["all_served"], f"{QWEN} speculative {name}: not every request got its tokens")
        _check_no_bench_kernels(run["launches"], f"{QWEN} speculative {name}")
        spec = "plain" not in name
        _check(run["steps"] > 0 and run["spec_steps"] == (run["steps"] if spec else 0),
               f"{QWEN} speculative {name}: steps {run['steps']}, speculative "
               f"{run['spec_steps']}")
        if spec:
            _check(0.0 < run["acceptance"] <= 1.0,
                   f"{QWEN} speculative {name}: acceptance {run['acceptance']} not in (0, 1]")
        if name.startswith("paged"):
            _check(run["launches"]["paged_decode_attention"] > 0 and (
                not spec or run["launches"]["qrlora_bgmv"] > 0),
                   f"{QWEN} speculative {name}: #2 never launched, or #1: {run['launches']}")
            _check(spec_blocks_ok(run),
                   f"{QWEN} speculative {name}: a shared block changed, lanes hold blocks past "
                   f"their K/V, the pool did not drain, or the forced block was written or "
                   f"not capped at: {run}")
        else:
            _check(run["launches"]["paged_decode_attention"] == 0,
                   f"{QWEN} speculative {name}: #2 launched on the dense layout")
        if run["sync_checked"]:
            _check(all(c == run["spec_steps"] for c in run["sync_checked"].values())
                   and out["planted_sync_caught"],
                   f"{QWEN} speculative {name}: not every draft, verify and commit ran under "
                   f"sync debug mode: {run['sync_checked']} of {run['spec_steps']}")
    paged_rows = QWEN_ENGINE["n_lanes"] * (SPEC_K + 1)
    _check(runs["paged"]["forced"] is not None,
           f"{QWEN} speculative: the shared-block rig never found a window to force")
    _check(runs["paged_base_tenant"]["acceptance"] == 1.0,
           f"{QWEN} speculative: base-tenant acceptance {runs['paged_base_tenant']['acceptance']}")
    for name, rows in ((n, runs[n]["bgmv_rows"]) for n in ("paged", "paged_bf16")):
        _check(paged_rows in rows and QWEN_ENGINE["n_lanes"] not in rows,
               f"{QWEN} speculative {name}: #1 rows {rows}: no verify at {paged_rows} rows, or "
               f"the base drafter launched #1")
    _check(QWEN_ENGINE["n_lanes"] in runs["paged_truncated"]["bgmv_rows"],
           f"{QWEN} speculative: the truncated-λ drafter never launched #1 at the lanes' rows")
    _check(DENSE_ENGINE["n_lanes"] * (SPEC_K + 1) in runs["dense"]["bgmv_rows"]
           and runs["dense"]["slice_preemptions"] >= 1,
           f"{QWEN} speculative dense: no verify at its rows, or no time slice: {runs['dense']}")
    for name, rows in out["float32"].items():
        if name.endswith("_vs_plain"):
            _check(spec_rows_ok(rows), f"{QWEN} speculative float32 {name}: tokens differ or "
                                       f"over {QWEN_CHUNK_FP32_TOL}: {rows}")
    _check(all(r["ok"] for r in out["bfloat16"]["verify_forced"]),
           f"{QWEN} speculative bf16 disagrees with the teacher-forced merged-weight reference: "
           f"{out['bfloat16']['verify_forced']}")
    for name, f in out["float32"]["faults"].items():
        _check(f["rejected"], f"{QWEN}: the speculative check let the planted fault {name} "
                              f"through: {f}")


# ---------------------------------------------------------------------------
# the λ-store cold tier on qwen2-0.5b
# ---------------------------------------------------------------------------

# EngineConfig.serving(**COLD_ENGINE): 2 usable hot slots for COLD_TENANTS
# tenants, so admission promotes, spills by LRU and defers; the all-hot twin
# (COLD_ALL_HOT) holds every tenant in a hot slot and serves the same traffic
COLD_ENGINE = {"n_lanes": 4, "n_slots": 3, "cold_slots": 16, "max_len": 384,
               "collect_logits": True}
COLD_ALL_HOT = {"n_slots": 13, "cold_slots": 0}
COLD_TENANTS = 12
COLD_REQUESTS = 16
COLD_GEN = 16
# the planted faults serve the first 8 requests (8 tenants behind 2 hot slots)
COLD_FAULT_REQUESTS = 8


def _sync(device) -> None:
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def cold_traffic(seed: int, vocab: int, n_tenants: int = COLD_TENANTS,
                 n_requests: int = COLD_REQUESTS):
    """(tenant, prompt) pairs: every tenant once in a shuffled order, then
    repeats, prompts of 16-48 tokens."""
    import numpy as np

    rng = np.random.default_rng(seed + 6000)
    order = [int(i) for i in rng.permutation(n_tenants)] + [
        int(i) for i in rng.integers(0, n_tenants, size=n_requests - n_tenants)]
    return [(f"cold{i}", rng.integers(2, vocab, size=int(rng.integers(16, 49))).astype(np.int32))
            for i in order]


def cold_lams(seed: int, params, n_tenants: int = COLD_TENANTS) -> dict:
    """The cold phase's tenants: λ at scale 0.3 from ``seed``."""
    import torch
    from repro_torch.serving import random_lambda

    gen = torch.Generator(device=params["embed"].device)
    return {f"cold{i}": random_lambda(gen.manual_seed(seed + 4000 + i), params, 0.3)
            for i in range(n_tenants)}


def cold_engine(cfg, params, seed: int, **overrides):
    """``EngineConfig.serving(**COLD_ENGINE, **overrides)`` on ``params``'
    device."""
    from repro_torch.serving import EngineConfig, MultiTenantEngine

    return MultiTenantEngine(cfg, EngineConfig.serving(seed=seed, **{**COLD_ENGINE, **overrides}),
                             params=params, device=params["embed"].device)


def cold_serve(engine, lams, traffic, gen: int = COLD_GEN, sync_check: bool = False) -> dict:
    """Register ``lams`` in one batch, submit ``traffic`` and step to the
    end.  Every step records the tokens it delivered (the schedule) and
    whether each active lane's tenant still holds the slot it was admitted
    to; every admission gate call is timed on the host, and the calls whose
    promotion spilled are counted.  With ``sync_check`` each gate call runs
    under sync debug mode "error".  Returns the readings (``done``: uid →
    request)."""
    from repro_torch import kernels

    store = engine.lam_store
    engine.add_tenants(lams)
    before = {n: getattr(store, n) for n in ("spills", "promotes", "cold_registers",
                                                 "lru_drops")}
    deferred0 = engine.deferred_promotions
    reqs = [engine.submit(t, p, gen) for t, p in traffic]
    gates = {"calls": 0, "promoted": 0, "spilled_and_promoted": 0, "promote_ms": []}
    sound_make = engine._make_gate

    def make_gate():
        gate = sound_make()
        checked = sync_checked(gate) if sync_check else gate

        def timed(req):
            s0, p0 = store.spills, store.promotes
            t0 = time.perf_counter()
            ok = checked(req)
            ms = (time.perf_counter() - t0) * 1e3
            gates["calls"] += 1
            if store.promotes > p0:
                gates["promoted"] += 1
                gates["promote_ms"].append(ms)
                gates["spilled_and_promoted"] += store.spills > s0
            return ok

        return timed

    engine._make_gate = make_gate
    kernels.reset_launch_counts()
    schedule, slot_held = [], True
    t0 = time.perf_counter()
    try:
        while engine.scheduler.has_work:
            engine.step()
            schedule.append([(e.uid, e.lane, e.index) for e in engine.events])
            slot_held &= all(store._slots.get(r.tenant) == r.slot
                             for r in engine.scheduler.active())
        _sync(engine.device)
    finally:
        del engine._make_gate
    serve_s = time.perf_counter() - t0
    launches = kernels.launch_counts()
    snap = engine.metrics()
    value = lambda name: snap[name]["series"][0]["value"]
    tokens = sum(len(r.tokens) for r in reqs)
    engine.release_prefix_cache()
    counts = {n: getattr(store, n) - v for n, v in before.items()}
    pm = sorted(gates.pop("promote_ms"))
    return {"done": {r.uid: r for r in reqs}, "schedule": schedule, "serve_s": serve_s,
            "tokens": tokens, "tok_per_s": tokens / serve_s, "steps": len(schedule),
            "launches": launches, **counts,
            "deferred_promotions": engine.deferred_promotions - deferred0, "gates": gates,
            "promote_gate_ms": {"n": len(pm), "median": pm[len(pm) // 2] if pm else None,
                                "max": pm[-1] if pm else None},
            "slot_held": slot_held,
            "all_served": all(len(r.tokens) == gen for r in reqs),
            "drained": (engine.allocator.n_free == engine.allocator.capacity
                        and store._pins == {"__base__": 1} and not store._protect),
            "cold_tenants": len(store.cold_tenants), "bytes_per_tenant": store.bytes_per_tenant(),
            "lam_cold_bytes": value("lam_cold_bytes"),
            "cold_bytes_ok": value("lam_cold_bytes") == len(store.cold_tenants)
            * store.bytes_per_tenant(),
            "lam_promotes_total": value("lam_promotes_total"),
            "lam_spills_total": value("lam_spills_total")}


def cold_restart(cfg, params, seed: int, lams, traffic, root: str) -> dict:
    """The cold tier on an mmap file under ``root``: one engine serves the
    traffic, a second engine opened on the same file finds the same cold
    tenants and digests, promotes each one bitwise the λ the first engine
    registered, and serves the same traffic (the first engine's hot
    tenants registered again)."""
    import numpy as np
    from repro_torch.serving.lam_store import _flatten, _host_rows

    path = os.path.join(root, "cold.lam")
    first = cold_engine(cfg, params, seed, cold_path=path)
    run_a = cold_serve(first, lams, traffic)
    cold_a = list(first.lam_store.cold_tenants)
    digests = {t: first.lam_store.digest(t) for t in cold_a}
    del first
    gc.collect()
    second = cold_engine(cfg, params, seed, cold_path=path)
    store = second.lam_store
    found = list(store.cold_tenants) == cold_a and all(
        store.digest(t) == dg for t, dg in digests.items())
    bitwise = True
    for t in cold_a:
        slot = store.promote(t)
        want = _host_rows(_flatten(lams[t]))
        bitwise &= slot is not None and all(
            np.array_equal(tab[slot].cpu().numpy(), want[key])
            for key, tab in store.tables.items())
    run_b = cold_serve(second, {t: lam for t, lam in lams.items() if t not in store}, traffic)
    rows = compare_streams(run_b, run_a)
    del second
    return {"cold_tenants": len(cold_a), "found": found, "promoted_bitwise": bitwise,
            "rows": rows, "ok": found and bitwise and chunk_rows_ok(rows, "float32"),
            "runs": (run_a, run_b)}


def cold_faults(cfg, params, seed: int, lams, traffic, hot_run) -> dict:
    """Planted faults of the cold tier (float32), each on a fresh engine
    and held to the all-hot twin's streams and the slot check: a promotion
    that skips its device write; a promotion that writes the row into one
    slot and books the tenant at another (the other hot tenant, or the base,
    swapped into its slot); an admission that leaves its lane without the
    hot-slot pin, so a later promotion spills an active lane's tenant
    mid-generation."""
    out = {}
    traffic = traffic[:COLD_FAULT_REQUESTS]

    def judged(name, engine):
        try:
            run = cold_serve(engine, lams, traffic)
        except Exception as e:  # a fault may also break the serve outright
            out[name] = {"raised": repr(e), "rejected": True}
            return
        rows = compare_streams(run, hot_run)
        out[name] = {"slot_held": run["slot_held"], "promotes": run["promotes"],
                     "parted": [r["parted_at"] for r in rows],
                     "max_abs_dlogits": max(r["max_abs_dlogits"] for r in rows),
                     "rejected": not (run["slot_held"] and chunk_rows_ok(rows, "float32"))}

    eng = cold_engine(cfg, params, seed)
    store, promote = eng.lam_store, eng.lam_store.promote

    def unwritten(tenant):
        store._write_slots = lambda slots, rows: None
        try:
            return promote(tenant)
        finally:
            del store._write_slots

    store.promote = unwritten
    judged("promotion_skips_its_write", eng)
    eng = cold_engine(cfg, params, seed)
    store2, promote2 = eng.lam_store, eng.lam_store.promote

    def misplaced(tenant):
        slot = promote2(tenant)
        if slot is None:
            return None
        # the other hot tenant (or the base) takes this slot, the tenant its
        other = next((t for t in store2._slots if t not in (tenant, "__base__")), "__base__")
        store2._slots[tenant], store2._slots[other] = store2._slots[other], slot
        return store2._slots[tenant]

    store2.promote = misplaced
    judged("promotion_returns_another_slot", eng)
    eng = cold_engine(cfg, params, seed)
    store3, admit = eng.lam_store, eng._admit

    def unpinned_admit(finished):
        before = {r.uid for r in eng.scheduler.active()}
        admit(finished)
        for r in eng.scheduler.active():
            if r.uid not in before:
                store3.unpin(r.tenant)  # the gate's hot-slot pin not kept

    eng._admit = unpinned_admit
    judged("lane_holds_no_pin", eng)
    return out


def cold_phase(seed: int, params: dict) -> dict:
    """qwen2-0.5b at full width on the posture's weights with the λ-store's
    cold tier: ``EngineConfig.serving(n_lanes=4, n_slots=3, cold_slots=16,
    max_len=384)``, 12 tenants, 16 requests of 16 tokens, in float32 and
    bf16, each beside the same traffic on an all-hot engine (13 slots);
    the admission gate (promotion, spill) under sync debug mode "error";
    bf16 against the teacher-forced merged-weight reference; the restart on
    an mmap file in a temporary directory; the planted faults.  Returns every reading
    (without the requests); check_cold holds them to the bars."""
    import tempfile

    import torch

    out = {"seconds": {}}
    t0 = time.perf_counter()

    def lap(name):
        nonlocal t0
        now = time.perf_counter()
        out["seconds"][name] = now - t0
        t0 = now

    runs, res = {}, {}
    for dtype in ("float32", "bfloat16"):
        p = params[dtype]
        cfg = qwen_cfg(dtype)
        lams = cold_lams(seed, p)
        traffic = cold_traffic(seed, cfg.vocab_size)
        cuda = p["embed"].device.type == "cuda"
        eng = cold_engine(cfg, p, seed)
        runs[f"cold_{dtype}"] = cold_serve(eng, lams, traffic, sync_check=cuda)
        hot = cold_engine(cfg, p, seed, **COLD_ALL_HOT)
        runs[f"hot_{dtype}"] = cold_serve(hot, lams, traffic)
        drift = None if dtype == "float32" else BF16_DRIFT
        res[dtype] = {"cold_vs_hot": compare_streams(runs[f"cold_{dtype}"],
                                                     runs[f"hot_{dtype}"], drift)}
        if dtype == "bfloat16":
            res[dtype]["verify_forced"] = verify_forced(cfg, eng, lams,
                                                        runs[f"cold_{dtype}"]["done"])
        else:
            with tempfile.TemporaryDirectory() as tmp:
                restart = cold_restart(cfg, p, seed, lams, traffic, tmp)
            for i, run in enumerate(restart.pop("runs")):
                runs[f"restart_{'ab'[i]}"] = run
            res["restart"] = restart
            lap("float32")
            res["faults"] = cold_faults(cfg, p, seed, lams, traffic, runs["hot_float32"])
            lap("faults")
        del eng, hot
        _sync(p["embed"].device)
    lap("bfloat16")
    if p["embed"].device.type == "cuda":
        res["planted_sync_caught"] = sync_mode_catches_a_sync()
        torch.cuda.empty_cache()
    for run in runs.values():
        del run["done"]
    res["runs"] = runs
    return {**out, **res}


def print_cold(out: dict, smi: str) -> None:
    for name, run in out["runs"].items():
        print(f"{QWEN} cold tier {name}: {run['tokens']} tokens in {run['serve_s']:.3f} s = "
              f"{run['tok_per_s']:.1f} tok/s over {run['steps']} steps; promotes "
              f"{run['promotes']}, spills {run['spills']}, deferred promotions "
              f"{run['deferred_promotions']}, cold registers {run['cold_registers']}, LRU drops "
              f"{run['lru_drops']}; gate calls {run['gates']}, promoting gate host ms "
              f"{run['promote_gate_ms']}; slots held {run['slot_held']}, drained "
              f"{run['drained']}; lam_cold_bytes {run['lam_cold_bytes']} = "
              f"{run['cold_tenants']} × {run['bytes_per_tenant']} B: {run['cold_bytes_ok']}; "
              f"launches {run['launches']} on {smi}")
    for dtype in ("float32", "bfloat16"):
        rows = out[dtype]["cold_vs_hot"]
        print(f"  {dtype} cold vs all-hot: bitwise {sum(r['bitwise'] for r in rows)}/{len(rows)}, "
              f"parted {[r['parted_at'] for r in rows]}, max|Δlogits| "
              f"{max(r['max_abs_dlogits'] for r in rows):.3e}"
              + (f", over the bf16 bound {max(r['max_dlogits_over_bound'] for r in rows):.4f}"
                 if "max_dlogits_over_bound" in rows[0] else ""))
    worst = max(r["max_dlogits_over_bound"] for r in out["bfloat16"]["verify_forced"])
    print(f"  bf16 cold vs the teacher-forced merged-weight reference: worst {worst:.4f} of "
          f"the bound, all ok {all(r['ok'] for r in out['bfloat16']['verify_forced'])}")
    r = out["restart"]
    print(f"  restart on the mmap file: {r['cold_tenants']} cold tenants found "
          f"{r['found']}, promoted bitwise {r['promoted_bitwise']}, streams bitwise "
          f"{sum(x['bitwise'] for x in r['rows'])}/{len(r['rows'])}, max|Δlogits| "
          f"{max(x['max_abs_dlogits'] for x in r['rows']):.3e}")
    for name, f in out["faults"].items():
        print(f"  float32 planted fault {name}: rejected {f['rejected']}; {f}")
    print(f"  a planted host read under sync debug mode raises: "
          f"{out.get('planted_sync_caught')}; seconds {out['seconds']}")


def check_cold(out: dict) -> None:
    runs = out["runs"]
    for name, run in runs.items():
        _check(run["all_served"] and run["drained"] and run["slot_held"] and run["cold_bytes_ok"],
               f"{QWEN} cold tier {name}: not every request served, the pool or the pins not "
               f"drained, a lane's slot moved, or lam_cold_bytes off: {run}")
        _check_no_bench_kernels(run["launches"], f"{QWEN} cold tier {name}")
        _check(run["launches"]["qrlora_bgmv"] > 0 and run["launches"]["paged_decode_attention"] > 0,
               f"{QWEN} cold tier {name}: #1 or #2 never launched: {run['launches']}")
        if name.startswith("cold_"):
            _check(run["promotes"] > 0 and run["spills"] > 0 and run["deferred_promotions"] > 0
                   and run["promotes"] == run["lam_promotes_total"],
                   f"{QWEN} cold tier {name}: no promotion, spill or deferral, or the counters "
                   f"disagree with the metrics: {run}")
        if name.startswith("hot_"):
            _check(run["promotes"] == run["spills"] == run["deferred_promotions"] == 0,
                   f"{QWEN} cold tier {name}: the all-hot twin promoted or spilled: {run}")
    cold32 = runs["cold_float32"]["gates"]
    _check(cold32["spilled_and_promoted"] > 0 and out["planted_sync_caught"],
           f"{QWEN} cold tier: no admission gate both spilled and promoted under sync debug "
           f"mode, or the mode caught no planted sync: {cold32}")
    for dtype in ("float32", "bfloat16"):
        rows = out[dtype]["cold_vs_hot"]
        _check(chunk_rows_ok(rows, dtype),
               f"{QWEN} cold tier {dtype} differs from the all-hot serve: {rows}")
    _check(all(r["ok"] for r in out["bfloat16"]["verify_forced"]),
           f"{QWEN} cold tier bf16 disagrees with the teacher-forced merged-weight reference: "
           f"{out['bfloat16']['verify_forced']}")
    _check(out["restart"]["ok"], f"{QWEN} cold tier restart: {out['restart']}")
    for name, f in out["faults"].items():
        _check(f["rejected"], f"{QWEN}: the cold-tier check let the planted fault {name} "
                              f"through: {f}")


# ---------------------------------------------------------------------------
# the audio family: musicgen-medium over frame embeddings
# ---------------------------------------------------------------------------

AUDIO = "musicgen-medium"
AUDIO_TENANTS = 4
AUDIO_GEN = 16
# the profiled bf16 serve takes 2 of the 4 requests (PERF.md §4)
AUDIO_PROFILE_TENANTS = 2
# 16 steps: after 4, λ is still so small that bf16 rounding of Adam's
# sign-like first updates reads 0.34 of max|λ| between the kernel and its
# twin; after 16, 0.104 (an H100 at --seed 0), inside TRAIN_TOL's 0.25
AUDIO_TRAIN_STEPS, AUDIO_TRAIN_BATCH, AUDIO_TRAIN_SEQ = 16, 4, 256
# bf16 serve vs the merged-weight reference (BF16_DRIFT's check) at
# musicgen-medium's depth: 48 layers of d 1536 round more than smollm's 30
# of d 576.  Set from full-width readings on an H100 at --seed 0, in units
# of 2^-9 of a row's largest |logit|: sound serve 14.45, planted faults
# 15.17 (decode seg sent to slot 0), 19.1 (λ of one layer left out) and 57.8
# (attend misses the newest K/V).  The bound sits between the sound serve
# and the smallest fault (2.4% either side), and every run plants all three.
# The float32 serve (7e-6 against the 1e-3 bar) carries the fault detection.
AUDIO_BF16_DRIFT = 14.8 * 2.0**-9
# #1 at musicgen-medium's wq and wv (K = N = 1536, rank cap 128): 4 decode
# lanes and a 64-row prefill bucket
AUDIO_BGMV_SHAPES = [(M, 1536, 1536, 128) for M in (4, 64)]
# #2 at 24 query heads over 24 KV heads (one query head a group), dh 64,
# block 16: (lengths, columns of an 8-column table), ragged with 0 and 1
AUDIO_PAGED_CASES = (((0, 1, 17, 63), 4), ((64, 0, 1, 33), 8), ((1, 16, 48, 127), 8),
                     ((0, 0, 16, 15), 2))
# #3 bf16 at the audio train step's projections: batch 4 × seq 256 rows
AUDIO_MATMUL_SHAPE = (1024, 1536, 1536, 128)


def check_shape_kernels(gen, details, arch, bgmv_shapes, heads, paged_cases, matmul_shape=None):
    """#1, #2 and #3 against their plain versions at ``arch``'s shapes: #1
    at ``bgmv_shapes`` (M, K, N, r), #2 with ``heads`` (H, KV, dh) over
    ``paged_cases`` (lengths, columns of an 8-column table), bf16 and
    float32 x; #3 bf16 at ``matmul_shape`` (M, K, N, r) when given.  Each
    also bitwise on a second call, length-0 lanes zeros.  Returns the worst
    |Δ| of each."""
    import torch
    from repro_torch.benchmarks.kernel_bench import TOL as BENCH_TOL
    from repro_torch.kernels.paged_attention import paged_decode_attention_cuda
    from repro_torch.kernels.qrlora_bgmv import qrlora_bgmv_cuda
    from repro_torch.kernels.ref import paged_decode_attention_ref, qrlora_bgmv_ref

    H, KV, dh = heads
    worst = {}
    for dt in (torch.bfloat16, torch.float32):
        name = str(dt).split(".")[1]
        for M, K, N, r in bgmv_shapes:
            x, W, B, A, lam, seg = _bgmv_inputs(gen, M, K, N, r, 8, dt)
            y = qrlora_bgmv_cuda(x, W, B, A, lam, seg, 0.7)
            again = qrlora_bgmv_cuda(x, W, B, A, lam, seg, 0.7)
            torch.cuda.synchronize()
            ref = qrlora_bgmv_ref(x, W, B, A, lam, seg, 0.7)
            err = _max_err(y, ref)
            ok = (_within(y, ref, _tol("qrlora_bgmv", dt)) and bool(torch.isfinite(y).all())
                  and torch.equal(y, again))
            details.append({"kernel": "qrlora_bgmv", "arch": arch, "x": name, "M": M, "K": K,
                            "N": N, "r": r, "max_abs_err": err, "ok": ok})
            _check(ok, f"qrlora_bgmv at {arch} x={name} M={M} K={K} N={N} r={r}: max|Δ|="
                       f"{err:.3e} over {_tol('qrlora_bgmv', dt)}, or a second call differs")
            worst[f"qrlora_bgmv_{name}"] = max(worst.get(f"qrlora_bgmv_{name}", 0.0), err)
        tol = BENCH_TOL["paged_decode_attention"][dt]
        for lengths, cols in paged_cases:
            q, kp, vp, tbl, lens = _paged_inputs(gen, lengths, dt, H, KV, dh, 16, 8)
            args = (q, kp, vp, tbl[:, :cols], torch.clamp(lens, max=cols * 16))
            o = paged_decode_attention_cuda(*args)
            again = paged_decode_attention_cuda(*args)
            torch.cuda.synchronize()
            err, over = _max_err(o, paged_decode_attention_ref(*args)), _paged_over(o, args, tol)
            zero = all(bool((o[b] == 0).all()) for b, n in enumerate(lengths) if n == 0)
            ok = over <= 1.0 and bool(torch.isfinite(o).all()) and zero and torch.equal(o, again)
            details.append({"kernel": "paged_decode_attention", "arch": arch, "dtype": name,
                            "H": H, "KV": KV, "dh": dh, "lengths": list(lengths),
                            "columns": cols, "max_abs_err": err, "err_over_bound": over,
                            "ok": ok})
            _check(ok, f"paged_decode_attention at {arch} {name} lengths {lengths} over {cols} "
                       f"columns: {over:.3f} of the bound, a length-0 lane not zeros, or a "
                       f"second call differs")
            w = worst.setdefault(f"paged_decode_attention_{name}",
                                 {"max_abs_err": 0.0, "err_over_bound": 0.0})
            w["max_abs_err"] = max(w["max_abs_err"], err)
            w["err_over_bound"] = max(w["err_over_bound"], over)
    if matmul_shape is not None:
        M, K, N, r = matmul_shape
        row = _matmul_case(gen, "qrlora_matmul", torch.bfloat16, M, K, N, r, rank=r)
        details.append({**row, "arch": arch})
        _check(row["ok"], f"qrlora_matmul at {arch} M={M} K={K} N={N} r={r}: max|Δ|="
                          f"{row['max_abs_err']:.3e} ({row['err_over_bound']:.3f} of the bound), "
                          f"bitwise on a second call: {row['bitwise_repeat']}")
        worst["qrlora_matmul_bfloat16"] = row["max_abs_err"]
    return worst


def check_audio_kernels(gen, details):
    """:func:`check_shape_kernels` at musicgen-medium's shapes (24 heads
    over 24, dh 64)."""
    return check_shape_kernels(gen, details, AUDIO, AUDIO_BGMV_SHAPES, (24, 24, 64),
                               AUDIO_PAGED_CASES, AUDIO_MATMUL_SHAPE)


def audio_params(seed: int):
    """Full-width musicgen-medium's random params from ``seed`` (float32,
    QR-LoRA built on the card) and the same weights in bf16 (λ stays
    float32, the QR factors are bf16 either way).  Returns ({dtype:
    params}, seconds)."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.tree import tree_map

    t0 = time.perf_counter()
    cfg = get_config(AUDIO).replace(dtype="float32")
    p32 = build_model(cfg).init(torch.Generator(device="cuda").manual_seed(seed))
    groups16 = {k: tree_map(lambda t: t.bfloat16() if t.dtype == torch.float32 else t, v)
                for k, v in p32["groups"].items() if k != "adapters"}
    groups16["adapters"] = p32["groups"]["adapters"]
    p16 = {k: (v.bfloat16() if isinstance(v, torch.Tensor) else v) for k, v in p32.items()
           if k != "groups"}
    p16["groups"] = groups16
    torch.cuda.synchronize()
    return {"float32": p32, "bfloat16": p16}, time.perf_counter() - t0


def audio_embeds_check(seed: int, params) -> dict:
    """``tests/test_decode_consistency.py:37-42`` at full width (float32):
    frame embeddings (2 × 12, scale 0.1) through ``apply(embeds=)``, and a
    prefill of the first 11 frames and a decode of the 12th through the
    lock-step cache, against the full forward's last two rows."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import build_model

    cfg = get_config(AUDIO).replace(dtype="float32")
    m = build_model(cfg)
    B, S = 2, 12
    gen = torch.Generator(device="cuda").manual_seed(seed + 7000)
    emb = torch.randn((B, S, cfg.d_model), generator=gen, device="cuda") * 0.1
    with torch.no_grad():
        full = m.apply(params, embeds=emb)
        cache = m.init_decode_state(B, 32, torch.float32)
        pre, cache = m.prefill(params, cache, embeds=emb[:, :S - 1])
        dec, cache = m.decode_step(params, cache, embeds=emb[:, S - 1:])
    scale = float(full.abs().max())
    atol = 3e-5 * max(scale, 1.0)
    e_pre, e_dec = _max_err(pre, full[:, S - 2]), _max_err(dec, full[:, S - 1])
    return {"prefill_err": e_pre, "decode_err": e_dec, "atol": atol,
            "finite": bool(torch.isfinite(full).all()),
            "ok": e_pre <= atol and e_dec <= atol and bool(torch.isfinite(full).all())}


def audio_train(params, seed: int) -> dict:
    """A few λ-only steps of full-width musicgen-medium (bf16) on frame
    embeddings (batch 4 × seq 256, code targets) through the train
    launcher's functions, beside the same run with the plain version in
    place of the one-λ kernel; launches counted."""
    import torch
    from repro_torch import kernels
    from repro_torch.configs import get_config
    from repro_torch.kernels import qrlora_matmul as mm
    from repro_torch.launch import train as tl
    from repro_torch.models import build_model
    from repro_torch.training import init_train_state

    model = build_model(get_config(AUDIO))  # bfloat16, the config's own
    out, runs = {}, {}
    for name, fwd in (("kernel", None), ("plain_twin", plain_forward)):
        kernels.reset_launch_counts()
        state = init_train_state(model, params=params)
        step_fn = tl.make_step(model, TRAIN_LR, AUDIO_TRAIN_STEPS)
        data = tl.batches(model.cfg, AUDIO_TRAIN_BATCH, AUDIO_TRAIN_SEQ, seed, model.device)
        with contextlib.ExitStack() as stack:
            if fwd is not None:
                stack.enter_context(swapped(mm, "qrlora_matmul", fwd))
            else:
                stack.enter_context(recompute_launches(out.setdefault("launches_recompute", {})))
            runs[name] = tl.train(step_fn, state, data, AUDIO_TRAIN_STEPS)
        torch.cuda.synchronize()
        out[f"launches_{name}"] = kernels.launch_counts()
    out["losses"] = [h["loss"] for h in runs["kernel"][1]]
    out.update(tl.summary(runs["kernel"][1], AUDIO_TRAIN_BATCH * AUDIO_TRAIN_SEQ))
    out["twin"] = compare_trains(runs["kernel"], runs["plain_twin"])
    out["n_layers"] = model.cfg.n_layers
    return out


def audio_phase(seed: int) -> dict:
    """musicgen-medium at full width (48 layers, d 1536, 24 heads over 24,
    vocab 2048; random weights from ``seed``): the default-config serve of
    4 tenants (prompts of 16-48 codes, 16 new tokens) in float32 and bf16,
    held against the merged-weight reference (bf16 teacher-forced) and
    profiled (bf16); the embeds prefill/decode against the full forward;
    the bf16 train steps beside their plain twin.  Returns every reading."""
    import torch
    from repro_torch import kernels
    from repro_torch.tree import tree_leaves

    out = {"seconds": {}}
    t0 = time.perf_counter()

    def lap(name):
        nonlocal t0
        now = time.perf_counter()
        out["seconds"][name] = now - t0
        t0 = now

    params, out["init_s"] = audio_params(seed)
    n_params = sum(t.numel() for t in tree_leaves(params["float32"]))
    out["n_params"] = n_params
    lap("init")
    out["embeds"] = audio_embeds_check(seed, params["float32"])
    lap("embeds")
    for dtype in ("float32", "bfloat16"):
        kernels.reset_launch_counts()
        cfg, engine, lams, done, _, t_serve = serve(dtype, seed, n_tenants=AUDIO_TENANTS,
                                                    gen_len=AUDIO_GEN, params=params[dtype],
                                                    arch=AUDIO)
        launches = kernels.launch_counts()
        res = {"serve_s": t_serve, "tokens": engine.decoded_tokens, "steps": engine.steps,
               "tok_per_s": engine.decoded_tokens / t_serve, "launches": launches,
               "all_served": len(done) == AUDIO_TENANTS and all(
                   len(r.tokens) == AUDIO_GEN for r in done.values()),
               "verify": verify(cfg, engine, lams, done, AUDIO_GEN, drift=AUDIO_BF16_DRIFT)}
        if dtype == "bfloat16":
            res["verify_forced"] = verify_forced(cfg, engine, lams, done, drift=AUDIO_BF16_DRIFT)
            res["profile"] = profile_serve(engine, seed + 1, n_tenants=AUDIO_PROFILE_TENANTS,
                                           gen_len=AUDIO_GEN, host_ops=False)
            res["planted_faults"] = planted_faults(cfg, engine, lams, done,
                                                   drift=AUDIO_BF16_DRIFT)
        out[f"serve_{dtype}"] = res
        del engine
        torch.cuda.empty_cache()
        lap(f"serve_{dtype}")
    del params["float32"]
    torch.cuda.empty_cache()
    out["train"] = audio_train(params["bfloat16"], seed)
    lap("train")
    del params
    torch.cuda.empty_cache()
    return out


def print_audio(out: dict, smi: str) -> None:
    print(f"{AUDIO}: {out['n_params']} parameters, init {out['init_s']:.1f} s (random weights "
          f"+ QR-LoRA on the card); embeds prefill/decode vs the full forward {out['embeds']}")
    for dtype in ("float32", "bfloat16"):
        s = out[f"serve_{dtype}"]
        print(f"{AUDIO} serve {dtype}: {s['tokens']} tokens in {s['serve_s']:.3f} s = "
              f"{s['tok_per_s']:.1f} tok/s over {s['steps']} steps; launches {s['launches']} on "
              f"{smi}")
        for row in s["verify"]:
            print(f"  {dtype} free-running vs the merged-weight reference: {row}")
        for row in s.get("verify_forced", ()):
            print(f"  bf16 vs the teacher-forced merged-weight reference: {row}")
    faults = out["serve_bfloat16"]["planted_faults"]
    sound = max(r["max_dlogits_over_bound"] for r in out["serve_bfloat16"]["verify_forced"])
    print(f"  bf16 drift readings (|Δlogits| over the bound {AUDIO_BF16_DRIFT / 2**-9:.1f}·2^-9 of "
          f"each row's max): sound serve {sound:.4f}, planted faults "
          + ", ".join(f"{n} {r['max_dlogits_over_bound']:.4f}" for n, r in faults.items()))
    print(f"  profiled bf16 serve: {out['serve_bfloat16']['profile']}")
    t = out["train"]
    print(f"{AUDIO} train bf16: {AUDIO_TRAIN_STEPS} steps at batch {AUDIO_TRAIN_BATCH} × seq "
          f"{AUDIO_TRAIN_SEQ} (frame embeddings), median step {t['median_step_ms']:.1f} ms, "
          f"{t['tokens_per_s']:.0f} train tokens/s, losses {t['losses']}; vs plain twin "
          f"{t['twin']} (bound {TRAIN_TOL['bfloat16']}); launches {t['launches_kernel']}; "
          f"seconds {out['seconds']}")


def check_audio(out: dict) -> None:
    _check(out["embeds"]["ok"], f"{AUDIO} embeds prefill/decode vs full forward: {out['embeds']}")
    for dtype in ("float32", "bfloat16"):
        s = out[f"serve_{dtype}"]
        _check(s["all_served"], f"{AUDIO} serve {dtype}: not every tenant got its tokens")
        _check(s["launches"]["qrlora_bgmv"] > 0 and s["launches"]["paged_decode_attention"] > 0,
               f"{AUDIO} serve {dtype}: #1 or #2 never launched: {s['launches']}")
        _check_no_bench_kernels(s["launches"], f"{AUDIO} serve {dtype}")
        if dtype == "float32":
            _check(all(r["tokens_match"] and r["max_abs_dlogits"] < FP32_LOGIT_TOL
                       for r in s["verify"]),
                   f"{AUDIO} fp32 serve diverged from the merged-weight reference: {s['verify']}")
        else:
            _check(all(r["ok"] for r in s["verify_forced"]),
                   f"{AUDIO} bf16 serve disagrees with the teacher-forced merged-weight "
                   f"reference: {s['verify_forced']}")
            for name, row in s["planted_faults"].items():
                _check(not row["ok"], f"{AUDIO}: the bf16 check let the planted fault {name} "
                                      f"through: {row}")
            for r in s["verify"]:
                _check(r["tokens_match"] or r["parting_margin"] <= r["parting_bound"],
                       f"{AUDIO} bf16 {r['tenant']} parts from the merged-weight reference "
                       f"where its lead is above the drift bound: {r}")
    t = out["train"]
    # wq and wv of every layer, every step
    check_train_launches(f"{AUDIO} train", t, 2 * t["n_layers"] * AUDIO_TRAIN_STEPS)
    _check(within_train_tol(t["twin"], "bfloat16"),
           f"{AUDIO} train disagrees with its plain-version twin: {t['twin']}")


# ---------------------------------------------------------------------------
# the moe family: moonshot-v1-16b-a3b at full width, mixtral-8x22b's shapes
# ---------------------------------------------------------------------------

MOE = "moonshot-v1-16b-a3b"
MIXTRAL = "mixtral-8x22b"
MOE_TENANTS = 4
MOE_GEN = 16
# the drop-free twin: C = min(max(8, ⌈11·T·6/64⌉), 6T) ≥ T for every T, so
# no expert overflows and a token's output no longer depends on its batch
# (the merged reference prefills the exact prompt, the engine its bucket)
MOE_DROP_FREE_CF = 11.0
# the float32 twin's depth: 8 of 48 layers (≈ 20.9 GB; all 48 would be 112 GB)
MOE_FP32_LAYERS = 8
MOE_TRAIN_STEPS, MOE_TRAIN_BATCH, MOE_TRAIN_SEQ = 4, 8, 256
# the bf16 train at full depth holds the loss only: 2 steps (4 until remat
# made each step ≈ 10 s, PERF.md §4); the float32 train keeps 4
MOE_BF16_TRAIN_STEPS = 2
# the float32 train twin's depth: the last layers of the float32 twin's tree
# (all adapted).  Set from readings on an H100 at --seed 0, |Δλ| over max|λ|
# after 4 steps, sound twin / λ of the last wq dropped: 1 layer 7.4e-6 /
# 8.0e-4, 2 layers 2.7e-5 / 8.1e-4, 4 layers 7.7e-5 / 3.5e-4, 8 layers 5.0e-4
# / 1.2e-3 (random moe layers amplify float32 summation order as bf16's
# rounding): at 2 the λ bound TRAIN_TOL["float32"] holds the twin 3.6× under
# it and rejects the fault 8.1× over it, and λ of the lower layer goes
# through the upper layer's moe backward too.
MOE_FP32_TRAIN_LAYERS = 2
# _BmmF32 (the expert matmuls' bf16 route, forward and backward) at a train
# microbatch's shapes: 64 experts of C = 30 rows, d 2048, f 1408
MOE_BMM_SHAPES = ((64, 30, 2048, 1408), (64, 30, 1408, 2048))
# bf16 drop-free serve vs the teacher-forced merged-weight reference routed
# as the engine routed, at moonshot's depth, in units of 2^-9 of a row's
# largest |logit|.  Set from full-width readings on an H100 at --seed 0: the
# sound serve 119.7, the planted faults 781 (unrenormalised gates) and 75.3
# (decode seg sent to slot 0: the last 4 layers' λ, below the drift of 48
# random layers: every moe layer adds its bf16 rounding at the residual
# stream's own scale, moe_drift_by_layer).  Routed freely, the reference
# flips 8,426 of 10,944 (token, layer) top-6 sets and reads 851·2^-9.
MOE_BF16_DRIFT = 160 * 2.0**-9
# the same serve against the merged-weight reference over the adapted layers
# only, run on the engine's own residual stream at the first of them
# (moe_verify_tail): the drift of the 44 layers below, which carry no
# adapter, stays out.  Set from full-width readings on an H100 at --seed 0
# (PERF.md, Findings): the sound serve 1.86-2.10 over its 4 tenants, the
# planted faults 3.81 (decode seg sent to slot 0) and 244 (unrenormalised
# gates).
MOE_BF16_TAIL_DRIFT = 3 * 2.0**-9
# the profiled shipped serve takes 2 of the 4 requests for 8 tokens each
# (all four for 16 make 142k device events, most of a minute to read back)
MOE_PROFILE_TENANTS, MOE_PROFILE_GEN = 2, 8
# the dispatch on the card against the CPU's: one layer, float32, T rows
MOE_DISPATCH_ROWS = 64
MOE_DISPATCH_RTOL = 1e-5
# #1 at moonshot's wq and wv (K = N = 2048, rank cap 160): 4 decode lanes
# and a 64-row prefill bucket; #2 at 16 heads over 16, dh 128; #3 bf16 at a
# train microbatch's 256 rows
MOE_BGMV_SHAPES = [(M, 2048, 2048, 160) for M in (4, 64)]
MOE_PAGED_CASES = (((0, 1, 17, 63), 4), ((64, 0, 1, 33), 8), ((1, 16, 48, 127), 8),
                   ((0, 0, 16, 15), 2))
MOE_MATMUL_SHAPE = (256, 2048, 2048, 160)
# mixtral-8x22b (no serve on one card): #1 at wq (K = N = 6144) and wv
# (N = 1024, 8 kv heads of 128), rank cap 256; #2 at 48 heads over 8, dh 128
MIXTRAL_BGMV_SHAPES = [(4, 6144, 6144, 256), (4, 6144, 1024, 256), (64, 6144, 6144, 256)]


def forcing_top_k(chosen):
    """A stand-in for ``moe._top_k`` that takes each call's experts (T, k)
    from the iterator ``chosen`` in place of the router's own top-k; the
    gates are this router's probabilities there (``route`` renormalises
    them).  Swapped in, it holds a forward to a routing chosen elsewhere."""
    import torch

    def top_k(probs, k):
        experts = next(chosen)
        return torch.gather(probs, 1, experts), experts

    return top_k


@contextlib.contextmanager
def residuals_recorded():
    """The layer stack's residual stream: the input of every
    ``transformer.rms_norm`` call (ln1 of layer l is call 2l, its ln2 call
    2l + 1, the final norm call 2L), appended to the list this yields."""
    from repro_torch.models import transformer

    xs, real = [], transformer.rms_norm

    def norm(x, scale, eps=1e-5):
        xs.append(x)
        return real(x, scale, eps)

    with swapped(transformer, "rms_norm", norm):
        yield xs


class RouteLog:
    """An engine's serve with ``moe.route`` wrapped: every call's top-k
    experts and dropped copies (device tensors, read after the run), and
    every forward's residual stream at each layer's input, under the
    forward they belong to (``("prefill", uid, None)`` or ``("decode",
    None, {lane: (uid, position)})``, set by wrapping the engine's
    ``_admit_paged`` and ``_dispatch_decode``)."""

    def __init__(self):
        self.calls, self.context, self.norms = [], None, []

    @contextlib.contextmanager
    def installed(self, engine):
        from repro_torch.models import moe

        real = moe.route

        def logged(x, wr, k, C):
            r = real(x, wr, k, C)
            self.calls.append((self.context, r.experts, (r.copy_slot == wr.shape[-1] * C).sum()))
            return r

        def admit(req, padded, _real=engine._admit_paged):
            self.norms.append((("prefill", req.uid, None), len(xs)))
            self.context = self.norms[-1][0]
            return _real(req, padded)

        def decode(decoding, _real=engine._dispatch_decode):
            self.context = ("decode", None, {r.lane: (r.uid, r.prompt.size + len(r.tokens) - 1)
                                             for r in decoding})
            self.norms.append((self.context, len(xs)))
            return _real(decoding)

        engine._admit_paged, engine._dispatch_decode = admit, decode
        try:
            with residuals_recorded() as xs, swapped(moe, "route", logged):
                yield self
        finally:
            del engine._admit_paged, engine._dispatch_decode
            self.norms = [(ctx, xs[start:end]) for (ctx, start), end in zip(
                self.norms, [s for _, s in self.norms[1:]] + [len(xs)])]

    def forwards(self):
        """The calls grouped by forward: [(context, [(experts, dropped) per
        layer])], read to the host."""
        out = []
        for ctx, experts, dropped in self.calls:
            if not out or out[-1][0] is not ctx:
                out.append((ctx, []))
            out[-1][1].append((experts.cpu().numpy(), int(dropped)))
        return out

    def drops(self, n_layers: int) -> dict:
        """Copies dropped by each prefill and each decode step (summed over
        the layers)."""
        per = {"prefill": [], "decode": []}
        for ctx, layers in self.forwards():
            _check(len(layers) == n_layers, f"a forward routed {len(layers)} layers")
            per[ctx[0]].append(sum(d for _, d in layers))
        return {kind: {"n": len(v), "total": sum(v), "max": max(v, default=0),
                       "mean": (sum(v) / len(v)) if v else 0.0, "each": v}
                for kind, v in per.items()}

    def rows(self, prompts: dict) -> dict:
        """(uid, position, layer) → the engine's top-k experts there, in
        its order (prefill rows past the prompt are the bucket's padding)."""
        out = {}
        for (kind, uid, lanes), layers in self.forwards():
            for layer, (experts, _) in enumerate(layers):
                if kind == "prefill":
                    for pos in range(prompts[uid]):
                        out[(uid, pos, layer)] = experts[pos]
                elif kind == "decode":
                    for lane, (u, pos) in lanes.items():
                        out[(u, pos, layer)] = experts[lane]
        return out

    def residuals(self, prompts: dict, n_layers: int) -> dict:
        """(uid, position) → the engine's residual stream there at each
        layer's input, (n_layers, d), left on the device."""
        import torch

        out = {}
        for (kind, uid, lanes), xs in self.norms:
            x = torch.stack([t.reshape(-1, t.shape[-1]) for t in xs[0:2 * n_layers:2]], 1)
            if kind == "prefill":
                for pos in range(prompts[uid]):
                    out[(uid, pos)] = x[pos]
            else:
                for lane, (u, pos) in lanes.items():
                    out[(u, pos)] = x[lane]
        return out

    def forcing(self, prompts: dict, layers, device):
        """A context per request that holds its reference forward's moe
        layers ``layers`` (in order) to the experts the engine chose for
        each of its rows there: ``ctx(req)`` for the prompt and fed tokens,
        ``ctx(req, n)`` for the first ``n`` rows."""
        import numpy as np
        import torch
        from repro_torch.models import moe

        rows = self.rows(prompts)

        @contextlib.contextmanager
        def ctx(req, n=None):
            n = req.prompt.size + len(req.tokens) - 1 if n is None else n
            chosen = iter([torch.from_numpy(np.stack([rows[(req.uid, pos, layer)]
                                                      for pos in range(n)])).to(device)
                           for layer in layers])
            with swapped(moe, "_top_k", forcing_top_k(chosen)):
                yield

        return ctx


def moe_params(seed: int, cfg):
    """``cfg``'s random params from ``seed``, drawn layer by layer on the
    card, QR-LoRA built there; (params, seconds, peak GiB allocated)."""
    import torch
    from repro_torch.models import build_model

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = build_model(cfg).init(torch.Generator(device="cuda").manual_seed(seed))
    torch.cuda.synchronize()
    return params, time.perf_counter() - t0, torch.cuda.max_memory_allocated() / 2**30


def last_layers_on_host(params, n: int):
    """The float32 twin's params from the bf16 tree, in host memory (so the
    two trees never share the card): the last ``n`` layers of every stacked
    leaf under ``groups`` (the adapted layers among them, with their QR
    factors, ranks and λ), the embedding, final norm and unembedding; every
    bf16 weight in float32, the bf16 QR factors as they are (as a float32
    model's init leaves them)."""
    import torch

    def walk(node, path):
        if isinstance(node, dict):
            return {k: walk(v, path + (k,)) for k, v in node.items()}
        t = (node[-n:] if path[0] == "groups" else node).cpu()
        keep = t.dtype != torch.bfloat16 or path[-1] in ("B", "A")
        return t if keep else t.float()

    return walk(params, ())


def moe_dispatch_check(params, cfg, seed: int) -> dict:
    """Layer 0's ``moe_ffn`` in float32 at ``MOE_DISPATCH_ROWS`` rows (the
    shipped capacity: copies drop) on the card, twice, and on the CPU on the
    same inputs: the same slots for every copy, y within
    ``MOE_DISPATCH_RTOL``·max(1, |y|), the two card runs bitwise."""
    import torch
    from repro_torch.models import moe

    p = {k: v[0].float() for k, v in params["groups"]["moe"].items()}
    dev = p["w_router"].device
    gen = torch.Generator(device=dev).manual_seed(seed + 9000)
    x = torch.randn((1, MOE_DISPATCH_ROWS, cfg.d_model), generator=gen, device=dev)
    C = moe.capacity(cfg, MOE_DISPATCH_ROWS)
    with torch.no_grad():
        y, aux = moe.moe_ffn(p, x, cfg)
        y2, aux2 = moe.moe_ffn(p, x, cfg)
        r = moe.route(x[0], p["w_router"], cfg.experts_per_token, C)
        pc = {k: v.cpu() for k, v in p.items()}
        yc, auxc = moe.moe_ffn(pc, x.cpu(), cfg)
        rc = moe.route(x[0].cpu(), pc["w_router"], cfg.experts_per_token, C)
    E = cfg.n_experts
    dropped = int((rc.copy_slot == E * C).sum())
    err = _max_err(y.cpu(), yc)
    scale = max(1.0, float(yc.abs().max()))
    out = {"T": MOE_DISPATCH_ROWS, "C": C, "copies": MOE_DISPATCH_ROWS * cfg.experts_per_token,
           "dropped": dropped, "same_slots": torch.equal(r.copy_slot.cpu(), rc.copy_slot),
           "max_abs_dy": err, "dy_rel": err / scale, "aux_cuda": float(aux),
           "aux_cpu": float(auxc), "bitwise_repeat": torch.equal(y, y2) and torch.equal(aux, aux2)}
    out["ok"] = (out["same_slots"] and out["dy_rel"] <= MOE_DISPATCH_RTOL and dropped > 0
                 and out["bitwise_repeat"] and abs(out["aux_cuda"] - out["aux_cpu"]) <= 1e-5)
    return out


def same_streams_bitwise(done, again) -> bool:
    import numpy as np

    a, b = _by_request(done), _by_request(again)
    return a.keys() == b.keys() and all(
        a[k].tokens == b[k].tokens and all(np.array_equal(x, y) for x, y in zip(a[k].logits,
                                                                               b[k].logits))
        for k in a)


def resubmit(engine, done) -> dict:
    """The requests of ``done`` served again, in their order, on ``engine``."""
    for uid in sorted(done):
        r = done[uid]
        engine.submit(r.tenant, r.prompt, len(r.tokens))
    return engine.run()


def _prompts(done) -> dict:
    return {uid: int(r.prompt.size) for uid, r in done.items()}


def routing_flips(cfg, engine, lams, done, log: RouteLog) -> dict:
    """Where the engine's top-k set for a (token, layer) differs from the
    teacher-forced merged-weight reference's own (one forward over each
    prompt and the engine's own tokens, routed freely): the count, the count
    by layer, and the first few with the reference's gap there (its k-th
    probability less the largest it gives an expert only the engine chose:
    a near-tie when small)."""
    import numpy as np
    import torch
    from repro_torch.models import build_model, moe
    from repro_torch.serving import merge_tenant_params

    model = build_model(cfg, engine.device)
    prompts = _prompts(done)
    eng_sets = {key: frozenset(row.tolist()) for key, row in log.rows(prompts).items()}
    real = moe.route
    flips, compared = [], 0
    by_layer = [0] * cfg.n_layers
    for uid in sorted(done):
        req = done[uid]
        seq = np.concatenate([req.prompt, np.asarray(req.tokens[:-1], np.int32)])
        merged = merge_tenant_params(engine.params, cfg, lams[req.tenant])
        seen = []

        def logged(x, wr, k, C):
            r = real(x, wr, k, C)
            seen.append((r.experts, r.probs))
            return r

        with swapped(moe, "route", logged), torch.no_grad():
            model.apply(merged, torch.from_numpy(seq).to(engine.device)[None])
        for layer, (experts, probs) in enumerate(seen):
            experts, probs = experts.cpu().numpy(), probs.cpu().numpy()
            for pos in range(seq.size):
                got = eng_sets.get((uid, pos, layer))
                if got is None:
                    continue
                compared += 1
                want = frozenset(experts[pos].tolist())
                if got != want:
                    by_layer[layer] += 1
                    p = probs[pos]
                    gap = float(p[sorted(want)].min() - p[sorted(got - want)].max())
                    flips.append({"uid": uid, "pos": pos, "layer": layer, "gap": gap,
                                  "engine": sorted(got), "reference": sorted(want)})
    flips.sort(key=lambda f: f["layer"])
    return {"compared": compared, "flips": len(flips), "by_layer": by_layer,
            "first": flips[:6]}


def moe_verify_forced(cfg, engine, lams, done, log: "RouteLog", drift: float):
    """:func:`verify_forced` with the reference routed as the engine routed
    (``log`` of the serve of ``done``): at full depth in bf16 a rounding
    difference flips one expert of a near-tie, moves that token by a whole
    expert, and the flips compound layer by layer."""
    from repro_torch.models import build_model

    model = build_model(cfg, engine.device)
    forcing = log.forcing(_prompts(done), range(cfg.n_layers), engine.device)

    def forward(req, merged, tokens):
        with forcing(req):
            return model.apply(merged, tokens)

    return verify_forced(cfg, engine, lams, done, drift, forward=forward)


def _rel_by_layer(x, ref):
    """(L, S, d) pairs → per layer, the largest over rows of a row's max|Δ|
    over that row's max|ref|."""
    x, ref = x.float(), ref.float()
    return ((x - ref).abs().amax(-1) / ref.abs().amax(-1).clamp_min(1e-30)).amax(-1)


def moe_drift_by_layer(cfg, engine, lams, done, log: "RouteLog") -> dict:
    """Where the drift of :func:`moe_verify_forced` enters: the engine's
    residual stream at each layer's input against the teacher-forced
    merged-weight reference's, routed as the engine routed (per layer, the
    largest |Δ| of a row over that row's largest |x|, over every request's
    rows).  Beside it, the reference over each prompt alone against the
    reference over the prompt and the generated tokens, prompt rows only:
    the same arithmetic at another row count, so another expert capacity
    and other cuBLAS shapes."""
    import numpy as np
    import torch
    from repro_torch.models import build_model
    from repro_torch.serving import merge_tenant_params

    L = cfg.n_layers
    model = build_model(cfg, engine.device)
    prompts = _prompts(done)
    res = log.residuals(prompts, L)
    forcing = log.forcing(prompts, range(L), engine.device)
    eng = rows = torch.zeros(L, device=engine.device)
    for uid in sorted(done):
        req = done[uid]
        P = req.prompt.size
        seq = np.concatenate([req.prompt, np.asarray(req.tokens[:-1], np.int32)])
        tokens = torch.from_numpy(seq).to(engine.device)[None]
        merged = merge_tenant_params(engine.params, cfg, lams[req.tenant])
        with torch.no_grad():
            with forcing(req), residuals_recorded() as whole:
                model.apply(merged, tokens)
            with forcing(req, P), residuals_recorded() as alone:
                model.apply(merged, tokens[:, :P])
        whole = torch.stack([t[0] for t in whole[0:2 * L:2]])  # (L, S, d)
        alone = torch.stack([t[0] for t in alone[0:2 * L:2]])
        mine = torch.stack([res[(uid, pos)] for pos in range(seq.size)], 1)
        eng = torch.maximum(eng, _rel_by_layer(mine, whole))
        rows = torch.maximum(rows, _rel_by_layer(alone, whole[:, :P]))
    return {"engine_vs_reference": eng.tolist(), "prompt_alone_vs_whole": rows.tolist()}


def first_adapted_layer(params) -> int:
    """The lowest layer with a selected rank in any adapted projection."""
    import torch

    ranks = torch.stack([leaf["ranks"].cpu() for projs in params["groups"]["adapters"].values()
                         for leaf in projs.values()])
    return int(torch.nonzero(ranks.amax(0) > 0).min())


def moe_verify_tail(cfg, engine, lams, done, log: "RouteLog", drift: float):
    """:func:`verify_forced` over the adapted layers only: from the first
    adapted layer on, the merged-weight reference runs on the engine's own
    residual stream there (every prompt and fed position, from ``log``),
    routed as the engine routed, then the final norm and the unembedding.
    The layers below carry no adapter, so the engine and the reference run
    the same weights there: this holds the adapter path (#1, its seg, the
    λ rows) to the merged weights without the drift that the random moe
    layers below add (:func:`moe_drift_by_layer`)."""
    import torch
    from repro_torch.models import transformer
    from repro_torch.tree import tree_map

    first = first_adapted_layer(engine.params)
    prompts = _prompts(done)
    res = log.residuals(prompts, cfg.n_layers)
    forcing = log.forcing(prompts, range(first, cfg.n_layers), engine.device)
    tail_cfg = cfg.replace(n_layers=cfg.n_layers - first)

    def forward(req, merged, tokens):
        S = tokens.shape[1]
        x = torch.stack([res[(req.uid, pos)][first] for pos in range(S)])[None]
        tail = {**merged, "groups": tree_map(lambda t: t[first:], merged["groups"])}
        with forcing(req):
            x, _ = transformer._run_layers(tail, tail_cfg, x, torch.arange(S, device=x.device),
                                           None)
        return transformer._logits(tail, tail_cfg, x)

    rows = verify_forced(cfg, engine, lams, done, drift, forward=forward)
    for r in rows:
        r["from_layer"] = first
    return rows


def moe_bf16_checks(cfg, engine, lams, done, log: "RouteLog") -> dict:
    """The bf16 drop-free serve's two teacher-forced checks, each row's
    ``ok``: the whole depth at ``MOE_BF16_DRIFT`` and the adapted layers at
    ``MOE_BF16_TAIL_DRIFT``."""
    return {"full": moe_verify_forced(cfg, engine, lams, done, log, MOE_BF16_DRIFT),
            "tail": moe_verify_tail(cfg, engine, lams, done, log, MOE_BF16_TAIL_DRIFT)}


def moe_planted_faults(cfg, engine, lams, done, check) -> dict:
    """tenant0's request served again under two planted faults, each read
    by ``check(cfg, engine, lams, served, log)``: the decode step's seg
    sending every lane to slot 0 (the base model), and the top-k gates
    left unrenormalised (raw softmax probabilities) in the engine only, the
    reference routing soundly."""
    import numpy as np
    import torch
    from repro_torch.models import moe

    req0 = next(r for r in done.values() if r.tenant == "tenant0")
    lam0 = {"tenant0": lams["tenant0"]}
    out = {}

    def serve_logged():
        log = RouteLog()
        with log.installed(engine):
            engine.submit("tenant0", req0.prompt, len(req0.tokens))
            return engine.run(), log

    engine.scheduler.batch_composition = lambda: np.zeros((engine.n_lanes,), np.int32)
    try:
        served, log = serve_logged()
    finally:
        del engine.scheduler.batch_composition
    out["decode_seg_to_slot0"] = check(cfg, engine, lam0, served, log)
    real = moe.route

    def raw_gates(x, wr, k, C):
        r = real(x, wr, k, C)
        return r._replace(gates=torch.gather(r.probs, 1, r.experts))

    with swapped(moe, "route", raw_gates):
        served, log = serve_logged()
    out["topk_not_renormalised"] = check(cfg, engine, lam0, served, log)
    return out


def moe_fp32_check(cfg, engine, lams, done, log=None):
    """:func:`verify` rows, each ``ok`` when its tokens equal the merged
    reference's and its logits are within ``FP32_LOGIT_TOL``."""
    rows = verify(cfg, engine, lams, done, MOE_GEN)
    for r in rows:
        r["ok"] = r["tokens_match"] and r["max_abs_dlogits"] < FP32_LOGIT_TOL
    return rows


def moe_bmm_check(gen) -> list:
    """``moe._BmmF32`` (the expert matmuls' bf16 route: a float32 output
    and the backward as JAX transposes it) against autograd through the
    float32 upcast at ``MOE_BMM_SHAPES``: y within 1e-5 of max|y| (float32
    summation order), da and db within one bf16 step (2^-7) of their
    largest.  A planted fault, the backward's da taken against the next
    expert's weights, must be rejected."""
    import torch
    from repro_torch.models import moe

    class NextExpert(moe._BmmF32):
        @staticmethod
        def backward(ctx, g):
            a, b = ctx.saved_tensors
            return torch.bmm(g, b.roll(1, 0).float().mT).to(a.dtype), None

    def rel(x, ref):
        return float((x.float() - ref.float()).abs().max() / ref.float().abs().max())

    rows = []
    for E, C, K, N in MOE_BMM_SHAPES:
        a = torch.randn((E, C, K), generator=gen, device="cuda").bfloat16()
        b = (torch.randn((E, K, N), generator=gen, device="cuda") * K**-0.5).bfloat16()
        g = torch.randn((E, C, N), generator=gen, device="cuda")
        grads = {}
        for name, fn in (("kernel", moe._BmmF32.apply), ("fault", NextExpert.apply),
                         ("plain", lambda x, w: torch.bmm(x.float(), w.float()))):
            x, w = a.clone().requires_grad_(), b.clone().requires_grad_(name != "fault")
            y = fn(x, w)
            y.backward(g)
            grads[name] = (y.detach(), x.grad, w.grad)
        (y, da, db), (yp, dap, dbp) = grads["kernel"], grads["plain"]
        row = {"shape": (E, C, K, N), "y_rel": rel(y, yp), "da_rel": rel(da, dap),
               "db_rel": rel(db, dbp), "fault_da_rel": rel(grads["fault"][1], dap),
               "dtypes": (str(y.dtype), str(da.dtype), str(db.dtype))}
        row["ok"] = (row["y_rel"] <= 1e-5 and row["da_rel"] <= 2.0**-7
                     and row["db_rel"] <= 2.0**-7 and y.dtype == torch.float32
                     and da.dtype == db.dtype == torch.bfloat16)
        row["fault_rejected"] = row["fault_da_rel"] > 2.0**-7
        rows.append(row)
    return rows


def moe_train(model, params, seed: int, runs, steps: int = MOE_TRAIN_STEPS) -> dict:
    """λ-only steps of moonshot at batch 8 × seq 256 in the config's 8
    microbatches, each routing its own 256 rows, through the train
    launcher's functions: ``runs`` (name, forward in place of the one-λ
    kernel or None), the first the kernel's own; launches counted, the aux
    read.  Every later run routes each (token, layer) to the experts the
    kernel's run chose (where its own top-k set differs is counted): a
    rounding difference that flips one expert of a near-tie moves that
    token by a whole expert, and over random layers such flips compound.
    Each later run is compared with the kernel's (``compare_trains``)."""
    import torch
    from repro_torch import kernels
    from repro_torch.kernels import qrlora_matmul as mm
    from repro_torch.launch import train as tl
    from repro_torch.models import moe
    from repro_torch.training import init_train_state

    real_top_k = moe._top_k
    chosen, flips, feed = [], [], {}

    def recording(probs, k):
        gates, experts = real_top_k(probs, k)
        chosen.append(experts)
        return gates, experts

    def replaying(probs, k):
        gates, experts = feed["forced"](probs, k)
        own = real_top_k(probs, k)[1]
        flips.append((own.sort(-1)[0] != experts.sort(-1)[0]).any(-1).sum())
        return gates, experts

    out, done = {}, {}
    for i, (name, fwd) in enumerate(runs):
        kernels.reset_launch_counts()
        feed["forced"] = forcing_top_k(iter(chosen))
        state = init_train_state(model, params=params)
        step_fn = tl.make_step(model, TRAIN_LR, steps)
        data = tl.batches(model.cfg, MOE_TRAIN_BATCH, MOE_TRAIN_SEQ, seed, model.device)
        with contextlib.ExitStack() as stack:
            stack.enter_context(swapped(moe, "_top_k", replaying if i else recording))
            if fwd is not None:
                stack.enter_context(swapped(mm, "qrlora_matmul", fwd))
            if not i:
                stack.enter_context(recompute_launches(out.setdefault("launches_recompute", {})))
            done[name] = tl.train(step_fn, state, data, steps)
        torch.cuda.synchronize()
        out[f"launches_{name}"] = kernels.launch_counts()
    out["routing_flips"] = int(sum(int(f) for f in flips))
    out["routed_pairs"] = sum(int(e.shape[0]) for e in chosen)
    hist = done[runs[0][0]][1]
    out["losses"] = [h["loss"] for h in hist]
    out["aux"] = [h["aux"] for h in hist]
    out["step_ms"] = [h["ms"] for h in hist]
    out.update(tl.summary(hist, MOE_TRAIN_BATCH * MOE_TRAIN_SEQ))
    for name, _ in runs[1:]:
        out[name] = compare_trains(done[runs[0][0]], done[name])
    out["n_layers"] = model.cfg.n_layers
    out["microbatches"] = model.cfg.microbatches
    out["steps"] = steps
    return out


def moe_kernel_timings(gen) -> dict:
    """#1, #2, #3 at moonshot's shapes and #1, #2 at mixtral's, by CUDA-graph
    replay beside their plain versions and library calls."""
    return {
        "qrlora_bgmv_moonshot_wq": time_bgmv(gen, 2048, 4, K=2048, r=160),
        "qrlora_bgmv_moonshot_wq_M64": time_bgmv(gen, 2048, 64, K=2048, r=160),
        "paged_decode_attention_moonshot": time_paged(gen, (40, 33, 57, 21), H=16, KV=16,
                                                      cols=4, max_blocks=8, dh=128),
        "qrlora_matmul_moonshot_wq": time_matmul(gen, 2048, M=256, K=2048, r=160),
        "qrlora_bgmv_mixtral_wq": time_bgmv(gen, 6144, 4, K=6144, r=256),
        "qrlora_bgmv_mixtral_wv": time_bgmv(gen, 1024, 4, K=6144, r=256),
        "qrlora_bgmv_mixtral_wq_M64": time_bgmv(gen, 6144, 64, K=6144, r=256),
        "paged_decode_attention_mixtral": time_paged(gen, (40, 33, 57, 21), H=48, KV=8, cols=4,
                                                     max_blocks=8, dh=128),
    }


def moe_phase(seed: int) -> dict:
    """moonshot-v1-16b-a3b at full width and depth (48 layers, d 2048, 16
    heads over 16 of dh 128, 64 experts top-6 of d_ff 1408, vocab 163840;
    random bf16 weights from ``seed``, QR-LoRA on wq/wv of the last 4
    layers): the dispatch on the card against the CPU's; the expert
    matmuls' bf16 route against the float32 upcast; the shipped serve (cf
    1.25, the default engine, 4 tenants) twice bitwise, its drops and a
    profile; the drop-free twin in bf16 teacher-forced against the merged
    reference over the whole depth and over the adapted layers, the drift
    layer by layer, its routing flips and two planted faults; the λ-only
    bf16 train beside its plain twin; then, the bf16 tree freed, the
    drop-free twin in float32 at 8 of 48 layers against the merged
    reference, and a float32 train on the last of those layers beside its
    plain twin and a planted fault.  Returns every reading."""
    import numpy as np
    import torch
    from repro_torch import kernels
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.tree import tree_leaves, tree_map

    out = {"seconds": {}}
    t0 = time.perf_counter()

    def lap(name):
        nonlocal t0
        now = time.perf_counter()
        out["seconds"][name] = now - t0
        t0 = now

    cfg = get_config(MOE)
    params, out["init_s"], out["init_peak_gib"] = moe_params(seed, cfg)
    out["n_params"] = sum(t.numel() for t in tree_leaves(params))
    out["router_dtype"] = str(params["groups"]["moe"]["w_router"].dtype)
    lap("init")
    out["dispatch"] = moe_dispatch_check(params, cfg, seed)
    out["bmm"] = moe_bmm_check(torch.Generator(device="cuda").manual_seed(seed + 9100))
    lap("dispatch")
    # -- the shipped serve: cf 1.25, the default engine, launches counted ------
    kernels.reset_launch_counts()
    cfg, engine, lams, done, _, t_serve = serve("bfloat16", seed, n_tenants=MOE_TENANTS,
                                                gen_len=MOE_GEN, params=params, arch=MOE)
    launches = kernels.launch_counts()
    log = RouteLog()
    with log.installed(engine):
        again = resubmit(engine, done)
    shipped = {"serve_s": t_serve, "tokens": engine.decoded_tokens, "steps": engine.steps,
               "tok_per_s": engine.decoded_tokens / t_serve, "launches": launches,
               "all_served": len(done) == MOE_TENANTS and all(
                   len(r.tokens) == MOE_GEN for r in done.values()),
               "finite": all(np.isfinite(np.stack(r.logits)).all() for r in done.values()),
               "repeat_bitwise": same_streams_bitwise(done, again),
               "drops": log.drops(cfg.n_layers),
               "peak_gib": torch.cuda.max_memory_allocated() / 2**30}
    gc.collect()
    shipped["profile"] = profile_serve(engine, seed, n_tenants=MOE_PROFILE_TENANTS,
                                       gen_len=MOE_PROFILE_GEN, host_ops=False)
    out["shipped"] = shipped
    del engine, log
    lap("shipped_serve")
    # -- the drop-free twin, bf16 at full depth --------------------------------
    free = {"capacity_factor": MOE_DROP_FREE_CF}
    cfg_f, engine, lams, done, _, t_serve = serve("bfloat16", seed, n_tenants=MOE_TENANTS,
                                                  gen_len=MOE_GEN, params=params, arch=MOE,
                                                  cfg_overrides=free)
    log = RouteLog()
    with log.installed(engine):
        logged = resubmit(engine, done)
    twin = {"serve_s": t_serve, "tok_per_s": engine.decoded_tokens / t_serve,
            "drops": log.drops(cfg_f.n_layers),
            "repeat_bitwise": same_streams_bitwise(done, logged),
            "verify": moe_bf16_checks(cfg_f, engine, lams, logged, log),
            "drift_by_layer": moe_drift_by_layer(cfg_f, engine, lams, logged, log)}
    twin["routing"] = routing_flips(cfg_f, engine, lams, logged, log)
    twin["planted_faults"] = moe_planted_faults(cfg_f, engine, lams, done, moe_bf16_checks)
    out["twin_bf16"] = twin
    del engine, log
    gc.collect()
    torch.cuda.empty_cache()
    lap("twin_bf16")
    # -- the λ-only train at full depth ----------------------------------------
    out["train"] = moe_train(build_model(get_config(MOE)), params, seed,  # bf16, microbatches 8
                             (("kernel", None), ("plain_twin", plain_forward)),
                             steps=MOE_BF16_TRAIN_STEPS)
    lap("train")
    # -- the drop-free twin in float32 at 8 of 48 layers -----------------------
    host, dev = last_layers_on_host(params, MOE_FP32_LAYERS), params["embed"].device
    del params
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    p32 = tree_map(lambda t: t.to(dev), host)
    del host
    out["fp32_peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    kernels.reset_launch_counts()
    cfg32, engine, lams, done, _, t_serve = serve(
        "float32", seed, n_tenants=MOE_TENANTS, gen_len=MOE_GEN, params=p32, arch=MOE,
        cfg_overrides={"n_layers": MOE_FP32_LAYERS, **free})
    launches = kernels.launch_counts()
    log = RouteLog()
    with log.installed(engine):
        logged = resubmit(engine, done)
    out["twin_fp32"] = {"serve_s": t_serve, "launches": launches,
                        "verify": moe_fp32_check(cfg32, engine, lams, done),
                        "repeat_bitwise": same_streams_bitwise(done, logged),
                        "routing": routing_flips(cfg32, engine, lams, logged, log),
                        "planted_faults": moe_planted_faults(
                            cfg32, engine, lams, done, lambda *a: moe_fp32_check(*a)[0])}
    del engine
    gc.collect()
    lap("twin_fp32")
    # -- λ through the moe backward: a float32 train on the last layers --------
    n = MOE_FP32_TRAIN_LAYERS
    cfg_t = get_config(MOE).replace(dtype="float32", n_layers=n)
    out["train_fp32"] = moe_train(
        build_model(cfg_t), {**p32, "groups": tree_map(lambda t: t[-n:], p32["groups"])}, seed,
        (("kernel", None), ("plain_twin", plain_forward),
         ("fault_last_wq_lam_dropped", last_wq_lam_dropped(cfg_t))))
    del p32
    gc.collect()
    torch.cuda.empty_cache()
    lap("train_fp32")
    return out


def _drift(rows) -> float:
    return max(r["max_dlogits_over_bound"] for r in rows)


def print_moe(out: dict, smi: str) -> None:
    s = out["shipped"]
    print(f"{MOE}: {out['n_params']} parameters (router {out['router_dtype']}), init "
          f"{out['init_s']:.1f} s, peak {out['init_peak_gib']:.2f} GiB allocated (random bf16 "
          f"weights drawn layer by layer + QR-LoRA on the card) on {smi}")
    print(f"{MOE} dispatch, card vs CPU (layer 0, float32): {out['dispatch']}")
    for row in out["bmm"]:
        print(f"{MOE} expert matmul bf16 route (_BmmF32) vs autograd of the float32 upcast: {row}")
    print(f"{MOE} shipped serve bf16 (cf 1.25): {s['tokens']} tokens in {s['serve_s']:.3f} s = "
          f"{s['tok_per_s']:.1f} tok/s over {s['steps']} steps; launches {s['launches']}; "
          f"repeat bitwise {s['repeat_bitwise']}; peak {s['peak_gib']:.2f} GiB")
    for kind, d in s["drops"].items():
        print(f"  copies dropped per {kind}: mean {d['mean']:.1f}, max {d['max']} over {d['n']} "
              f"({d['each']})")
    print(f"  profiled shipped serve ({MOE_PROFILE_TENANTS} requests × {MOE_PROFILE_GEN} tokens): "
          f"{s['profile']}")
    t = out["twin_bf16"]
    print(f"{MOE} drop-free twin bf16 (cf {MOE_DROP_FREE_CF}): {t['tok_per_s']:.1f} tok/s; drops "
          f"{ {k: d['total'] for k, d in t['drops'].items()} }; repeat bitwise "
          f"{t['repeat_bitwise']}")
    for part, what, bar in (("full", "the whole depth", MOE_BF16_DRIFT),
                            ("tail", "the adapted layers on the engine's residual stream",
                             MOE_BF16_TAIL_DRIFT)):
        for row in t["verify"][part]:
            print(f"  bf16 vs the teacher-forced merged-weight reference over {what}, routed as "
                  f"the engine routed: {row}")
        print(f"  bf16 drift over {what} (|Δlogits| over the bound {bar / 2**-9:.1f}·2^-9 of each "
              f"row's max): sound serve {_drift(t['verify'][part]):.4f}, planted faults "
              + ", ".join(f"{n} {_drift(r[part]):.4f}" for n, r in t["planted_faults"].items()))
    d = t["drift_by_layer"]
    print(f"  residual stream at each layer's input, max|Δ| of a row over its max|x| (layers "
          f"0..{len(d['engine_vs_reference']) - 1}): engine vs the reference "
          f"{[float(f'{v:.3g}') for v in d['engine_vs_reference']]}; the reference over the "
          f"prompt alone vs over the whole sequence "
          f"{[float(f'{v:.3g}') for v in d['prompt_alone_vs_whole']]}")
    print(f"  routing flips (engine top-6 set ≠ the teacher-forced reference's own): "
          f"{t['routing']}")
    tr = out["train"]
    print(f"{MOE} train bf16: {tr['steps']} steps at batch {MOE_TRAIN_BATCH} × seq "
          f"{MOE_TRAIN_SEQ} in {tr['microbatches']} microbatches, median step "
          f"{tr['median_step_ms']:.1f} ms (steps {tr['step_ms']}), losses {tr['losses']}, aux "
          f"{tr['aux']}; vs plain twin (routed as the kernel's run: its own top-6 differs at "
          f"{tr['routing_flips']} of {tr['routed_pairs']} (token, layer) pairs) "
          f"{tr['plain_twin']} (the loss bound {TRAIN_TOL['bfloat16']['dloss']}); launches "
          f"{tr['launches_kernel']}")
    f32 = out["twin_fp32"]
    print(f"{MOE} drop-free twin float32 at {MOE_FP32_LAYERS} of 48 layers (the bf16 tree's "
          f"last {MOE_FP32_LAYERS} in float32): peak {out['fp32_peak_gib']:.2f} GiB; launches "
          f"{f32['launches']}")
    for row in f32["verify"]:
        print(f"  fp32 vs the merged-weight reference: {row}")
    print(f"  fp32 routing flips (engine top-6 set ≠ the teacher-forced reference's own): "
          f"{f32['routing']}; repeat bitwise {f32['repeat_bitwise']}")
    for name, row in f32["planted_faults"].items():
        print(f"  fp32 planted fault {name}: {row}")
    tf = out["train_fp32"]
    print(f"{MOE} train float32 on the last {tf['n_layers']} layers: losses {tf['losses']}, "
          f"median step {tf['median_step_ms']:.1f} ms; vs plain twin {tf['plain_twin']}; planted "
          f"fault (λ of the last layer's wq dropped) {tf['fault_last_wq_lam_dropped']} (bounds "
          f"{TRAIN_TOL['float32']}); twin routing flips {tf['routing_flips']} of "
          f"{tf['routed_pairs']}; launches {tf['launches_kernel']}")
    print(f"{MOE} seconds {out['seconds']}")


def _check_moe_train(tr, dtype: str) -> None:
    # wq and wv of every layer, every microbatch of every step
    check_train_launches(f"{MOE} train {dtype}", tr,
                         2 * tr["n_layers"] * tr["microbatches"] * tr["steps"])
    _check(all(math.isfinite(x) for x in tr["losses"] + tr["aux"]),
           f"{MOE} train {dtype}: not finite")


def check_moe(out: dict) -> None:
    _check(out["router_dtype"] == "torch.float32", f"{MOE}: the router is {out['router_dtype']}")
    _check(out["dispatch"]["ok"], f"{MOE} dispatch on the card differs from the CPU's: "
                                  f"{out['dispatch']}")
    _check(all(r["ok"] and r["fault_rejected"] for r in out["bmm"]),
           f"{MOE}: the expert matmuls' bf16 route disagrees with the float32 upcast, or its "
           f"check let a backward from the wrong expert through: {out['bmm']}")
    s = out["shipped"]
    _check(s["all_served"] and s["finite"], f"{MOE} shipped serve: not every tenant got its "
                                            f"tokens, or a logit is not finite")
    _check(s["launches"]["qrlora_bgmv"] > 0 and s["launches"]["paged_decode_attention"] > 0,
           f"{MOE} shipped serve: #1 or #2 never launched: {s['launches']}")
    _check_no_bench_kernels(s["launches"], f"{MOE} shipped serve")
    _check(s["repeat_bitwise"], f"{MOE} shipped serve: the second serve differs")
    _check(s["drops"]["prefill"]["total"] > 0, f"{MOE} shipped serve dropped no copy in any "
                                               f"prefill: {s['drops']}")
    t = out["twin_bf16"]
    _check(sum(d["total"] for d in t["drops"].values()) == 0,
           f"{MOE} drop-free twin dropped copies: {t['drops']}")
    _check(t["repeat_bitwise"], f"{MOE} drop-free twin: the logged serve differs")
    for part in ("full", "tail"):
        _check(all(r["ok"] for r in t["verify"][part]),
               f"{MOE} bf16 drop-free twin disagrees with the teacher-forced merged-weight "
               f"reference ({part}): {t['verify'][part]}")
    # over the whole depth the drift of 48 random moe layers hides the decode
    # seg fault (the last 4 layers' λ); over the adapted layers both show
    for name, rows in t["planted_faults"].items():
        _check(not rows["tail"][0]["ok"],
               f"{MOE}: the bf16 check over the adapted layers let {name} through: {rows['tail']}")
    fault = t["planted_faults"]["topk_not_renormalised"]["full"][0]
    _check(not fault["ok"], f"{MOE}: the bf16 check over the whole depth let unrenormalised "
                            f"gates through: {fault}")
    f32 = out["twin_fp32"]
    _check(f32["launches"]["qrlora_bgmv"] > 0 and f32["launches"]["paged_decode_attention"] > 0,
           f"{MOE} float32 twin: #1 or #2 never launched: {f32['launches']}")
    _check(all(r["ok"] for r in f32["verify"]) and f32["repeat_bitwise"],
           f"{MOE} float32 drop-free twin diverged from the merged-weight reference, or its "
           f"logged serve from itself: {f32['verify']}")
    for name, row in f32["planted_faults"].items():
        _check(not row["ok"], f"{MOE}: the float32 check let the planted fault {name} through: "
                              f"{row}")
    tr = out["train"]
    _check_moe_train(tr, "bfloat16")
    # after 4 warm-up steps λ is lr-sized and Adam's sign-like updates turn
    # gradient noise at 48 random layers into whole-λ differences (1.19 of
    # max|λ| at --seed 0), so the bf16 twin holds the loss; λ through the moe
    # backward is the float32 train's to hold, as the smollm float32 train
    # holds it
    tw = tr["plain_twin"]
    _check(tw["finite"] and tw["max_dloss"] <= TRAIN_TOL["bfloat16"]["dloss"],
           f"{MOE} train: the loss disagrees with its plain-version twin: {tw}")
    tf = out["train_fp32"]
    _check_moe_train(tf, "float32")
    _check(within_train_tol(tf["plain_twin"], "float32"),
           f"{MOE} float32 train disagrees with its plain-version twin: {tf['plain_twin']}")
    _check(not within_train_tol(tf["fault_last_wq_lam_dropped"], "float32"),
           f"{MOE} float32 train: the check let λ of the last layer's wq dropped through: "
           f"{tf['fault_last_wq_lam_dropped']}")


# ---------------------------------------------------------------------------
# the vlm family: llama-3.2-vision-11b at full width and depth
# ---------------------------------------------------------------------------

VLM = "llama-3.2-vision-11b"
VLM_LANES, VLM_PROMPT, VLM_GEN = 4, 32, 16
# xa_gate and λ both start at zero, where the cross layers and the adapters
# add nothing: the phase serves one random λ (N(0, 0.5²) on every adapted
# wq/wv) and gates ±U[0.5, 1.5] (a numpy draw from the seed)
VLM_LAM_SCALE = 0.5
# the float32 twin: the last 2 of 8 groups (10 layers; the adapted self
# layers are group 7's, the adapted cross layers groups 4-7's), ≈ 13 GB
VLM_FP32_GROUPS = 2
# 2 steps (4 until remat made each bf16 step ≈ 3 s, PERF.md §4): the trains
# hold the loss and the first step's λ gradients
VLM_TRAIN_STEPS, VLM_TRAIN_BATCH, VLM_TRAIN_SEQ = 2, 4, 256
# bf16 serve vs the merged-weight plain path, teacher-forced, as a fraction
# of a logits row's largest |logit|: 16·2^-9 = 8 bf16 rounding steps (2^-8)
# of it, the other decoders' order (smollm 14, musicgen 14.8), fixed before
# the first full-width run.  Read on an H100 at --seed 0: sound 13.2·2^-9;
# planted faults: images permuted 40.7, causal cross mask 348; the cross wv
# adapter dropped 13.8 — bf16 cannot separate it from the sound serve, so
# the float32 twin holds it (0.051 against its 1e-3 bar)
VLM_BF16_DRIFT = 16 * 2.0**-9
# the same weights on an int8 base against its own merged (dequantized)
# plain path: read 15.8·2^-9 at --seed 0; #4 itself is held against its
# plain version at the vlm shapes
VLM_INT8_DRIFT = 20 * 2.0**-9
# #3 at the vlm path's new shapes (M, K, N, r): wq of a 4-lane decode step,
# a cross layer's wv over 4 lanes' 1600 image rows, a 4 × 256-row train wq;
# #4 (int8, fp8) at the first two
VLM_MATMUL_SHAPES = ((4, 4096, 4096, 256), (6400, 4096, 1024, 256), (1024, 4096, 4096, 256))
VLM_QUANT_SHAPES = VLM_MATMUL_SHAPES[:2]


def vlm_inputs(seed: int, cfg, device):
    """4 prompts of 32 tokens and 4 distinct stub images (standard normal
    patch embeddings, 1600 × 1280, bf16 on ``device``), from ``seed``."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed + 8000)
    prompts = rng.integers(2, cfg.vocab_size, size=(VLM_LANES, VLM_PROMPT)).astype(np.int32)
    img = rng.standard_normal((VLM_LANES, cfg.n_image_tokens, cfg.d_image), np.float32)
    return prompts, torch.from_numpy(img).to(device, torch.bfloat16)


def vlm_params(seed: int):
    """Full-width, full-depth llama-3.2-vision-11b in bf16 from ``seed``:
    the weights drawn on the card, then QR-LoRA on the 16 adapted 4096-wide
    projections (wq and wv of the last 4 self and the last 4 cross layers;
    timed apart), then the gates and one random λ set.  Returns (model,
    params, readings)."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import build_model

    cfg = get_config(VLM)
    model = build_model(cfg)
    dev = model.device
    gen = torch.Generator(device=dev).manual_seed(seed)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = model.init(gen, with_adapters=False)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    params = model.attach_adapters(gen, params)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    G = cfg.n_layers // cfg.cross_attn_every
    rng = np.random.default_rng(seed + 8100)
    gates = rng.choice([-1.0, 1.0], G) * rng.uniform(0.5, 1.5, G)
    params["groups"]["xattn"]["xa_gate"] = torch.tensor(gates, dtype=torch.float32, device=dev)
    params = with_lam(params, lambda lam: torch.randn(
        lam.shape, generator=gen, device=dev) * VLM_LAM_SCALE)
    ranks = {f"{mod}/{proj}": leaf["ranks"].flatten().tolist()
             for mod, projs in params["groups"]["adapters"].items() for proj, leaf in projs.items()}
    return model, params, {"draw_s": t1 - t0, "qr_lora_s": t2 - t1,
                           "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
                           "gates": gates.tolist(), "ranks": ranks}


def with_lam(params, fn):
    """``params`` with every adapter's λ replaced by ``fn(λ)`` (new dicts
    down to the adapters; every other leaf shared)."""
    groups = dict(params["groups"])
    groups["adapters"] = {mod: {proj: {**leaf, "lam": fn(leaf["lam"])}
                                for proj, leaf in projs.items()}
                          for mod, projs in groups["adapters"].items()}
    return {**params, "groups": groups}


def merged(params, cfg):
    """The plain path's params: every adapter folded into its weight
    (the engine's ``merge_tenant_params``, λ from the tree itself)."""
    from repro_torch.serving import merge_tenant_params
    from repro_torch.serving.lam_store import extract_lambda

    return merge_tenant_params(params, cfg, extract_lambda(params))


def causal_cross_mask(S: int, Sk: int, device):
    """Planted fault: a causal mask in the cross layer (query s sees image
    rows 0..s only)."""
    import torch

    k, q = torch.arange(Sk, device=device), torch.arange(S, device=device)
    return (k[None, :] <= q[:, None])[None, None, None]


def xattn_wv_adapter_dropped():
    """Planted fault: the cross layers' wv adapter term left out (their
    ``_project_qkv`` called without the wv adapter: the plain x·W)."""
    from repro_torch.models import attention

    sound = attention._project_qkv

    def fwd(p, x, cfg, adp, kv_input=None):
        if kv_input is not None and adp:
            adp = {k: v for k, v in adp.items() if k != "wv"}
        return sound(p, x, cfg, adp, kv_input)

    return fwd


def vlm_fault_runs(images):
    """(name, the run's images, context) of the three planted faults."""
    from repro_torch.models import attention

    return (("images_permuted", images.roll(1, 0), contextlib.nullcontext),
            ("causal_cross_mask", images,
             lambda: swapped(attention, "_cross_mask", causal_cross_mask)),
            ("xattn_wv_adapter_dropped", images,
             lambda: swapped(attention, "_project_qkv", xattn_wv_adapter_dropped())))


def teacher_forced(model, ref_params, prompts, run, images, drift: float) -> dict:
    """The plain path (merged weights, one forward over each lane's prompt
    and the run's own tokens, the true images) against a run's logits: at
    every generated position |Δlogits| and the run's token's margin within
    ``drift`` of the row's largest |logit|."""
    import numpy as np
    import torch

    dev = run["logits"].device
    toks = torch.from_numpy(run["tokens"]).to(dev)
    seq = torch.cat([torch.from_numpy(prompts).to(dev), toks[:, :-1]], dim=1)
    with torch.no_grad():
        ref = model.apply(ref_params, seq, image_embeds=images)[:, prompts.shape[1] - 1:]
    got = run["logits"]
    bound = drift * ref.abs().amax(-1)
    dlog = (got - ref).abs().amax(-1)
    margin = ref.amax(-1) - torch.gather(ref, -1, toks.long()[..., None])[..., 0]
    over = (dlog / bound).cpu().numpy()
    m_over = (margin / bound).cpu().numpy()
    finite = bool(torch.isfinite(got).all())
    return {"max_abs_dlogits": float(dlog.max()), "max_dlogits_over_bound": float(over.max()),
            "lane_dlogits_over_bound": over.max(1).tolist(),
            "max_token_margin_over_bound": float(m_over.max()),
            "argmax_agree": int((margin == 0).sum()), "finite": finite,
            "ok": bool(finite and (over <= 1).all() and (m_over <= 1).all())}


def free_running(run, ref) -> dict:
    """A float32 run against its plain twin: tokens equal, logits within
    ``FP32_LOGIT_TOL``."""
    import numpy as np

    same = bool(np.array_equal(run["tokens"], ref["tokens"]))
    err = float((run["logits"] - ref["logits"]).abs().max())
    return {"tokens_match": same, "max_abs_dlogits": err,
            "ok": same and err < FP32_LOGIT_TOL}


def profile_vlm_decode(model, params, prompts, images, steps: int = 3) -> dict:
    """``steps`` decode steps after a prefill (weights and kernels warm)
    under torch.profiler, the CUDA activity alone: wall time, device busy
    and idle share of a step, device time by kernel."""
    import torch
    from repro_torch.models.transformer import torch_dtype
    from repro_torch.training import make_decode_step, make_prefill_step

    B, P = prompts.shape
    cache = model.init_decode_state(B, P + steps + 1, torch_dtype(model.cfg.dtype))
    with torch.no_grad():
        logits, cache = make_prefill_step(model)(
            params, cache, {"tokens": torch.from_numpy(prompts).to(model.device),
                            "image_embeds": images})
        tok = torch.argmax(logits, -1).to(torch.int32)[:, None]
        decode = make_decode_step(model)
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(steps):
                tok, _, cache = decode(params, cache, {"token": tok, "image_embeds": images})
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
    return {**_device_busy(prof, wall_us), "steps": steps}


def vlm_kernel_checks(gen, details) -> dict:
    """#3 bf16 at :data:`VLM_MATMUL_SHAPES` and float32 at the decode wq and
    the cross wv; #4 int8 and fp8 at :data:`VLM_QUANT_SHAPES`: each against
    its plain version, bitwise on a second call, every rank column live.
    Returns the worst |Δ| of each."""
    import torch

    worst = {}
    cases = [("qrlora_matmul", torch.bfloat16, s, None) for s in VLM_MATMUL_SHAPES]
    cases += [("qrlora_matmul", torch.float32, s, None) for s in VLM_QUANT_SHAPES]
    cases += [("qrlora_matmul_quant", torch.bfloat16, s, b) for b in ("int8", "fp8")
              for s in VLM_QUANT_SHAPES]
    for kind, dt, (M, K, N, r), base in cases:
        row = _matmul_case(gen, kind, dt, M, K, N, r, base=base, rank=r)
        details.append({**row, "arch": VLM})
        _check(row["ok"], f"{kind} at {VLM} q={base} x={row['x']} M={M} K={K} N={N} r={r}: "
                          f"max|Δ|={row['max_abs_err']:.3e} ({row['err_over_bound']:.3f} of the "
                          f"bound), bitwise on a second call: {row['bitwise_repeat']}")
        key = f"{kind}_{row['x']}" + (f"_{base}" if base else "")
        worst[key] = max(worst.get(key, 0.0), row["max_abs_err"])
    return worst


def vlm_kernel_timings(gen) -> dict:
    """#3 and #4 at the vlm shapes by CUDA-graph replay beside their plain
    versions and cuBLAS's composition."""
    out = {"qrlora_matmul_vlm_wq_decode": time_matmul(gen, 4096, M=4, K=4096, r=256),
           "qrlora_matmul_vlm_xattn_wv": time_matmul(gen, 1024, M=6400, K=4096, r=256),
           "qrlora_matmul_vlm_wq_train": time_matmul(gen, 4096, M=1024, K=4096, r=256)}
    for base in ("int8", "fp8"):
        out[f"qrlora_matmul_quant_vlm_wq_decode_{base}"] = time_matmul_quant(
            gen, 4, 4096, base, K=4096, r=256)
        out[f"qrlora_matmul_quant_vlm_xattn_wv_{base}"] = time_matmul_quant(
            gen, 6400, 1024, base, K=4096, r=256)
    return out


def vlm_train(model, params, seed: int, runs) -> dict:
    """λ-only steps from λ = 0 at batch 4 × seq 256, each row with its own
    stub image, in the config's microbatches, through the train launcher's
    functions: ``runs`` (name, context), the first the kernel's own run,
    the others compared with it (``compare_trains``, and ``dlam0_rel``: the
    first step's λ gradients, max |Δ| over the largest |dλ| of the kernel's
    run); launches counted."""
    import torch
    from repro_torch import kernels
    from repro_torch.launch import train as tl
    from repro_torch.training import init_train_state
    from repro_torch.tree import tree_leaves

    params = with_lam(params, torch.zeros_like)
    out, done, grads = {}, {}, {}
    for i, (name, ctx) in enumerate(runs):
        kernels.reset_launch_counts()
        state = init_train_state(model, params=params)
        step_fn = tl.make_step(model, TRAIN_LR, VLM_TRAIN_STEPS)
        data = tl.batches(model.cfg, VLM_TRAIN_BATCH, VLM_TRAIN_SEQ, seed, model.device)
        split = (recompute_launches(out.setdefault("launches_recompute", {})) if not i
                 else contextlib.nullcontext())
        with ctx(), split:
            done[name] = tl.train(step_fn, state, data, VLM_TRAIN_STEPS)
        torch.cuda.synchronize()
        out[f"launches_{name}"] = kernels.launch_counts()
        # the first step left its summed microbatch gradients on the first
        # state's leaves (every later step takes new ones); a λ the run
        # never reached has none
        grads[name] = [torch.zeros_like(p) if p.grad is None else p.grad
                       for p in tree_leaves(state["trainable"])]
    hist = done[runs[0][0]][1]
    out["losses"] = [h["loss"] for h in hist]
    out["step_ms"] = [h["ms"] for h in hist]
    out.update(tl.summary(hist, VLM_TRAIN_BATCH * VLM_TRAIN_SEQ))
    g0 = grads[runs[0][0]]
    scale = max(float(g.abs().max()) for g in g0)
    for name, _ in runs[1:]:
        out[name] = compare_trains(done[runs[0][0]], done[name])
        out[name]["dlam0_rel"] = max(_max_err(a, b) for a, b in zip(grads[name], g0)) / scale
    out["n_layers"] = model.cfg.n_layers
    out["microbatches"] = model.cfg.microbatches
    return out


def vlm_phase(seed: int) -> dict:
    """llama-3.2-vision-11b at full width and depth (40 layers, d 4096, 32
    heads over 8, d_ff 14336, vocab 128256, a gated cross layer every 5th
    over 1600 image rows of width 1280; random bf16 weights from ``seed``,
    QR-LoRA on wq/wv of the last 4 self and the last 4 cross layers, one
    random λ, nonzero gates), one set of params for every sub-phase:
    the serve through ``launch/serve.py``'s ``generate`` (4 lanes, 4
    distinct images, prompts of 32, 16 new tokens; launches counted) held
    teacher-forced against the merged-weight plain path, three planted
    faults, an int8-base serve (#4), a profiled decode step, the float32
    twin on the last 2 groups against the plain path (free-running, the
    faults again), 4 bf16 train steps beside a plain twin, a float32 train
    on the 2 groups beside its plain twin and a planted fault.  Returns
    every reading."""
    import torch
    from repro_torch import kernels
    from repro_torch.configs import get_config
    from repro_torch.core.quantize import quantize_base_params
    from repro_torch.kernels import qrlora_matmul as mm
    from repro_torch.launch.serve import generate
    from repro_torch.models import attention, build_model
    from repro_torch.tree import tree_leaves, tree_map

    out = {"seconds": {}}
    t0 = time.perf_counter()

    def lap(name):
        nonlocal t0
        now = time.perf_counter()
        out["seconds"][name] = now - t0
        t0 = now

    model, params, out["init"] = vlm_params(seed)
    cfg = model.cfg
    out["n_params"] = sum(t.numel() for t in tree_leaves(params))
    out["n_layers"] = cfg.n_layers
    prompts, images = vlm_inputs(seed, cfg, model.device)
    lap("init")
    # -- the serve: full depth, bf16, launches counted --------------------------
    generate(model, params, prompts[:, :8], images, 2)  # warm: the kernels loaded
    kernels.reset_launch_counts()
    run = generate(model, params, prompts, images, VLM_GEN, keep_logits=True)
    launches = kernels.launch_counts()
    ref_params = merged(params, cfg)
    serve_out = {"prefill_s": run["prefill_s"], "decode_s": run["decode_s"],
                 "tok_per_s": VLM_LANES * (VLM_GEN - 1) / run["decode_s"],
                 "launches": launches, "tokens": run["tokens"].tolist(),
                 "lanes_differ": len({tuple(t) for t in run["tokens"].tolist()}) == VLM_LANES,
                 "check": teacher_forced(model, ref_params, prompts, run, images, VLM_BF16_DRIFT)}
    faults = {}
    for name, imgs, ctx in vlm_fault_runs(images):
        with ctx():
            bad = generate(model, params, prompts, imgs, VLM_GEN, keep_logits=True)
        faults[name] = teacher_forced(model, ref_params, prompts, bad, images, VLM_BF16_DRIFT)
    serve_out["planted_faults"] = faults
    closed = {**params, "groups": {**params["groups"], "xattn": {
        **params["groups"]["xattn"],
        "xa_gate": torch.zeros_like(params["groups"]["xattn"]["xa_gate"])}}}
    shut = generate(model, closed, prompts, images, 2, keep_logits=True)
    serve_out["gates_closed_dlogits"] = float((shut["logits"][:, 0] - run["logits"][:, 0])
                                              .abs().max())
    del ref_params
    out["serve"] = serve_out
    lap("serve_bf16")
    out["profile"] = profile_vlm_decode(model, params, prompts, images)
    lap("profile")
    # -- #4 on the path: the same weights on an int8 base ------------------------
    q8 = quantize_base_params(params, "int8")
    kernels.reset_launch_counts()
    run8 = generate(model, q8, prompts, images, VLM_GEN, keep_logits=True)
    out["serve_int8"] = {"launches": kernels.launch_counts(), "decode_s": run8["decode_s"],
                         "check": teacher_forced(model, merged(q8, cfg), prompts, run8, images,
                                                 VLM_INT8_DRIFT),
                         "vs_bf16_dlogits": float((run8["logits"] - run["logits"]).abs().max())}
    del q8, run8
    lap("serve_int8")
    # -- the bf16 train at full depth ---------------------------------------------
    out["train"] = vlm_train(model, params, seed, (
        ("kernel", contextlib.nullcontext),
        ("plain_twin", lambda: swapped(mm, "qrlora_matmul", plain_forward))))
    lap("train_bf16")
    # -- the float32 twin on the last 2 groups ------------------------------------
    host = last_layers_on_host(params, VLM_FP32_GROUPS)
    del params, closed, run, shut
    gc.collect()
    torch.cuda.empty_cache()
    p32 = tree_map(lambda t: t.to(model.device), host)
    del host
    cfg32 = get_config(VLM).replace(dtype="float32",
                                    n_layers=VLM_FP32_GROUPS * cfg.cross_attn_every)
    m32 = build_model(cfg32)
    kernels.reset_launch_counts()
    run32 = generate(m32, p32, prompts, images, VLM_GEN, keep_logits=True)
    launches32 = kernels.launch_counts()
    ref32 = generate(m32, merged(p32, cfg32), prompts, images, VLM_GEN, keep_logits=True)
    twin = {"launches": launches32, "check": free_running(run32, ref32), "planted_faults": {}}
    for name, imgs, ctx in vlm_fault_runs(images):
        with ctx():
            bad = generate(m32, p32, prompts, imgs, VLM_GEN, keep_logits=True)
        twin["planted_faults"][name] = free_running(bad, ref32)
    out["twin_fp32"] = twin
    del run32, ref32
    lap("twin_fp32")
    out["train_fp32"] = vlm_train(m32, p32, seed, (
        ("kernel", contextlib.nullcontext),
        ("plain_twin", lambda: swapped(mm, "qrlora_matmul", plain_forward)),
        ("fault_xattn_wv_adapter_dropped",
         lambda: swapped(attention, "_project_qkv", xattn_wv_adapter_dropped()))))
    del p32, m32
    gc.collect()
    torch.cuda.empty_cache()
    lap("train_fp32")
    return out


def print_vlm(out: dict, smi: str) -> None:
    i = out["init"]
    print(f"{VLM}: {out['n_params']} parameters; drawn on the card in {i['draw_s']:.1f} s, "
          f"QR-LoRA on the 16 adapted 4096-wide projections in {i['qr_lora_s']:.1f} s, peak "
          f"{i['peak_gib']:.2f} GiB allocated; gates {[round(g, 3) for g in i['gates']]}; "
          f"selected ranks {i['ranks']} on {smi}")
    s = out["serve"]
    print(f"{VLM} serve bf16 (launch/serve.py generate, {VLM_LANES} lanes × {VLM_PROMPT} + "
          f"{VLM_GEN} tokens, 4 images): prefill {s['prefill_s'] * 1e3:.1f} ms, decode "
          f"{s['decode_s'] * 1e3:.1f} ms = {s['tok_per_s']:.1f} tok/s; launches {s['launches']}; "
          f"lanes' streams differ {s['lanes_differ']}; gates closed move the first logits by "
          f"{s['gates_closed_dlogits']:.3f}")
    print(f"  vs the teacher-forced merged-weight plain path (bar {VLM_BF16_DRIFT / 2**-9:.1f}·2^-9 "
          f"of a row's max): {s['check']}")
    for name, row in s["planted_faults"].items():
        print(f"  planted fault {name} (bf16): {row}")
    print(f"  profiled decode steps: {out['profile']}")
    q = out["serve_int8"]
    print(f"{VLM} serve on an int8 base: launches {q['launches']}, decode {q['decode_s'] * 1e3:.1f} "
          f"ms; vs its merged plain path (bar {VLM_INT8_DRIFT / 2**-9:.1f}·2^-9) {q['check']}; "
          f"vs the bf16 serve max|Δlogits| "
          f"{q['vs_bf16_dlogits']:.3f} (reported)")
    t = out["twin_fp32"]
    print(f"{VLM} float32 twin ({VLM_FP32_GROUPS} groups, {VLM_FP32_GROUPS * 5} layers): vs the "
          f"merged-weight plain path {t['check']}; launches {t['launches']}")
    for name, row in t["planted_faults"].items():
        print(f"  planted fault {name} (float32): {row}")
    for key, dtype in (("train", "bfloat16"), ("train_fp32", "float32")):
        tr = out[key]
        print(f"{VLM} train {dtype} ({tr['n_layers']} layers): {VLM_TRAIN_STEPS} steps at batch "
              f"{VLM_TRAIN_BATCH} × seq {VLM_TRAIN_SEQ} with images in {tr['microbatches']} "
              f"microbatches, median step {tr['median_step_ms']:.1f} ms, "
              f"{tr['tokens_per_s']:.0f} train tokens/s, losses {tr['losses']}; launches "
              f"{tr['launches_kernel']}; vs plain twin {tr['plain_twin']} (bound "
              f"{TRAIN_TOL[dtype]})" + (f"; planted fault xattn wv adapter dropped "
                                         f"{tr['fault_xattn_wv_adapter_dropped']}"
                                         if dtype == "float32" else ""))
    print(f"{VLM} phase seconds: { {k: round(v, 1) for k, v in out['seconds'].items()} }")


def check_vlm(out: dict) -> None:
    s = out["serve"]
    forwards = VLM_GEN  # the prefill and 15 decode steps
    want = 2 * out["n_layers"] * forwards  # wq and wv of every layer (self and cross), each forward
    _check(s["launches"]["qrlora_matmul"] == want,
           f"{VLM} serve: {s['launches']['qrlora_matmul']} qrlora_matmul launches, want {want}")
    _check_no_bench_kernels(s["launches"], f"{VLM} serve")
    _check(s["lanes_differ"] and s["gates_closed_dlogits"] > 0.05,
           f"{VLM} serve: the lanes' streams are alike or the gates do not move the logits")
    _check(s["check"]["ok"], f"{VLM} bf16 serve vs the teacher-forced plain path: {s['check']}")
    t = out["twin_fp32"]
    _check(t["check"]["ok"], f"{VLM} float32 twin vs the plain path: {t['check']}")
    _check(t["launches"]["qrlora_matmul"] == 2 * VLM_FP32_GROUPS * 5 * forwards,
           f"{VLM} float32 twin launches {t['launches']}")
    for name in s["planted_faults"]:
        bf16_caught = not s["planted_faults"][name]["ok"]
        fp32_caught = not t["planted_faults"][name]["ok"]
        _check(fp32_caught, f"{VLM}: the float32 twin let the planted fault {name} through")
        if not bf16_caught:
            print(f"  {VLM}: the bf16 check cannot separate {name}; the float32 twin holds it")
    q = out["serve_int8"]
    _check(q["launches"]["qrlora_matmul_quant"] == want and q["check"]["ok"],
           f"{VLM} int8 serve: launches {q['launches']}; vs its merged plain path {q['check']}")
    for key, dtype in (("train", "bfloat16"), ("train_fp32", "float32")):
        tr = out[key]
        check_train_launches(f"{VLM} train {dtype}", tr,
                             2 * tr["n_layers"] * tr["microbatches"] * VLM_TRAIN_STEPS,
                             nested=True)
        _check(all(math.isfinite(x) for x in tr["losses"]), f"{VLM} train {dtype}: a loss is not finite")
        tw = tr["plain_twin"]
        _check(tw["finite"] and tw["max_dloss"] <= TRAIN_TOL[dtype]["dloss"],
               f"{VLM} train {dtype}: the loss disagrees with its plain-version twin: {tw}")
    # after 4 steps λ is lr-sized, and Adam's sign-like updates turn the
    # gradients' rounding into λ differences that grow with depth (bf16
    # 0.38 of max|λ|; float32 2.2e-4 over 10 layers of d 4096, where moe's
    # 2 layers read 2.7e-5): λ through #3's backward and the cross layers is
    # held at the first step's gradients, |Δdλ| ≤ DLAM_RTOL of max|dλ| in
    # float32, as the one-λ backward check holds them
    tf = out["train_fp32"]
    _check(tf["plain_twin"]["dlam0_rel"] <= DLAM_RTOL,
           f"{VLM} float32 train: the first step's λ gradients disagree with the plain twin's: "
           f"{tf['plain_twin']}")
    _check(tf["fault_xattn_wv_adapter_dropped"]["dlam0_rel"] > DLAM_RTOL,
           f"{VLM}: the float32 train check let the dropped xattn wv adapter through: "
           f"{tf['fault_xattn_wv_adapter_dropped']}")


# ---------------------------------------------------------------------------
# the recurrent families: xlstm-125m at full width, jamba's Mamba and attention
# ---------------------------------------------------------------------------

XLSTM = "xlstm-125m"
JAMBA = "jamba-1.5-large-398b"
XLSTM_GEN = 16
# the 4 tenants' prompt lengths: buckets 32 and 64, none a bucket's own
# length, so every prefill masks padding out of the recurrent state
XLSTM_PROMPTS = (20, 45, 27, 38)
XLSTM_QUANTUM = 3
# bf16 serve vs the merged-weight reference (BF16_DRIFT's check), in units of
# 2^-9 (bf16's half ulp) of a row's largest |logit|.  The two paths round
# differently at every adapted x_qkv (W + BλA rounded to bf16 against the
# kernel's fp32 sum) and the exponential gates and the sLSTM recurrence carry
# each rounding along the prompt: an H100 at --seed 0 read 55.3·2^-9 for the
# sound serve (smollm-135m's 30 layers: 12.1), so the bar sits 16% above it.
# Its faults are the float32 serve's to reject (1e-3 bar; they read 0.77-6.2).
XLSTM_BF16_DRIFT = 64 * 2.0**-9
# 2 steps (4 until remat made each step ≈ 5 s, PERF.md §4): the trains hold
# the loss
XLSTM_TRAIN_STEPS, XLSTM_TRAIN_BATCH, XLSTM_TRAIN_SEQ = 2, 8, 256
# the bf16 train's loss against its float32 twin's (the same weights upcast,
# the kernel's float32 route), step by step: bf16 rounding of 12 layers'
# activations moves a near-uniform cross-entropy (≈ 11.3) by 3.5e-3 on an
# H100 at --seed 0
XLSTM_TRAIN_FP32_DLOSS = 1e-2
# #1 at xlstm-125m's adapted projections (M, K, N, r): the mLSTM x_qkv at 4
# decode lanes and a 64-row bucket, the sLSTM x_qkv; #3 at the train step's
XLSTM_BGMV_SHAPES = [(4, 1536, 4608, 160), (64, 1536, 4608, 160), (4, 768, 3072, 160)]
XLSTM_MATMUL_SHAPE = (2048, 1536, 4608, 160)
# the mLSTM v projection: x_qkv's last third, W and A read by row stride
# (M, K, N, r, ld) for #1 and #3
XLSTM_V_BGMV = [(4, 1536, 1536, 160, 4608), (64, 1536, 1536, 160, 4608)]
XLSTM_V_MATMUL = [(2048, 1536, 1536, 160, 4608), (64, 1536, 1536, 160, 4608)]
# jamba-1.5-large's attention at full width: wq and wv (K 8192, r 256) at 4
# decode lanes; 64 query heads over 8, dh 128
JAMBA_BGMV_SHAPES = [(4, 8192, 8192, 256), (4, 8192, 1024, 256)]
JAMBA_PAGED_CASES = (((0, 1, 17, 63), 4), ((64, 0, 1, 33), 8), ((1, 16, 48, 127), 8))
# one Mamba layer at jamba's width: a 4-lane prefill of a 64-row bucket
# (true lengths below), then decode steps, against the step recurrence
JAMBA_MAMBA_LENGTHS = (64, 40, 17, 1)
JAMBA_MAMBA_DECODE = 3
# |Δ| over the largest |reference| of the prefill's outputs and states and
# the decode steps' outputs: the prefill's products run at 256 rows, the
# steps' at 4 (cuBLAS picks other kernels), and the scan's float32 state
# sums in another order; bf16 rounds every activation
JAMBA_MAMBA_TOL = {"float32": 1e-4, "bfloat16": 2.0**-5}
# reduced jamba through the engine in both layouts (float32): 6 requests on
# 2 lanes over buckets 8 and 16 and a lane reused, block 8
JAMBA_REDUCED_PROMPTS = (6, 9, 7, 13, 11, 5)
JAMBA_REDUCED_GEN = 8


def upcast(params):
    """``params`` with every bf16 weight in float32 (the QR factors, bf16 in
    every model dtype, and λ stay as they are): the float32 twin of a bf16
    model on the same weights."""
    import torch
    from repro_torch.tree import tree_map

    up = lambda t: t.float() if t.dtype == torch.bfloat16 else t
    groups = {k: tree_map(up, v) for k, v in params["groups"].items() if k != "adapters"}
    groups["adapters"] = params["groups"]["adapters"]
    return {**{k: up(v) for k, v in params.items() if k != "groups"}, "groups": groups}


def recurrent_serve(cfg, seed: int, prompts, gen_len: int, params=None, lams=None, **conf):
    """One request a tenant (tenant i: a prompt of ``prompts[i]`` tokens
    from ``seed``) through a MultiTenantEngine under the EngineConfig
    fields ``conf``; the tenants' λ drawn from ``seed`` unless given.
    Returns (engine, λ trees, finished requests, serve seconds)."""
    import numpy as np
    import torch
    from repro_torch.serving import EngineConfig, MultiTenantEngine, random_lambda

    engine = MultiTenantEngine(cfg, EngineConfig(seed=seed, collect_logits=True, **conf),
                               params=params)
    if lams is None:
        gen = torch.Generator(device="cuda")
        lams = {f"tenant{i}": random_lambda(gen.manual_seed(seed + 1000 + i), engine.params, 0.3)
                for i in range(len(prompts))}
    for t, lam in lams.items():
        engine.add_tenant(t, lam)
    rng = np.random.default_rng(seed)
    for t, n in zip(lams, prompts):
        engine.submit(t, rng.integers(2, cfg.vocab_size, size=n), gen_len)
    _sync(engine.device)
    t0 = time.perf_counter()
    done = engine.run()
    _sync(engine.device)
    return engine, lams, done, time.perf_counter() - t0


@contextlib.contextmanager
def counting_strided(module, attr: str, counts: dict):
    """Count the calls of ``module.attr`` (a kernel's dispatcher: on the
    card one call, one launch) whose W is a column slice read by stride,
    outside a backward's recompute (:func:`recompute_launches`)."""
    real = getattr(module, attr)

    def fn(x, W, *args, **kw):
        if not W.is_contiguous() and not _IN_BACKWARD[0]:
            counts[attr] = counts.get(attr, 0) + 1
        return real(x, W, *args, **kw)

    with swapped(module, attr, fn):
        yield


def v_adapter_dropped():
    """Planted fault: the mLSTM v projection (x_qkv's last third, the one
    strided W) served without its adapter."""
    from repro_torch.models import xlstm

    real = xlstm.adapted_matmul

    def fn(x, W, adp, scale=1.0):
        return real(x, W, None if not W.is_contiguous() else adp, scale)

    return fn


def padding_unmasked(mixer):
    """Planted fault: a recurrent mixer that ignores the prefill's true
    lengths, so the bucket's padding steps reach the state it leaves."""
    def fn(p, x, cfg, state=None, adp=None, length=None):
        return mixer(p, x, cfg, state=state, adp=adp, length=None)

    return fn


def profile_decode_step(engine, lams, prompts, gen_len: int) -> dict:
    """One decode step of ``len(prompts)`` requests (one a tenant of
    ``lams``, admitted by the steps before it) under torch.profiler, CUDA
    activity alone: the kernels a decode step launches and its idle share;
    the queue then drained."""
    import numpy as np
    import torch

    rng = np.random.default_rng(7)
    for t, n in zip(lams, prompts):
        engine.submit(t, rng.integers(2, engine.cfg.vocab_size, size=n), gen_len)
    while engine.scheduler.queue:
        engine.step()
    engine.step()  # warm: every lane decoding
    _sync(engine.device)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        engine.step()
        _sync(engine.device)
        wall_us = (time.perf_counter() - t0) * 1e6
    engine.run()
    busy = _device_busy(prof, wall_us)
    return {k: busy[k] for k in ("wall_ms", "device_busy_ms", "device_idle_share", "kernels",
                                 "port_kernels_ms")}


def xlstm_faults(cfg, engine, lams, done) -> dict:
    """tenant0's request (20 tokens in a 32-row bucket) served again under
    three planted faults, each held to the float32 check (tokens equal to
    the merged-weight reference, logits within FP32_LOGIT_TOL), which must
    reject it."""
    import numpy as np
    from repro_torch.models import xlstm

    req0 = next(r for r in done.values() if r.tenant == "tenant0")
    lam0 = {"tenant0": lams["tenant0"]}

    def serve_one(*ctxs):
        with contextlib.ExitStack() as stack:
            for c in ctxs:
                stack.enter_context(c)
            engine.submit("tenant0", req0.prompt, len(req0.tokens))
            got = engine.run()
        row = verify(cfg, engine, lam0, got, len(req0.tokens))[0]
        row["ok"] = row["tokens_match"] and row["max_abs_dlogits"] < FP32_LOGIT_TOL
        return row

    rows = {}
    engine.scheduler.batch_composition = lambda: np.zeros((engine.n_lanes,), np.int32)
    try:
        rows["decode_seg_to_slot0"] = serve_one()
    finally:
        del engine.scheduler.batch_composition
    rows["v_adapter_dropped"] = serve_one(swapped(xlstm, "adapted_matmul", v_adapter_dropped()))
    rows["padding_unmasked"] = serve_one(
        swapped(xlstm, "mlstm_mixer", padding_unmasked(xlstm.mlstm_mixer)),
        swapped(xlstm, "slstm_mixer", padding_unmasked(xlstm.slstm_mixer)))
    return rows


def xlstm_serves(seed: int, p16) -> dict:
    """xlstm-125m at full width and depth through the default engine (the
    dense layout, 4 lanes; 4 tenants, prompts of XLSTM_PROMPTS, 16 new
    tokens): float32 (the bf16 weights upcast) against the merged-weight
    reference, token for token, with three planted faults; bf16
    teacher-forced, its #1 launches and strided (v) launches counted,
    profiled; the same bf16 traffic on 2 lanes with quantum=3 against
    quantum off, bitwise."""
    import torch
    from repro_torch import kernels
    from repro_torch.configs import get_config
    from repro_torch.kernels import qrlora_bgmv

    out = {}
    for dtype, params in (("float32", upcast(p16)), ("bfloat16", p16)):
        cfg = get_config(XLSTM).replace(dtype=dtype)
        counts = {}
        kernels.reset_launch_counts()
        with counting_strided(qrlora_bgmv, "qrlora_bgmv", counts):
            engine, lams, done, t_serve = recurrent_serve(cfg, seed, XLSTM_PROMPTS, XLSTM_GEN,
                                                          params=params)
        res = {"serve_s": t_serve, "tokens": engine.decoded_tokens, "steps": engine.steps,
               "tok_per_s": engine.decoded_tokens / t_serve, "launches": kernels.launch_counts(),
               "v_launches": counts.get("qrlora_bgmv", 0), "layout": engine.layout,
               "prefill_buckets": sorted(engine.prefill_buckets),
               "state_bytes_per_lane": engine.kv_cache_bytes() / engine.n_lanes,
               "all_served": len(done) == len(XLSTM_PROMPTS) and all(
                   len(r.tokens) == XLSTM_GEN for r in done.values()),
               "verify": verify(cfg, engine, lams, done, XLSTM_GEN, drift=XLSTM_BF16_DRIFT)}
        if dtype == "float32":
            res["planted_faults"] = xlstm_faults(cfg, engine, lams, done)
        else:
            res["verify_forced"] = verify_forced(cfg, engine, lams, done, drift=XLSTM_BF16_DRIFT)
            prof = profile_serve(engine, seed + 1, n_tenants=len(XLSTM_PROMPTS),
                                 gen_len=XLSTM_GEN, host_ops=False)
            res["profile"] = prof
            res["decode_step"] = profile_decode_step(engine, lams, XLSTM_PROMPTS, XLSTM_GEN)
            sliced = {}
            for q in (None, XLSTM_QUANTUM):
                eng, _, d, t = recurrent_serve(cfg, seed, XLSTM_PROMPTS, XLSTM_GEN,
                                               params=params, lams=lams, n_lanes=2, quantum=q)
                sliced[q] = (eng.slice_preemptions, [d[u] for u in sorted(d)], t)
                del eng
            (n0, plain, _), (nq, cut, tq) = sliced[None], sliced[XLSTM_QUANTUM]
            res["quantum"] = {
                "quantum": XLSTM_QUANTUM, "lanes": 2, "slice_preemptions": nq,
                "unsliced_preemptions": n0, "serve_s": tq,
                "bitwise": all(a.tokens == b.tokens and all(
                    (x == y).all() for x, y in zip(a.logits, b.logits)) for a, b in zip(plain, cut))}
        out[dtype] = res
        del engine
        torch.cuda.empty_cache()
    return out


def xlstm_train(p16, seed: int) -> dict:
    """λ-only steps from λ = 0 of full-width xlstm-125m at batch 8 × seq 256
    through the train launcher's functions: bf16 through #3 (its strided v
    calls counted), the bf16 plain twin, and the float32 twin on the same
    weights upcast (the kernel's float32 route), which holds the loss."""
    import torch
    from repro_torch import kernels
    from repro_torch.configs import get_config
    from repro_torch.kernels import qrlora_matmul as mm
    from repro_torch.launch import train as tl
    from repro_torch.models import build_model
    from repro_torch.training import init_train_state

    zero = lambda p: with_lam(p, torch.zeros_like)
    runs = (("kernel", "bfloat16", p16, contextlib.nullcontext),
            ("plain_twin", "bfloat16", p16, lambda: swapped(mm, "qrlora_matmul", plain_forward)),
            ("fp32_twin", "float32", upcast(p16), contextlib.nullcontext))
    out, done = {}, {}
    for name, dtype, params, ctx in runs:
        model = build_model(get_config(XLSTM).replace(dtype=dtype))
        kernels.reset_launch_counts()
        counts = {}
        state = init_train_state(model, params=zero(params))
        step_fn = tl.make_step(model, TRAIN_LR, XLSTM_TRAIN_STEPS)
        data = tl.batches(model.cfg, XLSTM_TRAIN_BATCH, XLSTM_TRAIN_SEQ, seed, model.device)
        split = (recompute_launches(out.setdefault("launches_recompute", {}))
                 if name == "kernel" else contextlib.nullcontext())
        with ctx(), split, counting_strided(mm, "qrlora_matmul", counts):
            done[name] = tl.train(step_fn, state, data, XLSTM_TRAIN_STEPS)
        torch.cuda.synchronize()
        out[f"launches_{name}"] = kernels.launch_counts()
        out[f"v_calls_{name}"] = counts.get("qrlora_matmul", 0)
    hist = done["kernel"][1]
    out["losses"] = [h["loss"] for h in hist]
    out["fp32_losses"] = [h["loss"] for h in done["fp32_twin"][1]]
    out.update(tl.summary(hist, XLSTM_TRAIN_BATCH * XLSTM_TRAIN_SEQ))
    out["twin"] = compare_trains(done["kernel"], done["plain_twin"])
    out["fp32_twin"] = compare_trains(done["kernel"], done["fp32_twin"])
    # x_qkv of every block carries factors (those outside "last4" rank 0),
    # so a forward calls #3 three times a group: the mLSTM's q, k (with v)
    # and its v third again (strided), the sLSTM's
    out["groups"] = model.cfg.n_layers // model.cfg.group_size
    out["matmuls_per_step"] = 3 * out["groups"]
    return out


def mamba_width_check(seed: int) -> dict:
    """One Mamba layer at jamba-1.5-large's width (d 8192, d_in 16384, N 16,
    dt rank 512, random weights from ``seed``) in float32 and bf16: a 4-lane
    prefill of a 64-row bucket with true lengths JAMBA_MAMBA_LENGTHS, then
    JAMBA_MAMBA_DECODE decode steps, against the step recurrence from
    position 0 (the mixer's own decode step over each lane's valid tokens,
    each lane's state kept at its length, then the same decode inputs).
    Holds the valid prefill outputs, the conv carry and h the prefill
    leaves, and the decode outputs, each as |Δ| over the largest
    |reference|."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import mamba

    out = {}
    B, S = len(JAMBA_MAMBA_LENGTHS), max(JAMBA_MAMBA_LENGTHS)
    rel = lambda a, b: _max_err(a, b) / max(float(b.float().abs().max()), 1e-30)
    for dtype in ("float32", "bfloat16"):
        dt = getattr(torch, dtype)
        cfg = get_config(JAMBA).replace(dtype=dtype)
        gen = torch.Generator(device="cuda").manual_seed(seed + 8000)
        dev = gen.device
        p = {k: v[0] for k, v in mamba.init_mamba_params(gen, cfg, 1, dt).items()}
        x = torch.randn((B, S, cfg.d_model), generator=gen, device=dev).to(dt)
        xd = torch.randn((JAMBA_MAMBA_DECODE, B, 1, cfg.d_model), generator=gen,
                         device=dev).to(dt)
        length = torch.tensor(JAMBA_MAMBA_LENGTHS, dtype=torch.int32, device=dev)
        with torch.no_grad():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            y, pre = mamba.mamba_mixer(p, x, cfg, state=mamba.init_mamba_state(cfg, B, (), dt, dev),
                                       length=length)
            torch.cuda.synchronize()
            t_prefill = time.perf_counter() - t0
            st, dec = pre, []
            for i in range(JAMBA_MAMBA_DECODE):
                yd, st = mamba.mamba_mixer(p, xd[i], cfg, state=st)
                dec.append(yd)
            ref = mamba.init_mamba_state(cfg, B, (), dt, dev)
            kept = {k: torch.empty_like(v) for k, v in ref.items()}
            y_ref = []
            for t in range(S):
                yt, ref = mamba.mamba_mixer(p, x[:, t:t + 1], cfg, state=ref)
                y_ref.append(yt)
                for b, n in enumerate(JAMBA_MAMBA_LENGTHS):
                    if t == n - 1:
                        for k in kept:
                            kept[k][b] = ref[k][b]
            y_ref, st, dec_ref = torch.cat(y_ref, dim=1), kept, []
            for i in range(JAMBA_MAMBA_DECODE):
                yd, st = mamba.mamba_mixer(p, xd[i], cfg, state=st)
                dec_ref.append(yd)
        torch.cuda.synchronize()
        valid = torch.arange(S, device=dev)[None, :] < length[:, None]
        row = {"prefill_y": rel(y[valid], y_ref[valid]), "conv": rel(pre["conv"], kept["conv"]),
               "h": rel(pre["h"], kept["h"]),
               "decode_y": max(rel(a, b) for a, b in zip(dec, dec_ref)),
               "prefill_s": t_prefill, "tol": JAMBA_MAMBA_TOL[dtype],
               "finite": bool(torch.isfinite(y).all() and all(torch.isfinite(a).all()
                                                             for a in dec))}
        row["ok"] = row["finite"] and max(row[k] for k in ("prefill_y", "conv", "h",
                                                           "decode_y")) <= row["tol"]
        out[dtype] = row
        del p, x, xd, y, pre, st, kept, ref, y_ref
        torch.cuda.empty_cache()
    return out


def jamba_reduced_serves(seed: int) -> dict:
    """Reduced jamba-1.5-large-398b (8 layers in one group: attention at 4,
    7 Mamba layers, 4 moe layers; d 64; float32) on the card through the
    engine in the oracle-dense and the paged layout on the same weights,
    tenants and traffic: each token for token against the merged-weight
    reference (FP32_LOGIT_TOL), paged against dense (tokens equal, logits
    within QWEN_CHUNK_FP32_TOL), the pool drained, launches counted."""
    import numpy as np
    import torch
    from repro_torch import kernels
    from repro_torch.configs import get_reduced

    cfg = get_reduced(JAMBA).replace(dtype="float32")
    conf = {"n_lanes": 2, "max_len": 64, "block_size": 8}
    out, params, lams, runs = {}, None, None, {}
    for layout in ("oracle_dense", "paged"):
        kernels.reset_launch_counts()
        engine, lams, done, t = recurrent_serve(cfg, seed, JAMBA_REDUCED_PROMPTS,
                                                JAMBA_REDUCED_GEN, params=params, lams=lams,
                                                layout=layout, **conf)
        params = engine.params
        runs[layout] = [done[u] for u in sorted(done)]
        out[layout] = {"serve_s": t, "steps": engine.steps, "launches": kernels.launch_counts(),
                       "verify": verify(cfg, engine, lams, done, JAMBA_REDUCED_GEN),
                       "all_served": len(done) == len(JAMBA_REDUCED_PROMPTS)}
        if engine.paged:
            out[layout]["pool_drained"] = engine.allocator.n_free == engine.allocator.capacity
            out[layout]["pool_peak"] = engine.allocator.peak_in_use
        del engine
    out["paged_vs_dense"] = {
        "tokens_equal": all(a.tokens == b.tokens for a, b in zip(runs["oracle_dense"],
                                                                   runs["paged"])),
        "max_abs_dlogits": max(float(np.abs(np.stack(a.logits) - np.stack(b.logits)).max())
                               for a, b in zip(runs["oracle_dense"], runs["paged"]))}
    torch.cuda.empty_cache()
    return out


def check_strided_kernels(gen, details) -> dict:
    """#1 (bf16 and float32 x) and #3 (bf16 and float32) on W and A that are
    the last third of wider matrices (XLSTM_V_BGMV, XLSTM_V_MATMUL: the mLSTM
    v projection), against their plain versions, and bitwise the same
    kernel on contiguous copies; a planted fault (W's rows read N apart, as
    if it were contiguous) must fall outside the tolerance."""
    import torch
    from repro_torch.benchmarks.common import err_over_bound
    from repro_torch.kernels.qrlora_bgmv import qrlora_bgmv_cuda
    from repro_torch.kernels.qrlora_matmul import qrlora_matmul_cuda
    from repro_torch.kernels.ref import qrlora_bgmv_ref, qrlora_matmul_ref

    worst = {}
    for dt in (torch.bfloat16, torch.float32):
        name = str(dt).split(".")[1]
        cases = [("qrlora_bgmv", sh) for sh in XLSTM_V_BGMV] + [("qrlora_matmul", sh)
                                                                for sh in XLSTM_V_MATMUL]
        for kind, (M, K, N, r, ld) in cases:
            if kind == "qrlora_bgmv":
                x, W, B, A, lam, seg = _bgmv_inputs(gen, M, K, N, r, 8, dt)
                kernel, plain = qrlora_bgmv_cuda, qrlora_bgmv_ref
                rest = (lam, seg)
            else:
                x, W, B, A, lam = _matmul_inputs(gen, M, N, dt, K=K, r=r, rank=r)
                kernel, plain = qrlora_matmul_cuda, qrlora_matmul_ref
                rest = (lam,)
            Ws, As = _strided(W, ld), _strided(A, ld)
            y = kernel(x, Ws, B, As, *rest, scale=0.7)
            y_contig = kernel(x, W, B, A, *rest, scale=0.7)
            # planted fault: the slice's rows read N apart (its first row,
            # then 1e3 fill where the second row should be)
            W_bad = torch.as_strided(Ws, (K, N), (N, 1))
            y_bad = kernel(x, W_bad, B, As, *rest, scale=0.7)
            torch.cuda.synchronize()
            ref = plain(x, W, B, A, *rest, scale=0.7)
            tol = _tol(kind, dt)
            err = _max_err(y, ref)
            fault = err_over_bound(y_bad, ref, (*tol, 0.0))
            ok = (_within(y, ref, tol) and bool(torch.isfinite(y).all())
                  and torch.equal(y, y_contig) and fault > 1.0)
            details.append({"kernel": kind, "arch": XLSTM, "x": name, "M": M, "K": K, "N": N,
                            "r": r, "ld": ld, "max_abs_err": err, "bitwise_contiguous":
                            torch.equal(y, y_contig), "fault_rows_n_apart_over_bound": fault,
                            "ok": ok})
            _check(ok, f"{kind} on a column slice ({name}, M={M} K={K} N={N} r={r} ld={ld}): "
                       f"max|Δ|={err:.3e} over {tol}, not bitwise the contiguous call, or the "
                       f"planted stride fault ({fault:.1f} of the bound) went through")
            key = f"{kind}_{name}"
            worst[key] = max(worst.get(key, 0.0), err)
    return worst


def recurrent_kernel_timings(gen) -> dict:
    """#1, #2 and #3 at xlstm-125m's and jamba-1.5-large's shapes by
    CUDA-graph replay beside their plain versions and cuBLAS's composition
    (the v slices read by stride)."""
    return {
        "qrlora_bgmv_xlstm_qkv": time_bgmv(gen, 4608, 4, K=1536, r=160),
        "qrlora_bgmv_xlstm_v": time_bgmv(gen, 1536, 4, K=1536, r=160, ld=4608),
        "qrlora_bgmv_xlstm_slstm": time_bgmv(gen, 3072, 4, K=768, r=160),
        "qrlora_bgmv_xlstm_qkv_M64": time_bgmv(gen, 4608, 64, K=1536, r=160),
        "qrlora_matmul_xlstm_qkv": time_matmul(gen, 4608, M=2048, K=1536, r=160),
        "qrlora_matmul_xlstm_v": time_matmul(gen, 1536, M=2048, K=1536, r=160, ld=4608),
        "qrlora_bgmv_jamba_wq": time_bgmv(gen, 8192, 4, K=8192, r=256),
        "qrlora_bgmv_jamba_wv": time_bgmv(gen, 1024, 4, K=8192, r=256),
        "paged_decode_attention_jamba": time_paged(gen, (40, 33, 57, 21), H=64, KV=8, cols=4,
                                                   max_blocks=8, dh=128),
    }


def recurrent_phase(seed: int, gen) -> dict:
    """The recurrent families on the card: #1, #2 and #3 at xlstm-125m's and
    jamba-1.5-large's full-width shapes (the v slices by stride included);
    full-width, full-depth xlstm-125m (random bf16 weights from ``seed``,
    QR-LoRA on x_qkv of the last 4 of each block kind) served in float32 and
    bf16 with its planted faults and time-slicing (:func:`xlstm_serves`) and
    trained (:func:`xlstm_train`); one Mamba layer at jamba's width
    (:func:`mamba_width_check`); reduced jamba in both layouts
    (:func:`jamba_reduced_serves`).  Returns every reading."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.tree import tree_leaves

    out = {"seconds": {}, "cases": []}
    t0 = time.perf_counter()

    def lap(name):
        nonlocal t0
        now = time.perf_counter()
        out["seconds"][name] = now - t0
        t0 = now

    out["xlstm_kernels"] = check_shape_kernels(gen, out["cases"], XLSTM, XLSTM_BGMV_SHAPES,
                                               (1, 1, 64), (), XLSTM_MATMUL_SHAPE)
    out["jamba_kernels"] = check_shape_kernels(gen, out["cases"], JAMBA, JAMBA_BGMV_SHAPES,
                                               (64, 8, 128), JAMBA_PAGED_CASES)
    out["strided"] = check_strided_kernels(gen, out["cases"])
    lap("kernel_checks")
    out["timings"] = recurrent_kernel_timings(gen)
    lap("timings")
    model = build_model(get_config(XLSTM))
    t1 = time.perf_counter()
    p16 = model.init(torch.Generator(device="cuda").manual_seed(seed))
    torch.cuda.synchronize()
    out["xlstm_init_s"] = time.perf_counter() - t1
    out["xlstm_params"] = sum(t.numel() for t in tree_leaves(p16))
    lap("xlstm_init")
    out["serve"] = xlstm_serves(seed, p16)
    lap("xlstm_serve")
    out["train"] = xlstm_train(p16, seed)
    lap("xlstm_train")
    del p16, model
    torch.cuda.empty_cache()
    out["mamba"] = mamba_width_check(seed)
    lap("mamba")
    out["jamba"] = jamba_reduced_serves(seed)
    lap("jamba_reduced")
    return out


def print_recurrent(out: dict, smi: str) -> None:
    print(f"qrlora_bgmv and qrlora_matmul at {XLSTM}'s shapes (BGMV {XLSTM_BGMV_SHAPES}; one-λ "
          f"bf16 {XLSTM_MATMUL_SHAPE}): {out['xlstm_kernels']}; on the strided v slice (BGMV "
          f"{XLSTM_V_BGMV}, one-λ {XLSTM_V_MATMUL}, (M, K, N, r, row stride)): {out['strided']}, "
          f"bitwise the contiguous calls, rows read N apart rejected; #1 and #2 at {JAMBA}'s "
          f"(BGMV {JAMBA_BGMV_SHAPES}; paged 64 heads over 8, dh 128): {out['jamba_kernels']}")
    for name, t in out["timings"].items():
        print(f"{name}: kernel {t['ms']:.5f} ms (eager call {t['eager_ms']:.5f} ms), plain "
              f"{t['plain_ms']:.5f} ms, library {t['library_ms']} ms, bound "
              f"{t['bound_ms']:.6f} ms ({t['bound_by']}) at {t['shape']} on {smi}; timed by "
              f"CUDA-graph replay")
    print(f"{XLSTM}: {out['xlstm_params']} parameters, init {out['xlstm_init_s']:.1f} s")
    for dtype in ("float32", "bfloat16"):
        s = out["serve"][dtype]
        print(f"{XLSTM} serve {dtype} ({s['layout']}, buckets {s['prefill_buckets']}): "
              f"{s['tokens']} tokens in {s['serve_s']:.3f} s = {s['tok_per_s']:.1f} tok/s over "
              f"{s['steps']} steps; launches {s['launches']} ({s['v_launches']} #1 on the strided "
              f"v slice); decode state {s['state_bytes_per_lane']:.0f} B a lane on {smi}")
        for row in s["verify"]:
            print(f"  {dtype} free-running vs the merged-weight reference: {row}")
        for row in s.get("verify_forced", ()):
            print(f"  bf16 vs the teacher-forced merged-weight reference: {row}")
    for name, row in out["serve"]["float32"]["planted_faults"].items():
        print(f"  float32 planted fault {name}: {row}")
    b = out["serve"]["bfloat16"]
    sound = max(r["max_dlogits_over_bound"] for r in b["verify_forced"])
    print(f"  bf16 drift reading (|Δlogits| over the bound {XLSTM_BF16_DRIFT / 2**-9:.1f}·2^-9 "
          f"of each row's max): sound serve {sound:.4f}")
    print(f"  profiled bf16 serve (4 prefills, {b['profile']['steps']} decode steps): "
          f"{b['profile']}")
    print(f"  one profiled bf16 decode step of 4 lanes: {b['decode_step']}")
    print(f"  quantum={XLSTM_QUANTUM} on 2 lanes vs unsliced: {b['quantum']}")
    t = out["train"]
    print(f"{XLSTM} train bf16: {XLSTM_TRAIN_STEPS} steps at batch {XLSTM_TRAIN_BATCH} × seq "
          f"{XLSTM_TRAIN_SEQ}, median step {t['median_step_ms']:.1f} ms, {t['tokens_per_s']:.0f} "
          f"train tokens/s, losses {t['losses']} (float32 twin {t['fp32_losses']}); vs plain "
          f"twin {t['twin']} (bound {TRAIN_TOL['bfloat16']}); vs float32 twin {t['fp32_twin']} "
          f"(loss bound {XLSTM_TRAIN_FP32_DLOSS}); launches {t['launches_kernel']} "
          f"({t['v_calls_kernel']} on the strided v slice)")
    for dtype, row in out["mamba"].items():
        print(f"{JAMBA} Mamba layer at full width, {dtype}: prefill of lengths "
              f"{JAMBA_MAMBA_LENGTHS} + {JAMBA_MAMBA_DECODE} decode steps vs the step "
              f"recurrence: {row}")
    j = out["jamba"]
    for layout in ("oracle_dense", "paged"):
        print(f"{JAMBA} reduced, float32, {layout}: {j[layout]}")
    print(f"  paged vs dense: {j['paged_vs_dense']}; phase seconds {out['seconds']}")


def check_recurrent(out: dict) -> None:
    for dtype in ("float32", "bfloat16"):
        s = out["serve"][dtype]
        _check(s["all_served"] and s["layout"] == "oracle_dense",
               f"{XLSTM} serve {dtype}: not every tenant got its tokens, or layout {s['layout']}")
        _check(s["launches"]["qrlora_bgmv"] > 0 and s["v_launches"] > 0,
               f"{XLSTM} serve {dtype}: #1 never launched, or never on the v slice: "
               f"{s['launches']}, {s['v_launches']}")
        _check(s["launches"]["paged_decode_attention"] == 0,
               f"{XLSTM} serve {dtype}: an attention kernel launched: {s['launches']}")
        _check_no_bench_kernels(s["launches"], f"{XLSTM} serve {dtype}")
        _check(len(s["prefill_buckets"]) == 2,
               f"{XLSTM} serve {dtype}: prompts in buckets {s['prefill_buckets']}, want two")
    f32 = out["serve"]["float32"]
    _check(all(r["tokens_match"] and r["max_abs_dlogits"] < FP32_LOGIT_TOL for r in f32["verify"]),
           f"{XLSTM} fp32 serve diverged from the merged-weight reference: {f32['verify']}")
    for name, row in f32["planted_faults"].items():
        _check(not row["ok"], f"{XLSTM}: the float32 check let the planted fault {name} "
                              f"through: {row}")
    b = out["serve"]["bfloat16"]
    _check(all(r["ok"] for r in b["verify_forced"]),
           f"{XLSTM} bf16 serve disagrees with the teacher-forced merged-weight reference: "
           f"{b['verify_forced']}")
    for r in b["verify"]:
        _check(r["tokens_match"] or r["parting_margin"] <= r["parting_bound"],
               f"{XLSTM} bf16 {r['tenant']} parts from the merged-weight reference where its "
               f"lead is above the drift bound: {r}")
    q = b["quantum"]
    _check(q["slice_preemptions"] >= 1 and q["unsliced_preemptions"] == 0 and q["bitwise"],
           f"{XLSTM} quantum={XLSTM_QUANTUM}: not bitwise the unsliced serve, or it never "
           f"sliced: {q}")
    t = out["train"]
    check_train_launches(f"{XLSTM} train", t, t["matmuls_per_step"] * XLSTM_TRAIN_STEPS,
                         nested=True)
    _check(t["v_calls_kernel"] == t["groups"] * XLSTM_TRAIN_STEPS,
           f"{XLSTM} train: {t['v_calls_kernel']} forward calls on the strided v slice, want "
           f"{t['groups'] * XLSTM_TRAIN_STEPS}")
    # after 4 warm-up steps λ is lr-sized and Adam's sign-like updates turn
    # bf16 gradient noise into whole-λ differences (1.37 of max|λ| at --seed
    # 0), so the bf16 twin holds the loss, as moe's and vlm's do
    _check(t["twin"]["finite"] and t["twin"]["max_dloss"] <= TRAIN_TOL["bfloat16"]["dloss"],
           f"{XLSTM} train: the loss disagrees with its plain-version twin: {t['twin']}")
    _check(t["fp32_twin"]["finite"] and t["fp32_twin"]["max_dloss"] <= XLSTM_TRAIN_FP32_DLOSS,
           f"{XLSTM} bf16 train's loss is off its float32 twin's: {t['fp32_twin']}")
    for dtype, row in out["mamba"].items():
        _check(row["ok"], f"{JAMBA} Mamba layer {dtype} disagrees with the step recurrence: "
                          f"{row}")
    j = out["jamba"]
    for layout in ("oracle_dense", "paged"):
        _check(j[layout]["all_served"] and all(
            r["tokens_match"] and r["max_abs_dlogits"] < FP32_LOGIT_TOL
            for r in j[layout]["verify"]),
            f"{JAMBA} reduced {layout} diverged from the merged-weight reference: {j[layout]}")
        _check_no_bench_kernels(j[layout]["launches"], f"{JAMBA} reduced {layout}")
    p = j["paged"]
    _check(p["pool_drained"] and p["launches"]["qrlora_bgmv"] > 0
           and p["launches"]["paged_decode_attention"] > 0,
           f"{JAMBA} reduced paged: the pool not drained, or #1/#2 never launched: {p}")
    _check(j["paged_vs_dense"]["tokens_equal"]
           and j["paged_vs_dense"]["max_abs_dlogits"] <= QWEN_CHUNK_FP32_TOL,
           f"{JAMBA} reduced paged vs dense: {j['paged_vs_dense']}")


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

    report = {"card": smi, "cases": [], "phase_seconds": {}}
    t_mark = [time.perf_counter()]

    def mark(name):
        """Seconds since the previous mark, filed under ``name``."""
        now = time.perf_counter()
        report["phase_seconds"][name] = round(now - t_mark[0], 1)
        t_mark[0] = now

    mark("build")
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

    mark("kernel_checks")
    timings = {"qrlora_bgmv_wq": time_bgmv(gen, 576), "qrlora_bgmv_wv": time_bgmv(gen, 192),
               "qrlora_bgmv_wq_M64": time_bgmv(gen, 576, 64),
               "paged_decode_attention": time_paged(gen),
               "paged_decode_attention_long": time_paged_long(gen),
               "qrlora_matmul_wq": time_matmul(gen, 576), "qrlora_matmul_wv": time_matmul(gen, 192),
               "qrlora_bgmv_qwen2_wq": time_bgmv(gen, 896, 4, K=896, r=160),
               "qrlora_bgmv_qwen2_wv": time_bgmv(gen, 128, 4, K=896, r=160),
               "qrlora_bgmv_qwen2_wq_M32": time_bgmv(gen, 896, 32, K=896, r=160),
               "qrlora_bgmv_qwen2_wq_M20": time_bgmv(gen, 896, 20, K=896, r=160),
               "qrlora_bgmv_qwen2_wq_M2": time_bgmv(gen, 896, 2, K=896, r=160),
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
    # musicgen-medium's shapes: K = N = 1536, MHA
    timings["qrlora_bgmv_musicgen_wq"] = time_bgmv(gen, 1536, 4, K=1536, r=128)
    timings["qrlora_bgmv_musicgen_wq_M64"] = time_bgmv(gen, 1536, 64, K=1536, r=128)
    timings["paged_decode_attention_musicgen"] = time_paged(gen, (40, 33, 57, 21), H=24, KV=24,
                                                            cols=4, max_blocks=8)
    timings["qrlora_matmul_musicgen_wq"] = time_matmul(gen, 1536, M=1024, K=1536)
    # moonshot-v1-16b-a3b's and mixtral-8x22b's shapes (dh 128)
    timings.update(moe_kernel_timings(gen))
    # llama-3.2-vision-11b's shapes (K 4096, r 256; a cross layer's 6400 image rows)
    timings.update(vlm_kernel_timings(gen))
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

    mark("timings")
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

    mark("kernel_bench")
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

    mark("smollm_bf16")
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

    mark("smollm_sharded_bf16")
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

    mark("smollm_quant")
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

    mark("smollm_fp32")
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

    mark("smollm_fp32_int8")
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

    mark("posture")
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

    mark("request_api")
    # -- the oracle-dense layout, time-slicing and the router on the same ----
    t0 = time.perf_counter()
    dense_bgmv_err = check_dense_bgmv(gen, report["cases"])
    print(f"qrlora_bgmv at {QWEN}'s 1- and 2-lane decode steps {DENSE_BGMV_SHAPES}: max|Δ| "
          f"{dense_bgmv_err}, within tolerance, bitwise on a second call")
    dense = dense_phase(args.seed, qwen_params)
    report["dense"] = dense
    print_dense(dense, smi)
    check_dense(dense)
    t_dense = time.perf_counter() - t0
    routes = router_phase(args.seed, qwen_params)
    report["router"] = routes
    print_router(routes, smi)
    check_router(routes)
    print(f"{QWEN} oracle-dense layout in float32 and bf16: token-identical to the merged-weight "
          f"reference (float32), the time-sliced serve bitwise the unsliced one, every dense "
          f"decode dispatch free of syncs ({t_dense:.1f} s); 2 replicas on one card: routed "
          f"streams equal one engine's in both layouts, spillover, failover and disaggregation "
          f"hold; every planted fault rejected ({time.perf_counter() - t0:.1f} s)")
    mark("dense_router")
    # -- speculative decoding on the same weights and traffic ----------------
    t0 = time.perf_counter()
    spec = speculative_phase(args.seed, qwen_params)
    report["speculative"] = spec
    print_speculative(spec, smi)
    check_speculative(spec)
    print(f"{QWEN} speculative decoding (k={SPEC_K}) in float32 and bf16: float32 tokens equal "
          f"the plain twins' within {QWEN_CHUNK_FP32_TOL} (paged, truncated-λ drafter, dense "
          f"time-sliced), bf16 within the teacher-forced bar, no shared block written, the pool "
          f"drained, every draft, verify and commit free of syncs, every planted fault rejected "
          f"({time.perf_counter() - t0:.1f} s)")
    mark("speculative")
    # -- the λ-store cold tier on the same weights -----------------------------
    t0 = time.perf_counter()
    cold = cold_phase(args.seed, qwen_params)
    report["cold"] = cold
    print_cold(cold, smi)
    check_cold(cold)
    print(f"{QWEN} λ-store cold tier (2 hot slots, 12 tenants) in float32 and bf16: tokens equal "
          f"the all-hot serve's (float32 within {QWEN_CHUNK_FP32_TOL}, bf16 within the drift "
          f"bar), promotions, spills and deferrals counted, every admission gate free of syncs, "
          f"the mmap restart bitwise, every planted fault rejected "
          f"({time.perf_counter() - t0:.1f} s)")
    del qwen_params
    torch.cuda.empty_cache()

    mark("cold")
    # -- the audio family: musicgen-medium at full width ---------------------
    t0 = time.perf_counter()
    audio_err = check_audio_kernels(gen, report["cases"])
    print(f"qrlora_bgmv, paged_decode_attention and qrlora_matmul at {AUDIO}'s shapes (BGMV "
          f"{AUDIO_BGMV_SHAPES}; paged 24 heads over 24, dh 64, {AUDIO_PAGED_CASES}; one-λ bf16 "
          f"{AUDIO_MATMUL_SHAPE}): {audio_err}, within tolerance, length-0 lanes zeros, "
          f"bitwise on a second call")
    audio = audio_phase(args.seed)
    report["audio"] = audio
    print_audio(audio, smi)
    check_audio(audio)
    print(f"{AUDIO} at full width: the serve token-identical to the merged-weight reference "
          f"(float32; bf16 teacher-forced), the embeds prefill/decode equal to the full forward, "
          f"the bf16 train within its twin's bar ({time.perf_counter() - t0:.1f} s)")

    mark("audio")
    # -- the moe family: moonshot-v1-16b-a3b at full width, mixtral's shapes --
    t0 = time.perf_counter()
    moe_err = check_shape_kernels(gen, report["cases"], MOE, MOE_BGMV_SHAPES, (16, 16, 128),
                                  MOE_PAGED_CASES, MOE_MATMUL_SHAPE)
    mixtral_err = check_shape_kernels(gen, report["cases"], MIXTRAL, MIXTRAL_BGMV_SHAPES,
                                      (48, 8, 128), MOE_PAGED_CASES)
    print(f"qrlora_bgmv, paged_decode_attention and qrlora_matmul at {MOE}'s shapes (BGMV "
          f"{MOE_BGMV_SHAPES}; paged 16 heads over 16, dh 128, {MOE_PAGED_CASES}; one-λ bf16 "
          f"{MOE_MATMUL_SHAPE}): {moe_err}; at {MIXTRAL}'s (BGMV {MIXTRAL_BGMV_SHAPES}; paged 48 "
          f"heads over 8, dh 128): {mixtral_err}; within tolerance, length-0 lanes zeros, "
          f"bitwise on a second call")
    moe_out = moe_phase(args.seed)
    report["moe"] = moe_out
    print_moe(moe_out, smi)
    check_moe(moe_out)
    print(f"{MOE} at full width: the dispatch on the card equals the CPU's, the shipped serve "
          f"repeats bitwise, the drop-free twin within its bars (bf16 teacher-forced at full "
          f"depth, float32 at {MOE_FP32_LAYERS} layers token-identical), the bf16 train within "
          f"its twin's bar ({time.perf_counter() - t0:.1f} s)")
    mark("moe")
    # -- the vlm family: llama-3.2-vision-11b at full width and depth ---------
    t0 = time.perf_counter()
    vlm_err = vlm_kernel_checks(gen, report["cases"])
    print(f"qrlora_matmul (bf16 {VLM_MATMUL_SHAPES}, float32 {VLM_QUANT_SHAPES}) and "
          f"qrlora_matmul_quant (int8, fp8 {VLM_QUANT_SHAPES}) at {VLM}'s shapes: {vlm_err}, "
          f"within tolerance, bitwise on a second call")
    vlm_out = vlm_phase(args.seed)
    report["vlm"] = vlm_out
    print_vlm(vlm_out, smi)
    check_vlm(vlm_out)
    print(f"{VLM} at full width and depth: the bf16 serve through launch/serve.py within the "
          f"teacher-forced bar, the float32 twin token-identical to the plain path, every planted "
          f"fault rejected, the bf16 and float32 trains within their twins' bars "
          f"({time.perf_counter() - t0:.1f} s)")
    mark("vlm")
    # -- the recurrent families: xlstm-125m at full width, jamba's parts ------
    t0 = time.perf_counter()
    rec = recurrent_phase(args.seed, gen)
    report["recurrent"] = rec
    report["cases"].extend(rec.pop("cases"))
    timings.update(rec["timings"])
    print_recurrent(rec, smi)
    check_recurrent(rec)
    print(f"{XLSTM} at full width and depth: the float32 serve token-identical to the "
          f"merged-weight reference, every planted fault rejected, bf16 within the teacher-forced "
          f"bar, quantum={XLSTM_QUANTUM} bitwise the unsliced serve, the bf16 train within its "
          f"twins' bars; {JAMBA}'s Mamba layer at full width on the step recurrence's bar, the "
          f"reduced hybrid token-identical in both layouts ({time.perf_counter() - t0:.1f} s)")
    mark("recurrent")
    # -- the training path: full-width λ-only trains, launches counted -------
    want_launches = {name: 0 for name in kernels.KERNEL_WRAPPERS}
    report["train"] = {}
    kept = {}
    for dtype in ("bfloat16", "float32"):
        torch.cuda.reset_peak_memory_stats()
        tr = train_phase(dtype, args.seed, log_every=10 if dtype == "bfloat16" else 0,
                         keep=kept if dtype == "bfloat16" else None)
        report["train"][dtype] = tr
        print(f"train {dtype}: {TRAIN_STEPS} steps at batch {TRAIN_BATCH} × seq {TRAIN_SEQ}, "
              f"init {tr['init_s']:.1f} s; median step {tr['median_step_ms']:.1f} ms; "
              f"{tr['tokens_per_s']:.0f} train tokens/s; peak memory {tr['peak_mem_gb']:.2f} GiB; "
              f"launches {tr['launches_kernel']} ({tr['launches_recompute']['qrlora_matmul']} "
              f"qrlora_matmul in remat's recompute)")
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
        # wq and wv of every layer, every step
        check_train_launches(f"train {dtype}", tr, 2 * tr["n_layers"] * TRAIN_STEPS)
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

    mark("train")
    # -- the fault-tolerant train on the bf16 train's model and params ------
    ft = ft_phase(args.seed, kept["model"], kept["params"])
    report["fault_tolerant_train"] = ft
    print_ft(ft, smi)
    check_ft(ft, kept["model"].cfg.n_layers)
    print(f"fault-tolerant train: the crashed and the preempted runs resume bitwise the straight "
          f"run (λ, m, v), remat bitwise off, the NCCL compressed sync bitwise gloo's "
          f"({ft['s']:.1f} s)")
    del kept
    torch.cuda.empty_cache()

    mark("fault_tolerant_train")
    # -- the GLUE path: full-width RoBERTa-base in every mode, launches counted
    report["glue"], glue_launches = check_glue(glue_phase(args.seed), want_launches)

    mark("glue")
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
        # the oracle-dense serve (bf16, 2 lanes; its attend is plain torch) and
        # the routed serves (float32, 2 replicas on the card)
        ("qrlora_bgmv_qwen2_dense", "qrlora_bgmv_qwen2_wq_M2", dense_bgmv_err["bfloat16"],
         "src/repro_torch/kernels/csrc/qrlora_bgmv.cu", "src/repro/kernels/qrlora_bgmv.py:172",
         dense["bfloat16"]["runs"]["dense"]["launches"]["qrlora_bgmv"]),
        ("qrlora_bgmv_qwen2_routed", "qrlora_bgmv_qwen2_wq", qwen_err["qrlora_bgmv_float32"],
         "src/repro_torch/kernels/csrc/qrlora_bgmv.cu", "src/repro/kernels/qrlora_bgmv.py:172",
         routes["paged"]["routed"]["launches"]["qrlora_bgmv"]
         + routes["oracle_dense"]["routed"]["launches"]["qrlora_bgmv"]),
        ("paged_decode_attention_qwen2_routed", "paged_decode_attention_qwen2",
         qwen_err["paged_decode_attention_float32"]["max_abs_err"],
         "src/repro_torch/kernels/csrc/paged_attention.cu",
         "src/repro/kernels/paged_attention.py:116",
         routes["paged"]["routed"]["launches"]["paged_decode_attention"]),
        # the speculative paged serve (bf16, k=4): #1 in the verify at 4 × 5
        # rows and the prefills, #2 in every draft step
        ("qrlora_bgmv_qwen2_speculative", "qrlora_bgmv_qwen2_wq_M20",
         qwen_err["qrlora_bgmv_bfloat16"], "src/repro_torch/kernels/csrc/qrlora_bgmv.cu",
         "src/repro/kernels/qrlora_bgmv.py:172",
         spec["runs"]["paged_bf16"]["launches"]["qrlora_bgmv"]),
        ("paged_decode_attention_qwen2_speculative", "paged_decode_attention_qwen2",
         qwen_err["paged_decode_attention_bfloat16"]["max_abs_err"],
         "src/repro_torch/kernels/csrc/paged_attention.cu",
         "src/repro/kernels/paged_attention.py:116",
         spec["runs"]["paged_bf16"]["launches"]["paged_decode_attention"]),
        # the cold-tier serve (bf16, 2 hot slots)
        ("qrlora_bgmv_qwen2_cold", "qrlora_bgmv_qwen2_wq", qwen_err["qrlora_bgmv_bfloat16"],
         "src/repro_torch/kernels/csrc/qrlora_bgmv.cu", "src/repro/kernels/qrlora_bgmv.py:172",
         cold["runs"]["cold_bfloat16"]["launches"]["qrlora_bgmv"]),
        ("paged_decode_attention_qwen2_cold", "paged_decode_attention_qwen2",
         qwen_err["paged_decode_attention_bfloat16"]["max_abs_err"],
         "src/repro_torch/kernels/csrc/paged_attention.cu",
         "src/repro/kernels/paged_attention.py:116",
         cold["runs"]["cold_bfloat16"]["launches"]["paged_decode_attention"]),
        # musicgen-medium: the bf16 serve (#1, #2 at 24 heads over 24) and
        # the bf16 train (#3 at K = N = 1536)
        ("qrlora_bgmv_musicgen", "qrlora_bgmv_musicgen_wq", audio_err["qrlora_bgmv_bfloat16"],
         "src/repro_torch/kernels/csrc/qrlora_bgmv.cu", "src/repro/kernels/qrlora_bgmv.py:172",
         audio["serve_bfloat16"]["launches"]["qrlora_bgmv"]),
        ("paged_decode_attention_musicgen", "paged_decode_attention_musicgen",
         audio_err["paged_decode_attention_bfloat16"]["max_abs_err"],
         "src/repro_torch/kernels/csrc/paged_attention.cu",
         "src/repro/kernels/paged_attention.py:116",
         audio["serve_bfloat16"]["launches"]["paged_decode_attention"]),
        ("qrlora_matmul_musicgen", "qrlora_matmul_musicgen_wq", audio_err["qrlora_matmul_bfloat16"],
         "src/repro_torch/kernels/csrc/qrlora_matmul.cu",
         "src/repro/kernels/qrlora_matmul.py:161", audio["train"]["launches_kernel"]["qrlora_matmul"]),
        # moonshot-v1-16b-a3b: the shipped bf16 serve (#1 at K = N = 2048,
        # r 160; #2 at 16 heads over 16, dh 128) and the bf16 train (#3)
        ("qrlora_bgmv_moonshot", "qrlora_bgmv_moonshot_wq", moe_err["qrlora_bgmv_bfloat16"],
         "src/repro_torch/kernels/csrc/qrlora_bgmv.cu", "src/repro/kernels/qrlora_bgmv.py:172",
         moe_out["shipped"]["launches"]["qrlora_bgmv"]),
        ("paged_decode_attention_moonshot", "paged_decode_attention_moonshot",
         moe_err["paged_decode_attention_bfloat16"]["max_abs_err"],
         "src/repro_torch/kernels/csrc/paged_attention.cu",
         "src/repro/kernels/paged_attention.py:116",
         moe_out["shipped"]["launches"]["paged_decode_attention"]),
        ("qrlora_matmul_moonshot", "qrlora_matmul_moonshot_wq", moe_err["qrlora_matmul_bfloat16"],
         "src/repro_torch/kernels/csrc/qrlora_matmul.cu",
         "src/repro/kernels/qrlora_matmul.py:161",
         moe_out["train"]["launches_kernel"]["qrlora_matmul"]),
        # llama-3.2-vision-11b: the bf16 serve through launch/serve.py (#3 at
        # K 4096, r 256; a cross layer's wv over 6400 image rows) and the
        # same weights on an int8 base (#4)
        ("qrlora_matmul_vlm", "qrlora_matmul_vlm_xattn_wv", vlm_err["qrlora_matmul_bfloat16"],
         "src/repro_torch/kernels/csrc/qrlora_matmul.cu",
         "src/repro/kernels/qrlora_matmul.py:161", vlm_out["serve"]["launches"]["qrlora_matmul"]),
        ("qrlora_matmul_quant_vlm", "qrlora_matmul_quant_vlm_xattn_wv_int8",
         vlm_err["qrlora_matmul_quant_bfloat16_int8"], "src/repro_torch/kernels/csrc/qrlora_matmul.cu",
         "src/repro/kernels/qrlora_matmul.py:110",
         vlm_out["serve_int8"]["launches"]["qrlora_matmul_quant"]),
        # xlstm-125m: the bf16 serve (#1 at the mLSTM x_qkv, K 1536 × N 4608,
        # r 160; its v third by row stride, the strided launches of the same
        # serve) and the bf16 train (#3 at batch 8 × seq 256)
        ("qrlora_bgmv_xlstm", "qrlora_bgmv_xlstm_qkv", rec["xlstm_kernels"]["qrlora_bgmv_bfloat16"],
         "src/repro_torch/kernels/csrc/qrlora_bgmv.cu", "src/repro/kernels/qrlora_bgmv.py:172",
         rec["serve"]["bfloat16"]["launches"]["qrlora_bgmv"]),
        ("qrlora_bgmv_xlstm_v_strided", "qrlora_bgmv_xlstm_v", rec["strided"]["qrlora_bgmv_bfloat16"],
         "src/repro_torch/kernels/csrc/qrlora_bgmv.cu", "src/repro/kernels/qrlora_bgmv.py:172",
         rec["serve"]["bfloat16"]["v_launches"]),
        ("qrlora_matmul_xlstm", "qrlora_matmul_xlstm_qkv",
         rec["xlstm_kernels"]["qrlora_matmul_bfloat16"],
         "src/repro_torch/kernels/csrc/qrlora_matmul.cu",
         "src/repro/kernels/qrlora_matmul.py:161", rec["train"]["launches_kernel"]["qrlora_matmul"]),
        ("qrlora_matmul_xlstm_v_strided", "qrlora_matmul_xlstm_v",
         rec["strided"]["qrlora_matmul_bfloat16"], "src/repro_torch/kernels/csrc/qrlora_matmul.cu",
         "src/repro/kernels/qrlora_matmul.py:161", rec["train"]["v_calls_kernel"]),
        # jamba-1.5-large: #1 and #2 timed at its full-width shapes (wq K
        # 8192 × N 8192, r 256; 64 heads over 8, dh 128); the launches are
        # the reduced hybrid's paged serve, the path one card can run
        ("qrlora_bgmv_jamba", "qrlora_bgmv_jamba_wq", rec["jamba_kernels"]["qrlora_bgmv_bfloat16"],
         "src/repro_torch/kernels/csrc/qrlora_bgmv.cu", "src/repro/kernels/qrlora_bgmv.py:172",
         rec["jamba"]["paged"]["launches"]["qrlora_bgmv"]),
        ("paged_decode_attention_jamba", "paged_decode_attention_jamba",
         rec["jamba_kernels"]["paged_decode_attention_bfloat16"]["max_abs_err"],
         "src/repro_torch/kernels/csrc/paged_attention.cu",
         "src/repro/kernels/paged_attention.py:116",
         rec["jamba"]["paged"]["launches"]["paged_decode_attention"]),
    ):
        t = timings[key]
        entries.append({"name": name, "route": "cuda", "source": src, "replaces": replaces,
                        "launches": n, "max_abs_err": err, "ms": t["ms"],
                        "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
                        "bound_by": t["bound_by"], "library_ms": t["library_ms"]})
    print(f"phase seconds: {report['phase_seconds']}")
    print(json.dumps({"kernels": entries}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
