"""Multi-tenant serving driver of the port: heterogeneous adapter batch, one
decode loop.

Builds a :class:`repro_torch.serving.MultiTenantEngine` (paged KV cache),
registers N tenants (tenant 0 is the base model in slot 0; the rest get
distinct random λ), serves one request per tenant through shared decode
steps, then re-derives every tenant's output through the single-adapter
deployment (λ merged into the weights) and compares it token for token and
logit for logit.

    PYTHONPATH=src python -m repro_torch.launch.serve_multi --reduced --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve_multi          # on the card
    PYTHONPATH=src python -m repro_torch.launch.serve_multi --base-dtype int8

The comparison needs ``--dtype float32`` (the default): in bfloat16 the
merged weights round differently from the fused adapter path.  With a
quantized base (``--base-dtype int8|fp8``) the reference dequantizes the
same ``{q, scale}`` weights, but the engine scales the x·q sum while the
reference multiplies by the dequantized weight, so the logit bar loosens to
5e-2; tokens must still match exactly.
"""
from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch

from repro_torch.configs import get_config, get_reduced
from repro_torch.configs.base import BASE_DTYPES
from repro_torch.core.quantize import resident_base_bytes
from repro_torch.kernels import _build
from repro_torch.serving import (
    BASE_TENANT,
    EngineConfig,
    MultiTenantEngine,
    base_lambda,
    random_lambda,
    reference_decode,
)


def _say(msg: str) -> None:
    sys.stdout.write(f"[serve_multi] {msg}\n")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-135m")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--tenants", type=int, default=4)
    ap.add_argument("--lanes", type=int, default=4)
    ap.add_argument("--slots", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--gen-len", type=int, default=12)
    ap.add_argument("--max-len", type=int, default=64)
    ap.add_argument("--lam-scale", type=float, default=0.3)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--block-size", type=int, default=16)
    ap.add_argument(
        "--dtype", default="float32",
        help="float32 default: the verification compares fused-multi-λ vs "
        "merged-weight logits, which only makes sense at full precision",
    )
    ap.add_argument("--base-dtype", default="bf16", choices=BASE_DTYPES,
                    help="frozen-base dtype of the adapted projections (int8/fp8: "
                    "per-output-channel quantized, dequantized in the kernels)")
    ap.add_argument("--device", default="cuda", help="'cuda' (default) or 'cpu'")
    args = ap.parse_args(argv)

    cfg = (get_reduced if args.reduced else get_config)(args.arch).replace(dtype=args.dtype)
    # the store must hold every tenant the driver submits for at once
    n_slots = max(args.slots, args.tenants + 1)
    if n_slots != args.slots:
        _say(f"raising --slots {args.slots} → {n_slots} to hold all tenants")
    econf = EngineConfig(
        n_lanes=args.lanes, n_slots=n_slots, max_len=args.max_len,
        collect_logits=True, seed=args.seed, block_size=args.block_size,
        base_dtype=args.base_dtype,
    )
    engine = MultiTenantEngine(cfg, econf, device=args.device)
    _say(f"arch={cfg.name} layout={engine.layout} device={engine.device} "
         f"pool={engine.allocator.capacity} blocks of {args.block_size}")
    if engine.base_dtype != "bf16":
        qb, fb = resident_base_bytes(engine.params)
        _say(f"quantized base ({engine.base_dtype}): adapted projections resident at "
             f"{qb} B vs {fb} B bf16-equivalent ({fb / max(qb, 1):.2f}x)")

    gen = torch.Generator(device=engine.device)
    lams = {BASE_TENANT: base_lambda(engine.params)}
    for i in range(1, args.tenants):
        name = f"tenant{i}"
        lams[name] = random_lambda(gen.manual_seed(args.seed + 1000 + i), engine.params,
                                   args.lam_scale)
        engine.add_tenant(name, lams[name])

    rng = np.random.default_rng(args.seed)
    for tenant in lams:
        prompt = rng.integers(2, cfg.vocab_size, size=args.prompt_len).astype(np.int32)
        engine.submit(tenant, prompt, args.gen_len)

    if engine.device.type == "cuda":
        _build.build()  # compile the kernels now, not inside the timed serve
    t0 = time.perf_counter()
    done = engine.run()
    if engine.device.type == "cuda":
        torch.cuda.synchronize(engine.device)
    dt = time.perf_counter() - t0
    _say(f"{engine.decoded_tokens} tokens in {dt * 1e3:.1f} ms "
         f"({engine.decoded_tokens / dt:.0f} tok/s) over {engine.steps} shared decode "
         f"steps, pool peak={engine.allocator.peak_in_use}/{engine.allocator.capacity} "
         f"blocks, preemptions={engine.preemptions}")

    tol = 1e-3 if engine.base_dtype == "bf16" else 5e-2
    worst = 0.0
    for uid in sorted(done):
        req = done[uid]
        ref_toks, ref_logits = reference_decode(
            cfg, engine.params, lams[req.tenant], req.prompt, args.gen_len, args.max_len
        )
        err = float(np.abs(np.stack(req.logits) - ref_logits).max())
        worst = max(worst, err)
        ok = req.tokens == ref_toks and err < tol
        _say(f"verify {req.tenant}: tokens {'OK' if ok else 'MISMATCH'} "
             f"max|Δlogits|={err:.2e} {req.tokens[:12]}")
        if not ok:
            raise SystemExit(f"tenant {req.tenant} diverged from merged-weight reference")
    _say(f"all {len(done)} tenants match merged-weight refs (worst |Δlogits|={worst:.2e})")
    return done


if __name__ == "__main__":
    main()
