"""Multi-tenant serving driver of the port: heterogeneous adapter batch, one
decode loop.

Builds a :class:`repro_torch.serving.MultiTenantEngine` (paged KV cache),
registers N tenants (tenant 0 is the base model in slot 0; the rest get
distinct random λ), serves one request per tenant through shared decode
steps, then re-derives every tenant's output through the single-adapter
deployment (λ merged into the weights) and compares it token for token and
logit for logit.

    PYTHONPATH=src python -m repro_torch.launch.serve_multi --reduced --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve_multi --reduced --arch qwen2-0.5b \
        --device cpu --share-prefix --prefill-chunk 32 --max-len 64
    PYTHONPATH=src python -m repro_torch.launch.serve_multi --reduced --arch moonshot-v1-16b-a3b \
        --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve_multi          # on the card
    PYTHONPATH=src python -m repro_torch.launch.serve_multi --base-dtype int8
    PYTHONPATH=src python -m repro_torch.launch.serve_multi --reduced --device cpu --shard-lam --shard-ba
    PYTHONPATH=src torchrun --nproc-per-node 2 -m repro_torch.launch.serve_multi \
        --reduced --device cpu --shard-lam --shard-ba

``--layout`` picks the KV layout (``auto``, the default, pages unless
``--quantum`` is set; ``oracle_dense`` gives each lane a dense region).
``--n-blocks``, ``--share-prefix``, ``--watermark`` and ``--prefill-chunk``
configure the paged layout as the reference's driver takes them (the pool
size, copy-on-write prefix sharing, admission headroom, chunked prefill);
``--quantum N`` time-slices the dense layout (a lane that has decoded N
tokens while requests queue is snapshot-preempted and later restored).

    PYTHONPATH=src python -m repro_torch.launch.serve_multi --reduced --device cpu \
        --layout oracle_dense --quantum 3 --lanes 2

``--replicas N`` serves through N engine replicas behind the
adapter-locality router (placement by consistent hash of each tenant's λ
digest, spillover, prefix import between replicas); ``--disaggregate``
makes replica 0 a prefill replica that hands each committed prompt to a
decode replica.  Each routed stream is verified like a single engine's.

    PYTHONPATH=src python -m repro_torch.launch.serve_multi --reduced --device cpu --replicas 2
    PYTHONPATH=src python -m repro_torch.launch.serve_multi --reduced --device cpu \
        --replicas 2 --disaggregate --share-prefix --prefill-chunk 16

``--speculate-k K`` turns on speculative decoding: each step drafts K
tokens a lane with the base drafter (slot 0, λ ≡ 0: the same weights and KV
blocks), or with ``--draft-lam-rank R`` each tenant's top-R |λ|, verifies
every lane's window in one batched forward and accepts the longest prefix
that matches greedy, so the streams verify as the plain serve's do.

    PYTHONPATH=src python -m repro_torch.launch.serve_multi --device cpu --reduced \
        --layout paged --block-size 8 --speculate-k 3
    PYTHONPATH=src python -m repro_torch.launch.serve_multi --device cpu --reduced \
        --layout oracle_dense --speculate-k 4 --draft-lam-rank 2

``--cold-slots N`` adds the λ-store's host cold tier: the hot tier may then
be smaller than the tenant count (``--slots``), overflow spills to the host
and admission promotes a tenant back on demand; ``--cold-path PATH`` backs
the tier with an mmap file whose catalog survives a restart (with
``--replicas N``, replica i uses ``PATH.ri``).

    PYTHONPATH=src python -m repro_torch.launch.serve_multi --device cpu --reduced \
        --tenants 6 --slots 3 --cold-slots 8

``--stream`` prints each token as it decodes (``engine.stream()``);
``--metrics-out PATH`` writes the final metrics snapshot (``.prom``/``.txt``:
Prometheus text, else JSON) and ``--trace-out PATH`` the request-span
timeline as Chrome ``trace_event`` JSON (open it in ui.perfetto.dev);
``--no-telemetry`` turns the engine's telemetry off.

    PYTHONPATH=src python -m repro_torch.launch.serve_multi --reduced --device cpu \
        --stream --metrics-out /tmp/serve.prom --trace-out /tmp/serve_trace.json

``--shard-lam`` shards the packed λ tables' slot axis and ``--shard-ba`` the
QR factors' rank dim over a ``torch.distributed`` process group: the one
torchrun describes in the environment, else a world of one started here
(NCCL on ``cuda``, gloo on ``cpu``).  Rank i serves on ``cuda:i``; every rank
runs the whole engine, and rank 0 verifies against the merged-weight
reference built from the gathered factors.

The comparison needs ``--dtype float32`` (the default): in bfloat16 the
merged weights round differently from the fused adapter path.  With a
quantized base (``--base-dtype int8|fp8``) the reference dequantizes the
same ``{q, scale}`` weights, but the engine scales the x·q sum while the
reference multiplies by the dequantized weight, so the logit bar loosens to
5e-2; tokens must still match exactly.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import os
import shutil
import sys
import tempfile
import time

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.configs import get_config, get_reduced
from repro_torch.configs.base import BASE_DTYPES
from repro_torch.core.quantize import resident_base_bytes
from repro_torch.kernels import _build
from repro_torch.obs import write_metrics
from repro_torch.serving import (
    BASE_TENANT,
    EngineConfig,
    MultiTenantEngine,
    Router,
    base_lambda,
    build_replicas,
    random_lambda,
    reference_decode,
)


def _say(msg: str) -> None:
    sys.stdout.write(f"[serve_multi] {msg}\n")


@contextlib.contextmanager
def process_group(device: str):
    """Start the default process group of a sharded serve and yield this
    rank's device: from torchrun's environment (``RANK``, ``WORLD_SIZE``,
    ``MASTER_ADDR``) when it is set, else a world of one through a file
    store in a temporary directory.  The backend is NCCL for ``cuda`` and
    gloo for ``cpu``; rank i takes ``cuda:i``.  The group is destroyed on
    exit."""
    cuda = torch.device(device).type == "cuda"
    backend = "nccl" if cuda else "gloo"
    tmp = None
    if "RANK" in os.environ and "WORLD_SIZE" in os.environ:
        dist.init_process_group(backend, init_method="env://")
    else:
        tmp = tempfile.mkdtemp(prefix="serve_multi_")
        dist.init_process_group(backend, init_method=f"file://{tmp}/store", rank=0,
                                world_size=1)
    try:
        rank, world = dist.get_rank(), dist.get_world_size()
        if cuda:
            if world > torch.cuda.device_count():
                raise RuntimeError(
                    f"a world of {world} ranks needs {world} cards (NCCL puts one rank on a "
                    f"card), {torch.cuda.device_count()} visible")
            torch.cuda.set_device(rank)
            device = f"cuda:{rank}"
        yield device
    finally:
        dist.destroy_process_group()
        if tmp is not None:
            shutil.rmtree(tmp, ignore_errors=True)


def _factor_bytes(params) -> int:
    return sum(leaf[k].numel() * leaf[k].element_size()
               for projs in params["groups"].get("adapters", {}).values()
               for leaf in projs.values() for k in ("A", "B"))


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
    ap.add_argument("--layout", default="auto", choices=["auto", "paged", "oracle_dense"],
                    help="KV-cache layout: 'paged' = block pool + per-lane block tables, "
                    "'oracle_dense' = a dense (max_len) region per lane; 'auto' pages "
                    "unless --quantum is set")
    ap.add_argument("--quantum", type=int, default=None, metavar="STEPS",
                    help="time-slice fairness: snapshot-preempt a lane after this many decode "
                    "steps while requests queue, restored later without re-prefill (dense "
                    "layout only)")
    ap.add_argument("--replicas", type=int, default=1, metavar="N",
                    help="serve through N engine replicas behind the adapter-locality router "
                    "(1 = one plain engine)")
    ap.add_argument("--disaggregate", action="store_true",
                    help="prefill/decode disaggregation (needs --replicas >= 2): replica 0 "
                    "prefills and ships each committed prompt's blocks and first-token logits "
                    "to a decode replica")
    ap.add_argument("--block-size", type=int, default=16)
    ap.add_argument("--n-blocks", type=int, default=None,
                    help="KV pool size (default: dense-equivalent capacity + trash block)")
    ap.add_argument("--share-prefix", action="store_true",
                    help="copy-on-write prefix sharing: requests repeating a prompt prefix "
                    "reuse its resident KV blocks")
    ap.add_argument("--prefill-chunk", type=int, default=None, metavar="TOKENS",
                    help="chunked prefill: long prompts stream in chunks of this many tokens "
                    "between resident lanes' decode steps (a multiple of --block-size; "
                    "default: monolithic admission prefill)")
    ap.add_argument("--speculate-k", type=int, default=0, metavar="K",
                    help="speculative decoding: draft K tokens per lane per step with the free "
                    "slot-0 base drafter (λ ≡ 0 — same weights, same KV blocks), batch-verify "
                    "under the full multi-λ view, accept the longest matching greedy prefix "
                    "(token-identical output, up to K+1 tokens per host round-trip; 0 disables)")
    ap.add_argument("--draft-lam-rank", type=int, default=None, metavar="R",
                    help="drafter variant: keep only the top-R |λ| coefficients per tenant slot "
                    "instead of dropping the adapter entirely (needs --speculate-k >= 1; "
                    "default: λ ≡ 0 base drafter)")
    ap.add_argument("--cold-slots", type=int, default=0,
                    help="host cold-tier capacity (tenants): λ evicted from the hot device "
                    "slots spills to host memory and is promoted back on admission, so the "
                    "tenant count is bounded by host RAM (0 disables)")
    ap.add_argument("--cold-path", default=None, metavar="PATH",
                    help="back the λ cold tier with an mmap file at PATH (its JSON catalog "
                    "beside it) so the spilled tenants survive a restart; needs --cold-slots "
                    "> 0 (with --replicas N, replica i uses PATH.ri)")
    ap.add_argument("--watermark", type=int, default=0,
                    help="free blocks admission keeps in reserve as decode-growth headroom")
    ap.add_argument(
        "--dtype", default="float32",
        help="float32 default: the verification compares fused-multi-λ vs "
        "merged-weight logits, which only makes sense at full precision",
    )
    ap.add_argument("--base-dtype", default="bf16", choices=BASE_DTYPES,
                    help="frozen-base dtype of the adapted projections (int8/fp8: "
                    "per-output-channel quantized, dequantized in the kernels)")
    ap.add_argument("--device", default="cuda", help="'cuda' (default) or 'cpu'")
    ap.add_argument("--shard-lam", action="store_true",
                    help="shard the packed λ tables' slot axis over the process group "
                    "(bitwise the replicated serve)")
    ap.add_argument("--shard-ba", action="store_true",
                    help="shard the QR factors B/A over their rank dim across the process "
                    "group, all-gathered before each contraction (bitwise the replicated serve)")
    ap.add_argument("--stream", action="store_true",
                    help="print tokens as they decode (engine.stream() events) instead of "
                    "per-tenant lines at retirement")
    ap.add_argument("--no-telemetry", action="store_true",
                    help="turn off the engine's metrics and span tracing")
    ap.add_argument("--metrics-out", default=None, metavar="PATH",
                    help="write the final metrics snapshot here (.prom/.txt → Prometheus "
                    "text exposition, anything else → JSON)")
    ap.add_argument("--trace-out", default=None, metavar="PATH",
                    help="write the request-span timeline here as Chrome trace_event JSON "
                    "(open it in ui.perfetto.dev or chrome://tracing)")
    args = ap.parse_args(argv)
    if args.cold_slots and (args.slots - 1) + args.cold_slots < args.tenants - 1:
        ap.error(f"--tenants {args.tenants} exceeds hot+cold capacity "
                 f"({args.slots - 1} + {args.cold_slots}); raise --cold-slots")
    if args.no_telemetry and (args.metrics_out or args.trace_out):
        ap.error("--metrics-out/--trace-out need telemetry; drop --no-telemetry")
    if args.quantum is not None and args.layout == "paged":
        ap.error("--quantum needs the dense oracle layout; drop --layout paged")
    if args.replicas > 1 or args.disaggregate:
        if args.disaggregate and args.replicas < 2:
            ap.error("--disaggregate needs --replicas >= 2 (one to prefill, one to decode)")
        if args.stream or args.quantum is not None:
            ap.error("--replicas serves via the router (no --stream/--quantum)")
        if args.shard_lam or args.shard_ba:
            ap.error("--replicas serves unsharded engines (no --shard-lam/--shard-ba)")
        if args.trace_out:
            ap.error("--replicas writes the router's metrics, not a trace (no --trace-out)")
        return serve_replicated(args, args.device)
    if not (args.shard_lam or args.shard_ba):
        return serve(args, args.device)
    with process_group(args.device) as device:
        return serve(args, device)


def _config(args):
    """The model config and the EngineConfig the arguments describe."""
    cfg = (get_reduced if args.reduced else get_config)(args.arch).replace(dtype=args.dtype)
    # the store must hold every tenant this launcher submits for at once: one
    # hot slot each without a cold tier; with one the hot tier may be small,
    # overflow spills and admission promotes back (checked in main)
    n_slots = args.slots
    if not args.cold_slots:
        n_slots = max(args.slots, args.tenants + 1)
        if n_slots != args.slots:
            _say(f"raising --slots {args.slots} → {n_slots} to hold all tenants")
    econf = EngineConfig(
        layout=args.layout, n_lanes=args.lanes, n_slots=n_slots, max_len=args.max_len,
        collect_logits=True, seed=args.seed, block_size=args.block_size,
        n_blocks=args.n_blocks, share_prefix=args.share_prefix, watermark=args.watermark,
        prefill_chunk=args.prefill_chunk, quantum=args.quantum, base_dtype=args.base_dtype,
        speculate_k=args.speculate_k, draft_lam_rank=args.draft_lam_rank,
        shard_lam=args.shard_lam, shard_ba=args.shard_ba, telemetry=not args.no_telemetry,
        cold_slots=args.cold_slots, cold_path=args.cold_path,
    )
    return cfg, econf


def _tenant_lams(args, device, params):
    """The driver's tenants: the base model and ``--tenants - 1`` random λ."""
    gen = torch.Generator(device=device)
    lams = {BASE_TENANT: base_lambda(params)}
    for i in range(1, args.tenants):
        lams[f"tenant{i}"] = random_lambda(gen.manual_seed(args.seed + 1000 + i), params,
                                           args.lam_scale)
    return lams


def _verify(cfg, params, lams, done, args, tol):
    """Each finished request's tokens and logits against the merged-weight
    reference; raises SystemExit on a mismatch, returns the worst |Δ|."""
    worst = 0.0
    for uid in sorted(done):
        req = done[uid]
        ref_toks, ref_logits = reference_decode(
            cfg, params, lams[req.tenant], req.prompt, args.gen_len, args.max_len
        )
        err = float(np.abs(np.stack(req.logits) - ref_logits).max())
        worst = max(worst, err)
        ok = req.tokens == ref_toks and err < tol
        _say(f"verify {req.tenant}: tokens {'OK' if ok else 'MISMATCH'} "
             f"max|Δlogits|={err:.2e} {req.tokens[:12]}")
        if not ok:
            raise SystemExit(f"tenant {req.tenant} diverged from merged-weight reference")
    return worst


def serve(args, device):
    """Build the engine on ``device``, serve one request per tenant and
    verify every stream on rank 0 (rank 0 alone when unsharded)."""
    cfg, econf = _config(args)
    engine = MultiTenantEngine(cfg, econf, device=device)
    lead = not dist.is_initialized() or dist.get_rank() == 0
    pool = (f"pool={engine.allocator.capacity} blocks of {args.block_size}" if engine.paged
            else f"dense lanes of {args.max_len} positions quantum={args.quantum}")
    _say(f"arch={cfg.name} layout={engine.layout} device={engine.device} {pool} "
         f"share_prefix={args.share_prefix} watermark={args.watermark} "
         f"prefill_chunk={args.prefill_chunk}")
    if engine.base_dtype != "bf16":
        qb, fb = resident_base_bytes(engine.params)
        _say(f"quantized base ({engine.base_dtype}): adapted projections resident at "
             f"{qb} B vs {fb} B bf16-equivalent ({fb / max(qb, 1):.2f}x)")
    store = engine.lam_store
    if args.shard_lam:
        _say(f"λ tables sharded over {store.world} rank(s): {store.n_slots} slots, "
             f"{store.table_bytes(per_rank=True)} B/rank (replicated would be "
             f"{store.table_bytes()} B)")
    if args.cold_slots:
        _say(f"λ-store tiers: hot={store.hot_capacity} slots ({store.table_bytes()} B on "
             f"{engine.device.type}) cold={store.cold_slots} tenants "
             f"(≤{store.bytes_per_tenant() * store.cold_slots} B host)")
    if args.shard_ba:
        full = _factor_bytes(engine.gathered_params())
        _say(f"QR factors B/A rank-sharded over {dist.get_world_size()} rank(s): "
             f"{_factor_bytes(engine.params)} B/rank (replicated would be {full} B)")

    lams = _tenant_lams(args, engine.device, engine.params)
    for name, lam in lams.items():
        if name != BASE_TENANT:
            engine.add_tenant(name, lam)

    rng = np.random.default_rng(args.seed)
    reqs = {}
    for tenant in lams:
        prompt = rng.integers(2, cfg.vocab_size, size=args.prompt_len).astype(np.int32)
        r = engine.submit(tenant, prompt, args.gen_len)
        reqs[r.uid] = r

    if engine.device.type == "cuda":
        _build.build()  # compile the kernels now, not inside the timed serve
    t0 = time.perf_counter()
    if args.stream:
        # each event prints when its shared decode step finishes, not when
        # its request retires
        for ev in engine.stream():
            if lead:
                _say(f"stream step={engine.steps:<4d} {ev.tenant:<10s} lane={ev.lane} "
                     f"tok[{ev.index}]={ev.token}" + ("  <done>" if ev.done else ""))
        done = reqs  # stream() drained the queue
    else:
        done = engine.run()
    if engine.device.type == "cuda":
        torch.cuda.synchronize(engine.device)
    dt = time.perf_counter() - t0
    pool = (f"pool peak={engine.allocator.peak_in_use}/{engine.allocator.capacity} blocks, "
            if engine.paged else "")
    _say(f"{engine.decoded_tokens} tokens in {dt * 1e3:.1f} ms "
         f"({engine.decoded_tokens / dt:.0f} tok/s) over {engine.steps} shared decode "
         f"steps, {pool}preemptions={engine.preemptions}, cow_forks={engine.cow_forks}, "
         f"chunked admissions={engine.chunked_admissions} in "
         f"{engine.chunk_dispatches} chunks, KV cache {engine.kv_cache_bytes()} bytes")
    if args.quantum is not None:
        _say(f"quantum={args.quantum}: {engine.slice_preemptions} snapshot time-slices")
    if args.speculate_k:
        drafter = (f" draft_lam_rank={args.draft_lam_rank}" if args.draft_lam_rank
                   else " (base drafter)")
        _say(f"speculative k={args.speculate_k}{drafter}: {engine.drafted_tokens} drafted, "
             f"{engine.accepted_drafts} accepted (acceptance={engine.acceptance_rate:.0%}) over "
             f"{engine.spec_steps} draft+verify steps")
    if args.cold_slots:
        _say(f"λ churn: {store.spills} spills, {store.promotes} promotes, "
             f"{store.cold_registers} cold registers, {engine.deferred_promotions} deferred "
             f"admissions, cold_bytes={store.cold_bytes()}")
    if engine.prefix_cache is not None:
        pc = engine.prefix_cache
        _say(f"prefix hits={pc.hits} misses={pc.misses} cached={pc.cached_blocks} blocks")

    if not args.no_telemetry and lead:
        tel = engine.telemetry
        _say(f"latency: ttft p50≤{tel.ttft.quantile(0.5):g}ms p95≤{tel.ttft.quantile(0.95):g}ms"
             f" · tbt mean={tel.tbt.mean:.2f}ms p95≤{tel.tbt.quantile(0.95):g}ms · e2e "
             f"p95≤{tel.e2e.quantile(0.95):g}ms (bucket upper bounds, host clock)")
        if args.metrics_out:
            write_metrics(args.metrics_out, engine.metrics())
            _say(f"metrics snapshot → {args.metrics_out}")
        if args.trace_out:
            tel.write_trace(args.trace_out)
            _say(f"request-span trace → {args.trace_out} (open in ui.perfetto.dev)")

    params = engine.gathered_params()  # a collective under --shard-ba: every rank
    if not lead:
        return done
    tol = 1e-3 if engine.base_dtype == "bf16" else 5e-2
    worst = _verify(cfg, params, lams, done, args, tol)
    _say(f"all {len(done)} tenants match merged-weight refs (worst |Δlogits|={worst:.2e})")
    return done


def serve_replicated(args, device):
    """``--replicas N``: one engine per replica behind the adapter-locality
    router, the same tenants, prompts and verification as one engine."""
    cfg, econf = _config(args)
    overrides = None
    if econf.cold_path:
        # one mmap file per replica: the cold catalog is per-store state
        overrides = lambda i, c: dataclasses.replace(c, cold_path=f"{c.cold_path}.r{i}")
    replicas = build_replicas(cfg, econf, args.replicas, device=device,
                              config_overrides=overrides)
    router = Router(replicas, disaggregate=args.disaggregate,
                    telemetry=not args.no_telemetry)
    params = replicas[0].engine.params
    roles = " ".join(f"{r.name}:{r.role}" for r in router.replicas)
    _say(f"arch={cfg.name} layout={replicas[0].engine.layout} device={replicas[0].engine.device} "
         f"replicas={args.replicas} ({roles}) disaggregate={args.disaggregate}")
    lams = _tenant_lams(args, replicas[0].engine.device, params)
    router.add_tenants(lams)
    rng = np.random.default_rng(args.seed)
    routed = {}
    for tenant in lams:
        prompt = rng.integers(2, cfg.vocab_size, size=args.prompt_len).astype(np.int32)
        r = router.submit(tenant, prompt, args.gen_len)
        routed[r.uid] = r

    if replicas[0].engine.device.type == "cuda":
        _build.build()
    t0 = time.perf_counter()
    done = router.run()
    if replicas[0].engine.device.type == "cuda":
        torch.cuda.synchronize(replicas[0].engine.device)
    dt = time.perf_counter() - t0
    if set(done) != set(routed):
        raise SystemExit(f"router lost requests: {sorted(set(routed) - set(done))}")
    n_tok = sum(len(r.tokens) for r in done.values())
    stats = router.transport.stats()
    _say(f"{n_tok} tokens in {dt * 1e3:.1f} ms ({n_tok / dt:.0f} tok/s) across "
         f"{args.replicas} replicas")
    _say(f"placement hit rate {router.placement_hit_rate():.0%}; transport "
         f"{stats['total_bytes']} bytes {stats}")
    for rep in router.replicas:
        eng = rep.engine
        line = (f"  {rep.name} ({rep.role}): {eng.decoded_tokens} tokens, {eng.steps} steps, "
                f"slice preemptions {eng.slice_preemptions}")
        if eng.prefix_cache is not None:
            line += f", prefix hits={eng.prefix_cache.hits} misses={eng.prefix_cache.misses}"
        _say(line)
    if args.metrics_out:
        write_metrics(args.metrics_out, router.metrics())
        _say(f"router metrics snapshot → {args.metrics_out}")
    tol = 1e-3 if replicas[0].engine.base_dtype == "bf16" else 5e-2
    worst = _verify(cfg, params, lams, {u: r.engine_req for u, r in done.items()}, args, tol)
    _say(f"all {len(done)} routed tenants match merged-weight refs (worst "
         f"|Δlogits|={worst:.2e})")
    return done


if __name__ == "__main__":
    main()
