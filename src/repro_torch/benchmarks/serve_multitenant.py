"""Multi-tenant serving benchmark (port of ``benchmarks/serve_multitenant.py``:
the same row names and scales, timed on the port's engine and kernels).

The reference's eleven sub-benches, in its order (:data:`BENCHES`):
the hierarchical λ-store's adapter churn (register, promote and evict rates
behind a small hot tier); the multi-λ BGMV against the one-λ matmul; shared-decode throughput at
increasing tenant heterogeneity; the recurrent families' decode path (an
xlstm batch, a jamba hybrid batch); chunked-prefill tail latency; speculative
decoding at draft depth k ∈ {0, 2, 4}; telemetry on against off; the
device time of one paged decode step's parts (the K/V gather, the paged
attend, the λ-BGMV on a float and an int8 base); the paged-against-dense
KV footprint; copy-on-write prefix sharing; and the quantized base.

``REPRO_BENCH_SCALE=paper`` takes the full configs and the reference's
paper shapes; any other scale the reduced configs and its small shapes, as
the reference does.  The one exception: jamba-1.5-large-398b's full config
needs four cards, so its paper-scale case raises (ROADMAP item 14c).  Engine timings are host wall clock around work that
ends in a host sync (the engine reads every step's logits), a
``torch.cuda.synchronize`` included on a card; kernel timings are device
times on a card (CUDA-graph replay, :func:`common.graph_ms`).  On the CPU
the kernel wrappers run their plain versions and every time is a CPU time.

The reference asserts speed orderings measured with JAX on a TPU.  No TPU
speed target carries over to this card, so each of them is a reading here:
a ``held=<bool>`` field (``held_stall``/``held_step`` where a row carries
two) beside both sides' numbers in the row's detail.  Its correctness
assertions stay hard: a spilled and promoted λ row bitwise the registered
one, the paged KV footprint below the dense one, the
shared prefix's pool peak at most one prefix plus the lanes' tails and the
unshared peak at least a prefix a lane; and every kernel row's error
against its plain version within ``kernel_bench.TOL`` (``run.py`` exits 1
otherwise).
"""
from __future__ import annotations

import time

import numpy as np
import torch

from repro_torch.benchmarks import common
from repro_torch.benchmarks.common import _sync, emit, scale
from repro_torch.benchmarks.kernel_bench import TOL
from repro_torch.configs import get_config, get_reduced
from repro_torch.core.quantize import quantize_weight, resident_base_bytes
from repro_torch.device import resolve_device
from repro_torch.kernels import ops, ref
from repro_torch.serving import (
    BASE_TENANT,
    EngineConfig,
    LamStore,
    MultiTenantEngine,
    random_lambda,
)


def _paper() -> bool:
    return scale() == "paper"


def _cfg(arch: str):
    return (get_config if _paper() else get_reduced)(arch)


def _lam(eng, seed: int, lam_scale: float = 0.1):
    gen = torch.Generator(device=eng.device).manual_seed(seed)
    return random_lambda(gen, eng.params, lam_scale)


def _drain(eng) -> float:
    """Seconds to run ``eng`` to empty, the device included."""
    t0 = time.perf_counter()
    eng.run()
    _sync(eng.device)
    return time.perf_counter() - t0


def _us(fn, device) -> float:
    """µs of one call: on a card its device time (calls captured in a CUDA
    graph and replayed, warm L2), on the CPU its host time."""
    if device.type == "cuda":
        return common.graph_ms(fn) * 1e3
    return common.timed(fn, n=10, device=device)[1]


def _drive_engine(device, arch, *, n_tenants, lanes, prompt_len, gen, max_len, **config_kw):
    """The shared harness: an engine with ``n_tenants`` distinct-λ tenants
    (tenant 0 the base), one request a lane round-robin over them, drained.
    Returns (engine, seconds)."""
    cfg = _cfg(arch)
    eng = MultiTenantEngine(cfg, EngineConfig(n_lanes=lanes, n_slots=max(8, n_tenants + 1),
                                              max_len=max_len, **config_kw), device=device)
    tenants = [BASE_TENANT]
    for i in range(1, n_tenants):
        eng.add_tenant(f"t{i}", _lam(eng, i))
        tenants.append(f"t{i}")
    rng = np.random.default_rng(0)
    for lane in range(lanes):
        prompt = rng.integers(2, cfg.vocab_size, size=prompt_len).astype(np.int32)
        eng.submit(tenants[lane % len(tenants)], prompt, gen)
    return eng, _drain(eng)


def bench_adapter_churn(device):
    """Adapter churn through the hierarchical λ-store: register, promote and
    evict rates with a small hot tier (64 device slots) under a tenant
    population that only the host cold tier holds — the regime of the
    λ-only pitch (at the paper scale 10⁴ tenants of 30,720 B each).  Every
    register, hot-swap, promote and evict is one slot write, so each rate is
    O(one λ row) whatever ``n_slots``; a spill → promote round trip is held
    bitwise inline.  The times are host wall clock, the card synced at the
    end of each timed loop: readings, not limits."""
    n_tenants = 10_000 if _paper() else 2_000
    n_layers, cap = (12, 160) if _paper() else (4, 32)
    projs = ("wq", "wk", "wv", "wo")
    store = LamStore({("attn", p): (n_layers, cap) for p in projs}, n_slots=64,
                     cold_slots=n_tenants, device=device)
    rng = np.random.default_rng(0)

    def lam(i):
        r = np.random.default_rng(i)
        return {"attn": {p: r.standard_normal((n_layers, cap), np.float32) * 0.1
                         for p in projs}}

    trees = [lam(i) for i in range(n_tenants)]  # synthesis outside the timer
    t0 = time.perf_counter()
    for i, tree in enumerate(trees):
        store.register(f"t{i}", tree)
    _sync(device)
    t_reg = (time.perf_counter() - t0) / n_tenants * 1e6
    del trees
    emit("serve_multitenant:churn:register", t_reg,
         f"tenants={n_tenants};hot={store.hot_capacity};spills={store.spills};"
         f"bytes_per_tenant={store.bytes_per_tenant()};table_bytes={store.table_bytes()};"
         f"cold_bytes={store.cold_bytes()};per_s={1e6 / t_reg:.0f}")

    # spill → promote round-trips λ bitwise (the cold tier is a cache of the
    # truth, not an approximation of it)
    probe = int(rng.integers(0, n_tenants))
    name = f"t{probe}"
    if store.is_hot(name):
        store.spill(name)
    assert store.is_cold(name)
    slot = store.promote(name)
    want = lam(probe)["attn"]
    for (_, p), tab in store.tables.items():
        np.testing.assert_array_equal(
            tab[slot].cpu().numpy(), want[p],
            err_msg=f"spill→promote λ row not bit-identical for {p}")

    n_ops = 200
    picks = rng.choice(n_tenants, size=n_ops, replace=False)
    t0 = time.perf_counter()
    for i in picks:
        store.promote(f"t{i}")  # a hot tenant's promote is a lookup
    _sync(device)
    t_promote = (time.perf_counter() - t0) / n_ops * 1e6
    emit("serve_multitenant:churn:promote", t_promote,
         f"ops={n_ops};promotes={store.promotes};spills={store.spills};"
         f"per_s={1e6 / t_promote:.0f}")

    t0 = time.perf_counter()
    for i in picks:
        store.evict(f"t{i}")
    _sync(device)
    t_evict = (time.perf_counter() - t0) / n_ops * 1e6
    emit("serve_multitenant:churn:evict", t_evict,
         f"ops={n_ops};resident={len(store)};slot_writes={store.slot_writes};"
         f"per_s={1e6 / t_evict:.0f}")


def bench_bgmv_overhead(device):
    """The multi-λ BGMV (#1) against the one-λ matmul (#3) at one shape,
    float32 x, the QR factors in bf16 as ``init_adapters`` makes them."""
    M, K, N, r, n_slots = 256, 768, 768, 160, 64
    gen = torch.Generator(device=device).manual_seed(0)
    randn = lambda *s: torch.randn(s, generator=gen, device=device)
    x, W = randn(M, K) * 0.3, randn(K, N) * 0.05
    B, A = (randn(K, r) * 0.05).bfloat16(), (randn(r, N) * 0.05).bfloat16()
    tab = randn(n_slots, r)
    seg = torch.randint(0, n_slots, (M,), generator=gen, device=device, dtype=torch.int32)
    single = lambda: ops.qrlora_matmul(x, W, B, A, tab[1])
    multi = lambda: ops.qrlora_bgmv(x, W, B, A, tab, seg)
    name = "serve_multitenant:bgmv_vs_single"
    err = common.record_error(name, multi(), ref.qrlora_bgmv_ref(x, W, B, A, tab, seg),
                              TOL["qrlora_bgmv"][torch.float32])
    common.record_error(f"{name}:single", single(), ref.qrlora_matmul_ref(x, W, B, A, tab[1]),
                        TOL["qrlora_matmul"][torch.float32])
    t_single, t_multi = _us(single, device), _us(multi, device)
    emit(name, t_multi, f"single_us={t_single:.1f};overhead={t_multi / max(t_single, 1e-9):.2f}x;"
                        f"slots={n_slots};{err}")


def bench_engine_throughput(device):
    lanes, gen, prompt_len, max_len = (16, 64, 64, 256) if _paper() else (8, 16, 16, 64)
    for n_tenants in (1, 4, lanes):
        eng, dt = _drive_engine(device, "smollm-135m", n_tenants=n_tenants, lanes=lanes,
                                prompt_len=prompt_len, gen=gen, max_len=max_len)
        emit(f"serve_multitenant:engine:tenants={n_tenants}", dt / max(eng.steps, 1) * 1e6,
             f"tok_s={eng.decoded_tokens / dt:.0f};lanes={lanes};"
             f"bytes_per_tenant={eng.lam_store.bytes_per_tenant()}")


def bench_recurrent_families(device):
    """LaneState serving throughput of the families without (or beside) a
    KV cache: an xlstm batch (recurrent lanes only, O(1) state a lane) and a
    jamba hybrid batch (paged attention KV beside dense Mamba state, one
    ``step()``).  ``state_bytes`` is the whole decode cache.  At the paper
    scale xlstm-125m runs at its full config; jamba-1.5-large-398b's needs
    four cards and raises."""
    cases = (
        ("xlstm-125m", "ssm", {}),
        ("jamba-1.5-large-398b", "hybrid", dict(layout="paged", block_size=8)),
    )
    lanes, gen, prompt_len, max_len = (8, 32, 32, 128) if _paper() else (4, 8, 9, 32)
    for arch, fam, kw in cases:
        if _paper() and fam == "hybrid":
            raise NotImplementedError(
                f"{arch} at its full config holds ≈ 87 GB of bf16 weights a group of 8 "
                "layers, more than one card: its serve needs four (ROADMAP Queue 1 item 14c)")
        eng, dt = _drive_engine(device, arch, n_tenants=lanes, lanes=lanes,
                                prompt_len=prompt_len, gen=gen, max_len=max_len, **kw)
        extra = ""
        if eng.paged:
            extra = f";pool_peak={eng.allocator.peak_in_use}/{eng.allocator.capacity}"
        emit(f"serve_multitenant:engine:family={fam}", dt / max(eng.steps, 1) * 1e6,
             f"tok_s={eng.decoded_tokens / dt:.0f};lanes={lanes};"
             f"state_bytes={eng.kv_cache_bytes()}{extra}")


def bench_chunked_prefill(device):
    """Tail latency of resident decoders while long prompts admit,
    monolithic against chunked: the worst step after the long prompts land
    (the stall a resident lane eats), min over four interleaved warm drains,
    with the mean step time beside it."""
    cfg = _cfg("smollm-135m")
    if _paper():
        lanes, bs, chunk, max_len = 4, 16, 64, 512
        short, long_p, gen_s, gen_l = 32, 384, 96, 32
    else:
        lanes, bs, chunk, max_len = 2, 16, 32, 128
        short, long_p, gen_s, gen_l = 16, 96, 24, 8
    rng = np.random.default_rng(0)
    shorts = [rng.integers(2, cfg.vocab_size, size=short).astype(np.int32) for _ in range(lanes)]
    longs = [rng.integers(2, cfg.vocab_size, size=long_p).astype(np.int32) for _ in range(lanes)]

    def drain(eng) -> float:
        for p in shorts:
            eng.submit(BASE_TENANT, p, gen_s)
        for _ in range(4):
            eng.step()  # residents decoding before the long prompts land
        for p in longs:
            eng.submit(BASE_TENANT, p, gen_l)
        stall = 0.0
        while eng.scheduler.has_work:
            t0 = time.perf_counter()
            eng.step()
            _sync(device)
            stall = max(stall, time.perf_counter() - t0)
        return stall

    engines = {}
    for mode, pc in (("off", None), ("on", chunk)):
        eng = MultiTenantEngine(cfg, EngineConfig(layout="paged", n_lanes=lanes, n_slots=8,
                                                  max_len=max_len, block_size=bs,
                                                  prefill_chunk=pc), device=device)
        drain(eng)  # warm
        engines[mode] = eng
    per_step = {m: float("inf") for m in engines}
    stall = {m: float("inf") for m in engines}
    for _ in range(4):
        for mode, eng in engines.items():
            s0 = eng.steps
            t0 = time.perf_counter()
            worst = drain(eng)
            per_step[mode] = min(per_step[mode], (time.perf_counter() - t0) / max(eng.steps - s0, 1))
            stall[mode] = min(stall[mode], worst)
    held_stall = stall["on"] < stall["off"]
    held_step = per_step["on"] <= 1.15 * per_step["off"]
    for mode, eng in engines.items():
        tel = eng.telemetry
        extra = ""
        if mode == "on":
            extra = (f";held_stall={held_stall};held_step={held_step};"
                     f"off_stall_us={stall['off'] * 1e6:.1f};off_step_us={per_step['off'] * 1e6:.1f}")
        emit(f"serve_multitenant:chunked_prefill:{mode}", stall[mode] * 1e6,
             f"step_us={per_step[mode] * 1e6:.1f};tbt_p95_ms={tel.tbt.quantile(0.95):g};"
             f"ttft_p95_ms={tel.ttft.quantile(0.95):g};chunk={eng.config.prefill_chunk};"
             f"long_prompt={long_p};lanes={lanes}{extra}")


def bench_speculative(device):
    """Per-token latency at draft depth k ∈ {0, 2, 4} on base-tenant
    traffic, where the drafter is the target model in exact arithmetic
    (acceptance 1 at the small scales; in bf16 at full depth the drafter,
    which skips the adapter term, and the verify round apart at near-ties):
    a warm drain, then the best of three."""
    cfg = _cfg("smollm-135m")
    lanes, gen, prompt_len, max_len = (8, 64, 32, 256) if _paper() else (4, 16, 12, 64)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(2, cfg.vocab_size, size=prompt_len).astype(np.int32)
               for _ in range(lanes)]
    per_tok = {}
    for k in (0, 2, 4):
        eng = MultiTenantEngine(cfg, EngineConfig(layout="paged", n_lanes=lanes, n_slots=8,
                                                  max_len=max_len, speculate_k=k), device=device)
        best = float("inf")
        for rep in range(4):  # a warm drain, then the best of three
            for p in prompts:
                eng.submit(BASE_TENANT, p, gen)
            dt = _drain(eng)
            if rep:
                best = min(best, dt)
        tokens = lanes * gen
        per_tok[k] = best / tokens * 1e6
        emit(f"serve_multitenant:speculative:k={k}", per_tok[k],
             f"tok_s={tokens / best:.0f};lanes={lanes};acceptance={eng.acceptance_rate:.2f};"
             f"drafted={eng.drafted_tokens}")
    emit("serve_multitenant:speculative:saving", 0.0,
         f"k0_us_tok={per_tok[0]:.0f};k4_us_tok={per_tok[4]:.0f};"
         f"speedup={per_tok[0] / max(per_tok[4], 1e-9):.2f}x;held={per_tok[4] < per_tok[0]}")


def bench_telemetry_overhead(device):
    """Telemetry on against off on the ``tenants=4`` throughput workload."""
    lanes, gen, prompt_len, max_len = (16, 64, 64, 256) if _paper() else (8, 16, 16, 64)
    wall = {}
    for mode, on in (("off", False), ("on", True)):
        eng, dt = _drive_engine(device, "smollm-135m", n_tenants=4, lanes=lanes,
                                prompt_len=prompt_len, gen=gen, max_len=max_len, telemetry=on)
        wall[mode] = dt
        extra = ""
        if on:
            held = wall["on"] <= 1.5 * wall["off"]
            extra = (f";metrics={len(eng.metrics())};trace_events="
                     f"{len(eng.telemetry.tracer.events)};held={held};off_s={wall['off']:.4f};"
                     f"on_s={wall['on']:.4f}")
        emit(f"serve_multitenant:engine:telemetry={mode}", dt / max(eng.steps, 1) * 1e6,
             f"tok_s={eng.decoded_tokens / dt:.0f};lanes={lanes}{extra}")


def bench_decode_phases(device):
    """Device time of one paged decode step's parts, each timed alone: the
    block-table K/V gather (plain torch: the attend kernel reads through the
    table itself), the paged attend (#2), and the λ-BGMV at one row a lane
    on a float base (#1) and an int8 one (#5); each kernel held against its
    plain version."""
    if _paper():
        lanes, bs, max_blocks, H, KV, dh = 8, 16, 64, 32, 8, 128
        K, N, r, n_slots = 768, 768, 160, 64
    else:
        lanes, bs, max_blocks, H, KV, dh = 4, 16, 32, 8, 4, 64
        K, N, r, n_slots = 256, 256, 32, 16
    n_blocks = 1 + lanes * max_blocks
    gen = torch.Generator(device=device).manual_seed(0)
    randn = lambda *s: torch.randn(s, generator=gen, device=device)
    q = randn(lanes, H, dh)
    k_pool, v_pool = randn(n_blocks, bs, KV, dh), randn(n_blocks, bs, KV, dh)
    block_tbl = torch.randint(1, n_blocks, (lanes, max_blocks), generator=gen, device=device,
                              dtype=torch.int32)
    lengths = torch.full((lanes,), bs * max_blocks // 2, dtype=torch.int32, device=device)
    x, W = randn(lanes, K) * 0.3, randn(K, N) * 0.05
    Bm, A = (randn(K, r) * 0.05).bfloat16(), (randn(r, N) * 0.05).bfloat16()
    tab = randn(n_slots, r)
    seg = torch.arange(lanes, dtype=torch.int32, device=device) % n_slots
    qW = quantize_weight(W, "int8")
    wq, ws = qW["q"], qW["scale"]
    ids = block_tbl.long()
    fns = {
        "kv_gather": lambda: (k_pool[ids].reshape(lanes, max_blocks * bs, KV, dh),
                              v_pool[ids].reshape(lanes, max_blocks * bs, KV, dh)),
        "attend": lambda: ops.paged_decode_attention(q, k_pool, v_pool, block_tbl, lengths),
        "bgmv": lambda: ops.qrlora_bgmv(x, W, Bm, A, tab, seg),
        "dequant": lambda: ops.qrlora_bgmv_quant(x, wq, ws, Bm, A, tab, seg),
    }
    plain = {"attend": (lambda: ref.paged_decode_attention_ref(q, k_pool, v_pool, block_tbl,
                                                               lengths), "paged_decode_attention"),
             "bgmv": (lambda: ref.qrlora_bgmv_ref(x, W, Bm, A, tab, seg), "qrlora_bgmv"),
             "dequant": (lambda: ref.qrlora_bgmv_quant_ref(x, wq, ws, Bm, A, tab, seg),
                         "qrlora_bgmv_quant")}
    times = {name: _us(fn, device) for name, fn in fns.items()}
    for name, us in times.items():
        detail = {
            "kv_gather": f"pool_blocks={n_blocks};table={lanes}x{max_blocks};bs={bs}",
            "attend": f"reads_through_table;gather_share={times['kv_gather'] / max(us, 1e-9):.2f};"
                      f"heads={H}/{KV};dh={dh}",
            "bgmv": f"rows={lanes};r={r};slots={n_slots}",
            "dequant": f"vs_bgmv={us / max(times['bgmv'], 1e-9):.2f}x;int8_base;rows={lanes};r={r}",
        }[name]
        row = f"serve_multitenant:phase:{name}"
        if name in plain:
            want, kind = plain[name]
            detail += ";" + common.record_error(row, fns[name](), want(), TOL[kind][torch.float32])
        emit(row, us, detail)


def bench_paged_vs_dense(device):
    """Dense against paged KV on the same mixed-prompt-length workload at
    ``max_len=512``: the dense layout reserves every lane's whole region,
    the paged pool is sized to the traffic."""
    cfg = _cfg("smollm-135m")
    lanes, max_len, bs = (8, 512, 16) if _paper() else (4, 512, 16)
    prompt_lens = [8, 16, 24, 12][:lanes] * (lanes // 4 or 1)
    gen = 12
    rng = np.random.default_rng(0)
    prompts = [rng.integers(2, cfg.vocab_size, size=p).astype(np.int32) for p in prompt_lens]
    hbm = {}
    per_req_blocks = -(-(max(prompt_lens) + gen) // bs)
    for mode, kw in (("dense", dict(layout="oracle_dense")),
                     # the pool holds every lane's largest request and the trash block
                     ("paged", dict(layout="paged", block_size=bs,
                                    n_blocks=1 + lanes * per_req_blocks))):
        eng = MultiTenantEngine(cfg, EngineConfig(n_lanes=lanes, n_slots=8, max_len=max_len,
                                                  **kw), device=device)
        eng.add_tenant("t1", _lam(eng, 1))
        tenants = [BASE_TENANT, "t1"]
        for i, prompt in enumerate(prompts):
            eng.submit(tenants[i % 2], prompt, gen)
        dt = _drain(eng)
        hbm[mode] = eng.kv_cache_bytes()
        # host time by step phase (telemetry): launching, waiting, bookkeeping
        phases = ",".join(f"{lbl['phase']}:{h.mean:.2f}"
                          for lbl, h in eng.telemetry.step_phase.series() if h.count)
        emit(f"serve_multitenant:kv_cache:{mode}", dt / max(eng.steps, 1) * 1e6,
             f"hbm_bytes={hbm[mode]};tok_s={eng.decoded_tokens / dt:.0f};lanes={lanes};"
             f"max_len={max_len};tokens_per_mb={eng.decoded_tokens / (hbm[mode] / 2**20):.1f};"
             f"host_phase_ms={phases}")
    if not hbm["paged"] < hbm["dense"]:
        raise AssertionError(f"paged KV footprint {hbm['paged']} not below dense {hbm['dense']} "
                             f"at max_len={max_len} with short prompts")
    emit("serve_multitenant:kv_cache:paged_saving", 0.0,
         f"dense_bytes={hbm['dense']};paged_bytes={hbm['paged']};"
         f"ratio={hbm['dense'] / hbm['paged']:.2f}x")


def bench_prefix_sharing(device):
    """N tenants of one λ family on one common prompt, unshared against
    copy-on-write shared: peak blocks out of the free list (hard bounds)
    and step time (a reading), min of four interleaved warm drains."""
    cfg = _cfg("smollm-135m")
    lanes, bs, P, gen, max_len = (8, 16, 128, 32, 256) if _paper() else (4, 8, 64, 8, 96)
    rng = np.random.default_rng(0)
    prompt = rng.integers(2, cfg.vocab_size, size=P).astype(np.int32)
    engines = {}
    for mode, share in (("unshared", False), ("shared", True)):
        eng = MultiTenantEngine(cfg, EngineConfig(
            layout="paged", n_lanes=lanes, n_slots=max(8, lanes + 1), max_len=max_len,
            block_size=bs, share_prefix=share), device=device)
        fam = _lam(eng, 1)
        for i in range(lanes):
            eng.add_tenant(f"fam{i}", fam)  # one λ checkpoint, many tenants
            eng.submit(f"fam{i}", prompt, gen)
        _drain(eng)  # warm, and seeds the prefix cache
        engines[mode] = eng
    per_step = {m: float("inf") for m in engines}
    for _ in range(4):
        for mode, eng in engines.items():
            for i in range(lanes):
                eng.submit(f"fam{i}", prompt, gen)
            s0 = eng.steps
            per_step[mode] = min(per_step[mode], _drain(eng) / max(eng.steps - s0, 1))
    peaks = {}
    for mode, eng in engines.items():
        per_step[mode] *= 1e6
        peaks[mode] = eng.allocator.peak_in_use
        hits = eng.prefix_cache.hits if eng.prefix_cache is not None else 0
        emit(f"serve_multitenant:prefix_share:{mode}", per_step[mode],
             f"peak_blocks={peaks[mode]};prefix_hits={hits};lanes={lanes};prompt={P};"
             f"block_size={bs};block_bytes={eng.kv_cache_bytes() // eng.allocator.n_blocks}")
    prefix_blocks = P // bs
    want = prefix_blocks + lanes * -(-((P % bs) + gen) // bs)
    if peaks["shared"] > want:
        raise AssertionError(f"shared-prefix peak {peaks['shared']} blocks exceeds 1x prefix + "
                             f"{lanes} private tails = {want}")
    if peaks["unshared"] < lanes * prefix_blocks:
        raise AssertionError(f"unshared peak {peaks['unshared']} below {lanes}x prefix — the "
                             "workload no longer exercises duplication")
    emit("serve_multitenant:prefix_share:saving", 0.0,
         f"unshared_peak={peaks['unshared']};shared_peak={peaks['shared']};"
         f"ratio={peaks['unshared'] / max(peaks['shared'], 1):.2f}x;"
         f"held={per_step['shared'] <= 1.05 * per_step['unshared']};"
         f"shared_us={per_step['shared']:.1f};unshared_us={per_step['unshared']:.1f}")


def bench_quantized(device):
    """One paged engine per base dtype (bf16, int8) on the same weights,
    prompts and λ, every projection of every layer adapted (so quantized)
    and the model widened until the base matmuls dominate the step: a warm
    drain, then the best of three."""
    if _paper():
        dm, dff, heads, kv = 768, 2304, 8, 4
        lanes, gen, prompt_len, max_len = 8, 32, 16, 128
    else:
        dm, dff, heads, kv = 512, 1536, 8, 4
        lanes, gen, prompt_len, max_len = 4, 16, 8, 64
    base = get_reduced("smollm-135m")
    cfg = base.replace(d_model=dm, n_heads=heads, n_kv_heads=kv, d_ff=dff, dtype="bfloat16",
                       adapter=base.adapter.replace(
                           targets=("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down"),
                           layers="all"))
    rng = np.random.default_rng(0)
    prompts = [rng.integers(2, cfg.vocab_size, size=prompt_len).astype(np.int32)
               for _ in range(lanes)]
    wall = {}
    params = None
    for mode in ("bf16", "int8"):
        eng = MultiTenantEngine(cfg, EngineConfig(layout="paged", n_lanes=lanes, n_slots=4,
                                                  max_len=max_len, base_dtype=mode),
                                params=params, device=device)
        params = eng.params if params is None else params  # share the QR init
        eng.add_tenant("t1", _lam(eng, 1))
        best = float("inf")
        for rep in range(4):  # a warm drain, then the best of three
            for p in prompts:
                eng.submit("t1", p, gen)
            dt = _drain(eng)
            if rep:
                best = min(best, dt)
        wall[mode] = best
        extra = ""
        if mode == "int8":
            qb, fb = resident_base_bytes(eng.params)
            extra = f";base_bytes={qb};bf16_equiv_bytes={fb}"
        tokens = lanes * gen
        emit(f"serve_multitenant:kv_cache:paged_{mode}", best / tokens * 1e6,
             f"tok_s={tokens / best:.0f};lanes={lanes};d_model={dm};adapted=all{extra}")
    emit("serve_multitenant:kv_cache:paged_quant_saving", 0.0,
         f"bf16_s={wall['bf16']:.3f};int8_s={wall['int8']:.3f};"
         f"speedup={wall['bf16'] / wall['int8']:.2f}x;held={wall['int8'] < wall['bf16']}")


#: the sub-benches, in the reference's order (``main``, ``:724-735``)
BENCHES = {
    "adapter_churn": bench_adapter_churn,
    "bgmv_overhead": bench_bgmv_overhead,
    "engine_throughput": bench_engine_throughput,
    "recurrent_families": bench_recurrent_families,
    "chunked_prefill": bench_chunked_prefill,
    "speculative": bench_speculative,
    "telemetry_overhead": bench_telemetry_overhead,
    "decode_phases": bench_decode_phases,
    "paged_vs_dense": bench_paged_vs_dense,
    "prefix_sharing": bench_prefix_sharing,
    "quantized": bench_quantized,
}


def main(device="cuda"):
    """Run every sub-bench of :data:`BENCHES`, in the reference's order."""
    device = resolve_device(device)
    for fn in BENCHES.values():
        fn(device)


if __name__ == "__main__":
    main()
