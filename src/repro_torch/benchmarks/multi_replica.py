"""Multi-replica scaling: adapter-locality routing against one thrashing
engine (port of ``benchmarks/multi_replica.py``, same rows and bars).

The workload that makes the replica count matter at the smoke scale is
prefix-cache capacity, not parallel FLOPs: two adapter families, each with a
long shared prompt whose full-block prefix fills most of one engine's block
pool.  One replica serving interleaved A,B,A,B traffic evicts family A's
cached prefix to admit family B and the other way round, so every admission
is a full chunked prefill.  Two replicas behind the λ-digest router pin
each family to its home replica, so after one cold prefill per family every
admission matches the whole prefix and the chunk path recomputes only the
final chunk (the logits row), about 1/6 of the prompt.  The bar is ≥ 1.8×
at 2 replicas, held two ways.  The work bar, on every device: the prompt
rows the chunk path ran in the timed drives (the engines' own
``chunk_dispatches`` times the chunk), one replica's over two replicas', at
least 1.8 (≈ P/chunk = 6 at the smoke scale) — a property of the routing
itself, whatever else runs on the host.  The aggregate decode throughput
bar on a card, where both replicas share it; on the CPU the throughput
ratio is a reading (``held=`` beside both sides' numbers), since a
wall-clock ratio under a loaded multi-process test run is not a property of
the code.

The 1-replica baseline runs through the same Router code (a ring of one),
so the comparison isolates the replica count.  A disaggregated segment
(prefill replica → decode replica) measures the handoff's transfer bytes
and holds its tokens to the monolithic engine's.

On a card both replicas share it (``cuda:0``) and their device work
interleaves on its default stream.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from repro_torch.benchmarks.common import _sync, emit, say, scale
from repro_torch.configs import get_config, get_reduced
from repro_torch.serving import (
    EngineConfig,
    MultiTenantEngine,
    Router,
    build_replicas,
    lam_digest,
    random_lambda,
)

ARCH = "smollm-135m"


def _geometry():
    if scale() == "paper":
        # paper scale: a bigger pool, longer prompts, the same thrash
        return dict(lanes=2, bs=16, P=192, chunk=32, gen=4, R=8, n_blocks=15, max_len=256)
    return dict(lanes=2, bs=16, P=96, chunk=16, gen=2, R=6, n_blocks=9, max_len=128)


def _engine_config(g, **over):
    kw = dict(layout="paged", n_lanes=g["lanes"], n_slots=8, max_len=g["max_len"],
              block_size=g["bs"], n_blocks=g["n_blocks"], share_prefix=True,
              prefill_chunk=g["chunk"])
    kw.update(over)
    return EngineConfig(**kw)


def _lam(params, seed: int):
    gen = torch.Generator(device=params["embed"].device).manual_seed(seed)
    return random_lambda(gen, params, 0.1)


def _family_lams(params, router):
    """Two λ families whose digests land on different replicas of
    ``router``'s ring (a deterministic seed search; with one replica both
    share it)."""
    lam_a = _lam(params, 101)
    home_a = router.owner_of(lam_digest(lam_a))
    for seed in range(102, 118):
        lam_b = _lam(params, seed)
        if router.owner_of(lam_digest(lam_b)) is not home_a or len(router.replicas) == 1:
            return {"famA": lam_a, "famB": lam_b}
    raise AssertionError("no seed separated the families across the ring")


def _drive(router, prompts, g):
    """Interleaved A,B,A,B submission, drain, token lists per family."""
    routed = []
    for _ in range(g["R"]):
        for fam in ("famA", "famB"):
            routed.append(router.submit(fam, prompts[fam], g["gen"]))
    router.run()
    toks = {"famA": [], "famB": []}
    for r in routed:
        assert r.finished and len(r.tokens) == g["gen"], r
        toks[r.tenant].append(list(r.tokens))
    return toks


def _chunk_rows(router, g) -> int:
    """Prompt rows the chunk path has run so far, over every replica."""
    return sum(rep.engine.chunk_dispatches for rep in router.replicas) * g["chunk"]


def bench_replica_scaling(device):
    g = _geometry()
    cfg = (get_config if scale() == "paper" else get_reduced)(ARCH)
    rng = np.random.default_rng(7)
    prompts = {fam: rng.integers(2, cfg.vocab_size, size=g["P"]).astype(np.int32)
               for fam in ("famA", "famB")}
    total_tokens = 2 * g["R"] * g["gen"]

    tok_s, fam_tokens, rows, params = {}, {}, {}, None
    for n in (1, 2):
        replicas = build_replicas(cfg, _engine_config(g), n, params=params, device=device)
        params = replicas[0].engine.params  # shared across both configs
        router = Router(replicas, telemetry=True)
        router.add_tenants(_family_lams(params, router))
        _drive(router, prompts, g)  # warm: the kernels built, the caches seeded
        best, rows0 = float("inf"), _chunk_rows(router, g)
        for _ in range(2):
            _sync(device)
            t0 = time.perf_counter()
            toks = _drive(router, prompts, g)
            _sync(device)
            best = min(best, time.perf_counter() - t0)
        tok_s[n] = total_tokens / best
        rows[n] = (_chunk_rows(router, g) - rows0) // 2  # a drive's prefilled rows
        fam_tokens[n] = toks
        hits = sum(rep.engine.prefix_cache.hits for rep in router.replicas)
        misses = sum(rep.engine.prefix_cache.misses for rep in router.replicas)
        emit(f"multi_replica:throughput:r{n}", best / total_tokens * 1e6,
             f"tok_s={tok_s[n]:.0f};replicas={n};"
             f"placement_hit={router.placement_hit_rate():.2f};"
             f"prefix_hits={hits};prefix_misses={misses};prefill_rows={rows[n]};"
             f"transfer_bytes={router.transport.stats()['total_bytes']}")

    # routed output must be token-identical to one plain engine
    eng = MultiTenantEngine(cfg, _engine_config(g), params=params, device=device)
    eng.add_tenant("famA", _lam(params, 101))
    ref = eng.submit("famA", prompts["famA"], g["gen"])
    eng.run()
    for n in (1, 2):
        for seq in fam_tokens[n]["famA"]:
            assert seq == ref.tokens, (
                f"routed famA tokens {seq} != single-engine {ref.tokens} (replicas={n})")
        # every same-family request is the same (tenant, prompt) pair
        for fam in ("famA", "famB"):
            assert all(s == fam_tokens[n][fam][0] for s in fam_tokens[n][fam])

    ratio = tok_s[2] / tok_s[1]
    work = rows[1] / max(rows[2], 1)
    emit("multi_replica:scaling", 0.0,
         f"r1_tok_s={tok_s[1]:.0f};r2_tok_s={tok_s[2]:.0f};ratio={ratio:.2f}x;"
         f"r1_prefill_rows={rows[1]};r2_prefill_rows={rows[2]};work_ratio={work:.2f}x;"
         f"held={ratio >= 1.8}")
    assert work >= 1.8, (
        f"2 replicas prefill {rows[2]} prompt rows a drive against 1 replica's {rows[1]} "
        f"({work:.2f}x, need >= 1.8x) — adapter-locality routing is no longer avoiding the "
        "prefix-cache thrash")
    if torch.device(device).type == "cuda":
        assert ratio >= 1.8, (
            f"2-replica aggregate throughput only {ratio:.2f}x of 1 replica (need >= 1.8x) — "
            "adapter-locality routing is no longer avoiding the prefix-cache thrash")


def bench_disaggregated(device):
    """Prefill/decode disaggregation: r0 prefills, exports the committed
    blocks and first-token logits, r1 adopts them and decodes — no prompt
    recompute on the decode replica, tokens equal to the monolithic
    engine's, transfer bytes measured."""
    g = _geometry()
    cfg = (get_config if scale() == "paper" else get_reduced)(ARCH)
    rng = np.random.default_rng(7)
    prompt = rng.integers(2, cfg.vocab_size, size=g["P"]).astype(np.int32)
    gen = 4
    # a default-size pool (no thrash needed here), logits collected so the
    # handoff payload carries the committed first-token row
    econf = _engine_config(g, n_blocks=None, collect_logits=True)

    replicas = build_replicas(cfg, econf, 2, device=device)
    params = replicas[0].engine.params
    router = Router(replicas, disaggregate=True)
    lam = _lam(params, 101)
    router.add_tenant("famA", lam)
    warm = [router.submit("famA", prompt, gen) for _ in range(2)]
    router.run()  # warm: prefill chunks, the adopting admission, decode
    n_req = 4
    routed = [router.submit("famA", prompt, gen) for _ in range(n_req)]
    _sync(device)
    t0 = time.perf_counter()
    router.run()
    _sync(device)
    dt = time.perf_counter() - t0

    eng = MultiTenantEngine(cfg, econf, params=params, device=device)
    eng.add_tenant("famA", lam)
    ref = eng.submit("famA", prompt, gen)
    eng.run()
    for r in routed + warm:
        assert r.finished and r.tokens == ref.tokens, (
            f"disaggregated tokens {r.tokens} != monolithic {ref.tokens}")
        assert r.replica.role in ("decode", "both"), r
    stats = router.transport.stats()
    assert stats["shipments"].get("prefill", 0) == n_req + len(warm), stats
    # the decode replica must not have prefilled the prompt itself
    decode_eng = router.replicas[1].engine
    assert decode_eng.prefill_compilations == 0, (
        f"decode replica prefilled {decode_eng.prefill_compilations} buckets — the handoff "
        "recomputed the prompt")
    emit("multi_replica:disaggregated", dt / (n_req * gen) * 1e6,
         f"handoffs={stats['shipments'].get('prefill', 0)};"
         f"transfer_bytes={stats['bytes'].get('prefill', 0)};"
         f"tok_s={n_req * gen / dt:.0f}")


def main(device):
    say(f"# Multi-replica serving ({ARCH}, {scale()} scale, {device})")
    bench_replica_scaling(device)
    bench_disaggregated(device)
