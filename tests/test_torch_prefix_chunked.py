"""The port's serving posture: copy-on-write prefix sharing, lazy growth
and preemption, chunked prefill and the admission watermark (the port's
copies of ``tests/test_paging.py:398-593`` and ``:748-809``), on reduced
smollm-135m and reduced qwen2-0.5b (random QKV biases) in float32 on the
CPU; then the port's engine against the JAX engine under
``EngineConfig.serving()`` on the same traffic.

Port against port, the features are scheduling and bookkeeping only, so
shared-prefix and chunked-prefill serves are held bitwise to the unshared
and monolithic ones (the chunked path gathers keys at the monolithic
bucket's width, so the softmax reduces over the same score rows).  Against
the merged-weight reference and the JAX engine: identical tokens, logits
within 1e-4 (``test_torch_serving.py``'s bound, measured ~5e-6).  The
chunked tests read the engine's telemetry as the reference's do, and the
chunk starts themselves by wrapping the model's prefill."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced as jax_reduced
from repro.models import build_model as jax_build
from repro.serving import EngineConfig as JEngineConfig
from repro.serving import MultiTenantEngine as JEngine
from repro_torch.configs import get_reduced
from repro_torch.interop import params_from_jax
from repro_torch.models import build_model
from repro_torch.serving import (
    BASE_TENANT,
    EngineConfig,
    MultiTenantEngine,
    base_lambda,
    random_lambda,
    reference_decode,
)

LOGIT_TOL = 1e-4
ARCHS = ["smollm-135m", "qwen2-0.5b"]


@pytest.fixture(scope="module", autouse=True)
def _clear_jax_caches():
    yield
    jax.clear_caches()


def _cfg(arch, dtype="float32"):
    return get_reduced(arch).replace(dtype=dtype)


_PARAMS = {}


def _params(cfg):
    """The engine's params for ``cfg`` (seed 0), QKV biases made random so
    a path that dropped them would show; built once per config."""
    key = (cfg.name, cfg.dtype)
    if key not in _PARAMS:
        gen = torch.Generator().manual_seed(0)
        params = build_model(cfg, "cpu").init(gen)
        for name in ("bq", "bk", "bv"):
            if name in params["groups"]["attn"]:
                leaf = params["groups"]["attn"][name]
                leaf.copy_(torch.randn(leaf.shape, generator=gen) * 0.5)
        _PARAMS[key] = params
    return _PARAMS[key]


def _engine(cfg, **kw):
    return MultiTenantEngine(cfg, EngineConfig(layout="paged", **kw), params=_params(cfg),
                             device="cpu")


def _lam(eng, seed, scale=0.3):
    return random_lambda(torch.Generator().manual_seed(seed), eng.params, scale)


def _same_streams(want, got):
    assert want.keys() == got.keys()
    for uid in want:
        assert want[uid].tokens == got[uid].tokens, f"uid={uid}"
        np.testing.assert_array_equal(np.stack(want[uid].logits), np.stack(got[uid].logits))


def _count_prefills(eng):
    """Wrap the engine's model prefill: a list that gets each call's start
    (None for a monolithic prefill)."""
    calls, prefill = [], eng.model.prefill

    def counted(*a, **kw):
        calls.append(kw.get("start"))
        return prefill(*a, **kw)

    eng.model.prefill = counted
    return calls


# ---------------------------------------------------------------------------
# copy-on-write prefix sharing, lazy growth, preemption
# ---------------------------------------------------------------------------


def _run_prefix_engine(cfg, share_prefix, specs, *, lanes=2, n_blocks=None):
    """Tenants t1/t1b share one λ (a family), t2 is distinct; ``specs`` are
    (tenant, prompt)."""
    eng = _engine(cfg, n_lanes=lanes, n_slots=6, max_len=48, collect_logits=True,
                  block_size=8, n_blocks=n_blocks, share_prefix=share_prefix)
    fam_lam = _lam(eng, 1)
    eng.add_tenant("t1", fam_lam)
    eng.add_tenant("t1b", fam_lam)  # same λ bytes → same prefix family
    eng.add_tenant("t2", _lam(eng, 2))
    reqs = {}
    for tenant, prompt in specs:
        r = eng.submit(tenant, prompt, 4)
        reqs[r.uid] = (tenant, prompt)
    return eng, reqs, eng.run(), fam_lam


@pytest.mark.parametrize("arch", ARCHS)
def test_shared_prefix_bit_identical_to_unshared(arch):
    """Prefix sharing changes block accounting only: tokens and logits
    bitwise the unshared engine's, tenants of another λ never share."""
    cfg = _cfg(arch)
    rng = np.random.default_rng(5)
    pre = rng.integers(2, cfg.vocab_size, size=16).astype(np.int32)  # 2 full blocks
    tails = [rng.integers(2, cfg.vocab_size, size=4).astype(np.int32) for _ in range(4)]
    specs = [
        ("t1", np.concatenate([pre, tails[0]])),   # seeds the t1-family prefix
        ("t1", np.concatenate([pre, tails[1]])),   # same tenant, same prefix
        ("t1b", np.concatenate([pre, tails[2]])),  # same family, other tenant
        ("t2", np.concatenate([pre, tails[3]])),   # different λ: must not share
        ("t2", rng.integers(2, cfg.vocab_size, size=9).astype(np.int32)),
    ]
    _, _, base_done, _ = _run_prefix_engine(cfg, False, specs)
    eng, _, shared_done, _ = _run_prefix_engine(cfg, True, specs)
    _same_streams(base_done, shared_done)
    assert eng.prefix_cache.hits == 4  # the t1-family prefix reused twice
    # lanes drained: only the cache-held blocks stay out of the pool
    cached = eng.prefix_cache.cached_blocks
    assert eng.allocator.n_in_use == cached == eng.blocks_in_use()
    assert eng.release_prefix_cache() == cached
    assert eng.allocator.n_free == eng.allocator.capacity


@pytest.mark.parametrize("arch", ARCHS)
def test_shared_prefix_matches_merged_weight_reference(arch):
    cfg = _cfg(arch)
    rng = np.random.default_rng(9)
    pre = rng.integers(2, cfg.vocab_size, size=16).astype(np.int32)
    specs = [("t1", np.concatenate([pre, rng.integers(2, cfg.vocab_size, size=3).astype(np.int32)]))
             for _ in range(3)]
    eng, reqs, done, lam = _run_prefix_engine(cfg, True, specs)
    assert eng.prefix_cache.hits > 0
    for uid, (_, prompt) in reqs.items():
        toks, logits = reference_decode(cfg, eng.params, lam, prompt, 4, 48)
        assert done[uid].tokens == toks
        np.testing.assert_allclose(np.stack(done[uid].logits), logits, atol=LOGIT_TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_shared_prefix_footprint_is_one_prefix_plus_tails(arch):
    """N lanes on one prompt hold one prefix plus N growth tails, not N
    copies of everything."""
    cfg = _cfg(arch)
    lanes, bs, P, gen = 4, 8, 32, 4
    prompt = np.random.default_rng(3).integers(2, cfg.vocab_size, size=P).astype(np.int32)
    peaks = {}
    for share in (False, True):
        eng = _engine(cfg, n_lanes=lanes, n_slots=6, max_len=64, block_size=bs,
                      share_prefix=share)
        fam = _lam(eng, 1, 0.2)
        for i in range(lanes):
            eng.add_tenant(f"fam{i}", fam)  # one family, many tenants
            eng.submit(f"fam{i}", prompt, gen)
        eng.run()
        peaks[share] = eng.allocator.peak_in_use
    assert peaks[True] == P // bs + lanes
    assert peaks[False] == lanes * (P // bs + 1)


@pytest.mark.parametrize("arch", ARCHS)
def test_gate_pins_matches_against_same_round_eviction(arch):
    """A's gate matches cached blocks (need 0), then B's gate evicts the
    cache in the same round: A's pinned blocks survive and B is deferred,
    no PoolExhausted escapes run()."""
    cfg = _cfg(arch)
    eng = _engine(cfg, n_lanes=2, n_slots=2, max_len=32, block_size=8, n_blocks=1 + 4,
                  share_prefix=True)
    rng = np.random.default_rng(2)
    shared = rng.integers(2, cfg.vocab_size, size=16).astype(np.int32)  # 2 blocks
    other = rng.integers(2, cfg.vocab_size, size=24).astype(np.int32)  # 3 blocks
    eng.submit(BASE_TENANT, shared, 2)
    eng.run()
    assert eng.prefix_cache.cached_blocks == 2 and eng.allocator.n_free == 2
    a = eng.submit(BASE_TENANT, shared, 4)
    b = eng.submit(BASE_TENANT, other, 4)
    done = eng.run()
    assert len(done[a.uid].tokens) == 4 and len(done[b.uid].tokens) == 4
    eng.release_prefix_cache()
    assert eng.allocator.n_free == eng.allocator.capacity


@pytest.mark.parametrize("arch", ARCHS)
def test_lazy_growth_allocates_prompt_only(arch):
    cfg = _cfg(arch)
    eng = _engine(cfg, n_lanes=1, n_slots=2, max_len=64, block_size=8)
    eng.submit(BASE_TENANT, np.arange(2, 14, dtype=np.int32), 24)  # P=12
    eng.step()  # prefill + first decode: write pos 12 sits in the tail block
    assert eng.allocator.n_in_use == 2
    while len(eng.scheduler.active()[0].tokens) < 5:
        eng.step()  # write positions 13..15 stay inside block 1
        assert eng.allocator.n_in_use == 2
    eng.step()  # write position 16 crosses into block 2
    assert eng.allocator.n_in_use == 3
    eng.run()
    assert eng.allocator.n_free == eng.allocator.capacity


@pytest.mark.parametrize("arch", ARCHS)
def test_preemption_frees_youngest_and_recovers(arch):
    cfg = _cfg(arch)

    def run(n_blocks):
        eng = _engine(cfg, n_lanes=2, n_slots=2, max_len=32, collect_logits=True,
                      block_size=8, n_blocks=n_blocks)
        a = eng.submit(BASE_TENANT, np.arange(2, 10, dtype=np.int32), 16)
        b = eng.submit(BASE_TENANT, np.arange(12, 20, dtype=np.int32), 16)
        done = eng.run()
        assert eng.allocator.n_free == eng.allocator.capacity
        return eng, done[a.uid], done[b.uid]

    eng_big, a_big, b_big = run(1 + 8)
    assert eng_big.preemptions == 0
    eng, a, b = run(1 + 5)  # both need 3 blocks; they collide crossing pos 16
    assert eng.preemptions >= 1 and b.preemptions >= 1 and a.preemptions == 0
    _same_streams({0: a_big, 1: b_big}, {0: a, 1: b})


@pytest.mark.parametrize("arch", ARCHS)
def test_cow_fork_on_shared_write_block(arch):
    """A lane about to decode into a block another owner holds forks a
    private copy first: one fork, the lane's reference moves to the copy,
    the shared block is left as it was, tokens and logits unchanged."""
    cfg = _cfg(arch)

    def run(tamper):
        eng = _engine(cfg, n_lanes=1, n_slots=2, max_len=32, collect_logits=True, block_size=8)
        req = eng.submit(BASE_TENANT, np.arange(2, 14, dtype=np.int32), 6)  # P=12
        eng.step()  # admit; the tail block (positions 8..11) is private
        tail = eng._lane_blocks[req.lane][-1]
        before = eng.cache["layers"]["attn"]["k"][:, tail].clone()
        if tamper:
            eng.allocator.incref(tail)  # another owner of the tail
        done = eng.run()
        after = eng.cache["layers"]["attn"]["k"][:, tail]
        return eng, tail, done[req.uid], torch.equal(before, after)

    _, _, clean, _ = run(tamper=False)
    eng, tail, forked, kept = run(tamper=True)
    assert eng.cow_forks == 1
    assert eng.allocator.ref_count(tail) == 1, "the lane's ref moved to the copy"
    assert kept, "the lane wrote into the shared block"
    _same_streams({0: clean}, {0: forked})
    eng.allocator.decref(tail)
    assert eng.allocator.n_free == eng.allocator.capacity


# ---------------------------------------------------------------------------
# chunked prefill
# ---------------------------------------------------------------------------


def _run_chunked(cfg, specs, *, prefill_chunk, rng_seed=3, **kw):
    eng = _engine(cfg, n_lanes=2, n_slots=4, max_len=128, block_size=16,
                  collect_logits=True, prefill_chunk=prefill_chunk, **kw)
    calls = _count_prefills(eng)
    lams = {BASE_TENANT: base_lambda(eng.params), "t1": _lam(eng, 1)}
    eng.add_tenant("t1", lams["t1"])
    rng = np.random.default_rng(rng_seed)
    reqs = {}
    for t, P, G in specs:
        prompt = rng.integers(2, cfg.vocab_size, size=P).astype(np.int32)
        reqs[eng.submit(t, prompt, G).uid] = (t, prompt, G)
    return eng, reqs, eng.run(), calls


CHUNK_SPECS = [(BASE_TENANT, 37, 6), ("t1", 50, 5), ("t1", 9, 4), (BASE_TENANT, 60, 3)]


@pytest.mark.parametrize("arch", ARCHS)
def test_chunked_prefill_bit_identical_to_monolithic(arch):
    """Block-aligned chunks interleaved with resident decode steps are a
    scheduling change only: tokens and logits bitwise the monolithic
    engine's (reached on the CPU; the card's reading is in chip_smoke)."""
    cfg = _cfg(arch)
    _, _, mono, mono_calls = _run_chunked(cfg, CHUNK_SPECS, prefill_chunk=None)
    eng, _, chunked, calls = _run_chunked(cfg, CHUNK_SPECS, prefill_chunk=16)
    _same_streams(mono, chunked)
    assert eng.allocator.n_free == eng.allocator.capacity
    assert set(mono_calls) == {None} and len(mono_calls) == 4
    # the 37/50/60-token prompts stream in 3, 4 and 4 chunks; the 9-token
    # one prefills in one pass
    assert sorted(c for c in calls if c is not None) == [0, 0, 0, 16, 16, 16, 32, 32, 32, 48, 48]
    assert calls.count(None) == 1
    # the chunk machinery actually ran, and telemetry saw it
    snap = eng.metrics()
    assert snap["serve_prefill_chunk_ms"]["series"][0]["count"] >= 2
    phases = {s["labels"]["phase"] for s in snap["serve_step_phase_ms"]["series"]}
    assert "prefill_chunk" in phases
    spans = {
        e["name"]
        for e in eng.telemetry.tracer.to_chrome()["traceEvents"]
        if e["ph"] == "X"
    }
    assert "prefill_chunk" in spans


@pytest.mark.parametrize("arch", ARCHS)
def test_chunked_prefill_mid_chunk_preemption_recovers(arch):
    """Block pressure while a lane is still mid-prefill preempts it cleanly
    (chunk progress dropped, blocks freed) and its output is re-derived
    exactly once re-admitted."""
    cfg = _cfg(arch)

    def run(n_blocks):
        eng = _engine(cfg, n_lanes=2, n_slots=2, max_len=64, block_size=8,
                      collect_logits=True, prefill_chunk=8, n_blocks=n_blocks)
        mid = []
        preempt = eng._preempt

        def watched(victim):
            mid.append(victim.uid in eng._prefilling and victim.prefill_pos > 0)
            preempt(victim)
            assert victim.prefill_pos == -1 and victim.uid not in eng._prefilling

        eng._preempt = watched
        a = eng.submit(BASE_TENANT, np.arange(2, 17, dtype=np.int32), 6)  # P=15
        b = eng.submit(BASE_TENANT, np.arange(20, 52, dtype=np.int32), 4)  # P=32
        done = eng.run()
        assert eng.allocator.n_free == eng.allocator.capacity
        return eng, done[a.uid], done[b.uid], mid

    _, a_big, b_big, _ = run(1 + 12)
    eng, a, b, mid = run(1 + 6)
    assert eng.preemptions >= 1 and b.preemptions >= 1 and a.preemptions == 0
    assert mid and mid[0], "the victim was not mid-prefill when preempted"
    _same_streams({0: a_big, 1: b_big}, {0: a, 1: b})


@pytest.mark.parametrize("arch", ARCHS)
def test_chunked_prefill_skips_cached_prefix_blocks(arch):
    """A chunked prefill over a prefix-cache hit does not recompute the
    cached blocks: chunk starts skip them (one logits-only pass when the
    whole prompt is cached), outputs bitwise the monolithic engine's."""
    cfg = _cfg(arch)
    rng = np.random.default_rng(5)
    pre = rng.integers(2, cfg.vocab_size, size=32).astype(np.int32)  # 2 blocks
    tail = rng.integers(2, cfg.vocab_size, size=5).astype(np.int32)
    tail2 = rng.integers(2, cfg.vocab_size, size=7).astype(np.int32)

    def run(prefill_chunk):
        eng = _engine(cfg, n_lanes=1, n_slots=2, max_len=64, block_size=16,
                      collect_logits=True, share_prefix=True, prefill_chunk=prefill_chunk)
        calls = _count_prefills(eng)
        subs, starts = [], []
        for prompt in (pre, pre, np.concatenate([pre, tail]), np.concatenate([pre, tail2])):
            subs.append(eng.submit(BASE_TENANT, prompt, 4))
            eng.run()
            starts.append(list(calls))
            calls.clear()
        return eng, subs, starts

    eng_m, mono, _ = run(None)
    eng_c, chunked, starts = run(16)
    assert eng_c.prefix_cache.hits == eng_m.prefix_cache.hits == 4
    # seeding: one pass (P = 2·chunk); fully cached: one pass over the last
    # chunk; a tail (another bucket, so another family): three chunks; the
    # same prefix with another tail: the cached blocks skipped, one chunk
    assert starts == [[None], [16], [0, 16, 32], [32]]
    for rm, rc in zip(mono, chunked):
        assert rm.tokens == rc.tokens
        np.testing.assert_array_equal(np.stack(rm.logits), np.stack(rc.logits))


# ---------------------------------------------------------------------------
# the admission watermark, stale families
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_watermark_defers_an_admission_that_eats_the_headroom(arch):
    """With 5 usable blocks and a watermark of 2, a 2-block request waits
    while a 2-block lane runs (2 + 2 > 5 - 2); without the watermark both
    run at once.  The streams are the same either way."""
    cfg = _cfg(arch)
    rng = np.random.default_rng(4)
    prompts = [rng.integers(2, cfg.vocab_size, size=12).astype(np.int32) for _ in range(2)]
    runs = {}
    for wm in (0, 2):
        eng = _engine(cfg, n_lanes=2, n_slots=2, max_len=32, block_size=8, n_blocks=1 + 5,
                      watermark=wm, collect_logits=True)
        subs = [eng.submit(BASE_TENANT, p, 3) for p in prompts]
        eng.step()
        runs[wm] = (eng, len(eng.scheduler.active()), eng.run(), subs)
    assert runs[0][1] == 2 and runs[2][1] == 1
    assert runs[2][0].allocator.peak_in_use <= 5 - 2 + 1
    _same_streams(runs[0][2], runs[2][2])
    with pytest.raises(ValueError, match="watermark"):
        _engine(cfg, n_lanes=1, n_slots=2, max_len=32, block_size=8, n_blocks=1 + 5,
                watermark=5)


@pytest.mark.parametrize("arch", ARCHS)
def test_hot_swap_and_lru_drop_reclaim_stale_prefix_families(arch):
    """Prefix-cache entries of a retired λ digest are freed once no resident
    tenant carries it (a copy of ``tests/test_lam_store.py:484`` and
    ``:515`` for the port's hot tier)."""
    cfg = _cfg(arch)
    eng = _engine(cfg, n_lanes=2, n_slots=4, max_len=32, block_size=8, share_prefix=True)
    lam_a, lam_b = _lam(eng, 1, 0.2), _lam(eng, 2, 0.2)
    eng.add_tenant("t1", lam_a)
    eng.add_tenant("t2", lam_a)  # same λ → same family digest
    prompt = np.random.default_rng(0).integers(2, cfg.vocab_size, size=16).astype(np.int32)
    eng.submit("t1", prompt, 4)
    eng.run()
    assert len(eng.prefix_cache) == 2 and eng.blocks_in_use() == 2
    eng.add_tenant("t1", lam_b)  # t2 still holds the old digest
    assert len(eng.prefix_cache) == 2, "family dropped while a tenant still holds it"
    eng.add_tenant("t2", lam_b)  # the old digest is extinct now
    assert len(eng.prefix_cache) == 0 and eng.blocks_in_use() == 0
    # LRU pressure: one tenant slot, a second tenant pushes the first out
    eng = _engine(cfg, n_lanes=1, n_slots=2, max_len=32, block_size=8, share_prefix=True)
    eng.add_tenant("t1", lam_a)
    eng.submit("t1", prompt, 4)
    eng.run()
    assert len(eng.prefix_cache) == 2
    eng.add_tenant("t3", lam_b)
    assert "t1" not in eng.lam_store and len(eng.prefix_cache) == 0
    assert eng.blocks_in_use() == 0, "the dropped tenant's family blocks leaked"


# ---------------------------------------------------------------------------
# the port's engine against the JAX engine under EngineConfig.serving()
# ---------------------------------------------------------------------------


def _serving_traffic(rng, vocab):
    """Six requests of three tenants (two share a λ) on one 24-token system
    prefix with 2-8-token tails, and two long prompts for the chunked path."""
    pre = rng.integers(2, vocab, size=24).astype(np.int32)
    reqs = []
    for i in range(6):
        tail = rng.integers(2, vocab, size=int(rng.integers(2, 9))).astype(np.int32)
        reqs.append((["a", "a2", "b"][i % 3], np.concatenate([pre, tail]),
                     int(rng.integers(3, 8))))
    reqs.append(("b", rng.integers(2, vocab, size=50).astype(np.int32), 5))
    reqs.append(("a", rng.integers(2, vocab, size=41).astype(np.int32), 6))
    return reqs


@pytest.mark.parametrize("n_blocks", [20, 10])
@pytest.mark.parametrize("arch", ARCHS)
def test_serving_preset_matches_jax_engine(arch, n_blocks):
    """Both engines under ``EngineConfig.serving()`` (block 8, chunk 16,
    watermark 1) on the same traffic: identical streams, prefix hits and
    misses, CoW forks, pool peak, schedule and final occupancy; logits
    within 1e-4.  The smaller pool runs the gate's LRU eviction."""
    jcfg = jax_reduced(arch).replace(dtype="float32")
    cfg = _cfg(arch)
    jp = jax_build(jcfg).init(jax.random.PRNGKey(3))
    npj = jax.tree_util.tree_map(np.asarray, jp)
    rng = np.random.default_rng(0)
    for name in ("bq", "bk", "bv"):
        if name in npj["groups"]["attn"]:
            npj["groups"]["attn"][name] = (
                rng.standard_normal(npj["groups"]["attn"][name].shape) * 0.5).astype(np.float32)
    lam_shape = npj["groups"]["adapters"]["attn"]["wq"]["lam"].shape
    draw = lambda: {"attn": {p: (rng.standard_normal(lam_shape) * 0.3).astype(np.float32)
                             for p in ("wq", "wv")}}
    fam = draw()
    lams = {"a": fam, "a2": fam, "b": draw()}
    reqs = _serving_traffic(rng, cfg.vocab_size)
    common = dict(n_lanes=3, n_slots=6, max_len=64, collect_logits=True, block_size=8,
                  n_blocks=n_blocks)
    jeng = JEngine(jcfg, JEngineConfig.serving(telemetry=False, **common),
                   params=jax.tree_util.tree_map(jnp.asarray, npj))
    teng = MultiTenantEngine(cfg, EngineConfig.serving(**common),
                             params=params_from_jax(npj, device="cpu"), device="cpu")
    calls = _count_prefills(teng)
    for t, lam in lams.items():
        jeng.add_tenant(t, jax.tree_util.tree_map(jnp.asarray, lam))
        teng.add_tenant(t, lam)
    for t, p, n in reqs:
        jeng.submit(t, p, n)
        teng.submit(t, p, n)
    jdone, tdone = jeng.run(), teng.run()
    assert sorted(jdone) == sorted(tdone) == list(range(len(reqs)))
    worst = 0.0
    for uid in jdone:
        assert tdone[uid].tokens == jdone[uid].tokens, f"request {uid}"
        got, want = np.stack(tdone[uid].logits), np.stack(jdone[uid].logits)
        np.testing.assert_allclose(got, want, atol=LOGIT_TOL)
        worst = max(worst, float(np.abs(got - want).max()))
    print(f"[parity] {arch} serving() n_blocks={n_blocks}: logits max|Δ| {worst:.2e}, "
          f"hits {teng.prefix_cache.hits}, chunk dispatches "
          f"{sum(c is not None for c in calls)}, peak {teng.allocator.peak_in_use}")
    assert (teng.prefix_cache.hits, teng.prefix_cache.misses) == (
        jeng.prefix_cache.hits, jeng.prefix_cache.misses)
    assert teng.prefix_cache.hits > 0
    assert teng.cow_forks == jeng.cow_forks
    assert teng.preemptions == jeng.preemptions
    assert teng.steps == jeng.steps
    assert teng.allocator.peak_in_use == jeng.allocator.peak_in_use
    assert teng.blocks_in_use() == jeng.blocks_in_use()
    assert teng.prefill_buckets == jeng.prefill_buckets
    assert sum(c is not None for c in calls) >= 2, "the chunked path did not run"
    assert teng.chunk_dispatches == sum(c is not None for c in calls)
    assert teng.chunk_dispatches == sum(r.prefill_chunks for r in tdone.values())
    assert teng.kv_cache_bytes() == jeng.kv_cache_bytes()


def test_serve_multi_driver_verifies_the_serving_flags_on_qwen():
    """The driver with the posture's flags on reduced qwen2-0.5b: 40-token
    prompts stream in 16-token chunks, every tenant verified against its
    merged-weight reference inside ``main``."""
    from repro_torch.launch import serve_multi

    done = serve_multi.main(["--reduced", "--arch", "qwen2-0.5b", "--device", "cpu",
                             "--share-prefix", "--prefill-chunk", "16", "--block-size", "8",
                             "--watermark", "1", "--n-blocks", "20", "--max-len", "64",
                             "--prompt-len", "40", "--gen-len", "6", "--tenants", "3",
                             "--lanes", "2"])
    assert len(done) == 3 and all(len(r.tokens) == 6 for r in done.values())
