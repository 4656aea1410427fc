"""Speculative decoding of the PyTorch port (reduced smollm-135m, float32,
CPU): ports of the reference's ``tests/test_speculative.py`` (all seven)
and ``tests/test_paging.py:594`` (rollback conserves blocks) held port
against port; the port's speculative engine beside the JAX package's on the
same weights and traffic, in both layouts with both drafters; the verify
forward row by row against decode; the in-place safety rig of
``chip_smoke.py`` (a shared block forced into a window) with its planted
faults; the engine config's speculative fields; the ``serve_multi``
driver's ``--speculate-k``.

Bounds: logits within 1e-4 (the reference's own bar for speculative
against plain: the verify reduces attention over a (lanes, k+1) window and
associates float sums otherwise than the single-row decode; against the JAX
engine, ``test_torch_serving.py``'s, measured ~5e-6); a verify row within
2e-5 of the decode it stands for (``test_torch_models.py``'s bound for one
forward); tokens, schedules and counters equal."""
import functools
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _hypothesis_compat import given, settings, st
from repro.configs import get_reduced as jax_reduced
from repro.models import build_model as jax_build
from repro.serving import EngineConfig as JEngineConfig
from repro.serving import MultiTenantEngine as JEngine
from repro.serving.config import SPECULATIVE_FAMILIES as J_SPECULATIVE_FAMILIES
from repro_torch.configs import get_reduced
from repro_torch.interop import params_from_jax
from repro_torch.launch import serve_multi
from repro_torch.models import build_model
from repro_torch.serving import (
    BASE_TENANT,
    EngineConfig,
    MultiTenantEngine,
    random_lambda,
)
from repro_torch.serving.config import SPECULATIVE_FAMILIES

ROOT = Path(__file__).resolve().parents[1]
LOGIT_TOL = 1e-4
VERIFY_TOL = 2e-5

# mixed tenants, heterogeneous prompt/generation lengths, lane reuse
SPEC_SPECS = [(BASE_TENANT, 6, 8), ("t1", 9, 10), ("t2", 7, 6), ("t1", 5, 8)]


@pytest.fixture(scope="module", autouse=True)
def _clear_jax_caches():
    yield
    jax.clear_caches()


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Torch's CPU ops on two threads in this module: under the suite's
    parallel workers, larger OpenMP teams oversubscribe the cores and every
    small op of an engine step stalls."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _cfg():
    return get_reduced("smollm-135m").replace(dtype="float32")


@functools.cache
def _params():
    """The engines' weights, built once a module: the reduced model's init
    from ``EngineConfig.seed``, the tree each engine would draw itself."""
    return build_model(_cfg(), "cpu").init(torch.Generator().manual_seed(EngineConfig().seed))


def _run_engine(specs, *, rng_seed=3, n_tenants=2, **config_kw):
    """The reference's harness on the port: an engine from its own seeded
    init, tenants t1..tN with λ drawn at scale 0.3, one request a spec."""
    cfg = _cfg()
    config_kw.setdefault("n_lanes", 2)
    config_kw.setdefault("n_slots", 4)
    config_kw.setdefault("max_len", 48)
    config_kw.setdefault("collect_logits", True)
    eng = MultiTenantEngine(cfg, EngineConfig(**config_kw), params=_params(), device="cpu")
    for i in range(1, n_tenants + 1):
        eng.add_tenant(f"t{i}", random_lambda(torch.Generator().manual_seed(i), eng.params, 0.3))
    rng = np.random.default_rng(rng_seed)
    reqs = {}
    for t, P, G in specs:
        r = eng.submit(t, rng.integers(2, cfg.vocab_size, size=P).astype(np.int32), G)
        reqs[r.uid] = r
    done = eng.run()
    assert done.keys() == reqs.keys()
    return eng, done


def _assert_same_outputs(plain_done, spec_done):
    for uid in plain_done:
        assert plain_done[uid].tokens == spec_done[uid].tokens, f"uid={uid}"
        np.testing.assert_allclose(np.stack(plain_done[uid].logits),
                                   np.stack(spec_done[uid].logits), atol=LOGIT_TOL, rtol=0)


# ---------------------------------------------------------------------------
# ports of tests/test_speculative.py, port against port
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("k", [2, 4])
@pytest.mark.parametrize("layout", ["paged", "oracle_dense"])
def test_speculative_matches_plain_greedy(layout, k):
    """Token-identical to the plain greedy engine in both KV layouts, with
    mixed tenants sharing the decode batch (``tests/test_speculative.py:61``)."""
    kw = dict(layout=layout)
    if layout == "paged":
        kw["block_size"] = 8
    _, plain_done = _run_engine(SPEC_SPECS, **kw)
    eng, spec_done = _run_engine(SPEC_SPECS, speculate_k=k, **kw)
    _assert_same_outputs(plain_done, spec_done)
    assert eng.spec_steps > 0 and eng.drafted_tokens >= k * eng.spec_steps // 2
    assert eng.spec_steps == eng.steps
    assert 0.0 < eng.acceptance_rate <= 1.0
    if layout == "paged":
        assert eng.allocator.n_free == eng.allocator.capacity, "blocks leaked"


def test_speculative_quantum_preemption_matches_plain():
    """Quantum expiry, accounted in accepted tokens, snapshots and restores
    lanes without corrupting the window (``tests/test_speculative.py:80``)."""
    kw = dict(layout="oracle_dense", n_lanes=1, quantum=3)
    specs = [(BASE_TENANT, 6, 9), ("t1", 5, 9)]
    _, plain_done = _run_engine(specs, **kw)
    eng, spec_done = _run_engine(specs, speculate_k=3, **kw)
    _assert_same_outputs(plain_done, spec_done)
    assert eng.slice_preemptions >= 1, "quantum never fired mid-draft"


def test_speculative_share_prefix_matches_plain():
    """Prefix-cache hits seed lanes with shared blocks; forking only the
    write block keeps the output and the residual refcounts the plain
    engine's (``tests/test_speculative.py:93``)."""
    cfg = _cfg()
    rng = np.random.default_rng(5)
    pre = rng.integers(2, cfg.vocab_size, size=16).astype(np.int32)  # 2 blocks

    def run(k):
        eng = MultiTenantEngine(cfg, EngineConfig(
            layout="paged", n_lanes=2, n_slots=2, max_len=48, block_size=8,
            collect_logits=True, share_prefix=True, speculate_k=k), params=_params(),
            device="cpu")
        subs = [eng.submit(BASE_TENANT, pre, 6)]  # seeds the prefix cache
        eng.run()
        subs.append(eng.submit(BASE_TENANT, pre, 6))  # fully cached prompt
        subs.append(eng.submit(BASE_TENANT, pre[:8], 6))  # partial prefix
        eng.run()
        return eng, subs

    eng_plain, plain = run(k=0)
    eng, spec = run(k=3)
    assert eng.prefix_cache.hits == eng_plain.prefix_cache.hits > 0
    assert eng.allocator.n_free == eng_plain.allocator.n_free
    for rp, rs in zip(plain, spec):
        assert rp.tokens == rs.tokens
        np.testing.assert_allclose(np.stack(rp.logits), np.stack(rs.logits), atol=LOGIT_TOL,
                                   rtol=0)


def test_speculative_tight_pool_preemption_recovers():
    """Block pressure preempts the youngest lane with its window rolled
    back: the free list is whole after the drain and every request
    re-derives its plain-engine tokens (``tests/test_speculative.py:129``)."""
    cfg = _cfg()

    def run(k, n_blocks):
        eng = MultiTenantEngine(cfg, EngineConfig(
            layout="paged", n_lanes=2, n_slots=2, max_len=32, block_size=8,
            n_blocks=n_blocks, speculate_k=k), params=_params(), device="cpu")
        a = eng.submit(BASE_TENANT, np.arange(2, 10, dtype=np.int32), 16)
        b = eng.submit(BASE_TENANT, np.arange(12, 20, dtype=np.int32), 16)
        done = eng.run()
        assert eng.allocator.n_free == eng.allocator.capacity
        return eng, done[a.uid], done[b.uid]

    _, a_plain, b_plain = run(k=0, n_blocks=1 + 8)  # uncontended reference
    eng, a, b = run(k=2, n_blocks=1 + 5)  # collide crossing position 16
    assert eng.preemptions >= 1 and b.preemptions >= 1
    assert a.tokens == a_plain.tokens and b.tokens == b_plain.tokens


def test_speculative_truncated_lambda_drafter_matches_plain():
    """``draft_lam_rank=r`` drafts with each slot's top-r |λ|; exact
    acceptance still gives the plain tokens (``tests/test_speculative.py:155``)."""
    kw = dict(layout="paged", block_size=8)
    _, plain_done = _run_engine(SPEC_SPECS, **kw)
    eng, spec_done = _run_engine(SPEC_SPECS, speculate_k=3, draft_lam_rank=2, **kw)
    _assert_same_outputs(plain_done, spec_done)
    assert eng.acceptance_rate > 0.0
    # the view keeps exactly the top-2 |λ| of every tenant row, memoized
    # until a slot write
    view = eng._draft_params_view()
    assert eng._draft_params_view() is view
    for projs in view["groups"]["adapters"].values():
        for leaf in projs.values():
            assert int((leaf["lam"] != 0).sum(-1).max()) <= 2
    eng.add_tenant("t3", random_lambda(torch.Generator().manual_seed(9), eng.params, 0.3))
    assert eng._draft_params_view() is not view


def test_speculative_telemetry_counts_exactly_once():
    """Every speculative step records its acceptance once; the counters
    reconcile with the engine's and the draft/verify spans are in the trace
    (``tests/test_speculative.py:169``)."""
    eng, _ = _run_engine(SPEC_SPECS, layout="paged", block_size=8, speculate_k=3)
    snap = eng.metrics()
    assert snap["serve_spec_acceptance"]["series"][0]["count"] == eng.spec_steps
    counters = {name: snap[name]["series"][0]["value"]
                for name in ("serve_spec_drafted_total", "serve_spec_accepted_total",
                             "serve_spec_rolled_back_total")}
    assert counters["serve_spec_drafted_total"] == eng.drafted_tokens
    assert counters["serve_spec_accepted_total"] == eng.accepted_drafts
    assert counters["serve_spec_rolled_back_total"] == eng.drafted_tokens - eng.accepted_drafts
    spans = {e["name"] for e in eng.telemetry.tracer.to_chrome()["traceEvents"] if e["ph"] == "X"}
    assert {"draft", "verify"} <= spans


def test_speculation_rejected_for_recurrent_families():
    """The family gate (``tests/test_speculative.py:201``): the config-level
    check in both packages, and engine construction on xlstm-125m (the
    reference's engine case) and on a dense config marked ssm."""
    assert SPECULATIVE_FAMILIES == J_SPECULATIVE_FAMILIES
    for cls in (EngineConfig, JEngineConfig):
        cfg = cls(n_lanes=1, n_slots=2, max_len=16, speculate_k=2)
        for family in SPECULATIVE_FAMILIES:
            cfg.validate_speculation(family)  # no raise
        for family in ("ssm", "hybrid"):
            with pytest.raises(ValueError, match="cannot rewind"):
                cfg.validate_speculation(family)
    with pytest.raises(ValueError, match="cannot rewind"):
        MultiTenantEngine(get_reduced("xlstm_125m"),
                          EngineConfig(n_lanes=1, n_slots=2, max_len=16, speculate_k=2),
                          device="cpu")
    with pytest.raises(ValueError, match="cannot rewind"):
        MultiTenantEngine(_cfg().replace(family="ssm"),
                          EngineConfig(n_lanes=1, n_slots=2, max_len=16, speculate_k=2),
                          device="cpu")


@settings(max_examples=10, deadline=None)
@given(k=st.integers(1, 4), n_blocks=st.integers(5, 9), seed=st.integers(0, 50))
def test_engine_speculative_rollback_conserves_blocks(k, n_blocks, seed):
    """Property (``tests/test_paging.py:594``): whatever the draft depth,
    pool size and traffic — window growth, rollback, preemption under
    pressure — the tokens are the plain paged engine's and the pool drains
    to a full free list."""
    cfg = _cfg()
    rng = np.random.default_rng(seed)
    specs = [(int(rng.integers(3, 12)), int(rng.integers(4, 9)))
             for _ in range(int(rng.integers(2, 5)))]

    def run(speculate_k):
        eng = MultiTenantEngine(cfg, EngineConfig(
            layout="paged", n_lanes=2, n_slots=2, max_len=24, block_size=8,
            n_blocks=n_blocks, speculate_k=speculate_k), params=_params(), device="cpu")
        rng2 = np.random.default_rng(seed + 1)
        subs = [eng.submit(BASE_TENANT, rng2.integers(2, cfg.vocab_size, size=P).astype(np.int32),
                           G) for P, G in specs]
        done = eng.run()
        assert eng.allocator.n_free == eng.allocator.capacity, "blocks leaked"
        return [done[r.uid].tokens for r in subs]

    assert run(k) == run(0)


# ---------------------------------------------------------------------------
# both engines side by side
# ---------------------------------------------------------------------------

_WEIGHTS = {}


def _weights():
    """Reduced float32 JAX params as numpy leaves and the λ of t1 and t2."""
    if not _WEIGHTS:
        jcfg = jax_reduced("smollm-135m").replace(dtype="float32")
        npj = jax.tree_util.tree_map(np.asarray, jax_build(jcfg).init(jax.random.PRNGKey(3)))
        rng = np.random.default_rng(5)
        shape = npj["groups"]["adapters"]["attn"]["wq"]["lam"].shape
        lams = {f"t{i}": {"attn": {p: (rng.standard_normal(shape) * 0.3).astype(np.float32)
                                   for p in ("wq", "wv")}} for i in (1, 2)}
        _WEIGHTS.update(jcfg=jcfg, npj=npj, lams=lams)
    return _WEIGHTS["jcfg"], _WEIGHTS["npj"], _WEIGHTS["lams"]


def _serve_both(conf):
    """The JAX engine and the port's under the EngineConfig fields ``conf``
    on the same weights, tenants and SPEC_SPECS traffic: each engine and
    its finished requests in submission order."""
    jcfg, npj, lams = _weights()
    jeng = JEngine(jcfg, JEngineConfig(**conf), params=jax.tree_util.tree_map(jnp.asarray, npj))
    teng = MultiTenantEngine(_cfg(), EngineConfig(**conf),
                             params=params_from_jax(npj, device="cpu"), device="cpu")
    out = []
    for eng, to_lam in ((jeng, lambda t: jax.tree_util.tree_map(jnp.asarray, t)),
                        (teng, lambda t: t)):
        for t, lam in lams.items():
            eng.add_tenant(t, to_lam(lam))
        rng = np.random.default_rng(3)
        reqs = [eng.submit(t, rng.integers(2, 256, size=P).astype(np.int32), G)
                for t, P, G in SPEC_SPECS]
        done = eng.run()
        out.append((eng, [done[r.uid] for r in reqs]))
    return out


@pytest.mark.parametrize("draft_lam_rank", [None, 2], ids=["base", "truncated"])
@pytest.mark.parametrize("layout", ["paged", "oracle_dense"])
def test_speculative_engine_matches_the_jax_engine(layout, draft_lam_rank):
    conf = dict(layout=layout, n_lanes=2, n_slots=4, max_len=48, collect_logits=True,
                speculate_k=3, draft_lam_rank=draft_lam_rank)
    if layout == "paged":
        conf["block_size"] = 8
    (jeng, jreqs), (teng, treqs) = _serve_both(conf)
    for name in ("spec_steps", "drafted_tokens", "accepted_drafts", "steps", "decoded_tokens"):
        assert getattr(teng, name) == getattr(jeng, name), name
    assert teng.acceptance_rate == pytest.approx(jeng.acceptance_rate)
    for jr, tr in zip(jreqs, treqs):
        assert tr.tokens == jr.tokens
        np.testing.assert_allclose(np.stack(tr.logits), np.stack(jr.logits), atol=LOGIT_TOL,
                                   rtol=0)
    if layout == "paged":
        assert teng.allocator.n_free == teng.allocator.capacity


# ---------------------------------------------------------------------------
# the verify forward, row by row
# ---------------------------------------------------------------------------


def _clone_cache(c):
    return {"pos": c["pos"].clone(),
            "layers": {"attn": {k: v.clone() for k, v in c["layers"]["attn"].items()}}}


@pytest.mark.parametrize("layout", ["paged", "oracle_dense"])
def test_verify_row_s_is_decode_after_s_tokens(layout):
    """``decoder_verify`` row s equals ``decoder_decode`` after the window's
    first s tokens are committed, within 2e-5; the offsets come back
    unchanged, and a lane's rows at or past its ``n_valid`` write nothing a
    read can see (its K/V positions there, or its blocks, as they were)."""
    W = 4
    conf = dict(layout=layout, n_lanes=2, n_slots=4, max_len=48)
    if layout == "paged":
        conf["block_size"] = 8
    eng = MultiTenantEngine(_cfg(), EngineConfig(**conf), params=_params(), device="cpu")
    eng.add_tenant("t1", random_lambda(torch.Generator().manual_seed(1), eng.params, 0.3))
    rng = np.random.default_rng(0)
    reqs = [eng.submit(t, rng.integers(2, 256, size=P).astype(np.int32), 20)
            for t, P in (("t1", 13), (BASE_TENANT, 6))]
    eng.step()  # both admitted, one decode step
    ab = None
    if eng.paged:
        eng._grow_lanes(W)
        ab = eng._attend_blocks(reqs)
    window = torch.from_numpy(rng.integers(2, 256, size=(2, W)).astype(np.int32))
    for r in reqs:
        window[r.lane, 0] = r.tokens[-1]
    n_valid = torch.tensor([W, 2], dtype=torch.int32)
    view = eng._params_view()
    seg = torch.from_numpy(eng.scheduler.batch_composition())
    before = _clone_cache(eng.cache)
    logits, cache = eng.model.verify_step(view, eng.cache, window, seg_ids=seg, n_valid=n_valid,
                                          attend_blocks=ab)
    assert torch.equal(cache["pos"], before["pos"])
    assert torch.equal(cache["layers"]["attn"]["idx"], before["layers"]["attn"]["idx"])
    a, b0 = cache["layers"]["attn"], before["layers"]["attn"]
    idx1 = int(b0["idx"][0, 1])
    if eng.paged:
        bs = eng.block_size
        blk = eng._lane_blocks[1]
        for pos in range(idx1 + 2, min(idx1 + W, len(blk) * bs)):
            b, o = blk[pos // bs], pos % bs
            assert torch.equal(a["k"][:, b, o], b0["k"][:, b, o])
    else:
        assert torch.equal(a["k"][:, 1, idx1 + 2:], b0["k"][:, 1, idx1 + 2:])
    ref = before
    for s in range(W):
        row, ref = eng.model.decode_step(view, ref, window[:, s:s + 1], seg_ids=seg,
                                         attend_blocks=ab)
        for lane in (0, 1):
            if s < int(n_valid[lane]):
                np.testing.assert_allclose(logits[lane, s].numpy(), row[lane].numpy(),
                                           atol=VERIFY_TOL, rtol=0)


# ---------------------------------------------------------------------------
# in-place safety: the chip phase's rig and planted faults, on the CPU
# ---------------------------------------------------------------------------


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


RIG_SPECS = [("t1", 19, 12), (BASE_TENANT, 21, 12), ("t2", 19, 10), ("t1", 22, 9)]


def _rig_engine(speculate_k=4):
    """The posture on the reduced config: paged, block 8, prefix sharing
    (the four prompts share a 16-token prefix), watermark 1, monolithic."""
    eng = MultiTenantEngine(_cfg(), EngineConfig(
        layout="paged", n_lanes=2, n_slots=4, max_len=48, block_size=8, share_prefix=True,
        watermark=1, collect_logits=True, speculate_k=speculate_k), params=_params(),
        device="cpu")
    for i in (1, 2):
        eng.add_tenant(f"t{i}", random_lambda(torch.Generator().manual_seed(i), eng.params, 0.3))
    rng = np.random.default_rng(7)
    prefix = rng.integers(2, 256, size=16).astype(np.int32)
    traffic = [(t, np.concatenate([prefix, rng.integers(2, 256, size=P - 16).astype(np.int32)]))
               for t, P, _ in RIG_SPECS]
    return eng, traffic


def _rig_serve(cs, eng, traffic, **kw):
    return cs.spec_serve(eng, traffic, gen=16, **kw)


@pytest.fixture(scope="module")
def rig_plain():
    cs = _chip_smoke()
    eng, traffic = _rig_engine(speculate_k=0)
    return cs, traffic, _rig_serve(cs, eng, traffic)


def test_a_forced_shared_block_caps_the_window_and_keeps_its_bytes(rig_plain):
    cs, traffic, plain = rig_plain
    eng, _ = _rig_engine()
    run = _rig_serve(cs, eng, traffic, force_shared=True)
    assert run["forced"] is not None and run["forced"]["cap"] <= run["forced"]["room"]
    assert run["forced"]["kept"] and run["shared_changed"] == [] and run["covers"]
    assert run["drained"] and cs.spec_blocks_ok(run)
    assert plain["covers"] and plain["drained"]
    assert cs.spec_rows_ok(cs.compare_streams(run, plain))
    assert 0 < run["acceptance"] < 1


def test_the_rig_rejects_a_draft_without_its_write_limit(rig_plain):
    cs = rig_plain[0]
    eng, traffic = _rig_engine()
    sound = eng._draft_cache

    def unlimited(nv):
        view = sound(nv)
        del view["layers"]["attn"]["write_limit"]
        return view

    eng._draft_cache = unlimited
    run = _rig_serve(cs, eng, traffic, force_shared=True)
    assert run["forced"] is not None and not run["forced"]["kept"]
    assert run["forced"]["block"] in run["shared_changed"]
    assert not cs.spec_blocks_ok(run)


def test_a_window_committed_whole_parts_from_the_plain_streams(rig_plain):
    cs, traffic, plain = rig_plain
    eng, _ = _rig_engine()
    eng._accept = lambda decoding, window, greedy, n_valid: n_valid.copy()
    run = _rig_serve(cs, eng, traffic)
    assert not cs.spec_rows_ok(cs.compare_streams(run, plain))


def test_a_window_committed_whole_moves_the_acceptance_counters(rig_plain):
    """The check that does not read logits: a sound serve's counters are
    those of another sound serve of the same traffic, a whole-window
    commit's are not."""
    cs, traffic, _ = rig_plain
    sound = [_rig_serve(cs, _rig_engine()[0], traffic) for _ in range(2)]
    assert cs.spec_counters(sound[0]) == cs.spec_counters(sound[1])
    eng, _ = _rig_engine()
    eng._accept = lambda decoding, window, greedy, n_valid: n_valid.copy()
    run = _rig_serve(cs, eng, traffic)
    assert sound[0]["acceptance"] < run["acceptance"] == 1.0
    assert cs.spec_counters(run) != cs.spec_counters(sound[0])


def test_a_skipped_rollback_leaves_blocks_past_the_kv(rig_plain):
    """The forced block lies past its lane's accepted frontier, so the
    rollback must release it.  The pool still drains (retirement frees every
    block of a lane), so the per-step coverage check is what rejects it."""
    cs, traffic, _ = rig_plain
    eng, _ = _rig_engine()
    eng._rollback_window_blocks = lambda decoding, adv: None
    run = _rig_serve(cs, eng, traffic, force_shared=True)
    assert run["drained"] and not run["covers"] and not cs.spec_blocks_ok(run)


# ---------------------------------------------------------------------------
# the engine config and the driver
# ---------------------------------------------------------------------------

# the reference's speculative cases (tests/test_engine_config.py:44-47)
@pytest.mark.parametrize(
    "kw",
    [
        dict(speculate_k=-1),
        dict(draft_lam_rank=4),  # a drafter needs speculate_k >= 1
        dict(speculate_k=2, draft_lam_rank=0),
        dict(layout="paged", speculate_k=2, prefill_chunk=16),  # verify vs chunk
    ],
    ids=lambda kw: ",".join(f"{k}={v}" for k, v in kw.items()),
)
def test_config_rejects_incoherent_speculation(kw):
    for cls in (EngineConfig, JEngineConfig):
        with pytest.raises(ValueError):
            cls(**kw)


def test_config_accepts_speculation():
    for cls in (EngineConfig, JEngineConfig):
        c = cls(speculate_k=3, draft_lam_rank=2)
        assert (c.speculate_k, c.draft_lam_rank) == (3, 2)
        assert cls.oracle_dense(speculate_k=4, quantum=2).speculate_k == 4


@pytest.mark.parametrize("argv", [
    ["--layout", "paged", "--block-size", "8", "--speculate-k", "3"],
    ["--layout", "oracle_dense", "--speculate-k", "4", "--draft-lam-rank", "2"],
], ids=["paged", "dense_truncated"])
def test_serve_multi_speculative_verifies_every_tenant(argv, capsys):
    done = serve_multi.main(["--reduced", "--device", "cpu", "--tenants", "3", "--lanes", "2",
                             "--gen-len", "6", "--prompt-len", "9", "--max-len", "32", *argv])
    assert len(done) == 3 and all(len(r.tokens) == 6 for r in done.values())
    out = capsys.readouterr().out
    assert "speculative k=" in out and "acceptance=" in out
