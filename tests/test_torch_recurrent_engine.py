"""The recurrent families through the serving engine: the port's
``MultiTenantEngine`` beside the JAX package's on the same reduced
xlstm-125m and jamba-1.5-large-398b weights, tenants and traffic
(``tests/test_serving.py``'s ``FAMILY_SPECS`` cases: xlstm, hybrid dense,
hybrid paged; the xlstm case and the xlstm quantum tests are
``test_torch_xlstm_engine.py``'s), then the reference's recurrent-engine
tests port against port: hybrid paged bitwise hybrid dense, hybrid
preemption, the family gates (no paged ssm, no chunked or shipped
recurrent prefill, the router never disaggregates them) and the lane reset
of ``m`` to -1e30.

Bound: logits within 1e-4 of the JAX engine (``test_torch_serving.py``'s
engine bar) with identical streams and schedules; port against port the
comparisons are bitwise."""
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
from repro_torch.models.lane_state import extract_lane
from repro_torch.serving import (BASE_TENANT, EngineConfig, MultiTenantEngine, Router,
                                 build_replicas, random_lambda, reference_decode)

XLSTM, JAMBA = "xlstm-125m", "jamba-1.5-large-398b"
LOGIT_TOL = 1e-4
# mixed prompt lengths across buckets (8 and 16) with mid-stream lane reuse
FAMILY_SPECS = [(BASE_TENANT, 6, 4), ("t1", 9, 5), ("t2", 7, 3), ("t1", 13, 4)]


@pytest.fixture(scope="module", autouse=True)
def _threads_and_jax_caches():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)
    jax.clear_caches()


_WEIGHTS = {}


def _weights(arch):
    """Reduced float32 JAX params as numpy leaves and two tenants' λ."""
    if arch not in _WEIGHTS:
        jcfg = jax_reduced(arch).replace(dtype="float32")
        npj = jax.tree_util.tree_map(np.asarray, jax_build(jcfg).init(jax.random.PRNGKey(0)))
        rng = np.random.default_rng(5)
        lams = {t: {mod: {p: (rng.standard_normal(leaf["lam"].shape) * 0.3).astype(np.float32)
                          for p, leaf in projs.items()}
                    for mod, projs in npj["groups"]["adapters"].items()}
                for t in ("t1", "t2")}
        _WEIGHTS[arch] = (npj, lams)
    return _WEIGHTS[arch]


def _prompts(specs, vocab):
    rng = np.random.default_rng(3)
    return [(t, rng.integers(2, vocab, size=P).astype(np.int32), G) for t, P, G in specs]


def _serve_both(arch, conf, specs=FAMILY_SPECS):
    """Both engines under the EngineConfig fields ``conf``: each engine, its
    requests in submission order, its per-step schedule."""
    npj, lams = _weights(arch)
    jcfg = jax_reduced(arch).replace(dtype="float32")
    cfg = get_reduced(arch).replace(dtype="float32")
    jeng = JEngine(jcfg, JEngineConfig(**conf), params=jax.tree_util.tree_map(jnp.asarray, npj))
    teng = MultiTenantEngine(cfg, EngineConfig(**conf), params=params_from_jax(npj, device="cpu"),
                             device="cpu")
    out = []
    for eng, to_lam in ((jeng, lambda t: jax.tree_util.tree_map(jnp.asarray, t)),
                        (teng, lambda t: params_from_jax(t, device="cpu"))):
        for t, lam in lams.items():
            eng.add_tenant(t, to_lam(lam))
        reqs = [eng.submit(t, p, n) for t, p, n in _prompts(specs, cfg.vocab_size)]
        sched = []
        while eng.scheduler.has_work:
            eng.step()
            sched.append([(e.uid, e.lane, e.token, e.index) for e in eng.events])
        out.append((eng, reqs, sched))
    return out


_CASES = {
    "xlstm": (XLSTM, {}),
    "hybrid-dense": (JAMBA, {}),
    "hybrid-paged": (JAMBA, dict(layout="paged", block_size=8)),
}


@pytest.mark.parametrize("case", ["hybrid-dense", "hybrid-paged"])
def test_engines_match_on_family_specs(case):
    """``tests/test_serving.py:299-313`` with the JAX engine beside the
    port's: identical streams and schedules, logits within 1e-4, and the
    port's streams token-identical to its merged-weight references (the
    xlstm case: ``test_torch_xlstm_engine.py``)."""
    check_engines_on_family_specs(case)


def check_engines_on_family_specs(case):
    arch, kw = _CASES[case]
    conf = dict(n_lanes=2, n_slots=4, max_len=48, collect_logits=True,
                layout=kw.get("layout", "oracle_dense"), **{k: v for k, v in kw.items()
                                                             if k != "layout"})
    (jeng, jreqs, jsched), (teng, treqs, tsched) = _serve_both(arch, conf)
    assert tsched == jsched
    assert teng.steps == jeng.steps and teng.decoded_tokens == jeng.decoded_tokens
    worst = 0.0
    for jr, tr in zip(jreqs, treqs):
        assert tr.tokens == jr.tokens
        worst = max(worst, float(np.abs(np.stack(tr.logits) - np.stack(jr.logits)).max()))
    print(f"[parity] {arch} {case} engine vs JAX engine: logits max|Δ| {worst:.2e}")
    assert worst < LOGIT_TOL
    _, lams = _weights(arch)
    cfg = teng.cfg
    lam_of = {BASE_TENANT: None, **lams}
    for (t, prompt, G), req in zip(_prompts(FAMILY_SPECS, cfg.vocab_size), treqs):
        lam = lam_of[t]
        if lam is None:
            lam = {m: {p: torch.zeros_like(torch.from_numpy(v)) for p, v in projs.items()}
                   for m, projs in lams["t1"].items()}
        else:
            lam = params_from_jax(lam, device="cpu")
        toks, logits = reference_decode(cfg, teng.params, lam, prompt, G, 48)
        assert req.tokens == toks
        np.testing.assert_allclose(np.stack(req.logits), logits, atol=LOGIT_TOL, rtol=LOGIT_TOL)
    assert teng.kv_cache_bytes() == jeng.kv_cache_bytes()
    if teng.paged:
        assert teng.allocator.n_free == teng.allocator.capacity == jeng.allocator.n_free


def _run_family_engine(arch, **config_kw):
    cfg = get_reduced(arch).replace(dtype="float32")
    config_kw.setdefault("layout", "oracle_dense")
    eng = MultiTenantEngine(cfg, EngineConfig(n_lanes=2, n_slots=4, max_len=48,
                                              collect_logits=True, **config_kw), device="cpu")
    for i in (1, 2):
        eng.add_tenant(f"t{i}", random_lambda(torch.Generator().manual_seed(i), eng.params, 0.3))
    reqs = [eng.submit(t, p, G) for t, p, G in _prompts(FAMILY_SPECS, cfg.vocab_size)]
    eng.run()
    return eng, reqs


def test_hybrid_paged_bit_identical_to_dense():
    """``tests/test_serving.py:316``, port against port: paging the hybrid's
    attention layers is a layout change only, tokens and logits bitwise."""
    _, dense = _run_family_engine(JAMBA)
    eng, paged = _run_family_engine(JAMBA, layout="paged", block_size=8)
    assert eng.allocator.n_free == eng.allocator.capacity
    for d, p in zip(dense, paged):
        assert d.tokens == p.tokens
        np.testing.assert_array_equal(np.stack(d.logits), np.stack(p.logits))


def test_hybrid_paged_preemption_recovers():
    """``tests/test_serving.py:332``: pool pressure preempts the youngest
    hybrid lane (blocks freed, Mamba state reset) and re-derives its output
    exactly."""
    cfg = get_reduced(JAMBA).replace(dtype="float32")

    def run(n_blocks):
        eng = MultiTenantEngine(cfg, EngineConfig(
            layout="paged", n_lanes=2, n_slots=2, max_len=32, collect_logits=True,
            block_size=8, n_blocks=n_blocks), device="cpu")
        a = eng.submit(BASE_TENANT, np.arange(2, 10, dtype=np.int32), 16)
        b = eng.submit(BASE_TENANT, np.arange(12, 20, dtype=np.int32), 16)
        eng.run()
        assert eng.allocator.n_free == eng.allocator.capacity
        return eng, a, b

    eng_big, a_big, b_big = run(1 + 8)  # uncontended
    assert eng_big.preemptions == 0
    eng, a, b = run(1 + 5)  # the two collide crossing position 16
    assert eng.preemptions >= 1 and b.preemptions >= 1 and a.preemptions == 0
    for got, want in ((a, a_big), (b, b_big)):
        assert got.tokens == want.tokens
        np.testing.assert_array_equal(np.stack(got.logits), np.stack(want.logits))


def test_family_gates():
    """``tests/test_serving.py`` family gates: ssm has nothing to page; the
    auto layout serves it dense and pages the hybrid; speculation is
    refused for both."""
    with pytest.raises(ValueError, match="has none"):
        MultiTenantEngine(get_reduced(XLSTM), EngineConfig(layout="paged", n_lanes=1, n_slots=2),
                          device="cpu")
    assert EngineConfig().resolved_layout("ssm") == "oracle_dense"
    assert EngineConfig().resolved_layout("hybrid") == "paged"
    for arch in (XLSTM, JAMBA):
        with pytest.raises(ValueError, match="cannot rewind"):
            MultiTenantEngine(get_reduced(arch), EngineConfig(n_lanes=1, n_slots=2, max_len=16,
                                                              speculate_k=2), device="cpu")


def test_hybrid_prompt_prefills_in_one_pass_and_ships_nowhere():
    """``_chunkable``: with ``prefill_chunk`` set a long hybrid prompt still
    prefills in one pass (and serves what the unchunked engine serves,
    bitwise); ``inject_prefilled`` refuses the family; the router never
    sends its prompts to a prefill replica."""
    cfg = get_reduced(JAMBA).replace(dtype="float32")
    prompt = np.arange(2, 42, dtype=np.int32)  # 40 tokens: 5 blocks, > 2 chunks of 8
    runs = []
    for chunk in (None, 8):
        eng = MultiTenantEngine(cfg, EngineConfig(layout="paged", n_lanes=2, n_slots=2,
                                                  max_len=64, block_size=8, collect_logits=True,
                                                  prefill_chunk=chunk), device="cpu")
        req = eng.submit(BASE_TENANT, prompt, 4)
        eng.run()
        assert eng.chunked_admissions == 0 and eng.chunk_dispatches == 0
        runs.append(req)
    assert runs[0].tokens == runs[1].tokens
    np.testing.assert_array_equal(np.stack(runs[0].logits), np.stack(runs[1].logits))
    with pytest.raises(ValueError, match="cannot be disaggregated"):
        eng.inject_prefilled(BASE_TENANT, prompt, 4, {"block_size": 8})
    replicas = build_replicas(cfg, EngineConfig(layout="paged", n_lanes=2, n_slots=2,
                                                max_len=64, block_size=8), 2,
                              params=eng.params, device="cpu")
    router = Router(replicas, disaggregate=True, telemetry=False)
    assert replicas[0].role == "prefill" and replicas[0].engine.paged
    assert not router._disagg_eligible(prompt[:9], 4)
    router.add_tenant("t1", random_lambda(torch.Generator().manual_seed(1), eng.params, 0.3))
    req = router.submit("t1", prompt[:9], 4)
    router.run()
    assert req.phase != "prefill" and req.replica.role == "decode"


@pytest.mark.parametrize("arch", [XLSTM, JAMBA])
def test_lane_reset_restores_the_initial_state(arch):
    """A retired lane is reset to the fresh 1-lane state (dense xlstm lanes
    are overwritten by the next admission, so the check reads the snapshot
    the engine resets from): mLSTM/sLSTM ``m`` at -1e30, not zero."""
    cfg = get_reduced(arch).replace(dtype="float32")
    eng = MultiTenantEngine(cfg, EngineConfig(n_lanes=2, n_slots=2, max_len=32), device="cpu")
    snap = eng._init_snap["layers"]
    if arch == XLSTM:
        for key in ("mlstm", "slstm"):
            assert torch.all(snap[key]["m"] == -1e30)
            assert snap[key]["m"].dtype == torch.float32
    eng.submit(BASE_TENANT, np.arange(2, 11, dtype=np.int32), 3)
    eng.run()
    lane = extract_lane(eng.cache, eng._axes, 0)
    if arch == XLSTM:
        # the retired lane still holds its request's state: m moved off -1e30
        assert not torch.all(lane["layers"]["mlstm"]["m"] == -1e30)
        from repro_torch.models.lane_state import reset_lane
        reset_lane(eng.cache, eng._axes, 0, eng._init_snap)
        lane = extract_lane(eng.cache, eng._axes, 0)
        assert torch.all(lane["layers"]["mlstm"]["m"] == -1e30)
        assert torch.all(lane["layers"]["slstm"]["m"] == -1e30)
        assert torch.all(lane["layers"]["mlstm"]["C"] == 0)
    else:
        # paged hybrid lanes are reset at retirement: Mamba state zero again
        assert torch.all(lane["layers"]["mamba"]["h"] == 0)
        assert torch.all(lane["layers"]["mamba"]["conv"] == 0)
