"""The port's engine with the λ-store's cold tier against the JAX engine
(reduced smollm-135m, float32, CPU): promote-on-admission, deferral while
every hot slot is pinned, the two-level pins, prefix-family reclamation,
the telemetry of ``tests/test_obs.py:319-357`` and a restart on an mmap
``cold_path`` — the same streams, schedule and tier counters as the JAX
engine on the same traffic; the ``serve_multi`` launcher's ``--cold-slots``;
and ``chip_smoke.py``'s cold-tier rig and its three planted faults at
reduced size."""
import importlib.util
from pathlib import Path

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
from repro_torch.launch import serve_multi
from repro_torch.models import build_model
from repro_torch.serving import (
    BASE_TENANT,
    COLD_SLOT,
    EngineConfig,
    MultiTenantEngine,
    reference_decode,
)

ROOT = Path(__file__).resolve().parents[1]
# float32 through 3 layers, the fused multi-λ path against JAX's: ~5e-6
LOGIT_TOL = 1e-4


@pytest.fixture(scope="module", autouse=True)
def _threads_and_jax_caches():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)
    jax.clear_caches()


@pytest.fixture(scope="module")
def weights():
    """Reduced smollm-135m's JAX params, as numpy, and 8 tenants' λ."""
    jcfg = jax_reduced("smollm-135m").replace(dtype="float32")
    npj = jax.tree_util.tree_map(np.asarray, jax_build(jcfg).init(jax.random.PRNGKey(3)))
    shape = npj["groups"]["adapters"]["attn"]["wq"]["lam"].shape
    rng = np.random.default_rng(1)
    lams = {f"t{i}": {"attn": {p: (rng.standard_normal(shape) * 0.3).astype(np.float32)
                               for p in ("wq", "wv")}} for i in range(1, 9)}
    return jcfg, npj, lams


def _engines(weights, config_kw, preset=None):
    """The JAX engine and the port's on the same params and config."""
    jcfg, npj, _ = weights
    cfg = get_reduced("smollm-135m").replace(dtype="float32")
    jc = (getattr(JEngineConfig, preset) if preset else JEngineConfig)(**config_kw)
    tc = (getattr(EngineConfig, preset) if preset else EngineConfig)(**config_kw)
    jeng = JEngine(jcfg, jc, params=jax.tree_util.tree_map(jnp.asarray, npj))
    teng = MultiTenantEngine(cfg, tc, params=params_from_jax(npj, device="cpu"), device="cpu")
    return jeng, teng


def _drive(eng, lams, traffic, jax_side):
    """Register, submit, step to the end; the per-step delivered events
    (the schedule) and each request's tokens and logits."""
    for t, lam in lams.items():
        eng.add_tenant(t, jax.tree_util.tree_map(jnp.asarray, lam) if jax_side else lam)
    reqs = [eng.submit(t, p, n) for t, p, n in traffic]
    schedule = []
    while eng.scheduler.has_work:
        eng.step()
        schedule.append([(e.uid, e.tenant, e.lane, e.token, e.index, e.done) for e in eng.events])
    return reqs, schedule


def _same_serve(jeng, teng, jout, tout):
    (jreqs, jsched), (treqs, tsched) = jout, tout
    assert tsched == jsched, "schedule differs"
    for jr, tr in zip(jreqs, treqs):
        assert tr.tokens == jr.tokens
        np.testing.assert_allclose(np.stack(tr.logits), np.stack(jr.logits), atol=LOGIT_TOL)
    for name in ("promotes", "spills", "cold_registers", "lru_drops"):
        assert getattr(teng.lam_store, name) == getattr(jeng.lam_store, name), name
    assert teng.deferred_promotions == jeng.deferred_promotions
    assert teng.lam_store.hot_tenants == jeng.lam_store.hot_tenants
    assert teng.lam_store.cold_tenants == jeng.lam_store.cold_tenants


def _traffic(seed, n, tenants, lens=(3, 20), gens=(4, 10)):
    rng = np.random.default_rng(seed)
    return [(tenants[i % len(tenants)],
             rng.integers(2, 256, size=int(rng.integers(*lens))).astype(np.int32),
             int(rng.integers(*gens))) for i in range(n)]


# ---------------------------------------------------------------------------
# the reference's engine tests (tests/test_lam_store.py:436-538)
# ---------------------------------------------------------------------------


def test_engine_promotes_cold_tenant_on_admission(weights):
    """A request for a spilled tenant admits by promoting its λ back into a
    hot slot, and decodes what the JAX engine does and what the port's
    merged-weight reference does."""
    _, _, lams = weights
    kw = dict(n_lanes=1, n_slots=3, max_len=32, cold_slots=8, collect_logits=True)
    jeng, teng = _engines(weights, kw)
    four = {t: lams[t] for t in ("t1", "t2", "t3", "t4")}
    traffic = [("t1", np.random.default_rng(0).integers(2, 256, size=6).astype(np.int32), 4)]
    out = [_drive(e, four, traffic, j) for e, j in ((jeng, True), (teng, False))]
    assert teng.lam_store.promotes >= 1
    _same_serve(jeng, teng, *out)
    req = out[1][0][0]
    toks, logits = reference_decode(teng.cfg, teng.params, lams["t1"], req.prompt, 4, 32)
    assert req.tokens == toks
    np.testing.assert_allclose(np.stack(req.logits), logits, atol=LOGIT_TOL)


def test_engine_defers_admission_until_hot_slot_frees(weights):
    _, _, lams = weights
    kw = dict(n_lanes=2, n_slots=2, max_len=32, cold_slots=4, collect_logits=True)
    jeng, teng = _engines(weights, kw)
    rng = np.random.default_rng(0)
    traffic = [("t2", rng.integers(2, 256, size=5).astype(np.int32), 8),
               ("t1", rng.integers(2, 256, size=5).astype(np.int32), 4)]
    two = {t: lams[t] for t in ("t1", "t2")}
    out = []
    for eng, j in ((jeng, True), (teng, False)):
        for t, lam in two.items():
            eng.add_tenant(t, jax.tree_util.tree_map(jnp.asarray, lam) if j else lam)
        assert eng.lam_store.is_cold("t1")  # t2 took the single usable hot slot
        r2, r1 = (eng.submit(t, p, n) for t, p, n in traffic)
        eng.step()  # t2 admits and pins the only slot; t1 waits
        assert r2.lane >= 0 and r1.lane < 0
        rest = []
        while eng.scheduler.has_work:
            eng.step()
            rest.append([(e.uid, e.lane, e.token) for e in eng.events])
        out.append(((r2, r1), rest))
    assert out[0][1] == out[1][1]
    assert teng.deferred_promotions == jeng.deferred_promotions >= 1
    assert [len(r.tokens) for r in out[1][0]] == [8, 4]


def test_hot_swap_and_removal_drop_stale_prefix_families(weights):
    """Prefix-cache entries keyed on a retired λ digest go at once, but only
    once no resident tenant carries it, in both engines alike."""
    _, _, lams = weights
    kw = dict(layout="paged", n_lanes=2, n_slots=4, max_len=32, block_size=8, share_prefix=True)
    prompt = np.random.default_rng(0).integers(2, 256, size=16).astype(np.int32)
    for eng, j in zip(_engines(weights, kw), (True, False)):
        conv = (lambda lam: jax.tree_util.tree_map(jnp.asarray, lam)) if j else (lambda lam: lam)
        eng.add_tenant("t1", conv(lams["t1"]))
        eng.add_tenant("t2", conv(lams["t1"]))  # the same λ: one family
        eng.submit("t1", prompt, 4)
        eng.run()
        assert len(eng.prefix_cache) == 2 and eng.blocks_in_use() == 2
        eng.add_tenant("t1", conv(lams["t2"]))
        assert len(eng.prefix_cache) == 2, "family dropped while a tenant still holds it"
        eng.remove_tenant("t2")
        assert len(eng.prefix_cache) == 0 and eng.blocks_in_use() == 0


def test_implicit_lru_drop_reclaims_prefix_family(weights):
    _, _, lams = weights
    kw = dict(layout="paged", n_lanes=1, n_slots=2, max_len=32, cold_slots=1, block_size=8,
              share_prefix=True)
    prompt = np.random.default_rng(0).integers(2, 256, size=16).astype(np.int32)
    for eng, j in zip(_engines(weights, kw), (True, False)):
        conv = (lambda lam: jax.tree_util.tree_map(jnp.asarray, lam)) if j else (lambda lam: lam)
        eng.add_tenant("t1", conv(lams["t1"]))
        eng.submit("t1", prompt, 4)
        eng.run()
        assert len(eng.prefix_cache) == 2 and eng.blocks_in_use() == 2
        # t2 spills t1 to the 1-slot cold tier; t3 then needs that room and
        # drops t1, whose cached prefix blocks must come back
        eng.add_tenant("t2", conv(lams["t2"]))
        assert eng.lam_store.is_cold("t1") and len(eng.prefix_cache) == 2
        assert eng.add_tenant("t3", conv(lams["t3"])) != COLD_SLOT
        assert "t1" not in eng.lam_store and eng.lam_store.lru_drops == 1
        assert len(eng.prefix_cache) == 0 and eng.blocks_in_use() == 0


# ---------------------------------------------------------------------------
# telemetry (tests/test_obs.py:319-357) and mixed traffic under the posture
# ---------------------------------------------------------------------------


def _series(snap, name):
    return {tuple(sorted(s["labels"].items())): s.get("value", s.get("count"))
            for s in snap[name]["series"]}


def test_engine_deferred_promotions_back_compat_property(weights):
    _, _, lams = weights
    kw = dict(n_lanes=2, n_slots=2, max_len=32, cold_slots=4)
    jeng, teng = _engines(weights, kw)
    snaps = []
    for eng, j in ((jeng, True), (teng, False)):
        for t in ("t1", "t2"):
            eng.add_tenant(t, jax.tree_util.tree_map(jnp.asarray, lams[t]) if j else lams[t])
        eng.submit("t1", np.arange(2, 8, dtype=np.int32), 8)
        r = eng.submit("t2", np.arange(2, 8, dtype=np.int32), 4)
        eng.run()
        assert eng.deferred_promotions >= 1
        snap = eng.metrics()
        by_cause = {s["labels"]["cause"]: s["value"]
                    for s in snap["serve_deferrals_total"]["series"]}
        assert by_cause["cold_promote"] == float(eng.deferred_promotions)
        assert "defer" in r.trace.names()
        assert snap["lam_hot_slots_capacity"]["series"][0]["value"] == 1.0
        assert snap["lam_promotes_total"]["series"][0]["value"] == float(eng.lam_store.promotes)
        snaps.append(snap)
    lam_series = sorted(n for n in snaps[0] if n.startswith("lam_"))
    assert lam_series == sorted(n for n in snaps[1] if n.startswith("lam_"))
    for name in lam_series + ["serve_deferrals_total"]:
        if name not in ("lam_table_bytes",):  # the port's slot axis is padded alike
            assert _series(snaps[1], name) == _series(snaps[0], name), name
    assert teng.deferred_promotions == jeng.deferred_promotions


def test_engine_disabled_telemetry_still_dedups_deferrals(weights):
    """Telemetry off: the property reads 0, as the reference's does, and
    serving is unaffected."""
    _, _, lams = weights
    cfg = get_reduced("smollm-135m").replace(dtype="float32")
    eng = MultiTenantEngine(cfg, EngineConfig(n_lanes=2, n_slots=2, max_len=32, cold_slots=4,
                                              telemetry=False),
                            params=params_from_jax(weights[1], device="cpu"), device="cpu")
    for t in ("t1", "t2"):
        eng.add_tenant(t, lams[t])
    eng.submit("t1", np.arange(2, 8, dtype=np.int32), 8)
    r = eng.submit("t2", np.arange(2, 8, dtype=np.int32), 4)
    eng.run()
    assert eng.deferred_promotions == 0 and eng.metrics() == {}
    assert len(r.tokens) == 4 and eng.lam_store.promotes >= 1


@pytest.mark.parametrize("preset,kw", [
    ("serving", dict(n_lanes=3, n_slots=3, max_len=64, block_size=8, cold_slots=6,
                     collect_logits=True)),
    ("oracle_dense", dict(n_lanes=3, n_slots=3, max_len=64, cold_slots=6, quantum=3,
                          collect_logits=True)),
])
def test_mixed_traffic_matches_jax_engine(weights, preset, kw):
    """Eight tenants behind two hot slots under the serving posture (prefix
    sharing, chunked prefill, the watermark) and under the time-sliced dense
    layout: the same per-step events, tokens, tier counters, deferrals and
    final tiers as the JAX engine, logits within the float32 bar."""
    _, _, lams = weights
    jeng, teng = _engines(weights, kw, preset)
    traffic = _traffic(5, 12, [f"t{i}" for i in range(1, 9)])
    out = [_drive(e, lams, traffic, j) for e, j in ((jeng, True), (teng, False))]
    assert teng.lam_store.promotes > 0 and teng.lam_store.spills > 0
    assert teng.deferred_promotions > 0
    _same_serve(jeng, teng, *out)
    assert teng.lam_store._pins == {BASE_TENANT: 1} and not teng.lam_store._protect


def test_cancel_and_preemption_release_both_pin_levels(weights):
    """Cancel of a queued and an active request, and block-pressure
    preemption, under the cold tier: the pins and protects drop as the
    JAX engine drops them."""
    _, _, lams = weights
    kw = dict(n_lanes=2, n_slots=3, max_len=48, block_size=8, n_blocks=7, cold_slots=6,
              collect_logits=True)
    jeng, teng = _engines(weights, kw, "serving")
    traffic = _traffic(9, 6, ["t1", "t2", "t3"], lens=(10, 30), gens=(8, 16))
    states = []
    for eng, j in ((jeng, True), (teng, False)):
        for t in ("t1", "t2", "t3"):
            eng.add_tenant(t, jax.tree_util.tree_map(jnp.asarray, lams[t]) if j else lams[t])
        reqs = [eng.submit(t, p, n) for t, p, n in traffic]
        eng.step()
        eng.cancel(reqs[-1])  # queued
        eng.cancel(reqs[0])  # active
        mid = (dict(eng.lam_store._pins), dict(eng.lam_store._protect))
        eng.run()
        states.append((mid, dict(eng.lam_store._pins), dict(eng.lam_store._protect),
                       eng.preemptions, [r.tokens for r in reqs]))
    assert states[0] == states[1]
    assert states[1][1] == {BASE_TENANT: 1} and not states[1][2]


# ---------------------------------------------------------------------------
# restart on an mmap cold_path
# ---------------------------------------------------------------------------


def test_restart_on_cold_path_serves_the_same_tokens(weights, tmp_path):
    """An engine's cold tier on an mmap file: a second engine opened on it
    (its own package's, and the JAX engine on the port's file) finds the
    spilled tenants and digests and serves them the same tokens."""
    _, npj, lams = weights
    cfg = get_reduced("smollm-135m").replace(dtype="float32")
    path = str(tmp_path / "cold.lam")
    kw = dict(n_lanes=2, n_slots=3, max_len=32, cold_slots=8, collect_logits=True)
    traffic = _traffic(2, 4, ["t1", "t2", "t3", "t4"])
    first = MultiTenantEngine(cfg, EngineConfig(cold_path=path, **kw),
                              params=params_from_jax(npj, device="cpu"), device="cpu")
    reqs, _ = _drive(first, {t: lams[t] for t in ("t1", "t2", "t3", "t4")}, traffic, False)
    cold = first.lam_store.cold_tenants
    digests = {t: first.lam_store.digest(t) for t in cold}
    assert cold
    del first
    again = MultiTenantEngine(cfg, EngineConfig(cold_path=path, **kw),
                              params=params_from_jax(npj, device="cpu"), device="cpu")
    assert again.lam_store.cold_tenants == cold
    assert {t: again.lam_store.digest(t) for t in cold} == digests
    missing = {t: lams[t] for t in ("t1", "t2", "t3", "t4") if t not in again.lam_store}
    reqs2, _ = _drive(again, missing, traffic, False)
    assert [r.tokens for r in reqs2] == [r.tokens for r in reqs]
    del again
    jeng = JEngine(jax_reduced("smollm-135m").replace(dtype="float32"),
                   JEngineConfig(cold_path=path, **kw),
                   params=jax.tree_util.tree_map(jnp.asarray, npj))
    assert set(jeng.lam_store.cold_tenants) <= {"t1", "t2", "t3", "t4"}
    missing = {t: lams[t] for t in ("t1", "t2", "t3", "t4") if t not in jeng.lam_store}
    reqs3, _ = _drive(jeng, missing, traffic, True)
    assert [r.tokens for r in reqs3] == [r.tokens for r in reqs]


# ---------------------------------------------------------------------------
# the launcher and the chip-smoke rig
# ---------------------------------------------------------------------------


def test_serve_multi_verifies_a_cold_tier_serve(capsys):
    done = serve_multi.main(["--reduced", "--device", "cpu", "--tenants", "6", "--slots", "3",
                             "--cold-slots", "8", "--gen-len", "6"])
    out = capsys.readouterr().out
    assert len(done) == 6 and "all 6 tenants match merged-weight refs" in out
    assert "λ-store tiers: hot=2 slots" in out and "λ churn:" in out
    with pytest.raises(SystemExit):  # more tenants than hot + cold hold
        serve_multi.main(["--reduced", "--device", "cpu", "--tenants", "9", "--slots", "3",
                          "--cold-slots", "4"])


def test_serve_multi_gives_each_replica_its_own_cold_file(tmp_path, capsys):
    path = tmp_path / "cold.lam"
    serve_multi.main(["--reduced", "--device", "cpu", "--tenants", "5", "--slots", "3",
                      "--cold-slots", "6", "--gen-len", "4", "--replicas", "2",
                      "--cold-path", str(path)])
    assert "all 5 routed tenants match" in capsys.readouterr().out
    assert (tmp_path / "cold.lam.r0").exists() and (tmp_path / "cold.lam.r1").exists()
    assert not (tmp_path / "cold.lam").exists()


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture(scope="module")
def rig():
    """chip_smoke.py's cold-tier rig at reduced qwen2-0.5b (float32, CPU):
    the 2-hot-slot serve, its all-hot twin, the faults and the restart."""
    cs = _chip_smoke()
    cfg = get_reduced("qwen2-0.5b").replace(dtype="float32")
    params = build_model(cfg, "cpu").init(torch.Generator().manual_seed(0))
    lams = cs.cold_lams(0, params)
    traffic = cs.cold_traffic(0, cfg.vocab_size)
    cold = cs.cold_serve(cs.cold_engine(cfg, params, 0), lams, traffic)
    hot = cs.cold_serve(cs.cold_engine(cfg, params, 0, **cs.COLD_ALL_HOT), lams, traffic)
    return cs, cfg, params, lams, traffic, cold, hot


def test_chip_smoke_cold_rig_promotes_spills_and_defers(rig):
    cs, _, _, _, traffic, cold, hot = rig
    assert cold["promotes"] > 0 and cold["spills"] > 0 and cold["deferred_promotions"] > 0
    assert cold["gates"]["spilled_and_promoted"] > 0
    assert hot["promotes"] == hot["spills"] == hot["deferred_promotions"] == 0
    for run in (cold, hot):
        assert run["all_served"] and run["drained"] and run["slot_held"] and run["cold_bytes_ok"]
    rows = cs.compare_streams(cold, hot)
    assert cs.chunk_rows_ok(rows, "float32") and len(rows) == len(traffic)


def test_chip_smoke_cold_restart_holds(rig, tmp_path):
    cs, cfg, params, lams, traffic, _, _ = rig
    res = cs.cold_restart(cfg, params, 0, lams, traffic, str(tmp_path))
    assert res["ok"] and res["found"] and res["promoted_bitwise"], res


def test_chip_smoke_cold_planted_faults_are_rejected(rig):
    cs, cfg, params, lams, traffic, _, hot = rig
    faults = cs.cold_faults(cfg, params, 0, lams, traffic, hot)
    assert set(faults) == {"promotion_skips_its_write", "promotion_returns_another_slot",
                           "lane_holds_no_pin"}
    for name, f in faults.items():
        assert f["rejected"] and "raised" not in f, (name, f)  # rejected by the checks
    assert not faults["lane_holds_no_pin"]["slot_held"]
