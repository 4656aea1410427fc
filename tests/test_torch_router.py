"""Multi-replica serving of the PyTorch port (reduced smollm-135m, CPU): the
port's copies of the five tests of ``tests/test_router.py`` — deterministic
λ-digest placement on the consistent ring, routed output token-identical to
one engine in both layouts, spillover with a prefix import from the home
replica, replica-failure re-placement, and disaggregated prefill→decode
bitwise a monolithic engine with no prompt recompute — plus the port's
router and the reference's over the same replicas' weights and jobs (the
same replica for every digest, the same tokens), the transport meter, the
replica device groups, the ``multi_replica`` bench at the smoke scale and
the ``--replicas`` driver.

Bounds: routed tokens equal a single engine's (port against port, and the
port's router against the reference's); the disaggregated stream's logits
bitwise the monolithic engine's, as the reference asserts."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced as jax_reduced
from repro.models import build_model as jax_build
from repro.serving import EngineConfig as JEngineConfig
from repro.serving import Router as JRouter
from repro.serving import build_replicas as j_build_replicas
from repro.serving.replica import payload_nbytes as j_payload_nbytes
from repro_torch.benchmarks import common, run
from repro_torch.configs import get_reduced
from repro_torch.interop import params_from_jax
from repro_torch.launch import serve_multi
from repro_torch.serving import (
    EngineConfig,
    EngineReplica,
    LocalTransport,
    MultiTenantEngine,
    Router,
    build_replicas,
    payload_nbytes,
    random_lambda,
)
from repro_torch.serving.router import DEFAULT_VNODES, PID_ROUTER
from repro_torch.sharding.rules import replica_device_groups


@pytest.fixture(scope="module", autouse=True)
def _clear_jax_caches():
    yield
    jax.clear_caches()


def _paged(**over):
    kw = dict(layout="paged", n_lanes=2, n_slots=6, max_len=48, block_size=8,
              share_prefix=True, prefill_chunk=8)
    kw.update(over)
    return EngineConfig(**kw)


def _replicas(econf, n, **kw):
    return build_replicas(get_reduced("smollm-135m"), econf, n, device="cpu", **kw)


def _lam(params, seed, scale=0.2):
    return random_lambda(torch.Generator().manual_seed(seed), params, scale)


def _single(econf, params, lams):
    eng = MultiTenantEngine(get_reduced("smollm-135m"), econf, params=params, device="cpu")
    eng.add_tenants(lams)
    return eng


# ---------------------------------------------------------------------------
# placement: deterministic, balanced, minimally disruptive on ring change
# ---------------------------------------------------------------------------


def test_placement_deterministic_and_minimally_disruptive():
    """Any front-end computes the same ring, every replica owns a share of
    the digest space, and removing a replica moves only the digests it
    owned."""
    eng = MultiTenantEngine(get_reduced("smollm-135m"), _paged(), device="cpu")

    def mk_router(n):
        return Router([EngineReplica(i, eng) for i in range(n)], telemetry=False)

    rng = np.random.default_rng(0)
    digests = [rng.integers(0, 256, 20, dtype=np.uint8).tobytes() for _ in range(256)]
    ra, rb = mk_router(3), mk_router(3)
    owners = [ra.owner_of(d).name for d in digests]
    assert owners == [rb.owner_of(d).name for d in digests]
    assert set(owners) == {"r0", "r1", "r2"}
    ra.kill_replica(2)
    for d, before in zip(digests, owners):
        after = ra.owner_of(d).name
        if before == "r2":
            assert after in ("r0", "r1")
        else:
            assert after == before, "killing r2 moved a digest r2 never owned"


# ---------------------------------------------------------------------------
# token identity: routed == single engine, paged and dense layouts
# ---------------------------------------------------------------------------

JOBS = [(17, 4), (9, 3), (24, 5), (12, 4), (20, 3), (8, 2)]


def _jobs(vocab):
    rng = np.random.default_rng(5)
    return [(f"t{1 + i % 3}", rng.integers(2, vocab, size=P).astype(np.int32), G)
            for i, (P, G) in enumerate(JOBS)]


@pytest.mark.parametrize("layout_kw", [
    dict(layout="paged", block_size=8, share_prefix=True, prefill_chunk=8),
    dict(layout="oracle_dense"),
], ids=["paged", "oracle_dense"])
def test_routed_tokens_identical_to_single_engine(layout_kw):
    econf = EngineConfig(n_lanes=2, n_slots=6, max_len=48, **layout_kw)
    replicas = _replicas(econf, 2)
    params = replicas[0].engine.params
    assert all(r.engine.params is params for r in replicas), "replicas copied the weights"
    router = Router(replicas)
    lams = {f"t{i}": _lam(params, i) for i in (1, 2, 3)}
    router.add_tenants(lams)
    jobs = _jobs(get_reduced("smollm-135m").vocab_size)
    routed = [router.submit(t, p, g) for t, p, g in jobs]
    router.run()
    ref_eng = _single(econf, params, lams)
    refs = [ref_eng.submit(t, p, g) for t, p, g in jobs]
    ref_eng.run()
    for r, ref in zip(routed, refs):
        assert r.finished, r
        assert r.tokens == ref.tokens, f"routed {r} diverged from the single-engine reference"
    assert {r.replica.name for r in routed} == {"r0", "r1"}, "one replica served everything"


# ---------------------------------------------------------------------------
# spillover + cross-replica prefix import
# ---------------------------------------------------------------------------


def test_spillover_imports_prefix_from_home_replica():
    """A spilled request costs one block-ship, not a re-prefill: the home
    replica's cached prompt prefix is shipped into the spill target before
    submission, and the spilled output matches the primary's."""
    replicas = _replicas(_paged(n_lanes=1, n_slots=4), 2)
    params = replicas[0].engine.params
    router = Router(replicas, spill_threshold=0)  # any load gap spills
    router.add_tenant("fam", _lam(params, 1))
    home = router.owner_of(router.digest("fam"))
    sibling = next(r for r in router.replicas if r is not home)
    prompt = np.random.default_rng(0).integers(2, 256, size=24).astype(np.int32)

    first = router.submit("fam", prompt, 3)
    router.run()  # home prefills and caches the 3 full prompt blocks
    assert first.replica is home and first.finished
    r_primary = router.submit("fam", prompt, 3)  # loads equal → primary
    r_spill = router.submit("fam", prompt, 3)  # home 1 deep → spills
    assert r_primary.replica is home
    assert r_spill.replica is sibling
    stats = router.transport.stats()
    assert stats["shipments"].get("prefix", 0) == 1, stats
    assert stats["bytes"]["prefix"] > 0
    assert len(sibling.engine.prefix_cache) >= 3, "the spill target adopted no shipped block"
    router.run()
    assert r_spill.finished and r_spill.tokens == r_primary.tokens
    assert 0.0 < router.placement_hit_rate() < 1.0  # the spill was counted


# ---------------------------------------------------------------------------
# replica failure: orphans re-place on survivors and finish identically
# ---------------------------------------------------------------------------


def test_replica_failure_replaces_and_finishes_identically():
    econf = _paged()
    replicas = _replicas(econf, 3)
    params = replicas[0].engine.params
    router = Router(replicas)
    lams = {f"t{i}": _lam(params, i) for i in (1, 2)}
    router.add_tenants(lams)
    rng = np.random.default_rng(2)
    prompts = {t: rng.integers(2, 256, size=16).astype(np.int32) for t in lams}
    routed = [router.submit(t, prompts[t], 6) for t in lams for _ in range(2)]
    for _ in range(2):
        router.step()  # mid-flight: nothing can have finished (gen=6)
    victim = routed[0].replica
    orphans = [r for r in routed if r.replica is victim and not r.finished]
    assert orphans, "the victim replica carried no work"
    assert router.kill_replica(victim.replica_id) == len(orphans)
    assert router.kill_replica(victim.replica_id) == 0  # idempotent
    router.run()

    ref_eng = _single(econf, params, lams)
    refs = [ref_eng.submit(t, prompts[t], 6) for t in lams for _ in range(2)]
    ref_eng.run()
    for r, ref in zip(routed, refs):
        assert r.finished and r.replica.alive, r
        assert r.tokens == ref.tokens, f"failover changed the output of {r}"
    for r in orphans:
        assert r.placements == 2, "an orphan was not re-placed exactly once"
    snap = router.registry.snapshot()["router_placements_total"]["series"]
    assert sum(s["value"] for s in snap if s["labels"]["outcome"] == "failover") == len(orphans)
    m = router.metrics()
    assert m["replicas"][victim.name]["alive"] is False
    assert all(m["replicas"][r.name]["alive"] for r in router.replicas if r is not victim)


# ---------------------------------------------------------------------------
# disaggregation: prefill replica → decode replica, bitwise, no prompt
# recompute on the decode side
# ---------------------------------------------------------------------------


def test_disaggregated_handoff_bit_identical_zero_recompute():
    econf = _paged(n_slots=4, max_len=64, collect_logits=True)
    replicas = _replicas(econf, 2)
    params = replicas[0].engine.params
    router = Router(replicas, disaggregate=True)
    assert [r.role for r in router.replicas] == ["prefill", "decode"]
    lam = _lam(params, 1)
    router.add_tenant("fam", lam)
    prompt = np.random.default_rng(4).integers(2, 256, size=24).astype(np.int32)
    routed = [router.submit("fam", prompt, 5) for _ in range(2)]
    router.run()

    eng = _single(econf, params, {"fam": lam})
    ref = eng.submit("fam", prompt, 5)
    eng.run()
    decode_rep = router.replicas[1]
    for r in routed:
        assert r.finished and r.replica is decode_rep, r
        assert r.placements == 2 and r.phase == "decode"
        assert r.tokens == ref.tokens
        # the first logits row is the very row the prefill replica committed
        np.testing.assert_array_equal(np.stack(r.engine_req.logits), np.stack(ref.logits))
    assert decode_rep.engine.prefill_compilations == 0, (
        "the decode replica prefilled a bucket: the handoff recomputed the prompt")
    stats = router.transport.stats()
    assert stats["shipments"].get("prefill", 0) == len(routed), stats
    snap = router.registry.snapshot()["router_placements_total"]["series"]
    assert sum(s["value"] for s in snap if s["labels"]["outcome"] == "handoff") == len(routed)


def test_disaggregation_needs_two_replicas_and_a_paged_prefill():
    replicas = _replicas(_paged(), 1)
    with pytest.raises(ValueError, match=">= 2 replicas"):
        Router(replicas, disaggregate=True)
    dense = _replicas(EngineConfig.oracle_dense(n_lanes=2, n_slots=4, max_len=48), 2)
    router = Router(dense, disaggregate=True)
    router.add_tenant("fam", _lam(dense[0].engine.params, 1))
    r = router.submit("fam", np.arange(2, 14, dtype=np.int32), 3)
    assert r.phase == "decode" and r.replica.role == "decode", (
        "a dense prefill replica cannot export its prompt: the request must place directly")
    router.run()
    assert r.finished and len(r.tokens) == 3


# ---------------------------------------------------------------------------
# the port's router against the reference's
# ---------------------------------------------------------------------------


def test_port_router_places_and_serves_as_the_reference():
    """The two routers over two replicas each, on the same weights, λ and
    jobs: every digest on the same replica name (the ring and the digest
    are the same bytes), every routed stream the same tokens, the same
    placement hit rate."""
    jcfg = jax_reduced("smollm-135m").replace(dtype="float32")
    cfg = get_reduced("smollm-135m").replace(dtype="float32")
    npj = jax.tree_util.tree_map(np.asarray, jax_build(jcfg).init(jax.random.PRNGKey(3)))
    shape = npj["groups"]["adapters"]["attn"]["wq"]["lam"].shape
    rng = np.random.default_rng(9)
    lams = {f"t{i}": {"attn": {p: (rng.standard_normal(shape) * 0.3).astype(np.float32)
                               for p in ("wq", "wv")}} for i in (1, 2, 3)}
    conf = dict(layout="paged", n_lanes=2, n_slots=6, max_len=48, block_size=8,
                share_prefix=True, prefill_chunk=8)
    jrouter = JRouter(j_build_replicas(jcfg, JEngineConfig(**conf), 2,
                                       params=jax.tree_util.tree_map(jnp.asarray, npj)))
    trouter = Router(build_replicas(cfg, EngineConfig(**conf), 2,
                                    params=params_from_jax(npj, device="cpu"), device="cpu"))
    jrouter.add_tenants({t: jax.tree_util.tree_map(jnp.asarray, lam) for t, lam in lams.items()})
    trouter.add_tenants(lams)
    for t in lams:
        assert trouter.digest(t) == jrouter.digest(t)
    digests = [np.random.default_rng(s).bytes(20) for s in range(64)]
    assert [trouter.owner_of(d).name for d in digests] == [
        jrouter.owner_of(d).name for d in digests]
    jobs = _jobs(cfg.vocab_size)
    jr = [jrouter.submit(t, p, g) for t, p, g in jobs]
    tr = [trouter.submit(t, p, g) for t, p, g in jobs]
    jrouter.run()
    trouter.run()
    for a, b in zip(tr, jr):
        assert a.finished and b.finished
        assert a.replica.name == b.replica.name
        assert a.tokens == b.tokens
    assert trouter.placement_hit_rate() == jrouter.placement_hit_rate()
    assert trouter.transport.stats() == jrouter.transport.stats()


# ---------------------------------------------------------------------------
# transport, device groups, router telemetry
# ---------------------------------------------------------------------------


def test_payload_bytes_and_local_transport_meter():
    payload = {"k": np.zeros((2, 3, 8, 2, 4), np.float32), "v": np.ones((2, 3, 8, 2, 4)),
               "n_blocks": 3, "logits": None, "token": 5}
    assert payload_nbytes(payload) == j_payload_nbytes(payload) == 1536 + 3072 + 3 * 8
    assert payload_nbytes(None) == 0
    t = LocalTransport()
    assert t.ship(payload, None, None, "prefix") is payload
    t.ship(payload, None, None, "prefix")
    t.ship({"k": np.zeros(4, np.float32)}, None, None, "prefill")
    assert t.stats() == {"shipments": {"prefix": 2, "prefill": 1},
                         "bytes": {"prefix": 2 * 4632, "prefill": 16},
                         "total_bytes": 2 * 4632 + 16}


def test_replica_device_groups_share_the_cpu():
    groups = replica_device_groups(3)
    assert len(groups) == 3 and all(g == [torch.device("cpu")] for g in groups)
    with pytest.raises(ValueError):
        replica_device_groups(0)
    reps = _replicas(_paged(), 2)
    assert [r.devices for r in reps] == [[torch.device("cpu")]] * 2
    assert reps[0].engine.lam_store is not reps[1].engine.lam_store


def test_router_trace_and_metrics():
    replicas = _replicas(_paged(n_lanes=1, n_slots=4), 2)
    router = Router(replicas, spill_threshold=0)
    assert len(router._ring) == 2 * DEFAULT_VNODES
    router.add_tenant("fam", _lam(replicas[0].engine.params, 1))
    prompt = np.random.default_rng(0).integers(2, 256, size=24).astype(np.int32)
    router.submit("fam", prompt, 2)
    router.run()
    router.submit("fam", prompt, 2)
    router.submit("fam", prompt, 2)  # spills, importing the prefix
    router.run()
    snap = router.registry.snapshot()
    assert snap["router_requests_total"]["series"][0]["value"] == 3
    assert snap["router_prefix_imports_total"]["series"][0]["value"] == 1
    trace = router.tracer.to_chrome()["traceEvents"]
    assert any(e.get("name") == "ship_prefix" and e["pid"] == PID_ROUTER for e in trace)
    assert set(router.metrics()["replicas"]) == {"r0", "r1"}


# ---------------------------------------------------------------------------
# the bench and the driver
# ---------------------------------------------------------------------------


def test_multi_replica_bench_runs_at_the_smoke_scale(monkeypatch):
    """Both replica counts serve the same tokens as one engine, one replica
    prefills ≥ 1.8× the prompt rows two do (the bench's own work bar; the
    throughput ratio is a ``held=`` reading on the CPU), and the
    disaggregated segment hands every request over without a prefill on the
    decode replica (the bench asserts each; a failure exits 1)."""
    monkeypatch.setenv("REPRO_BENCH_SCALE", "smoke")
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        run.main(["--only", "multi_replica", "--device", "cpu"])
    finally:
        torch.set_num_threads(threads)
    names = [row.split(",")[0] for row in common.rows()]
    assert names == ["multi_replica:throughput:r1", "multi_replica:throughput:r2",
                     "multi_replica:scaling", "multi_replica:disaggregated"]
    r2 = next(row for row in common.rows() if row.startswith("multi_replica:throughput:r2"))
    assert "placement_hit=1.00" in r2
    scaling = next(row for row in common.rows() if row.startswith("multi_replica:scaling"))
    fields = dict(kv.split("=") for kv in scaling.split(",", 2)[2].split(";"))
    r1_rows, r2_rows = int(fields["r1_prefill_rows"]), int(fields["r2_prefill_rows"])
    assert r2_rows > 0 and r1_rows >= 1.8 * r2_rows, scaling
    assert fields["held"] in ("True", "False") and float(fields["ratio"][:-1]) > 0, scaling


@pytest.mark.parametrize("extra", [[], ["--disaggregate", "--share-prefix",
                                        "--prefill-chunk", "16"],
                                   ["--layout", "oracle_dense"]],
                         ids=["paged", "disaggregate", "oracle_dense"])
def test_serve_multi_replicas_drive_verifies(extra):
    done = serve_multi.main(["--reduced", "--device", "cpu", "--replicas", "2", "--tenants", "3",
                             "--gen-len", "5", "--prompt-len", "20", *extra])
    assert len(done) == 3 and all(r.finished and len(r.tokens) == 5 for r in done.values())
    if extra[:1] == ["--disaggregate"]:
        assert all(r.replica.role == "decode" and r.placements == 2 for r in done.values())
