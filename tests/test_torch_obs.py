"""The port's serving telemetry (``repro_torch.obs``): the port's copies of
``tests/test_obs.py``'s registry, exposition, trace and allocator-gauge
tests; the same operations on both packages' registries and tracers give the
same snapshot JSON, Prometheus text and Chrome trace; and the engine's
instrumentation, first as the reference's engine tests check it, then
against the JAX engine on the same traffic (reduced smollm-135m, float32,
``telemetry=True``): every counter, every histogram's count, every
request's milestones and the whole Chrome trace but its times are equal.

The reference's engine tests build ``EngineConfig.oracle_dense`` engines,
a layout the port serves with a later slice (ROADMAP Queue 1 item 10c);
their copies here build the paged layout.  The quantum and cold-tier tests
(``tests/test_obs.py:261`` and ``:320``) come with those slices."""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import repro.obs as jobs
from repro.configs import get_reduced as jax_reduced
from repro.models import build_model as jax_build
from repro.serving import EngineConfig as JEngineConfig
from repro.serving import MultiTenantEngine as JEngine
from repro_torch import obs as tobs
from repro_torch.configs import get_reduced
from repro_torch.interop import params_from_jax
from repro_torch.obs import (
    NULL,
    MetricsRegistry,
    Tracer,
    to_prometheus,
    write_metrics,
)
from repro_torch.obs.metrics import Histogram
from repro_torch.serving import BASE_TENANT, EngineConfig, MultiTenantEngine
from repro_torch.serving.paging import BlockAllocator


@pytest.fixture(scope="module", autouse=True)
def _clear_jax_caches():
    yield
    jax.clear_caches()


# ---------------------------------------------------------------------------
# registry + instruments (tests/test_obs.py:29-190)
# ---------------------------------------------------------------------------


def test_registry_counter_gauge_histogram_basics():
    reg = MetricsRegistry()
    c = reg.counter("c_total", "a counter")
    g = reg.gauge("g", "a gauge")
    h = reg.histogram("h_ms", "a histogram", buckets=(1.0, 10.0, 100.0))
    c.inc()
    c.inc(2.5)
    with pytest.raises(ValueError):
        c.inc(-1)  # counters are monotonic
    g.set(7)
    g.inc(3)
    g.dec()
    for v in (0.5, 5.0, 50.0, 500.0):
        h.observe(v)
    assert c.value == 3.5 and g.value == 9.0
    assert h.count == 4 and h.sum == 555.5 and h.mean == pytest.approx(138.875)
    # quantile returns the holding bucket's upper edge; overflow → inf
    assert h.quantile(0.25) == 1.0 and h.quantile(0.5) == 10.0
    assert h.quantile(1.0) == float("inf")
    assert Histogram(buckets=(1.0,)).quantile(0.5) == 0.0  # empty


def test_registry_labels_memoize_and_validate():
    reg = MetricsRegistry()
    fam = reg.counter("ops_total", "ops", labels=("cause",))
    a1 = fam.labels(cause="x")
    a2 = fam.labels(cause="x")
    b = fam.labels(cause="y")
    assert a1 is a2 and a1 is not b
    a1.inc()
    a1.inc()
    b.inc()
    snap = reg.snapshot()["ops_total"]
    assert {(s["labels"]["cause"], s["value"]) for s in snap["series"]} == {
        ("x", 2.0), ("y", 1.0)
    }
    with pytest.raises(ValueError):
        fam.labels(reason="x")  # wrong label name
    # same name must re-register with the same kind and label schema
    with pytest.raises(ValueError):
        reg.gauge("ops_total")
    with pytest.raises(ValueError):
        reg.counter("ops_total", labels=())


def test_registry_callbacks_sampled_at_snapshot_only():
    reg = MetricsRegistry()
    calls = []
    reg.callback("depth", lambda: calls.append(1) or len(calls), help="probe")
    reg.callback("done_total", lambda: 5, kind="counter")
    assert calls == []  # registration does not sample
    snap = reg.snapshot()
    assert calls == [1]
    assert snap["depth"]["series"][0]["value"] == 1.0
    assert snap["done_total"]["type"] == "counter"
    with pytest.raises(ValueError):
        reg.callback("depth", lambda: 0)  # name collision with callback
    with pytest.raises(ValueError):
        reg.counter("depth")  # instrument colliding with callback
    with pytest.raises(ValueError):
        reg.callback("x", lambda: 0, kind="histogram")


def test_disabled_registry_is_null_and_empty():
    reg = MetricsRegistry(enabled=False)
    c = reg.counter("c_total")
    h = reg.histogram("h_ms", labels=("phase",))
    assert c is NULL and h.labels(phase="x") is NULL
    c.inc()
    h.observe(3.0)  # all no-ops
    assert NULL.value == 0.0 and NULL.quantile(0.9) == 0.0
    assert reg.snapshot() == {}
    reg.callback("cb", lambda: 1 / 0)  # never sampled, never raises
    assert reg.snapshot() == {}


def test_prometheus_text_round_trip():
    reg = MetricsRegistry()
    reg.counter("req_total", "requests", labels=("cause",)).labels(
        cause='a"b\\c\n'
    ).inc(3)
    h = reg.histogram("lat_ms", "latency", buckets=(1.0, 10.0))
    h.observe(0.5)
    h.observe(5.0)
    h.observe(100.0)
    text = to_prometheus(reg.snapshot())
    assert "# TYPE req_total counter" in text
    assert "# HELP lat_ms latency" in text
    # label escaping: backslash, quote, newline
    assert 'req_total{cause="a\\"b\\\\c\\n"} 3' in text
    # cumulative buckets + +Inf tail + sum/count
    assert 'lat_ms_bucket{le="1"} 1' in text
    assert 'lat_ms_bucket{le="10"} 2' in text
    assert 'lat_ms_bucket{le="+Inf"} 3' in text
    assert "lat_ms_sum 105.5" in text and "lat_ms_count 3" in text


def test_write_metrics_json_vs_prom_by_extension(tmp_path):
    reg = MetricsRegistry()
    reg.counter("c_total", "c").inc(2)
    snap = reg.snapshot()
    jpath = tmp_path / "sub" / "m.json"
    ppath = tmp_path / "m.prom"
    write_metrics(str(jpath), snap)  # creates parent dirs
    write_metrics(str(ppath), snap)
    assert json.loads(jpath.read_text()) == snap
    assert "# TYPE c_total counter" in ppath.read_text()


def test_tracer_emits_valid_chrome_trace(tmp_path):
    tr = Tracer()
    tr.thread_name(0, 1, "lane 1")
    tr.complete("work", 0, 1, ts=0.001, dur=0.002, args={"k": "v"})
    tr.instant("mark", 0, 1)
    path = tmp_path / "t" / "trace.json"
    tr.write(str(path))
    doc = json.loads(path.read_text())
    assert doc["displayTimeUnit"] == "ms"
    evs = doc["traceEvents"]
    x = next(e for e in evs if e["ph"] == "X")
    assert x["name"] == "work" and x["ts"] == 1000 and x["dur"] == 2000
    assert {"pid", "tid", "ts"} <= set(x)
    assert any(e["ph"] == "M" for e in evs)  # process/thread metadata
    assert any(e["ph"] == "i" for e in evs)


def test_allocator_tracks_in_use_and_peak_gauges():
    reg = MetricsRegistry()
    alloc = BlockAllocator(8, 4, metrics=reg)
    a = alloc.alloc(3)
    assert alloc.peak_in_use == 3
    for b in a:
        alloc.decref(b)
    b2 = alloc.alloc(2)
    snap = reg.snapshot()
    assert snap["kv_pool_blocks_in_use"]["series"][0]["value"] == 2.0
    assert snap["kv_pool_blocks_peak"]["series"][0]["value"] == 3.0
    assert snap["kv_pool_blocks_capacity"]["series"][0]["value"] == 7.0
    for b in b2:
        alloc.decref(b)
    assert reg.snapshot()["kv_pool_blocks_in_use"]["series"][0]["value"] == 0.0
    assert alloc.peak_in_use == 3  # peak is a high-water mark


# ---------------------------------------------------------------------------
# the same operations on both packages: identical snapshot, text and trace
# ---------------------------------------------------------------------------


def _ops_counters(reg):
    c = reg.counter("req_total", "requests", labels=("cause",))
    c.labels(cause="pool_full").inc()
    c.labels(cause='q"uo\\te\n').inc(2.5)
    reg.counter("plain_total", "a plain counter").inc(7)
    g = reg.gauge("depth", "a gauge")
    g.set(4)
    g.dec(1.5)
    reg.callback("cb_total", lambda: 12, kind="counter", help="sampled")
    reg.callback("cb_rate", lambda: 1 / 3)


def _ops_histograms(reg):
    h = reg.histogram("lat_ms", "latency", buckets=(0.5, 2.0, 10.0))
    for v in (0.1, 0.5, 0.75, 3.0, 99.0, 1e9):
        h.observe(v)
    p = reg.histogram("phase_ms", "phases", labels=("phase",))
    for i, name in enumerate(("admit", "grow", "dispatch", "sync", "emit", "admit")):
        p.labels(phase=name).observe(0.01 * (i + 1) ** 3)
    reg.histogram("empty_ms", "never observed")


def _ops_disabled(reg):
    _ops_counters(reg)
    _ops_histograms(reg)


@pytest.mark.parametrize("ops,enabled", [(_ops_counters, True), (_ops_histograms, True),
                                         (_ops_disabled, False)],
                         ids=["counters_gauges_callbacks", "histograms", "disabled"])
def test_registry_snapshot_and_text_identical_to_reference(ops, enabled, tmp_path):
    mine, ref = tobs.MetricsRegistry(enabled=enabled), jobs.MetricsRegistry(enabled=enabled)
    ops(mine)
    ops(ref)
    snap, ref_snap = mine.snapshot(), ref.snapshot()
    assert json.dumps(snap, sort_keys=True) == json.dumps(ref_snap, sort_keys=True)
    assert list(snap) == list(ref_snap)  # the same family order
    assert tobs.to_prometheus(snap) == jobs.to_prometheus(ref_snap)
    # each package's renderer reads the other's snapshot the same way
    assert tobs.to_prometheus(ref_snap) == jobs.to_prometheus(snap)
    for name in ("m.json", "m.prom"):
        tobs.write_metrics(str(tmp_path / "t" / name), snap)
        jobs.write_metrics(str(tmp_path / "j" / name), ref_snap)
        assert (tmp_path / "t" / name).read_text() == (tmp_path / "j" / name).read_text()


def test_tracer_document_identical_to_reference():
    docs = []
    for pkg in (tobs, jobs):
        tr = pkg.Tracer(max_events=6)
        tr.thread_name(pkg.PID_ENGINE, 2, "lane 2")
        tr.thread_name(pkg.PID_QUEUE, 7, "req 7")
        tr.complete("prefill", pkg.PID_ENGINE, 2, ts=0.25, dur=0.0125, args={"uid": 7})
        tr.instant("cow_fork", pkg.PID_ENGINE, 2, ts=0.5, args={"src_block": 3})
        for i in range(4):  # past max_events: dropped and counted
            tr.complete("decode", pkg.PID_ENGINE, 2, ts=1.0 + i, dur=0.001)
        docs.append((tr.to_chrome(), tr.dropped))
    assert docs[0] == docs[1] and docs[0][1] > 0


# ---------------------------------------------------------------------------
# the engine's instrumentation contract (tests/test_obs.py:194-360)
# ---------------------------------------------------------------------------


def _tiny_engine(**kw):
    cfg = get_reduced("smollm-135m").replace(dtype="float32")
    econf = EngineConfig(layout="paged", n_lanes=2, n_slots=3, max_len=32, **kw)
    return cfg, MultiTenantEngine(cfg, econf, device="cpu")


def test_engine_span_lifecycle_and_latency_histograms():
    cfg, eng = _tiny_engine()
    r = eng.submit(BASE_TENANT, np.arange(2, 8, dtype=np.int32), 4)
    eng.run()
    names = r.trace.names()
    # milestone ordering: submit → admit → prefill → first_token → retire,
    # each exactly once
    assert [n for n in names if n != "defer"] == [
        "submit", "admit", "prefill", "first_token", "retire"
    ]
    assert r.trace.ttft_ms is not None and r.trace.ttft_ms >= 0
    assert r.trace.e2e_ms is not None and r.trace.e2e_ms >= r.trace.ttft_ms
    snap = eng.metrics()
    assert snap["serve_ttft_ms"]["series"][0]["count"] == 1
    assert snap["serve_e2e_ms"]["series"][0]["count"] == 1
    assert snap["serve_tokens_total"]["series"][0]["value"] == 4.0
    assert snap["serve_requests_total"]["series"][0]["value"] == 1.0
    assert snap["serve_retired_total"]["series"][0]["value"] == 1.0
    # step-phase histograms cover the decode loop
    phases = {s["labels"]["phase"] for s in snap["serve_step_phase_ms"]["series"]}
    assert {"admit", "dispatch", "sync", "emit"} <= phases
    # the paged layout's paths were dispatched at one shape each: the prompt
    # bucket, one attend bound (the reference's compile counts)
    assert snap["serve_jit_compiles_prefill_paged"]["series"][0]["value"] == 1.0
    assert snap["serve_jit_compiles_decode"]["series"][0]["value"] == 1.0
    # chrome trace carries the lane timeline
    doc = eng.telemetry.tracer.to_chrome()
    spans = {e["name"] for e in doc["traceEvents"] if e["ph"] == "X"}
    assert {"queued", "prefill", "decode"} <= spans
    assert any(s.startswith("req ") for s in spans)


def test_engine_block_pressure_preemption_counted_once_and_stream_unaffected():
    cfg = get_reduced("smollm-135m").replace(dtype="float32")

    def run(telemetry):
        eng = MultiTenantEngine(
            cfg,
            EngineConfig(
                layout="paged", n_lanes=2, n_slots=2, max_len=32, block_size=8,
                n_blocks=1 + 5, telemetry=telemetry,
            ),
            device="cpu",
        )
        a = eng.submit(BASE_TENANT, np.arange(2, 10, dtype=np.int32), 16)
        b = eng.submit(BASE_TENANT, np.arange(12, 20, dtype=np.int32), 16)
        events = list(eng.stream())
        return eng, a, b, events

    eng, a, b, events = run(telemetry=True)
    assert eng.preemptions >= 1
    snap = eng.metrics()
    by_cause = {
        s["labels"]["cause"]: s["value"]
        for s in snap["serve_preemptions_total"]["series"]
    }
    assert by_cause["block_pressure"] == float(eng.preemptions)
    # the victim's trace records each preemption exactly once
    assert b.trace.names().count("preempt") == b.preemptions
    # delivered (exactly-once) tokens < decoded (incl. re-derivation)
    assert snap["serve_tokens_total"]["series"][0]["value"] == len(events)
    assert eng.decoded_tokens > len(events)
    # telemetry must not perturb scheduling: disabled engine decodes the
    # same tokens through the same preemption schedule
    eng_off, a_off, b_off, events_off = run(telemetry=False)
    assert a_off.trace is None and eng_off.metrics() == {}
    assert a_off.tokens == a.tokens and b_off.tokens == b.tokens
    assert [(e.uid, e.token) for e in events_off] == [
        (e.uid, e.token) for e in events
    ]


def test_engine_prefix_and_cow_counters_match_attrs():
    cfg = get_reduced("smollm-135m").replace(dtype="float32")
    eng = MultiTenantEngine(
        cfg,
        EngineConfig(
            layout="paged", n_lanes=2, n_slots=3, max_len=32, block_size=8,
            share_prefix=True,
        ),
        device="cpu",
    )
    prompt = np.arange(2, 18, dtype=np.int32)  # two full blocks
    eng.submit(BASE_TENANT, prompt, 4)
    eng.submit(BASE_TENANT, prompt, 4)  # same family+prompt → shared prefix
    eng.run()
    snap = eng.metrics()
    assert eng.prefix_cache.hits > 0
    assert snap["serve_prefix_hits_total"]["series"][0]["value"] == float(
        eng.prefix_cache.hits
    )
    assert snap["serve_prefix_misses_total"]["series"][0]["value"] == float(
        eng.prefix_cache.misses
    )
    assert snap["serve_cow_forks_total"]["series"][0]["value"] == float(
        eng.cow_forks
    )
    assert snap["kv_prefix_hit_rate"]["series"][0]["value"] == pytest.approx(
        eng.prefix_cache.hits / (eng.prefix_cache.hits + eng.prefix_cache.misses)
    )


def test_engine_disabled_telemetry_is_inert(tmp_path):
    cfg, eng = _tiny_engine(telemetry=False)
    r = eng.submit(BASE_TENANT, np.arange(2, 8, dtype=np.int32), 4)
    eng.run()
    assert r.trace is None
    assert eng.metrics() == {}
    assert eng.telemetry.tracer is None
    with pytest.raises(RuntimeError):
        eng.telemetry.write_trace(str(tmp_path / "never.json"))
    assert len(r.tokens) == 4  # serving itself is unaffected


# ---------------------------------------------------------------------------
# the port's engine against the JAX engine on the same traffic
# ---------------------------------------------------------------------------



def _drive(eng, lams, traffic):
    """Register ``lams``, submit ``traffic`` and step to the end; once the
    first request decodes, take a reference on its tail block, as another
    owner would, so its next write forks a copy (dropped at the end)."""
    for t, lam in lams.items():
        eng.add_tenant(t, lam)
    reqs = [eng.submit(t, p, n) for t, p, n in traffic]
    events, tail = [], None
    while eng.scheduler.has_work:
        eng.step()
        events += eng.events
        if tail is None and reqs[0].tokens and reqs[0].lane >= 0:
            tail = eng._lane_blocks[reqs[0].lane][-1]
            eng.allocator.incref(tail)
    eng.allocator.decref(tail)
    return reqs, events


@pytest.fixture(scope="module")
def telemetry_pair():
    """The JAX engine and the port's engine under ``EngineConfig.serving()``
    (block 8, chunks of 16, watermark 1) with a pool of 10 blocks: six
    requests of three tenants (two share a λ) on one 16-token prefix, one of
    them a 40-token prompt that streams in chunks; the pool defers
    admissions and preempts, the prefix cache hits, one CoW fork is forced."""
    jcfg = jax_reduced("smollm-135m").replace(dtype="float32")
    cfg = get_reduced("smollm-135m").replace(dtype="float32")
    npj = jax.tree_util.tree_map(np.asarray, jax_build(jcfg).init(jax.random.PRNGKey(3)))
    rng = np.random.default_rng(0)
    shape = npj["groups"]["adapters"]["attn"]["wq"]["lam"].shape
    draw = lambda: {"attn": {p: (rng.standard_normal(shape) * 0.3).astype(np.float32)
                             for p in ("wq", "wv")}}
    fam = draw()
    lams = {"a": fam, "a2": fam, "b": draw()}
    pre = rng.integers(2, 256, size=16).astype(np.int32)
    traffic = []
    for i in range(5):
        tail = rng.integers(2, 256, size=int(rng.integers(2, 7))).astype(np.int32)
        traffic.append((["a", "a2", "b"][i % 3], np.concatenate([pre, tail]),
                        int(rng.integers(8, 20))))
    traffic.insert(2, ("b", rng.integers(2, 256, size=40).astype(np.int32), 10))
    common = dict(n_lanes=3, n_slots=6, max_len=64, collect_logits=True, block_size=8,
                  n_blocks=11)
    jeng = JEngine(jcfg, JEngineConfig.serving(**common),
                   params=jax.tree_util.tree_map(jnp.asarray, npj))
    jreqs, jevents = _drive(jeng, {t: jax.tree_util.tree_map(jnp.asarray, lam)
                                   for t, lam in lams.items()}, traffic)
    teng = MultiTenantEngine(cfg, EngineConfig.serving(**common),
                             params=params_from_jax(npj, device="cpu"), device="cpu")
    treqs, tevents = _drive(teng, lams, traffic)
    return jeng, jreqs, jevents, teng, treqs, tevents


def _series(snap, name):
    """label tuple → a counter's value or a histogram's count."""
    return {tuple(sorted(s["labels"].items())): s.get("value", s.get("count"))
            for s in snap[name]["series"]}


def test_engine_counters_and_histogram_counts_match_jax_engine(telemetry_pair):
    jeng, _, _, teng, _, _ = telemetry_pair
    jsnap, tsnap = jeng.metrics(), teng.metrics()
    assert set(tsnap) == set(jsnap)
    for name in tsnap:
        assert tsnap[name]["type"] == jsnap[name]["type"], name
        assert tsnap[name]["help"] == jsnap[name]["help"] or name.startswith(
            ("serve_jit_compiles_", "lam_slot_writes")), name
        assert _series(tsnap, name) == _series(jsnap, name), name
    # the traffic ran every path the counters count (no cold tier here: its
    # deferral cause reads 0 in both engines)
    for name in ("serve_preemptions_total", "serve_deferrals_total", "serve_cow_forks_total",
                 "serve_prefix_hits_total", "serve_prefill_chunk_ms"):
        assert all(v > 0 for k, v in _series(tsnap, name).items()
                   if k != (("cause", "cold_promote"),)), name
    assert _series(tsnap, "serve_deferrals_total")[(("cause", "cold_promote"),)] == 0.0
    phases = {s["labels"]["phase"] for s in tsnap["serve_step_phase_ms"]["series"]}
    assert phases == {"admit", "prefill_chunk", "grow", "dispatch", "sync", "emit"}
    assert teng.prefill_compilations == jeng.prefill_compilations


def test_engine_request_milestones_match_jax_engine(telemetry_pair):
    _, jreqs, _, _, treqs, _ = telemetry_pair
    for jr, tr in zip(jreqs, treqs):
        assert [(e, d) for e, _, d in tr.trace.events] == [
            (e, d) for e, _, d in jr.trace.events], f"request {tr.uid}"
        assert tr.trace.tokens == jr.trace.tokens == jr.max_new_tokens
    assert sum(r.preemptions for r in treqs) > 0


def test_engine_chrome_trace_matches_jax_engine_but_times(telemetry_pair):
    jeng, _, jevents, teng, _, tevents = telemetry_pair
    strip = lambda eng: [(e["name"], e["ph"], e.get("pid"), e.get("tid"), e.get("args"))
                         for e in eng.telemetry.tracer.to_chrome()["traceEvents"]]
    assert strip(teng) == strip(jeng)
    assert [dict(vars(e)) for e in tevents] == [dict(vars(e)) for e in jevents]
