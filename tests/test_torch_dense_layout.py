"""The oracle-dense layout and quantum time-slicing of the PyTorch port
against the JAX package (reduced smollm-135m and qwen2-0.5b, float32, CPU):
the engine config's layout rules (ports of ``tests/test_engine_config.py:37``
and ``:73``), the per-lane dense cache and its decode, the dense engine
against the merged-weight reference (``tests/test_serving.py:197``), paged
against dense (``tests/test_paging.py:287`` and ``:356``), time-slicing
(the logic of ``tests/test_serving.py:379`` and ``:476`` and of
``tests/test_obs.py:264``, which the reference runs on xlstm, on the dense
family) and both engines side by side under ``EngineConfig.oracle_dense(
n_lanes=2, quantum=3)``.

Bounds: model logits within 2e-5 of JAX (``test_torch_models.py``'s bound);
engine logits within 1e-4 of JAX and of the merged-weight reference
(``test_torch_serving.py``'s, measured ~5e-6); tokens, schedules and
counters equal.  Port against port — sliced against unsliced, paged
against dense — is bitwise."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.overrides import TorchFunctionMode

from repro.configs import get_reduced as jax_reduced
from repro.models import build_model as jax_build
from repro.models.lane_state import restore_lane as j_restore_lane
from repro.serving import EngineConfig as JEngineConfig
from repro.serving import MultiTenantEngine as JEngine
from repro_torch.configs import get_reduced
from repro_torch.interop import params_from_jax
from repro_torch.launch import serve_multi
from repro_torch.models import build_model
from repro_torch.models.lane_state import extract_lane, restore_lane
from repro_torch.serving import (
    BASE_TENANT,
    EngineConfig,
    MultiTenantEngine,
    base_lambda,
    reference_decode,
)

ATOL = 2e-5
LOGIT_TOL = 1e-4
ARCHS = ["smollm-135m", "qwen2-0.5b"]
VOCAB = 256


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


_WEIGHTS = {}


def _weights(arch: str):
    """Reduced float32 JAX params (numpy leaves; qwen2-0.5b's QKV biases
    drawn, the init leaves them zero), the configs of both packages and a λ
    draw."""
    if arch not in _WEIGHTS:
        jcfg = jax_reduced(arch).replace(dtype="float32")
        cfg = get_reduced(arch).replace(dtype="float32")
        npj = jax.tree_util.tree_map(np.asarray, jax_build(jcfg).init(jax.random.PRNGKey(3)))
        rng = np.random.default_rng(5)
        attn = npj["groups"]["attn"]
        for name in ("bq", "bk", "bv"):
            if name in attn:
                attn[name] = (rng.standard_normal(attn[name].shape) * 0.5).astype(np.float32)
        shape = npj["groups"]["adapters"]["attn"]["wq"]["lam"].shape
        lams = {f"t{i}": {"attn": {p: (rng.standard_normal(shape) * 0.3).astype(np.float32)
                                   for p in ("wq", "wv")}} for i in (1, 2)}
        _WEIGHTS[arch] = (jcfg, cfg, npj, lams)
    return _WEIGHTS[arch]


def _engine(arch, pkg, conf):
    """An engine of ``pkg`` ("jax" or "port") on ``arch``'s shared weights
    under the EngineConfig fields ``conf``, tenants t1 and t2 registered."""
    jcfg, cfg, npj, lams = _weights(arch)
    if pkg == "jax":
        eng = JEngine(jcfg, JEngineConfig(**conf),
                      params=jax.tree_util.tree_map(jnp.asarray, npj))
        for t, lam in lams.items():
            eng.add_tenant(t, jax.tree_util.tree_map(jnp.asarray, lam))
        return eng
    eng = MultiTenantEngine(cfg, EngineConfig(**conf), params=params_from_jax(npj, device="cpu"),
                            device="cpu")
    for t, lam in lams.items():
        eng.add_tenant(t, lam)
    return eng


def _prompts(specs, seed=3):
    rng = np.random.default_rng(seed)
    return [(t, rng.integers(2, VOCAB, size=P).astype(np.int32), G) for t, P, G in specs]


def _events(evs):
    return [(e.uid, e.tenant, e.lane, e.token, e.index, e.done) for e in evs]


# ---------------------------------------------------------------------------
# the engine config
# ---------------------------------------------------------------------------

DENSE_REFUSALS = [
    dict(quantum=0),
    dict(layout="paged", quantum=2),  # snapshots need dense lanes
    dict(layout="oracle_dense", prefill_chunk=16),  # chunks need blocks
    dict(layout="oracle_dense", share_prefix=True),
    dict(layout="oracle_dense", watermark=1),
]


@pytest.mark.parametrize("kw", DENSE_REFUSALS,
                         ids=lambda kw: ",".join(f"{k}={v}" for k, v in kw.items()))
def test_config_rejects_incoherent_dense_combinations(kw):
    for cls in (EngineConfig, JEngineConfig):
        with pytest.raises(ValueError):
            cls(**kw)


def test_quantum_on_a_paged_config_names_the_dense_layout():
    for cls in (EngineConfig, JEngineConfig):
        with pytest.raises(ValueError, match="dense layout"):
            cls(layout="paged", n_lanes=1, n_slots=2, quantum=2)


def test_config_layout_resolution_and_quantum():
    """quantum only bends auto (to dense); explicit layouts stay."""
    for cls in (EngineConfig, JEngineConfig):
        assert cls(quantum=2).resolved_layout("dense") == "oracle_dense"
        assert cls.oracle_dense(quantum=2).resolved_layout("dense") == "oracle_dense"
        assert cls(layout="oracle_dense").resolved_layout("dense") == "oracle_dense"
        assert cls().resolved_layout("dense") == "paged"


def test_oracle_dense_preset_accepts_overrides():
    cfg = EngineConfig.oracle_dense(n_lanes=2, quantum=3)
    assert cfg.layout == "oracle_dense" and cfg.quantum == 3 and cfg.n_lanes == 2
    assert not cfg.share_prefix and cfg.prefill_chunk is None
    ref = JEngineConfig.oracle_dense(n_lanes=2, quantum=3)
    for f in ("layout", "quantum", "n_lanes", "n_slots", "max_len", "watermark",
              "share_prefix", "prefill_chunk"):
        assert getattr(cfg, f) == getattr(ref, f), f


# ---------------------------------------------------------------------------
# the per-lane dense cache and its decode
# ---------------------------------------------------------------------------


def _models(arch):
    jcfg, cfg, npj, _ = _weights(arch)
    return (jax_build(jcfg), jax.tree_util.tree_map(jnp.asarray, npj), build_model(cfg, "cpu"),
            params_from_jax(npj, device="cpu"))


def test_per_lane_cache_and_lane_axes_match_jax():
    jm, _, tm, _ = _models("smollm-135m")
    jc = jm.init_decode_state(3, 32, jnp.float32, per_lane=True)
    tc = tm.init_decode_state(3, 32, torch.float32, per_lane=True)
    assert tc["pos"].shape == jc["pos"].shape == (3,)
    for name in ("k", "v", "idx"):
        assert tuple(tc["layers"]["attn"][name].shape) == jc["layers"]["attn"][name].shape, name
    assert tm.lane_axes() == tm.lane_axes(paged=False) == jm.lane_axes(paged=False)


def _spliced_lanes(jm, jp, tm, tp, lengths, max_len=48, bucket=16):
    """Both packages' per-lane caches with lane ``i`` prefilled (a 1-lane
    cache, prompt padded to ``bucket``, true length ``lengths[i]``) and
    spliced in; returns (jax cache, port cache, prefill logits of each)."""
    n = len(lengths)
    jc = jm.init_decode_state(n, max_len, jnp.float32, per_lane=True)
    tc = tm.init_decode_state(n, max_len, torch.float32, per_lane=True)
    jaxes, taxes = jm.lane_axes(paged=False), tm.lane_axes()
    rows = []
    for lane, P in enumerate(lengths):
        toks = np.zeros((1, bucket), np.int32)
        toks[0, :P] = np.random.default_rng(lane).integers(2, VOCAB, size=P)
        j1 = jm.init_decode_state(1, max_len, jnp.float32, per_lane=True)
        jl, j1 = jm.prefill(jp, j1, tokens=jnp.asarray(toks), length=jnp.asarray([P], jnp.int32))
        t1 = tm.init_decode_state(1, max_len, torch.float32, per_lane=True)
        tl, t1 = tm.prefill(tp, t1, torch.from_numpy(toks), length=torch.tensor([P]))
        jc = j_restore_lane(jc, jaxes, lane, j1)
        restore_lane(tc, taxes, lane, t1)
        rows.append((np.asarray(jl), tl.numpy()))
    return jc, tc, rows


@pytest.mark.parametrize("arch", ARCHS)
def test_per_lane_prefill_splice_and_decode_match_jax(arch):
    """Three lanes at offsets 5, 11 and 2 decode four steps, each writing
    its K/V at its own offset: logits and the written K/V within 2e-5 of
    JAX, offsets equal."""
    jm, jp, tm, tp = _models(arch)
    lengths = (5, 11, 2)
    jc, tc, rows = _spliced_lanes(jm, jp, tm, tp, lengths)
    for want, got in rows:
        np.testing.assert_allclose(got, want, atol=ATOL)
    nxt = np.array([[7], [9], [11]], np.int32)
    for step in range(4):
        jl, jc = jm.decode_step(jp, jc, token=jnp.asarray(nxt))
        tl, tc = tm.decode_step(tp, tc, torch.from_numpy(nxt))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL, err_msg=f"step {step}")
        nxt = np.array(jnp.argmax(jl, axis=-1), np.int32)[:, None]
    ja, ta = jc["layers"]["attn"], tc["layers"]["attn"]
    np.testing.assert_array_equal(ta["idx"].numpy(), np.asarray(ja["idx"]))
    np.testing.assert_array_equal(tc["pos"].numpy(), np.asarray(jc["pos"]))
    for lane, P in enumerate(lengths):
        for name in ("k", "v"):
            np.testing.assert_allclose(ta[name][:, lane, : P + 4].numpy(),
                                       np.asarray(ja[name])[:, lane, : P + 4], atol=ATOL)


class _NoHostRead(TorchFunctionMode):
    """Raises on any read of a tensor's value on the host (``int()``,
    ``.item()``, ``bool()``, indexing by a tensor, ``.tolist()``,
    ``.numpy()``): the CPU stand-in for sync debug mode "error"."""

    READS = {torch.Tensor.item, torch.Tensor.__int__, torch.Tensor.__index__,
             torch.Tensor.__bool__, torch.Tensor.__float__, torch.Tensor.tolist,
             torch.Tensor.numpy}

    def __torch_function__(self, func, types, args=(), kwargs=None):
        if func in self.READS:
            raise RuntimeError(f"host read: {func.__name__}")
        return func(*args, **(kwargs or {}))


def test_per_lane_decode_reads_no_offset_on_the_host():
    """The per-lane decode writes through an index scatter: no offset is
    read on the host.  Control: the lock-step cache's decode (the
    merged-weight reference's) reads its offset and is caught."""
    jm, jp, tm, tp = _models("smollm-135m")
    _, tc, _ = _spliced_lanes(jm, jp, tm, tp, (5, 11))
    tok = torch.tensor([[7], [9]], dtype=torch.int32)
    with _NoHostRead():
        tm.decode_step(tp, tc, tok)
    lock = tm.init_decode_state(2, 48, torch.float32)
    tm.prefill(tp, lock, torch.from_numpy(np.full((2, 4), 5, np.int32)))
    with pytest.raises(RuntimeError, match="host read"), _NoHostRead():
        tm.decode_step(tp, lock, tok)


def test_extract_lane_to_host_and_restore_round_trip():
    _, _, tm, _ = _models("smollm-135m")
    cache = tm.init_decode_state(3, 16, torch.float32, per_lane=True)
    gen = torch.Generator().manual_seed(0)
    for leaf in cache["layers"]["attn"].values():
        if leaf.is_floating_point():
            leaf.copy_(torch.randn(leaf.shape, generator=gen))
    cache["layers"]["attn"]["idx"].copy_(torch.tensor([3, 7, 9]))
    axes = tm.lane_axes()
    snap = extract_lane(cache, axes, 1, host=True)
    assert snap["layers"]["attn"]["k"].device.type == "cpu"
    assert snap["layers"]["attn"]["k"].shape[1] == 1
    other = tm.init_decode_state(3, 16, torch.float32, per_lane=True)
    restore_lane(other, axes, 2, snap)
    for name in ("k", "v", "idx"):
        assert torch.equal(other["layers"]["attn"][name][:, 2], cache["layers"]["attn"][name][:, 1])
        assert not other["layers"]["attn"][name][:, :2].any()


# ---------------------------------------------------------------------------
# the dense engine
# ---------------------------------------------------------------------------

MIXED = [(BASE_TENANT, 6, 4), ("t1", 9, 5), ("t2", 7, 3), ("t1", 5, 4)]


@pytest.mark.parametrize("arch", ARCHS)
def test_dense_engine_mixed_batch_matches_merged_reference(arch):
    """The port's copy of ``tests/test_serving.py:197``: 4 requests over 2
    dense lanes (lanes reused mid-stream) against the per-tenant
    merged-weight decode."""
    _, cfg, _, lams = _weights(arch)
    eng = _engine(arch, "port", dict(layout="oracle_dense", n_lanes=2, n_slots=4, max_len=40,
                                     collect_logits=True))
    assert eng.layout == "oracle_dense" and eng.allocator is None
    jobs = _prompts(MIXED)
    reqs = [eng.submit(t, p, g) for t, p, g in jobs]
    eng.run()
    lams = {**lams, BASE_TENANT: base_lambda(eng.params)}
    for req, (t, p, g) in zip(reqs, jobs):
        toks, logits = reference_decode(cfg, eng.params, lams[t], p, g, 40)
        assert req.tokens == toks, f"uid={req.uid} tenant={t}"
        np.testing.assert_allclose(np.stack(req.logits), logits, atol=LOGIT_TOL, rtol=LOGIT_TOL)


PAGING = [(BASE_TENANT, 6, 4), ("t1", 9, 5), ("t2", 7, 3), ("t1", 13, 4)]


def test_paged_engine_bitwise_the_dense_engine():
    """The port's copy of ``tests/test_paging.py:287``: mixed tenants and
    prompt lengths, lanes reused; the paged engine's tokens and logits are
    the dense engine's bit for bit, and the pool drains."""
    conf = dict(n_lanes=2, n_slots=4, max_len=48, collect_logits=True, block_size=8)
    runs = {}
    for layout in ("oracle_dense", "paged"):
        eng = _engine("smollm-135m", "port", dict(layout=layout, **conf))
        reqs = [eng.submit(t, p, g) for t, p, g in _prompts(PAGING)]
        eng.run()
        runs[layout] = (eng, reqs)
    for rd, rp in zip(runs["oracle_dense"][1], runs["paged"][1]):
        assert rd.tokens == rp.tokens
        np.testing.assert_array_equal(np.stack(rd.logits), np.stack(rp.logits))
    al = runs["paged"][0].allocator
    assert al.n_free == al.capacity


def test_paged_kv_below_dense_and_dense_bytes_match_jax():
    """``tests/test_paging.py:356``: a pool sized to the traffic holds less
    than lanes × max_len; the dense cache's bytes equal the JAX engine's."""
    conf = dict(n_lanes=4, n_slots=2, max_len=256)
    dense = _engine("smollm-135m", "port", dict(layout="oracle_dense", **conf))
    paged = _engine("smollm-135m", "port", dict(layout="paged", block_size=16,
                                                 n_blocks=1 + 4 * 2, **conf))
    assert paged.kv_cache_bytes() < dense.kv_cache_bytes()
    jdense = _engine("smollm-135m", "jax", dict(layout="oracle_dense", telemetry=False, **conf))
    assert dense.kv_cache_bytes() == jdense.kv_cache_bytes()


def test_dense_engine_refuses_the_handoff_as_the_reference():
    eng = _engine("smollm-135m", "port", dict(layout="oracle_dense", n_lanes=1, n_slots=3,
                                              max_len=32))
    p = np.arange(2, 12, dtype=np.int32)
    req = eng.submit("t1", p, 4)
    eng.step()
    assert eng.export_prefix("t1", p) is None
    assert eng.import_prefix("t1", p, {"block_size": 16, "n_blocks": 1}) == 0
    with pytest.raises(ValueError, match="paged layout"):
        eng.export_request_state(req)
    with pytest.raises(ValueError, match="paged layout"):
        eng.inject_prefilled("t1", p, 4, {"block_size": 16})
    eng.cancel(req)
    assert not eng.scheduler.has_work


# ---------------------------------------------------------------------------
# quantum time-slicing
# ---------------------------------------------------------------------------


def _sliced(quantum, arch="smollm-135m", n_lanes=1, specs=((BASE_TENANT, 7, 9), ("t1", 5, 9)),
            **conf):
    eng = _engine(arch, "port", dict(layout="oracle_dense", n_lanes=n_lanes, n_slots=3,
                                     max_len=48, collect_logits=True, quantum=quantum, **conf))
    reqs = [eng.submit(t, p, g) for t, p, g in _prompts(specs, seed=0)]
    events = list(eng.stream())
    return eng, reqs, events


@pytest.mark.parametrize("arch", ARCHS)
def test_quantum_round_robin_is_bitwise_the_unsliced_serve(arch):
    """The logic of ``tests/test_serving.py:379`` on the dense family: a
    lane time-sliced out snapshots its K/V region to the host and is
    restored on re-admission; every stream is the unsliced engine's bit for
    bit."""
    plain_eng, plain, _ = _sliced(None, arch)
    eng, sliced, _ = _sliced(3, arch)
    assert eng.slice_preemptions >= 2 and plain_eng.slice_preemptions == 0
    for rp, rq in zip(plain, sliced):
        assert rq.preemptions >= 1 and rq.snapshot is None
        assert rp.tokens == rq.tokens
        np.testing.assert_array_equal(np.stack(rp.logits), np.stack(rq.logits))


def test_quantum_preempts_at_most_one_lane_per_waiter():
    """``tests/test_serving.py:476``: one waiter churns one lane, the most
    overdue."""
    eng = _engine("smollm-135m", "port", dict(layout="oracle_dense", n_lanes=2, n_slots=3,
                                              max_len=32, quantum=2))
    for t, p, g in _prompts([(BASE_TENANT, 5, 8)] * 3, seed=1):
        eng.submit(t, p, g)
    while eng.slice_preemptions == 0 and eng.scheduler.has_work:
        before_active = len(eng.scheduler.active())
        eng.step()
    assert eng.slice_preemptions == 1, "both lanes churned for one waiter"
    assert before_active == 2
    done = eng.run()
    assert all(len(r.tokens) == 8 for r in done.values())


def test_quantum_preemption_recorded_per_requeue():
    """``tests/test_obs.py:264`` on the dense family: each time-slice is one
    ``quantum`` preemption and one trace mark; a restored request admits
    again without a second prefill; telemetry off serves the same."""
    eng, (r1, r2), events = _sliced(3)
    by_cause = {s["labels"]["cause"]: s["value"]
                for s in eng.metrics()["serve_preemptions_total"]["series"]}
    assert by_cause["quantum"] == float(eng.slice_preemptions) >= 2
    marks = r1.trace.names().count("preempt") + r2.trace.names().count("preempt")
    assert marks == eng.slice_preemptions
    for r in (r1, r2):
        assert r.preemptions >= 1
        assert r.trace.names().count("admit") == r.preemptions + 1
        assert r.trace.names().count("prefill") == 1
    off, (o1, o2), off_events = _sliced(3, telemetry=False)
    assert o1.trace is None and off.metrics() == {}
    assert (o1.tokens, o2.tokens) == (r1.tokens, r2.tokens)
    assert _events(off_events) == _events(events)


@pytest.mark.parametrize("arch", ARCHS)
def test_both_engines_time_slice_identically(arch):
    """The port's engine and the JAX engine under
    ``EngineConfig.oracle_dense(n_lanes=2, quantum=3)`` on the same
    traffic: the same events (so the same schedule: lanes, order, tokens),
    the same slice preemptions and preemption causes, the same admissions
    and prefills per request, logits within 1e-4."""
    conf = dict(layout="oracle_dense", n_lanes=2, n_slots=4, max_len=40, collect_logits=True,
                quantum=3)
    specs = [(BASE_TENANT, 6, 7), ("t1", 9, 8), ("t2", 7, 6), ("t1", 5, 9), ("t2", 12, 5)]
    out = {}
    for pkg in ("jax", "port"):
        eng = _engine(arch, pkg, conf)
        reqs = [eng.submit(t, p, g) for t, p, g in _prompts(specs, seed=4)]
        out[pkg] = (eng, reqs, _events(eng.stream()))
    (jeng, jreqs, jev), (teng, treqs, tev) = out["jax"], out["port"]
    assert tev == jev
    assert teng.slice_preemptions == jeng.slice_preemptions >= 3
    assert teng.steps == jeng.steps
    causes = lambda e: {s["labels"]["cause"]: s["value"]
                        for s in e.metrics()["serve_preemptions_total"]["series"]}
    assert causes(teng)["quantum"] == causes(jeng)["quantum"]
    for jr, tr in zip(jreqs, treqs):
        assert tr.tokens == jr.tokens and tr.preemptions == jr.preemptions
        assert tr.trace.names() == jr.trace.names()
        np.testing.assert_allclose(np.stack(tr.logits), np.stack(jr.logits), atol=LOGIT_TOL)


# the planted faults chip_smoke.py's sliced-against-unsliced check must reject


def test_a_snapshot_restored_into_the_wrong_lane_changes_the_streams(monkeypatch):
    from repro_torch.serving import engine as engine_mod

    specs = [(BASE_TENANT, 7, 9), ("t1", 5, 9), ("t2", 6, 9)]
    plain = _sliced(None, n_lanes=2, specs=specs)[1]
    extract, restore = engine_mod.extract_lane, engine_mod.restore_lane

    def tagged(state, axes, lane, host=False):
        snap = extract(state, axes, lane, host=host)
        if host:
            snap["sliced"] = True  # restore_lane walks the state's keys only
        return snap

    def wrong_lane(state, axes, lane, snap):
        return restore(state, axes, (lane + 1) % 2 if "sliced" in snap else lane, snap)

    monkeypatch.setattr(engine_mod, "extract_lane", tagged)
    monkeypatch.setattr(engine_mod, "restore_lane", wrong_lane)
    eng, faulty, _ = _sliced(2, n_lanes=2, specs=specs)
    assert eng.slice_preemptions >= 1
    assert any(a.tokens != b.tokens or not np.array_equal(np.stack(a.logits), np.stack(b.logits))
               for a, b in zip(plain, faulty))


def test_a_snapshot_missing_its_last_position_changes_the_streams(monkeypatch):
    from repro_torch.serving import engine as engine_mod

    plain = _sliced(None)[1]
    real = engine_mod.extract_lane

    def drop_last(state, axes, lane, host=False):
        snap = real(state, axes, lane, host=host)
        if host:
            a = snap["layers"]["attn"]
            last = int(a["idx"][0, 0]) - 1
            a["k"][:, :, last] = 0
            a["v"][:, :, last] = 0
        return snap

    monkeypatch.setattr(engine_mod, "extract_lane", drop_last)
    eng, faulty, _ = _sliced(3)
    assert eng.slice_preemptions >= 2
    assert any(a.tokens != b.tokens or not np.array_equal(np.stack(a.logits), np.stack(b.logits))
               for a, b in zip(plain, faulty))


# ---------------------------------------------------------------------------
# the driver
# ---------------------------------------------------------------------------


def test_serve_multi_dense_quantum_drive_verifies():
    done = serve_multi.main(["--reduced", "--device", "cpu", "--layout", "oracle_dense",
                             "--quantum", "3", "--lanes", "2", "--tenants", "3",
                             "--gen-len", "6", "--prompt-len", "9", "--max-len", "32"])
    assert len(done) == 3 and all(len(r.tokens) == 6 for r in done.values())
    assert sum(r.preemptions for r in done.values()) >= 1


@pytest.mark.parametrize("argv", [["--quantum", "3", "--layout", "paged"],
                                  ["--replicas", "2", "--quantum", "3"],
                                  ["--disaggregate"]],
                         ids=["quantum_paged", "replicas_quantum", "disaggregate_one_replica"])
def test_serve_multi_refuses_incoherent_flags(argv):
    with pytest.raises(SystemExit):
        serve_multi.main(["--reduced", "--device", "cpu", *argv])
