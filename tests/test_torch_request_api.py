"""The port engine's request API against the JAX engine on the same calls
(reduced smollm-135m, float32, CPU): ``stream()`` and its exactly-once
delivery under preemption (the port's copies of
``tests/test_serving.py:418`` and ``:452``), the split step, ``cancel``,
``add_tenants``/``remove_tenant``, and the handoff between engines
(``export_prefix``/``import_prefix``, ``export_request_state``/
``inject_prefilled``), a payload of the JAX engine served by the port's.

Bounds: tokens equal; logits within 1e-4 of the JAX engine
(``test_torch_serving.py``'s bound, measured ~5e-6); shipped K/V within
1e-5 of the JAX engine's (float32 projections of the same weights in
another summation order).  Each scenario runs once on each engine, in a
module-scoped fixture."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.configs import get_reduced as jax_reduced
from repro.models import build_model as jax_build
from repro.serving import EngineConfig as JEngineConfig
from repro.serving import MultiTenantEngine as JEngine
from repro_torch.configs import get_reduced
from repro_torch.interop import params_from_jax
from repro_torch.serving import BASE_TENANT, EngineConfig, MultiTenantEngine, TokenEvent

LOGIT_TOL = 1e-4
KV_TOL = 1e-5
VOCAB = 256


@pytest.fixture(scope="module", autouse=True)
def _clear_jax_caches():
    yield
    jax.clear_caches()


@pytest.fixture(scope="module")
def model():
    """Reduced float32 configs of both packages, one set of JAX-initialised
    weights (numpy leaves) and a λ draw."""
    jcfg = jax_reduced("smollm-135m").replace(dtype="float32")
    cfg = get_reduced("smollm-135m").replace(dtype="float32")
    npj = jax.tree_util.tree_map(np.asarray, jax_build(jcfg).init(jax.random.PRNGKey(3)))
    shape = npj["groups"]["adapters"]["attn"]["wq"]["lam"].shape
    rng = np.random.default_rng(11)

    def draw(scale=0.3):
        return {"attn": {p: (rng.standard_normal(shape) * scale).astype(np.float32)
                         for p in ("wq", "wv")}}

    return jcfg, cfg, npj, draw


def _engine(model, pkg, conf, **kw):
    """An engine of ``pkg`` ("jax" or "port") on the shared weights under
    ``conf(**kw)`` (``conf`` names a constructor of that package's
    EngineConfig: "plain" or "serving")."""
    jcfg, cfg, npj, _ = model
    if pkg == "jax":
        econf = JEngineConfig.serving(**kw) if conf == "serving" else JEngineConfig(**kw)
        return JEngine(jcfg, econf, params=jax.tree_util.tree_map(jnp.asarray, npj))
    econf = EngineConfig.serving(**kw) if conf == "serving" else EngineConfig(**kw)
    return MultiTenantEngine(cfg, econf, params=params_from_jax(npj, device="cpu"),
                             device="cpu")


def _engines(model, conf, **kw):
    """A JAX engine and a port engine on the same weights and config."""
    return _engine(model, "jax", conf, **kw), _engine(model, "port", conf, **kw)


def _lams(eng, lams):
    """λ trees in ``eng``'s package (JAX arrays for the JAX engine)."""
    if isinstance(eng, JEngine):
        return {t: jax.tree_util.tree_map(jnp.asarray, lam) for t, lam in lams.items()}
    return lams


def _add(eng, tenant, lam):
    return eng.add_tenant(tenant, _lams(eng, {tenant: lam})[tenant])


def _serve(eng, tenant, prompt, n):
    """Submit one request and run to the end; returns it."""
    req = eng.submit(tenant, prompt, n)
    eng.run()
    return req


def _events(evs):
    return [(e.uid, e.tenant, e.lane, e.token, e.index, e.done) for e in evs]


def _refs(eng):
    return dict(sorted(eng.allocator._refs.items()))


def _close(got, want, tol=LOGIT_TOL):
    np.testing.assert_allclose(np.stack(got.logits), np.stack(want.logits), atol=tol)


# ---------------------------------------------------------------------------
# stream(), and the split step
# ---------------------------------------------------------------------------

STREAM_SPECS = [(BASE_TENANT, 5, 4), ("t1", 8, 3), ("t1", 4, 5)]


@pytest.fixture(scope="module")
def streamed(model):
    """The :data:`STREAM_SPECS` traffic (tests/test_serving.py:418) through
    the default config: ``stream()`` on the JAX engine and on the port's,
    ``run()`` and ``step_finish(step_begin())`` on two more port engines."""
    lam = model[3](0.2)
    kw = dict(n_lanes=2, n_slots=3, max_len=32, collect_logits=True)

    def submit(eng):
        _add(eng, "t1", lam)
        rng = np.random.default_rng(7)
        return [eng.submit(t, rng.integers(2, VOCAB, size=P).astype(np.int32), G)
                for t, P, G in STREAM_SPECS]

    jeng, teng = _engines(model, "plain", **kw)
    out = {"jax_subs": submit(jeng), "subs": submit(teng)}
    out["jax_events"], out["events"] = list(jeng.stream()), list(teng.stream())
    for name, drive in (("run", lambda e: e.run()),
                        ("split", lambda e: [e.step_finish(e.step_begin())
                                             for _ in iter(lambda: e.scheduler.has_work, False)])):
        eng = _engine(model, "port", "plain", **kw)
        subs = submit(eng)
        drive(eng)
        out[name] = (eng, subs)
    out["engine"] = teng
    return out


def test_stream_yields_every_token_in_decode_order(streamed):
    events, subs = streamed["events"], streamed["subs"]
    assert all(isinstance(ev, TokenEvent) for ev in events)
    per_uid = {}
    for ev in events:
        assert ev.index == len(per_uid.setdefault(ev.uid, [])), "events out of order"
        per_uid[ev.uid].append(ev.token)
        assert ev.tenant == subs[ev.uid].tenant
    # stream == run, token for token
    for r_run, r_stream in zip(streamed["run"][1], subs):
        assert per_uid[r_stream.uid] == r_run.tokens == r_stream.tokens
    # exactly one terminal event per request, carrying its final token
    finals = [ev for ev in events if ev.done]
    assert sorted(ev.uid for ev in finals) == sorted(r.uid for r in subs)
    for ev in finals:
        assert ev.token == subs[ev.uid].tokens[-1]
    # events arrive as they decode: the first lands on the very first step
    assert events[0].index == 0


def test_stream_events_identical_to_jax_engine(streamed):
    assert _events(streamed["events"]) == _events(streamed["jax_events"])
    for got, want in zip(streamed["subs"], streamed["jax_subs"]):
        assert got.tokens == want.tokens
        _close(got, want)


def test_split_step_equals_step(streamed):
    eng, subs = streamed["split"]
    _, run_subs = streamed["run"]
    for got, want in zip(subs, run_subs):
        assert got.tokens == want.tokens
        np.testing.assert_array_equal(np.stack(got.logits), np.stack(want.logits))
    assert eng.steps == streamed["engine"].steps and eng.blocks_in_use() == 0
    # the pending handle of an idle step finishes with nothing to emit
    pending = eng.step_begin()
    assert pending["decoding"] is None and eng.step_finish(pending) == []


@pytest.fixture(scope="module")
def preempting(model):
    """tests/test_serving.py:452: two requests that collide crossing
    position 16 in a pool of 5 blocks, streamed on both engines."""
    kw = dict(layout="paged", n_lanes=2, n_slots=2, max_len=32, block_size=8, n_blocks=1 + 5)
    engines = _engines(model, "plain", **kw)
    out = []
    for eng in engines:
        a = eng.submit(BASE_TENANT, np.arange(2, 10, dtype=np.int32), 16)
        b = eng.submit(BASE_TENANT, np.arange(12, 20, dtype=np.int32), 16)
        out.append((eng, a, b, list(eng.stream())))
    return out


def test_stream_is_exactly_once_under_preemption(preempting):
    eng, a, b, events = preempting[1]
    assert eng.preemptions >= 1 and b.preemptions >= 1
    per_uid = {}
    for ev in events:
        assert ev.index == len(per_uid.setdefault(ev.uid, [])), (
            f"uid={ev.uid} duplicated or skipped index {ev.index}")
        per_uid[ev.uid].append(ev.token)
    assert per_uid[a.uid] == a.tokens and per_uid[b.uid] == b.tokens
    assert b.delivered == len(b.tokens) and eng.decoded_tokens > len(events)


def test_preempting_stream_identical_to_jax_engine(preempting):
    (jeng, ja, jb, jevents), (teng, ta, tb, tevents) = preempting
    assert _events(tevents) == _events(jevents)
    assert teng.preemptions == jeng.preemptions
    assert (ta.tokens, tb.tokens) == (ja.tokens, jb.tokens)


# ---------------------------------------------------------------------------
# cancel
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def cancelled(model):
    """Under ``EngineConfig.serving()`` (block 8, chunks of 16), four
    requests on a shared prefix and one 40-token prompt: after two steps the
    prompt is mid chunked prefill, one request decodes and one waits;
    cancel those three, then run the rest.  Blocks, refcounts and pins after
    the cancels and at the end, on both engines."""
    lam = model[3]()
    rng = np.random.default_rng(5)
    pre = rng.integers(2, VOCAB, size=16).astype(np.int32)
    prompts = [np.concatenate([pre, rng.integers(2, VOCAB, size=n).astype(np.int32)])
               for n in (3, 6, 5)]
    long = rng.integers(2, VOCAB, size=40).astype(np.int32)
    traffic = [(prompts[0], 8), (long, 5), (prompts[1], 6), (prompts[2], 7)]
    out = {}
    for name, eng in zip(("jax", "port"), _engines(
            model, "serving", n_lanes=2, n_slots=4, max_len=64, block_size=8,
            collect_logits=True)):
        _add(eng, "t1", lam)
        reqs = [eng.submit("t1", p, n) for p, n in traffic]
        eng.step()
        eng.step()
        state = {"mid_prefill": reqs[1].uid in eng._prefilling,
                 "decoding": bool(reqs[0].tokens) and reqs[0].lane >= 0,
                 "queued": reqs[2].lane < 0}
        for r in (reqs[1], reqs[0], reqs[2]):
            eng.cancel(r)
        state["after_cancel"] = (eng.blocks_in_use(), _refs(eng), dict(eng.lam_store._pins),
                                 len(eng.scheduler.queue), eng.scheduler.active())
        eng.cancel(reqs[2])  # a second cancel of the same request is a no-op
        done = eng.run()
        state["end"] = (eng.blocks_in_use(), _refs(eng), dict(eng.lam_store._pins))
        state["done"], state["reqs"], state["engine"] = done, reqs, eng
        out[name] = state
    return out


def test_cancel_queued_active_and_mid_prefill(cancelled):
    st = cancelled["port"]
    assert st["mid_prefill"] and st["decoding"] and st["queued"]
    eng, reqs = st["engine"], st["reqs"]
    in_use, refs, pins, queued, active = st["after_cancel"]
    # only the last request waits; no lane is held; the only blocks out of
    # the pool are the prefix cache's
    assert queued == 1 and active == []
    assert in_use == eng.prefix_cache.cached_blocks and set(refs.values()) == {1}
    assert pins.get("t1") == 1  # the request still queued
    assert sorted(st["done"]) == [reqs[3].uid]
    assert len(reqs[0].tokens) < 8 and reqs[0].tokens[: reqs[0].delivered] == reqs[0].tokens
    assert st["end"][2].get("t1") is None


def test_cancel_matches_jax_engine(cancelled):
    jst, tst = cancelled["jax"], cancelled["port"]
    for key in ("mid_prefill", "decoding", "queued", "end"):
        assert tst[key] == jst[key], key
    assert tst["after_cancel"][:3] == jst["after_cancel"][:3]
    for got, want in zip(tst["reqs"], jst["reqs"]):
        assert got.tokens == want.tokens
    _close(tst["done"][3], jst["done"][3])


# ---------------------------------------------------------------------------
# add_tenants / remove_tenant
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def cohorts(model):
    """Three usable slots: a cohort of two; a cohort that hot-swaps one and
    adds one; remove one; a cohort of two that needs an LRU drop; one
    request per resident tenant; then a cohort while every slot is pinned."""
    lams = {t: model[3]() for t in ("t1", "t2", "t3", "t4", "t5", "t1b", "t6")}
    out = {}
    for name, eng in zip(("jax", "port"), _engines(
            model, "plain", n_lanes=3, n_slots=4, max_len=32, block_size=8,
            collect_logits=True)):
        pick = lambda *ts, eng=eng: _lams(eng, {t.rstrip("b"): lams[t] for t in ts})
        slots = [eng.add_tenants(pick("t1", "t2")), eng.add_tenants(pick("t1b", "t3"))]
        eng.remove_tenant("t2")
        slots.append(eng.add_tenants(pick("t4", "t5")))
        resident = [t for t in ("t1", "t3", "t4", "t5") if t in eng.lam_store]
        tables = {k: np.asarray(v) for k, v in eng.lam_store._tables.items()}
        rng = np.random.default_rng(2)
        reqs = [eng.submit(t, rng.integers(2, VOCAB, size=9).astype(np.int32), 4)
                for t in resident]
        eng.step()  # every resident tenant pinned by an active lane
        with pytest.raises(RuntimeError, match="exhausted"):
            eng.add_tenants(pick("t6"))
        eng.run()
        out[name] = {"slots": slots, "resident": resident, "tables": tables, "reqs": reqs,
                     "order": list(eng.lam_store._slots)}
    return out


def test_add_tenants_and_remove_tenant_match_jax_engine(cohorts):
    jst, tst = cohorts["jax"], cohorts["port"]
    assert tst["slots"] == jst["slots"]
    assert tst["resident"] == jst["resident"] and len(tst["resident"]) == 3
    assert tst["order"] == jst["order"]
    assert tst["tables"].keys() == jst["tables"].keys()
    for key in tst["tables"]:
        np.testing.assert_array_equal(tst["tables"][key], jst["tables"][key])
    for got, want in zip(tst["reqs"], jst["reqs"]):
        assert got.tenant == want.tenant and got.tokens == want.tokens
        _close(got, want)


# ---------------------------------------------------------------------------
# the handoff between engines
# ---------------------------------------------------------------------------


HANDOFF = dict(n_lanes=2, n_slots=4, max_len=64, block_size=8, collect_logits=True)


@pytest.fixture(scope="module")
def handoff(model):
    """Engines A and B of each package under ``EngineConfig.serving()``
    (block 8, chunks of 16).  Request handoff: A admits P1 (a 28-token
    prompt, one monolithic prefill), exports its state and cancels it; B
    injects it.  Prefix handoff: A serves P2 (a 24-token prefix and a tail);
    B serves a prompt that shares P2's first block, imports A's export of
    P2's prefix and serves P2.  A port engine W serves P1 and P2 whole; a
    port engine X takes the JAX engine's payloads."""
    lam = model[3]()
    rng = np.random.default_rng(9)
    p1 = rng.integers(2, VOCAB, size=28).astype(np.int32)
    x = rng.integers(2, VOCAB, size=24).astype(np.int32)
    p2 = np.concatenate([x, rng.integers(2, VOCAB, size=5).astype(np.int32)])
    q = np.concatenate([x[:8], rng.integers(2, VOCAB, size=21).astype(np.int32)])
    out = {"lam": lam, "prompts": (p1, p2)}
    for pkg in ("jax", "port"):
        a, b = (_engine(model, pkg, "serving", **HANDOFF) for _ in range(2))
        for eng in (a, b):
            _add(eng, "t1", lam)
        st = {}
        r = a.submit("t1", p1, 6)
        a.step()
        st["state"] = a.export_request_state(r)
        a.cancel(r)
        st["a_after_cancel"] = (a.blocks_in_use(), _refs(a))
        inj = b.inject_prefilled("t1", p1, 6, st["state"])
        b.run()
        st["injected"] = inj
        st["b_after_inject"] = (b.blocks_in_use(), _refs(b))
        st["a_p2"] = _serve(a, "t1", p2, 5)
        st["prefix"] = a.export_prefix("t1", p2)
        _serve(b, "t1", q, 3)
        hits0 = b.prefix_cache.hits
        st["local"] = len(b.prefix_cache.match(b._family_key("t1", p2.size), p2))
        st["imported"] = b.import_prefix("t1", p2, st["prefix"])
        st["b_after_import"] = (b.blocks_in_use(), _refs(b))
        st["b_p2"] = _serve(b, "t1", p2, 5)
        st["b_hits"] = b.prefix_cache.hits - hits0
        out[pkg] = st
    whole = _engine(model, "port", "serving", **HANDOFF)
    _add(whole, "t1", lam)
    out["whole"] = (_serve(whole, "t1", p1, 6), _serve(whole, "t1", p2, 5))
    # the JAX engine's payloads on a fresh port engine
    xeng = _engine(model, "port", "serving", **HANDOFF)
    _add(xeng, "t1", lam)
    jx = out["jax"]
    x1 = xeng.inject_prefilled("t1", p1, 6, jx["state"])
    xeng.run()
    imported = xeng.import_prefix("t1", p2, jx["prefix"])
    out["cross"] = (x1, imported, _serve(xeng, "t1", p2, 5), xeng)
    return out


def test_export_request_state_payload_matches_jax_engine(handoff):
    got, want = handoff["port"]["state"], handoff["jax"]["state"]
    p1 = handoff["prompts"][0]
    assert got["k"].shape == want["k"].shape == (get_reduced("smollm-135m").n_layers, 4, 8,
                                                 *want["k"].shape[3:])
    assert got["k"].dtype == np.float32
    for name in ("k", "v"):
        np.testing.assert_allclose(got[name], want[name], atol=KV_TOL)
    np.testing.assert_allclose(got["logits"], want["logits"], atol=LOGIT_TOL)
    assert got["token"] == want["token"] and got["n_blocks"] == want["n_blocks"] == 4
    np.testing.assert_array_equal(got["prompt"], p1)
    assert handoff["port"]["a_after_cancel"] == handoff["jax"]["a_after_cancel"]


def test_inject_prefilled_serves_the_request_as_whole(handoff):
    got, want = handoff["port"]["injected"], handoff["whole"][0]
    assert got.tokens == want.tokens and got.preemptions == 0
    np.testing.assert_allclose(np.stack(got.logits), np.stack(want.logits), atol=KV_TOL)
    jax_inj = handoff["jax"]["injected"]
    assert got.tokens == jax_inj.tokens
    _close(got, jax_inj)
    assert handoff["port"]["b_after_inject"] == handoff["jax"]["b_after_inject"]


def test_export_import_prefix_matches_jax_engine(handoff):
    port, jx = handoff["port"], handoff["jax"]
    for name in ("k", "v"):
        np.testing.assert_allclose(port["prefix"][name], jx["prefix"][name], atol=KV_TOL)
    assert port["prefix"]["n_blocks"] == 3 and port["local"] == jx["local"] == 1
    assert port["imported"] == jx["imported"] == 2
    assert port["b_after_import"] == jx["b_after_import"]
    assert port["b_hits"] == jx["b_hits"] == 3  # P2 on B adopts every full block
    want = handoff["whole"][1]
    for got in (port["b_p2"], port["a_p2"]):
        assert got.tokens == want.tokens
        np.testing.assert_allclose(np.stack(got.logits), np.stack(want.logits), atol=LOGIT_TOL)
    assert port["b_p2"].tokens == jx["b_p2"].tokens
    _close(port["b_p2"], jx["b_p2"])


def test_jax_engine_payloads_serve_on_the_port_engine(handoff):
    x1, imported, x2, xeng = handoff["cross"]
    w1, w2 = handoff["whole"]
    assert x1.tokens == w1.tokens and imported == 3
    _close(x1, w1)
    assert x2.tokens == w2.tokens and xeng.prefix_cache.hits == 3
    _close(x2, w2)


def test_import_prefix_from_the_local_match_only(handoff, model):
    """Writing the shipped blocks from the payload's first block instead of
    from the local match puts the wrong K/V under the imported entries: the
    served logits leave the bar (the check rejects the planted fault)."""
    p2 = handoff["prompts"][1]
    b = _engine(model, "port", "serving", **HANDOFF)
    _add(b, "t1", handoff["lam"])
    # B's cache holds P2's first block: the import writes two, from block 1
    _serve(b, "t1", np.concatenate([p2[:8], p2[:8] + 1, p2[16:]]), 2)
    write = b._write_imported_blocks
    b._write_imported_blocks = lambda ids, payload, skip: write(ids, payload, skip=0)
    assert b.import_prefix("t1", p2, handoff["port"]["prefix"]) == 2
    got, want = _serve(b, "t1", p2, 5), handoff["whole"][1]
    n = min(len(got.tokens), len(want.tokens))
    err = np.abs(np.stack(got.logits)[:n] - np.stack(want.logits)[:n]).max()
    assert err > 100 * LOGIT_TOL


def test_token_only_handoff_serves_the_same_tokens(handoff, model):
    """A payload without its logits row (a prefill engine that does not
    collect logits) hands over the first token alone; an engine that
    collects logits refuses it."""
    state = dict(handoff["port"]["state"], logits=None)
    p1 = handoff["prompts"][0]
    for collect in (False, True):
        eng = _engine(model, "port", "serving", **{**HANDOFF, "collect_logits": collect})
        _add(eng, "t1", handoff["lam"])
        r = eng.inject_prefilled("t1", p1, 6, state)
        if collect:
            with pytest.raises(ValueError, match="collects logits"):
                eng.run()
        else:
            eng.run()
            assert r.tokens == handoff["whole"][0].tokens
