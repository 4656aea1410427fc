"""The legacy engine keywords in the PyTorch port against the JAX reference:
the four reference cases (``tests/test_engine_config.py:108``, ``:124``,
``:141``, ``:147``) held against the reference.

* ``EngineConfig.from_legacy_kwargs`` field for field the reference's over
  random draws of :data:`LEGACY_KWARGS` (or the same exception; the port's
  config alone refuses ``n_slots < 2``, which the reference refuses when it
  builds the engine); unknown keywords give the reference's ``TypeError``.
* The engine's shim warns once a process a topic, and again after
  ``_reset_deprecation_warnings``; its prefix is the port's own, which the
  repo's warnings filter for ``repro.serving`` leaves alone.
* A legacy engine (reduced smollm-135m, float32, CPU) streams bitwise the
  config engine's (tokens and logits) and gives the JAX legacy engine's
  tokens on the same weights and λ.
* ``registry`` warns and ``is`` the λ-store.
* No module of the port and nothing in ``chip_smoke.py`` builds an engine
  from legacy keywords, but the script's deliberate check of the shim.
"""
import ast
import dataclasses
import warnings
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
from repro.serving import config as jconfig
from repro.serving.engine import _reset_deprecation_warnings as j_reset
from repro.serving.lam_store import LamStore as JLamStore
from repro_torch.configs import get_reduced
from repro_torch.interop import params_from_jax
from repro_torch.serving import EngineConfig, MultiTenantEngine
from repro_torch.serving import config as tconfig
from repro_torch.serving import engine as tengine

ROOT = Path(__file__).resolve().parents[1]
# the legacy engine's tokens equal the JAX legacy engine's (float32, 3
# layers): both packages' engines agree to ~5e-6 in logits here
# (test_torch_serving.py), so greedy tokens are exact


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)
    jax.clear_caches()


def _fields(c) -> dict:
    return dataclasses.asdict(c)


def test_legacy_kwargs_are_the_reference_names():
    assert tconfig.LEGACY_KWARGS == jconfig.LEGACY_KWARGS and len(tconfig.LEGACY_KWARGS) == 14


def test_from_legacy_kwargs_round_trip():
    """``tests/test_engine_config.py:108`` on the port, and each side
    against the reference's."""
    assert EngineConfig.from_legacy_kwargs() == EngineConfig.oracle_dense()
    kw = dict(n_lanes=2, n_slots=3, max_len=32, paged=True, block_size=8, share_prefix=True,
              watermark=1)
    got = EngineConfig.from_legacy_kwargs(**kw)
    assert got == EngineConfig(layout="paged", n_lanes=2, n_slots=3, max_len=32, block_size=8,
                               share_prefix=True, watermark=1)
    assert _fields(got) == _fields(JEngineConfig.from_legacy_kwargs(**kw))
    for bad in (dict(paged=True, blocksize=8), dict(lanes=2, registry=1)):
        with pytest.raises(TypeError) as mine:
            EngineConfig.from_legacy_kwargs(**bad)
        with pytest.raises(TypeError) as ref:
            JEngineConfig.from_legacy_kwargs(**bad)
        assert str(mine.value) == str(ref.value)
        assert str(mine.value).startswith("unknown engine kwargs")


def _draw_legacy(seed: int) -> dict:
    """A random subset of the legacy keywords with values on both sides of
    the config's validation."""
    rng = np.random.default_rng(seed)
    values = {
        "n_lanes": lambda: int(rng.integers(0, 6)),
        "n_slots": lambda: int(rng.integers(1, 10)),
        "max_len": lambda: int(rng.choice([16, 48, 128])),
        "collect_logits": lambda: bool(rng.integers(2)),
        "seed": lambda: int(rng.integers(0, 100)),
        "paged": lambda: bool(rng.integers(2)),
        "block_size": lambda: int(rng.choice([4, 8, 16])),
        "n_blocks": lambda: None if rng.integers(2) else int(rng.integers(4, 64)),
        "share_prefix": lambda: bool(rng.integers(2)),
        "watermark": lambda: int(rng.integers(-1, 3)),
        "quantum": lambda: None if rng.integers(2) else int(rng.integers(0, 5)),
        "cold_slots": lambda: int(rng.integers(-1, 6)),
        "shard_lam": lambda: bool(rng.integers(2)),
        "telemetry": lambda: bool(rng.integers(2)),
    }
    names = [n for n in tconfig.LEGACY_KWARGS if rng.integers(2)]
    return {n: values[n]() for n in names}


def _outcome(cls, kw):
    try:
        return _fields(cls.from_legacy_kwargs(**kw))
    except (TypeError, ValueError) as e:
        return (type(e), str(e))


@settings(max_examples=80, deadline=None)
@given(seed=st.integers(0, 2**31 - 1))
def test_from_legacy_kwargs_matches_the_reference(seed):
    """Field for field the reference's config, or the same exception and
    message, for any draw of the legacy keywords.  One place differs: the
    port's config refuses ``n_slots < 2`` (no slot beside the base's), which
    the reference's config takes and its λ-store then refuses when the
    engine is built; so there both refuse, each where it checks."""
    kw = _draw_legacy(seed)
    got, want = _outcome(EngineConfig, dict(kw)), _outcome(JEngineConfig, dict(kw))
    if kw.get("n_slots", 2) < 2 and isinstance(want, dict):
        assert got == (ValueError, "n_slots must hold slot 0 (base) plus one tenant"), kw
        with pytest.raises(AssertionError, match="slot 0"):
            JLamStore({}, n_slots=kw["n_slots"])
        return
    assert got == want, kw


@pytest.fixture(scope="module")
def weights():
    """Reduced smollm-135m (float32) drawn by JAX and crossed into the port,
    three tenants' λ and four requests."""
    jcfg = jax_reduced("smollm-135m").replace(dtype="float32")
    cfg = get_reduced("smollm-135m").replace(dtype="float32")
    jp = jax_build(jcfg).init(jax.random.PRNGKey(5))
    tp = params_from_jax(jax.tree_util.tree_map(np.asarray, jp), device="cpu")
    rng = np.random.default_rng(1)
    lam_shape = np.asarray(jp["groups"]["adapters"]["attn"]["wq"]["lam"]).shape
    lams = {f"t{i}": {"attn": {p: (rng.standard_normal(lam_shape) * 0.3).astype(np.float32)
                               for p in ("wq", "wv")}} for i in range(3)}
    reqs = [(f"t{i % 3}", rng.integers(2, 256, size=int(rng.integers(4, 20))).astype(np.int32), 6)
            for i in range(4)]
    return jcfg, jp, cfg, tp, lams, reqs


def _serve(engine, lams, reqs, to_lam=lambda lam: lam):
    for t, lam in lams.items():
        engine.add_tenant(t, to_lam(lam))
    for tenant, prompt, n in reqs:
        engine.submit(tenant, prompt, n)
    done = engine.run()
    return [(done[u].tenant, list(done[u].tokens), [np.asarray(x) for x in done[u].logits])
            for u in sorted(done)]


LEGACY = dict(n_lanes=2, n_slots=4, max_len=48, collect_logits=True, block_size=8)


@pytest.mark.parametrize("paged", [True, False], ids=["paged", "oracle_dense"])
def test_legacy_engine_streams_the_config_engine_and_the_reference(paged, weights):
    """``tests/test_engine_config.py:124`` on the port: the legacy keywords
    warn once (a second construction is silent) and build the config a
    migrated call site passes; that engine streams bitwise the config
    engine's and gives the JAX legacy engine's tokens."""
    jcfg, jp, cfg, tp, lams, reqs = weights
    tengine._reset_deprecation_warnings()
    with pytest.warns(DeprecationWarning, match="^repro_torch.serving deprecation: ") as rec:
        legacy = MultiTenantEngine(cfg, params=tp, device="cpu", paged=paged, **LEGACY)
    assert len([w for w in rec if w.category is DeprecationWarning]) == 1
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        MultiTenantEngine(cfg, params=tp, device="cpu", paged=paged, **LEGACY)
    assert not [w for w in caught if "repro_torch.serving deprecation" in str(w.message)]
    want_config = EngineConfig.from_legacy_kwargs(paged=paged, **LEGACY)
    assert legacy.config == want_config
    assert legacy.layout == ("paged" if paged else "oracle_dense") and legacy.paged == paged
    config_engine = MultiTenantEngine(cfg, want_config, params=tp, device="cpu")
    got, want = _serve(legacy, lams, reqs), _serve(config_engine, lams, reqs)
    assert [(t, toks) for t, toks, _ in got] == [(t, toks) for t, toks, _ in want]
    assert all(np.array_equal(a, b) for (_, _, la), (_, _, lb) in zip(got, want)
               for a, b in zip(la, lb, strict=True))
    j_reset()
    with pytest.warns(DeprecationWarning, match="repro.serving deprecation"):
        jlegacy = JEngine(jcfg, params=jp, paged=paged, **LEGACY)
    ref = _serve(jlegacy, lams, reqs, lambda lam: jax.tree_util.tree_map(jnp.asarray, lam))
    assert [(t, toks) for t, toks, _ in got] == [(t, toks) for t, toks, _ in ref]


def test_engine_rejects_config_plus_legacy_kwargs(weights):
    """``tests/test_engine_config.py:141`` on the port."""
    cfg, tp = weights[2], weights[3]
    with pytest.raises(TypeError, match="not both"):
        MultiTenantEngine(cfg, EngineConfig(), params=tp, device="cpu", n_lanes=2)


def test_registry_property_is_a_deprecated_alias(weights):
    """``tests/test_engine_config.py:147`` on the port: the warning fires
    once a process and re-arms after the reset."""
    cfg, tp = weights[2], weights[3]
    eng = MultiTenantEngine(cfg, EngineConfig(n_lanes=1, n_slots=2, max_len=16), params=tp,
                            device="cpu")
    tengine._reset_deprecation_warnings()
    with pytest.warns(DeprecationWarning, match="lam_store"):
        reg = eng.registry
    assert reg is eng.lam_store
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        assert eng.registry is eng.lam_store
    assert not caught
    tengine._reset_deprecation_warnings()
    with pytest.warns(DeprecationWarning, match="^repro_torch.serving deprecation: "):
        eng.registry


def _engine_calls(path: Path):
    """(enclosing function, call) of every ``MultiTenantEngine(...)`` call."""
    tree = ast.parse(path.read_text())
    out = []

    def visit(node, fn):
        for child in ast.iter_child_nodes(node):
            name = child.name if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)) else fn
            if isinstance(child, ast.Call):
                f = child.func
                if (getattr(f, "id", None) or getattr(f, "attr", None)) == "MultiTenantEngine":
                    out.append((name, child))
            visit(child, name)

    visit(tree, None)
    return out


def test_nothing_in_tree_builds_an_engine_from_legacy_keywords():
    """Every engine the port's modules and ``chip_smoke.py`` build takes an
    ``EngineConfig`` (keywords: params, device, config; no ``**``), but
    ``chip_smoke.legacy_serve``, the script's check of the shim."""
    allowed = {"params", "device", "config"}
    paths = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
    found = 0
    for path in paths:
        for fn, call in _engine_calls(path):
            found += 1
            if path.name == "chip_smoke.py" and fn == "legacy_serve":
                continue
            names = {k.arg for k in call.keywords}
            assert None not in names and names <= allowed, (path, fn, names)
    assert found >= 10
