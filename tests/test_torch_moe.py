"""The moe family of the port (``repro_torch/models/moe.py``; moonshot-v1-16b-a3b
and mixtral-8x22b) against the JAX package on the CPU: the routed FFN
``_local_moe`` / ``moe_ffn`` in float32 drop-free and at a capacity that
drops copies, and in bf16; the init trees; reduced ``apply`` logits and aux;
``tests/test_decode_consistency.py``'s prefill+decode contract; a planted
fault the parity check must reject; the deterministic combine; the configs
and the full-width parameter count on meta tensors.

Inputs are numpy draws from a seed, weights cross from JAX's trees through
``interop``.  Bounds: float32 y within 1e-5·max(1, |y|) (measured ≤ 7.2e-7:
the two packages sum float32 in other orders), aux within 1e-6 (measured 0);
bf16 y within one bf16 ulp of max|y| (measured bitwise: both round the same
float32 products and sums to bf16); logits within 2e-5 (``test_torch_models.py``'s
bound; four layers of routed experts, two frameworks, float32: measured
≤ 1.2e-5)."""
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.configs import get_reduced as jax_reduced
from repro.models import build_model as jax_build
from repro.models import moe as jmoe
from repro_torch.configs import get_config, get_reduced
from repro_torch.interop import params_from_jax
from repro_torch.models import build_model, moe, transformer
from repro_torch.tree import tree_leaves

ROOT = Path(__file__).resolve().parents[1]
ARCHS = ("moonshot-v1-16b-a3b", "mixtral-8x22b")
Y_RTOL = 1e-5
AUX_TOL = 1e-6
LOGIT_TOL = 2e-5
BF16_ULP = 2.0**-8


@pytest.fixture(scope="module", autouse=True)
def _threads_and_jax_caches():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)
    jax.clear_caches()


def _weights(seed, T, d=64, E=8, f=32):
    """x (T, d), router (d, E), experts (E, d, f), (E, d, f), (E, f, d)."""
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((T, d)).astype(np.float32),
            (rng.standard_normal((d, E)) / 8).astype(np.float32),
            (rng.standard_normal((E, d, f)) / 8).astype(np.float32),
            (rng.standard_normal((E, d, f)) / 8).astype(np.float32),
            (rng.standard_normal((E, f, d)) / np.sqrt(f)).astype(np.float32))


def _jax_kept(x, wr, k, C):
    """The reference's routing, ``moe.py:66-76`` in jnp: the (T·k,) mask of
    the copies that keep a slot and each kept copy's slot."""
    probs = jax.nn.softmax(jnp.asarray(x) @ jnp.asarray(wr), axis=-1)
    _, topi = jax.lax.top_k(probs, k)
    E = wr.shape[-1]
    flat_e = topi.reshape(-1)
    order = jnp.argsort(flat_e, stable=True)
    sorted_e = flat_e[order]
    counts = jnp.bincount(flat_e, length=E)
    starts = jnp.cumsum(counts) - counts
    pos = jnp.arange(flat_e.size) - starts[sorted_e]
    slot = jnp.where(pos < C, sorted_e * C + pos, E * C)
    copy_slot = np.empty(flat_e.size, np.int64)
    copy_slot[np.asarray(order)] = np.asarray(slot)
    return copy_slot < E * C, copy_slot


def _both(ws, k, C, dtype=np.float32):
    """(port y, port aux, JAX y, JAX aux) of ``_local_moe`` on ``ws``; the
    router stays float32, the rest in ``dtype``."""
    x, wr, wg, wu, wd = ws
    jcast = (lambda a: jnp.asarray(a).astype(jnp.bfloat16)) if dtype != np.float32 else jnp.asarray
    tcast = (lambda a: torch.from_numpy(a).bfloat16()) if dtype != np.float32 else torch.from_numpy
    jy, ja = jmoe._local_moe(jcast(x), jnp.asarray(wr), jcast(wg), jcast(wu), jcast(wd), k=k,
                             capacity=C, psum_axis=None)
    ty, ta = moe._local_moe(tcast(x), torch.from_numpy(wr), tcast(wg), tcast(wu), tcast(wd),
                            k=k, capacity=C)
    return (ty.float().numpy(), float(ta), np.asarray(jy.astype(jnp.float32)), float(ja))


@pytest.mark.parametrize("C", [64, 8], ids=["drop_free", "cf1_drops"])
def test_local_moe_matches_jax_float32(C):
    """T = 32 rows, E = 8, k = 2: C = T·k keeps every copy; C = 8 is cf 1.0
    (``max(8, ⌈32·2/8⌉)``), where copies past an expert's 8th drop.  The
    same copies keep the same slots, y and aux agree."""
    T, k = 32, 2
    ws = _weights(0, T)
    ty, ta, jy, ja = _both(ws, k, C)
    r = moe.route(torch.from_numpy(ws[0]), torch.from_numpy(ws[1]), k, C)
    kept, slots = _jax_kept(ws[0], ws[1], k, C)
    np.testing.assert_array_equal(r.copy_slot.numpy(), slots)
    n_drop = int((~kept).sum())
    assert (n_drop > 0) == (C < T)  # the dropping case really drops
    err = float(np.abs(ty - jy).max())
    print(f"[parity] _local_moe float32 C={C}: {n_drop} copies dropped, y max|Δ| {err:.2e}, "
          f"aux |Δ| {abs(ta - ja):.2e}")
    assert err <= Y_RTOL * max(1.0, float(np.abs(jy).max()))
    assert abs(ta - ja) <= AUX_TOL


@pytest.mark.parametrize("C", [64, 8], ids=["drop_free", "cf1_drops"])
def test_local_moe_matches_jax_bf16(C):
    """bf16 x and experts, float32 router: y within one bf16 ulp of max|y|
    (the float32 products and sums round to bf16 at h and at y, in both)."""
    ty, ta, jy, ja = _both(_weights(1, 32), 2, C, dtype="bfloat16")
    err = float(np.abs(ty - jy).max())
    print(f"[parity] _local_moe bf16 C={C}: y max|Δ| {err:.2e} (bar {BF16_ULP:.2e}·max|y|)")
    assert err <= BF16_ULP * float(np.abs(jy).max())
    assert abs(ta - ja) <= AUX_TOL


def test_unrenormalised_gates_are_rejected(monkeypatch):
    """A planted fault: the top-k gates left as raw softmax probabilities
    (no renormalisation).  The float32 parity check above must fail."""
    ws = _weights(0, 32)
    sound, _, jy, _ = _both(ws, 2, 8)
    real = moe.route

    def raw_gates(x, wr, k, C):
        r = real(x, wr, k, C)
        return r._replace(gates=torch.gather(r.probs, 1, r.experts))

    monkeypatch.setattr(moe, "route", raw_gates)
    faulty, _, _, _ = _both(ws, 2, 8)
    bar = Y_RTOL * max(1.0, float(np.abs(jy).max()))
    assert float(np.abs(sound - jy).max()) <= bar
    assert float(np.abs(faulty - jy).max()) > 100 * bar


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_forced_experts_stand_in_for_the_top_k(monkeypatch):
    """``chip_smoke.forcing_top_k`` swapped in for ``moe._top_k``: the
    router's own choice forced gives the same routing bitwise; another
    choice keeps this router's probabilities at those experts,
    renormalised, and buffers them by that choice."""
    cs = _chip_smoke()
    x, wr = (torch.from_numpy(a) for a in _weights(5, 32)[:2])
    own = moe.route(x, wr, 2, 8)
    other = (own.experts + 1) % wr.shape[-1]
    monkeypatch.setattr(moe, "_top_k", cs.forcing_top_k(iter([own.experts, other])))
    again = moe.route(x, wr, 2, 8)
    assert all(torch.equal(a, b) for a, b in zip(own, again))
    r = moe.route(x, wr, 2, 8)
    g = torch.gather(own.probs, 1, other)
    assert torch.equal(r.experts, other)
    assert torch.equal(r.gates, g / g.sum(-1, keepdim=True))
    assert torch.equal(r.counts, torch.bincount(other.reshape(-1), minlength=wr.shape[-1]))


def test_the_adapted_layers_check_holds_a_sound_serve_and_rejects_the_faults():
    """``chip_smoke.moe_verify_tail`` on reduced moonshot in float32: the
    merged-weight reference over the adapted layers (the last 2 of 4), run
    on the engine's own residual stream at the first of them, routed as the
    engine routed, holds the served logits within 1e-5 of each row's
    largest |logit| (measured ≤ 7.3e-7); the two planted faults the card
    phase plants (the decode seg sent to slot 0, the top-k gates left
    unrenormalised) read over 100 times that bound (measured 6,127 and
    59,527 times)."""
    from repro_torch.serving import EngineConfig, MultiTenantEngine, random_lambda

    cs = _chip_smoke()
    cfg = get_reduced(ARCHS[0]).replace(dtype="float32")
    engine = MultiTenantEngine(cfg, EngineConfig(collect_logits=True), device="cpu")
    lams = {f"tenant{i}": random_lambda(torch.Generator().manual_seed(i), engine.params, 0.3)
            for i in range(3)}
    for t, lam in lams.items():
        engine.add_tenant(t, lam)
    rng = np.random.default_rng(0)
    log = cs.RouteLog()
    with log.installed(engine):
        for t in lams:
            engine.submit(t, rng.integers(2, cfg.vocab_size, size=int(rng.integers(5, 30))), 8)
        done = engine.run()
    drift = 1e-5
    sound = cs.moe_verify_tail(cfg, engine, lams, done, log, drift)
    assert all(r["ok"] and r["from_layer"] == 2 for r in sound), sound
    faults = cs.moe_planted_faults(cfg, engine, lams, done,
                                   lambda *a: cs.moe_verify_tail(*a, drift)[0])
    for name, row in faults.items():
        assert row["max_dlogits_over_bound"] > 100, (name, row)


def test_moe_every_other_than_one_is_refused():
    """``moe_every`` > 1 interleaves dense and moe layers, as the hybrid
    family does; the port routes every layer, so the config refuses it."""
    with pytest.raises(NotImplementedError, match="item 12b"):
        get_config(ARCHS[0]).replace(moe_every=2)


def test_combine_is_deterministic_and_independent_of_slot_order():
    """Two runs of ``_local_moe`` are bitwise equal; and ``combine`` gives
    bitwise the same tokens however the slots are laid out (the sort's
    order of the copies inside the buffers), since each token sums its own
    k rows in j order."""
    ws = [torch.from_numpy(a) for a in _weights(2, 32)]
    a, aux_a = moe._local_moe(*ws, k=2, capacity=8)
    b, aux_b = moe._local_moe(*ws, k=2, capacity=8)
    assert torch.equal(a, b) and torch.equal(aux_a, aux_b)
    rng = np.random.default_rng(3)
    T, k, S, d = 16, 3, 40, 24
    y_slots = torch.from_numpy(rng.standard_normal((S, d)).astype(np.float32))
    # every slot holds one copy; the other T·k - S copies dropped (slot S)
    copy_slot = torch.from_numpy(rng.permutation(
        np.concatenate([np.arange(S), np.full(T * k - S, S)])))
    pi = torch.from_numpy(rng.permutation(S))
    moved = torch.empty_like(y_slots)
    moved[pi] = y_slots  # slot s's row now lives at pi[s]
    relabel = torch.cat([pi, torch.tensor([S])])
    want = moe.combine(y_slots, copy_slot, T, k)
    got = moe.combine(moved, relabel[copy_slot], T, k)
    assert torch.equal(want, got)
    # token t sums its k rows in j order, a dropped copy's row zeros
    for t in range(T):
        rows = [y_slots[s] if s < S else torch.zeros(d) for s in copy_slot[t * k:(t + 1) * k]]
        acc = rows[0]
        for row in rows[1:]:
            acc = acc + row
        assert torch.equal(want[t], acc)


@pytest.fixture(scope="module", params=ARCHS)
def models(request):
    arch = request.param
    jcfg = jax_reduced(arch).replace(dtype="float32")
    jm = jax_build(jcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    tm = build_model(get_reduced(arch).replace(dtype="float32"), "cpu")
    tp = params_from_jax(jax.tree_util.tree_map(np.asarray, jp), device="cpu")
    return jm, jp, tm, tp


def test_apply_and_aux_match_jax(models):
    """Reduced ``apply`` logits and the summed aux (``train=True``)."""
    jm, jp, tm, tp = models
    toks = np.random.default_rng(4).integers(0, tm.cfg.vocab_size, size=(2, 16)).astype(np.int32)
    want, jaux = jm.apply(jp, tokens=jnp.asarray(toks), train=True)
    got, aux = tm.apply(tp, torch.from_numpy(toks), train=True)
    err = float(np.abs(got.detach().numpy() - np.asarray(want)).max())
    print(f"[parity] {tm.cfg.name} apply: max|Δ| {err:.2e}, aux {float(aux):.6f} "
          f"(JAX {float(jaux):.6f})")
    assert got.shape == (2, 16, tm.cfg.vocab_size) and err < LOGIT_TOL
    assert abs(float(aux) - float(jaux)) <= AUX_TOL * tm.cfg.n_layers
    assert float(aux) > 0.5 * tm.cfg.n_layers  # E·Σ frac·p ≥ 1 a layer at balance


def test_prefill_decode_matches_full(models):
    """``tests/test_decode_consistency.py:37-56``: a prefill of the first
    S-1 tokens and a decode of the last against the full forward, in the
    port (the reduced configs drop nothing, so the rows of a call do not
    matter), and the port's logits against JAX's prefill and decode."""
    jm, jp, tm, tp = models
    B, S = 2, 12
    toks = np.random.default_rng(1).integers(0, tm.cfg.vocab_size, size=(B, S)).astype(np.int32)
    t = torch.from_numpy(toks)
    full = tm.apply(tp, t)
    cache = tm.init_decode_state(B, 32, torch.float32)
    pre, cache = tm.prefill(tp, cache, t[:, :S - 1])
    dec, cache = tm.decode_step(tp, cache, t[:, S - 1:])
    atol = 3e-5 * max(float(full.abs().max()), 1.0)
    np.testing.assert_allclose(pre.numpy(), full[:, S - 2].numpy(), atol=atol)
    np.testing.assert_allclose(dec.numpy(), full[:, S - 1].numpy(), atol=atol)
    jcache = jm.init_decode_state(B, 32, jnp.float32)
    jpre, jcache = jm.prefill(jp, jcache, tokens=jnp.asarray(toks[:, :S - 1]))
    jdec, jcache = jm.decode_step(jp, jcache, token=jnp.asarray(toks[:, S - 1:]))
    np.testing.assert_allclose(pre.numpy(), np.asarray(jpre), atol=LOGIT_TOL)
    np.testing.assert_allclose(dec.numpy(), np.asarray(jdec), atol=LOGIT_TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_init_tree_matches_the_reference(arch):
    """The same keys, shapes and dtypes as JAX's bf16 init, ``moe`` in place
    of ``mlp``, the router float32."""
    jp = jax_build(jax_reduced(arch)).init(jax.random.PRNGKey(0))
    tp = build_model(get_reduced(arch), "cpu").init(torch.Generator().manual_seed(0))
    jflat = jax.tree_util.tree_flatten_with_path(jp)[0]
    want = {jax.tree_util.keystr(p): (tuple(v.shape), str(v.dtype)) for p, v in jflat}

    def walk(node, path=""):
        if isinstance(node, dict):
            out = {}
            for k, v in node.items():
                out.update(walk(v, f"{path}['{k}']"))
            return out
        return {path: (tuple(node.shape), str(node.dtype).split(".")[1])}

    assert walk(tp) == want
    r = tp["groups"]["moe"]
    assert r["w_router"].dtype == torch.float32 and r["we_gate"].dtype == torch.bfloat16
    assert "mlp" not in tp["groups"]


def test_interop_crosses_moe_leaves_bitwise():
    """A bf16 JAX tree's moe leaves cross leaf for leaf: the float32 router
    as float32, the bf16 experts by bit pattern."""
    jp = jax_build(jax_reduced(ARCHS[0])).init(jax.random.PRNGKey(1))
    tp = params_from_jax(jax.tree_util.tree_map(np.asarray, jp), device="cpu")
    for name, leaf in jp["groups"]["moe"].items():
        got = tp["groups"]["moe"][name]
        want = np.asarray(leaf.astype(jnp.float32))
        assert str(got.dtype).split(".")[1] == str(leaf.dtype), name
        np.testing.assert_array_equal(got.float().numpy(), want, err_msg=name)
    assert tp["groups"]["moe"]["w_router"].dtype == torch.float32


@pytest.mark.parametrize("arch", ARCHS)
def test_configs_match_the_reference(arch):
    for mine, ref in ((get_config(arch), jax_config(arch)), (get_reduced(arch), jax_reduced(arch))):
        for f in ("name", "family", "n_layers", "d_model", "n_heads", "n_kv_heads", "d_ff",
                  "vocab_size", "d_head", "dtype", "n_experts", "experts_per_token",
                  "moe_every", "capacity_factor", "microbatches", "is_moe"):
            assert getattr(mine, f) == getattr(ref, f), f
        for f in ("mode", "targets", "layers", "tau", "rank_cap"):
            assert getattr(mine.adapter, f) == getattr(ref.adapter, f), f
    red = get_reduced(arch)
    assert red.capacity_factor == red.n_experts  # drop-free: C = T·k in every call
    for T in (1, 4, 17, 64, 256):
        assert moe.capacity(red, T) == T * red.experts_per_token


@pytest.mark.parametrize("T,C", [(4, 8), (64, 8), (68, 8), (69, 9), (256, 30)])
def test_capacity_at_moonshot_width(T, C):
    """C = min(max(8, ⌈1.25·T·6/64⌉), T·6): 8 for every T ≤ 68 (a 64-row
    prefill bucket's 384 copies over 64 experts drop some), 30 over a
    256-row train microbatch; T·k for a single row."""
    assert moe.capacity(get_config("moonshot-v1-16b-a3b"), T) == C
    assert moe.capacity(get_config("moonshot-v1-16b-a3b"), 1) == 6


class _MetaGen(torch.Generator):
    """A generator whose draws land on the meta device (shapes only)."""

    @property
    def device(self):
        return torch.device("meta")


@pytest.mark.parametrize("arch", ARCHS)
def test_param_count_at_full_width_on_meta_tensors(arch):
    """``tests/test_models_smoke.py:74-76``: moonshot ≈ 28 B, mixtral
    141 B (0.5-1.7× each), counted over the port's full-width decoder built
    layer by layer on the meta device; the reference's analytic count is the
    same but for the RMS-norm scales."""
    cfg = get_config(arch)
    params = transformer.init_decoder_params(_MetaGen(), cfg)
    n = sum(t.numel() for t in tree_leaves(params))
    published = {"moonshot-v1-16b-a3b": 28e9, "mixtral-8x22b": 141e9}[arch]
    assert 0.5 * published < n < 1.7 * published, n
    assert n - (2 * cfg.n_layers + 1) * cfg.d_model == jax_config(arch).param_count()
    assert params["groups"]["moe"]["w_router"].dtype == torch.float32
