"""The hybrid family (jamba-1.5-large-398b, reduced: one group of 8 layers,
attention at 4, 7 Mamba layers, 4 moe layers; float32, CPU) against the
JAX package: the config, ``moe_every`` and the parameter count; the init
tree leaf for leaf; the Mamba pieces (``_causal_conv`` with its ``length``
gather, the chunked scan across chunks, the mixer's prefill and decode)
with the weights crossed by ``interop.py``; ``apply`` and its moe aux,
prefill and decode, the bucketed prefill (padded equals exact on the
Mamba leaves), the lane axes and per-lane init; the paged prefill view's
fresh recurrent state spliced into its lane (bitwise the dense
admission's); the mamba adapter targets.  Its train step's λ gradients
are ``test_torch_recurrent_train.py``'s.

Bounds: float32 within 2e-5 of JAX (logits, outputs; states 3e-5
absolute, 1e-4 relative, the reference's ``test_lane_state.py`` bar);
the scan sums in another order than JAX's associative scan (1e-5); port
against port bitwise."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.configs import get_reduced as jax_reduced
from repro.models import build_model as jax_build
from repro.models import mamba as jmamba
from repro_torch.configs import get_config, get_reduced
from repro_torch.interop import params_from_jax
from repro_torch.models import build_model, mamba
from repro_torch.models.model_zoo import Model

ARCH = "jamba-1.5-large-398b"
TOL = 2e-5


@pytest.fixture(scope="module", autouse=True)
def _threads_and_jax_caches():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)
    jax.clear_caches()


_CACHE = {}


def _models():
    if not _CACHE:
        jcfg = jax_reduced(ARCH).replace(dtype="float32", remat=False)
        jm = jax_build(jcfg)
        npj = jax.tree_util.tree_map(np.asarray, jm.init(jax.random.PRNGKey(0)))
        rng = np.random.default_rng(1)
        for projs in npj["groups"]["adapters"].values():
            for leaf in projs.values():
                leaf["lam"] = (rng.standard_normal(leaf["lam"].shape) * 0.3).astype(np.float32)
        tm = build_model(get_reduced(ARCH).replace(dtype="float32"), "cpu")
        _CACHE.update(jm=jm, npj=npj, tm=tm, tp=params_from_jax(npj, device="cpu"))
    c = _CACHE
    return c["jm"], jax.tree_util.tree_map(jnp.asarray, c["npj"]), c["tm"], c["tp"]


def _close(got, want, atol=TOL, rtol=TOL, msg=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=atol, rtol=rtol,
                               err_msg=msg)


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}/{k}"))
        return out
    return {prefix: tree}


@pytest.mark.parametrize("which", ["config", "reduced"])
def test_config_moe_every_and_param_count_match_the_reference(which):
    mine = (get_config if which == "config" else get_reduced)(ARCH)
    ref = (jax_config if which == "config" else jax_reduced)(ARCH)
    for f in ("family", "n_layers", "d_model", "n_heads", "n_kv_heads", "d_ff", "vocab_size",
              "n_experts", "experts_per_token", "moe_every", "hybrid_period",
              "hybrid_attn_index", "mamba_d_state", "mamba_d_conv", "mamba_expand",
              "capacity_factor", "group_size", "is_hybrid", "is_moe"):
        assert getattr(mine, f) == getattr(ref, f), f
    assert mine.param_count() == ref.param_count()
    assert mine.param_count(active_only=True) == ref.param_count(active_only=True)
    assert mamba.dt_rank(mine) == jmamba.dt_rank(ref)


def test_init_tree_matches_the_reference_leaf_for_leaf():
    """The port's own init draws its own numbers; its tree, shapes and
    dtypes are the reference's (stacked (G, 7, …) Mamba, (G, 4, …) moe,
    (G, 3, …) MLP leaves; the router, dt projection and A float32),
    adapters included, and A's log is the reference's exactly."""
    _, _, tm, _ = _models()
    mine = _flat(tm.init(torch.Generator().manual_seed(0)))
    ref = _flat(_CACHE["npj"])
    assert set(mine) == set(ref)
    for k in ref:
        assert tuple(mine[k].shape) == ref[k].shape, k
        assert str(mine[k].dtype).split(".")[1] == ref[k].dtype.name, k
    assert torch.equal(mine["/groups/mamba/m_A_log"],
                       torch.from_numpy(np.array(ref["/groups/mamba/m_A_log"])))


@pytest.mark.parametrize("with_prev", [False, True], ids=["fresh", "carried"])
def test_causal_conv_and_its_length_gather_match_jax(with_prev):
    rng = np.random.default_rng(2)
    x = rng.standard_normal((3, 10, 8), np.float32)
    w = rng.standard_normal((8, 4), np.float32)
    prev = rng.standard_normal((3, 3, 8), np.float32) if with_prev else None
    length = np.array([10, 4, 1], np.int32)
    for ln in (None, length):
        jo, jp_ = jmamba._causal_conv(jnp.asarray(x), jnp.asarray(w),
                                      None if prev is None else jnp.asarray(prev),
                                      None if ln is None else jnp.asarray(ln))
        to, tp_ = mamba._causal_conv(torch.from_numpy(x), torch.from_numpy(w),
                                     None if prev is None else torch.from_numpy(prev),
                                     None if ln is None else torch.from_numpy(ln))
        _close(to, jo)
        np.testing.assert_array_equal(tp_.numpy(), np.asarray(jp_))


def test_scan_matches_jax_across_chunks(monkeypatch):
    """The chunked scan with a chunk of 8 over 20 positions (three chunks, the
    last ragged), carried across chunks, against the reference's
    associative scan at the same chunk."""
    monkeypatch.setattr(mamba, "_CHUNK", 8)
    monkeypatch.setattr(jmamba, "_CHUNK", 8)
    rng = np.random.default_rng(3)
    B, S, di, N = 2, 20, 6, 4
    dt = np.abs(rng.standard_normal((B, S, di), np.float32)) * 0.1
    xc, Bs, Cs = (rng.standard_normal(s, np.float32) for s in ((B, S, di), (B, S, N), (B, S, N)))
    A = -np.abs(rng.standard_normal((di, N), np.float32))
    h0 = rng.standard_normal((B, di, N), np.float32)
    jy, jh = jmamba._ssm_scan_chunked(*(jnp.asarray(a) for a in (dt, xc, Bs, Cs, A, h0)))
    ty, th = mamba._ssm_scan_chunked(*(torch.from_numpy(a) for a in (dt, xc, Bs, Cs, A, h0)))
    _close(ty, jy, atol=1e-5, rtol=1e-5)
    _close(th, jh, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("masked", [False, True], ids=["exact", "bucketed"])
def test_mamba_mixer_matches_jax(masked):
    """The group's Mamba layer 2 on the same inputs: the prefill's output
    and the state it leaves, then a decode step from that state."""
    jm, jp, tm, tp = _models()
    cfg, jcfg = tm.cfg, jm.cfg
    jl = jax.tree_util.tree_map(lambda t: t[0, 2], jp["groups"]["mamba"])
    tl = {k: v[0, 2] for k, v in tp["groups"]["mamba"].items()}
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 12, cfg.d_model), np.float32)
    length = np.array([12, 5], np.int32) if masked else None
    jst = jmamba.init_mamba_state(jcfg, 2, (), jnp.float32)
    tst = mamba.init_mamba_state(cfg, 2, (), torch.float32)
    jy, jns = jmamba.mamba_mixer(jl, jnp.asarray(x), jcfg, state=jst,
                                 length=None if length is None else jnp.asarray(length))
    ty, tns = mamba.mamba_mixer(tl, torch.from_numpy(x), cfg, state=tst,
                                length=None if length is None else torch.from_numpy(length))
    valid = np.ones((2, 12), bool) if length is None else np.arange(12)[None] < length[:, None]
    _close(ty.numpy()[valid], np.asarray(jy)[valid], msg="prefill output")
    for key in ("conv", "h"):
        _close(tns[key], jns[key], atol=3e-5, rtol=1e-4, msg=key)
    xd = rng.standard_normal((2, 1, cfg.d_model), np.float32)
    jyd, jnd = jmamba.mamba_mixer(jl, jnp.asarray(xd), jcfg, state=jns)
    tyd, tnd = mamba.mamba_mixer(tl, torch.from_numpy(xd), cfg, state=tns)
    _close(tyd, jyd, msg="decode output")
    _close(tnd["h"], jnd["h"], atol=3e-5, rtol=1e-4)


def test_apply_aux_prefill_and_decode_match_jax():
    jm, jp, tm, tp = _models()
    toks = np.random.default_rng(2).integers(0, 256, size=(2, 13)).astype(np.int32)
    jl, jaux = jm.apply(jp, tokens=jnp.asarray(toks), train=False)
    tl, taux = tm.apply(tp, torch.from_numpy(toks), train=True)
    _close(tl, jl, msg="apply")
    assert abs(float(taux) - float(jaux)) <= 1e-6 and float(taux) > 0
    jc = jm.init_decode_state(2, 32, jnp.float32, per_lane=True)
    tc = tm.init_decode_state(2, 32, torch.float32, per_lane=True)
    assert set(tc["layers"]) == set(jc["layers"]) == {"attn", "mamba"}
    length = np.array([9, 6], np.int32)
    padded = np.where(np.arange(16)[None] < length[:, None],
                      np.pad(toks[:, :9], ((0, 0), (0, 7))), 0).astype(np.int32)
    jlg, jc = jm.prefill(jp, jc, tokens=jnp.asarray(padded), length=jnp.asarray(length))
    tlg, tc = tm.prefill(tp, tc, torch.from_numpy(padded), length=torch.from_numpy(length))
    _close(tlg, jlg, msg="prefill")
    for t in range(3):
        tok = np.full((2, 1), 7 + t, np.int32)
        jd, jc = jm.decode_step(jp, jc, token=jnp.asarray(tok))
        td, tc = tm.decode_step(tp, tc, torch.from_numpy(tok))
        _close(td, jd, msg=f"decode {t}")
    np.testing.assert_array_equal(tc["pos"].numpy(), np.asarray(jc["pos"]))
    for k in ("conv", "h"):
        _close(tc["layers"]["mamba"][k], jc["layers"]["mamba"][k], atol=3e-5, rtol=1e-4, msg=k)


def test_bucketed_prefill_matches_exact_recurrent_state():
    """``tests/test_lane_state.py:150`` on the port's hybrid: the Mamba conv
    carry and h the padded prefill leaves are the unpadded prefill's."""
    _, _, tm, tp = _models()
    B, P, Pb = 2, 9, 16
    toks = np.random.default_rng(1).integers(0, 256, size=(B, P)).astype(np.int32)
    padded = np.pad(toks, ((0, 0), (0, Pb - P)))
    length = torch.full((B,), P, dtype=torch.int32)
    c_e = tm.init_decode_state(B, 32, torch.float32, per_lane=True)
    c_p = tm.init_decode_state(B, 32, torch.float32, per_lane=True)
    lg_e, c_e = tm.prefill(tp, c_e, torch.from_numpy(toks), length=length)
    lg_p, c_p = tm.prefill(tp, c_p, torch.from_numpy(padded), length=length)
    _close(lg_p, lg_e)
    for k in ("conv", "h"):
        _close(c_p["layers"]["mamba"][k], c_e["layers"]["mamba"][k], atol=3e-5, rtol=1e-4,
               msg=k)
    t = torch.full((B, 1), 5, dtype=torch.int32)
    d_e, _ = tm.decode_step(tp, c_e, t)
    d_p, _ = tm.decode_step(tp, c_p, t)
    _close(d_p, d_e, atol=3e-5, rtol=1e-4)


def test_lane_axes_and_per_lane_init_match_the_reference():
    """``tests/test_lane_state.py:118``: the per-lane cache holds the
    attention KV beside the Mamba states, in both layouts, with the
    reference's lane axes."""
    jm, _, tm, _ = _models()
    for paged in (False, True):
        assert tm.lane_axes(paged=paged) == jm.lane_axes(paged=paged)
        c = tm.init_decode_state(2, 16, torch.float32, per_lane=True, paged=paged, block_size=8)
        j = jm.init_decode_state(2, 16, jnp.float32, per_lane=True, paged=paged, block_size=8)
        fc, fj = _flat(c), _flat(jax.tree_util.tree_map(np.asarray, j))
        assert set(fc) == set(fj)
        for k in fj:
            assert tuple(fc[k].shape) == fj[k].shape, k


def test_paged_prefill_view_splices_the_fresh_recurrent_state():
    """Admission through the 1-lane paged view: the view carries a fresh
    1-lane Mamba state, the prefill fills it, and the commit splices it
    into the lane (``lane_state.restore_lane``), bitwise the dense
    admission's 1-lane prefill; the other lane is untouched."""
    _, _, tm, tp = _models()
    P, bs = 11, 8
    toks = torch.from_numpy(np.random.default_rng(7).integers(0, 256, (1, 16)).astype(np.int32))
    length = torch.tensor([P], dtype=torch.int32)
    cache = tm.init_decode_state(2, 32, torch.float32, paged=True, block_size=bs)
    cache["layers"]["mamba"]["h"][:, :, 0] = 3.0  # lane 0's own state
    view = tm.paged_prefill_view(cache, torch.tensor([3, 4], dtype=torch.int32))
    assert view["layers"]["mamba"]["h"].shape[2] == 1
    assert torch.all(view["layers"]["mamba"]["h"] == 0)
    lg_p, filled = tm.prefill(tp, view, toks, length=length)
    tm.commit_paged_prefill(cache, filled, 1, torch.tensor([3, 4, 0, 0], dtype=torch.int32), P)
    dense = tm.init_decode_state(1, 32, torch.float32, per_lane=True)
    lg_d, dense = tm.prefill(tp, dense, toks, length=length)
    np.testing.assert_array_equal(lg_p.numpy(), lg_d.numpy())
    for k in ("conv", "h"):
        assert torch.equal(cache["layers"]["mamba"][k][:, :, 1], dense["layers"]["mamba"][k][:, :, 0])
    assert torch.all(cache["layers"]["mamba"]["h"][:, :, 0] == 3.0)
    assert int(cache["pos"][1]) == P and int(cache["layers"]["attn"]["idx"][0, 1]) == P


def test_mamba_adapter_targets_match_the_reference():
    """``mamba_in``/``mamba_out`` name the Mamba layers' ``m_in``/``m_out``
    (``repro/models/model_zoo.py:27-36``), beside the attention targets."""
    from repro.models.model_zoo import Model as JModel

    for targets in (("wq", "wv"), ("wq", "mamba_in", "mamba_out"), ("mamba_out",)):
        jcfg = jax_reduced(ARCH)
        cfg = get_reduced(ARCH)
        jcfg = jcfg.replace(adapter=jcfg.adapter.replace(targets=targets))
        cfg = cfg.replace(adapter=cfg.adapter.replace(targets=targets))
        assert Model(cfg, "cpu")._adapter_targets() == JModel(jcfg)._adapter_targets()
    m = build_model(cfg, "cpu")
    p = m.init(torch.Generator().manual_seed(0))
    B = p["groups"]["adapters"]["mamba"]["m_out"]["B"]
    assert B.shape[:3] == (1, 7, cfg.mamba_expand * cfg.d_model)
