"""The ssm family (xlstm-125m, reduced, float32, CPU) against the JAX
package: the config and its parameter count, the mLSTM parallel form
against the recurrent one (port against port, the property of
``tests/test_xlstm_forms.py``), the mLSTM and sLSTM mixers and the reduced
``apply`` against JAX with the weights crossed by ``interop.py``, prefill
and decode against JAX, the bucketed prefill (padded equals exact, every
recurrent leaf), the lane axes and per-lane init, and the column-sliced W
of the v projection
through the plain BGMV and one-λ versions against the reference's
``ref.*``.  Its train step's λ gradients are
``test_torch_recurrent_train.py``'s.

Bounds: float32 mixers, logits and states within 2e-5 of JAX (the
reference's own ``test_lane_state.py`` bar for states: 3e-5 absolute, 1e-4
relative); the parallel form against the recurrent within 2e-4 (the
reference's)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _hypothesis_compat import given, settings, st

from repro.configs import get_config as jax_config
from repro.configs import get_reduced as jax_reduced
from repro.kernels import ref as jref
from repro.models import build_model as jax_build
from repro.models import xlstm as jx
from repro_torch.configs import get_config, get_reduced
from repro_torch.core.quantize import _QUANTIZABLE_MODULES, quantize_base_params
from repro_torch.interop import params_from_jax
from repro_torch.kernels import ops
from repro_torch.models import build_model, xlstm
from repro_torch.models.lane_state import extract_lane, reset_lane

ARCH = "xlstm-125m"
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
    """The reduced float32 model in both packages, the JAX params with
    nonzero λ as numpy leaves, and the port's copy."""
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


@pytest.mark.parametrize("name", ["xlstm-125m", "xlstm_125m"])
def test_config_and_param_count_match_the_reference(name):
    for mine, ref in ((get_config(name), jax_config(name)), (get_reduced(name), jax_reduced(name))):
        assert (mine.family, mine.n_layers, mine.d_model, mine.n_heads, mine.vocab_size,
                mine.xlstm_pattern, mine.group_size) == (
            ref.family, ref.n_layers, ref.d_model, ref.n_heads, ref.vocab_size,
            ref.xlstm_pattern, ref.group_size)
        assert mine.adapter.targets == ref.adapter.targets == ("x_qkv",)
        assert mine.param_count() == ref.param_count()


@settings(max_examples=10, deadline=None)
@given(seed=st.integers(0, 2**16), S=st.integers(2, 24))
def test_mlstm_parallel_equals_recurrent(seed, S):
    """The property of ``tests/test_xlstm_forms.py``, port against port."""
    B, H, dh = 2, 2, 8
    rng = np.random.default_rng(seed)
    q, k, v = (torch.from_numpy(rng.standard_normal((B, S, H, dh), np.float32) * 0.5)
               for _ in range(3))
    ig = torch.from_numpy(rng.standard_normal((B, S, H), np.float32) * 1.5)
    lf = torch.nn.functional.logsigmoid(
        torch.from_numpy(rng.standard_normal((B, S, H), np.float32) * 2 + 2))
    h_par = xlstm._mlstm_parallel(q, k, v, ig, lf)
    state = {"C": torch.zeros((B, H, dh, dh)), "n": torch.zeros((B, H, dh)),
             "m": torch.full((B, H), -1e30)}
    outs = []
    for t in range(S):
        state, h = xlstm._mlstm_recurrent_step(state, q[:, t], k[:, t], v[:, t], ig[:, t],
                                               lf[:, t])
        outs.append(h)
    _close(h_par, torch.stack(outs, 1), atol=2e-4, rtol=0)


def test_mlstm_parallel_matches_jax_across_query_chunks():
    """More queries than one chunk (``_Q_CHUNK``), masked rows included."""
    rng = np.random.default_rng(4)
    B, S, H, dh = 1, 600, 2, 4
    q, k, v = (rng.standard_normal((B, S, H, dh), np.float32) * 0.5 for _ in range(3))
    ig = rng.standard_normal((B, S, H), np.float32)
    ig[:, 500:] = -1e30  # padded positions, as a bucketed prefill masks them
    lf = np.array(jax.nn.log_sigmoid(rng.standard_normal((B, S, H), np.float32) + 2))
    lf[:, 500:] = 0.0
    want = jx._mlstm_parallel(*(jnp.asarray(a) for a in (q, k, v, ig, lf)))
    got = xlstm._mlstm_parallel(*(torch.from_numpy(a) for a in (q, k, v, ig, lf)))
    _close(got, want, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("kind", ["mlstm", "slstm"])
@pytest.mark.parametrize("masked", [False, True], ids=["exact", "bucketed"])
def test_mixer_matches_jax(kind, masked):
    """One mixer of the reduced model (group 1, its adapters with nonzero
    λ) on the same inputs: the prefill's output and the state it leaves,
    then a decode step from that state."""
    jm, jp, tm, tp = _models()
    cfg, jcfg = tm.cfg, jm.cfg
    jfn, tfn = {"mlstm": (jx.mlstm_mixer, xlstm.mlstm_mixer),
                "slstm": (jx.slstm_mixer, xlstm.slstm_mixer)}[kind]
    jgr = jax.tree_util.tree_map(lambda t: t[1], jp["groups"])
    tgr = jax.tree_util.tree_map(lambda t: t[1], tp["groups"])
    jadp_ = {p: {k: v for k, v in leaf.items() if k != "ranks"}
             for p, leaf in jgr["adapters"][kind].items()}
    tadp = {p: {k: v for k, v in leaf.items() if k != "ranks"}
            for p, leaf in tgr["adapters"][kind].items()}
    rng = np.random.default_rng(6)
    x = rng.standard_normal((2, 12, cfg.d_model), np.float32)
    length = np.array([12, 7], np.int32) if masked else None
    init = {"mlstm": (jx.init_mlstm_state, xlstm.init_mlstm_state),
            "slstm": (jx.init_slstm_state, xlstm.init_slstm_state)}[kind]
    jst = init[0](jcfg, 2, (), jnp.float32)
    tst = init[1](cfg, 2, (), torch.float32)
    jy, jns = jfn(jgr[kind], jnp.asarray(x), jcfg, state=jst, adp=jadp_,
                  length=None if length is None else jnp.asarray(length))
    ty, tns = tfn(tgr[kind], torch.from_numpy(x), cfg, state=tst, adp=tadp,
                  length=None if length is None else torch.from_numpy(length))
    _close(ty, jy, msg="prefill output")
    for key in jns:
        _close(tns[key], jns[key], atol=3e-5, rtol=1e-4, msg=key)
    xd = rng.standard_normal((2, 1, cfg.d_model), np.float32)
    jyd, _ = jfn(jgr[kind], jnp.asarray(xd), jcfg, state=jns, adp=jadp_)
    tyd, _ = tfn(tgr[kind], torch.from_numpy(xd), cfg, state=tns, adp=tadp)
    _close(tyd, jyd, msg="decode output")


def test_apply_prefill_and_decode_match_jax():
    jm, jp, tm, tp = _models()
    toks = np.random.default_rng(2).integers(0, 256, size=(2, 13)).astype(np.int32)
    jl, jaux = jm.apply(jp, tokens=jnp.asarray(toks), train=False)
    tl, taux = tm.apply(tp, torch.from_numpy(toks), train=True)
    _close(tl, jl, msg="apply")
    assert float(taux) == float(jaux) == 0.0
    jc = jm.init_decode_state(2, 32, jnp.float32)
    tc = tm.init_decode_state(2, 32, torch.float32)
    assert set(tc["layers"]) == set(jc["layers"]) == {"mlstm", "slstm"}
    jlg, jc = jm.prefill(jp, jc, tokens=jnp.asarray(toks[:, :9]))
    tlg, tc = tm.prefill(tp, tc, torch.from_numpy(toks[:, :9]))
    _close(tlg, jlg, msg="prefill")
    for t in range(3):
        tok = np.full((2, 1), 7 + t, np.int32)
        jd, jc = jm.decode_step(jp, jc, token=jnp.asarray(tok))
        td, tc = tm.decode_step(tp, tc, torch.from_numpy(tok))
        _close(td, jd, msg=f"decode {t}")
    assert int(tc["pos"]) == int(jc["pos"]) == 12


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}/{k}"))
        return out
    return {prefix: tree}


def test_bucketed_prefill_matches_exact_recurrent_state():
    """``tests/test_lane_state.py:150`` on the port: right-padding a prompt
    to a bucket leaves every recurrent leaf (mLSTM conv/C/n/m, sLSTM
    c/n/h/m) as the unpadded prefill does, and the next decode agrees."""
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
    fe, fp = _flat(c_e), _flat(c_p)
    assert set(fe) == set(fp) and any("/m" in k for k in fe)
    for k in fe:
        _close(fp[k], fe[k], atol=3e-5, rtol=1e-4, msg=k)
    t = torch.full((B, 1), 5, dtype=torch.int32)
    d_e, _ = tm.decode_step(tp, c_e, t)
    d_p, _ = tm.decode_step(tp, c_p, t)
    _close(d_p, d_e, atol=3e-5, rtol=1e-4)


def test_lane_axes_and_per_lane_init_match_the_reference():
    """``tests/test_lane_state.py:118`` and ``:136``: the per-lane cache is
    the mLSTM and sLSTM states (``m`` at -1e30), the lane axes are the
    reference's, a reset lane is the fresh one, and paging refuses the
    family (there is none to page)."""
    jm, _, tm, _ = _models()
    cache = tm.init_decode_state(2, 16, torch.float32, per_lane=True)
    assert cache["pos"].shape == (2,)
    assert set(cache["layers"]) == {"mlstm", "slstm"}
    assert torch.all(cache["layers"]["mlstm"]["m"] == -1e30)
    assert tm.lane_axes() == jm.lane_axes()
    jc = jm.init_decode_state(2, 16, jnp.float32, per_lane=True)
    for k, v in _flat(cache).items():
        j = _flat(jax.tree_util.tree_map(np.asarray, jc))[k]
        assert tuple(v.shape) == j.shape and np.array_equal(v.numpy(), j), k
    fresh = extract_lane(tm.init_decode_state(1, 16, torch.float32, per_lane=True),
                         tm.lane_axes(), 0)
    for leaf in _flat(cache["layers"]).values():
        leaf.add_(1.0)
    reset_lane(cache, tm.lane_axes(), 1, fresh)
    lane1, lane0 = extract_lane(cache, tm.lane_axes(), 1), extract_lane(cache, tm.lane_axes(), 0)
    for k, v in _flat(lane1["layers"]).items():
        assert torch.equal(v, _flat(fresh["layers"])[k]), k
    assert not torch.equal(lane0["layers"]["mlstm"]["C"], fresh["layers"]["mlstm"]["C"])
    with pytest.raises(NotImplementedError, match="none to page"):
        tm.init_decode_state(2, 16, torch.float32, paged=True, block_size=8)


def test_quantized_base_leaves_ssm_native():
    """As the reference: ssm modules are not quantizable (x_qkv is read
    through a column slice), so an int8 engine base leaves them alone; the
    quantizable modules are the reference's."""
    from repro.core.quantize import _QUANTIZABLE_MODULES as J_QUANTIZABLE

    assert _QUANTIZABLE_MODULES == J_QUANTIZABLE
    _, _, _, tp = _models()
    q = quantize_base_params(tp, "int8")
    for mod in ("mlstm", "slstm"):
        assert torch.equal(q["groups"][mod]["x_qkv"], tp["groups"][mod]["x_qkv"])


@pytest.mark.parametrize("x_dtype", ["float32", "bfloat16"])
def test_column_sliced_w_through_the_plain_versions(x_dtype):
    """The mLSTM v projection's operands, W and A the last third of wider
    matrices (views whose rows lie 3N apart), through the port's BGMV and
    one-λ entry points (the plain versions on CPU tensors) against the
    reference's ``ref.*`` on the sliced arrays."""
    rng = np.random.default_rng(11)
    M, K, N, r = 6, 32, 16, 8
    dt = getattr(torch, x_dtype)
    jdt = getattr(jnp, x_dtype)
    x = rng.standard_normal((M, K), np.float32)
    W = rng.standard_normal((K, 3 * N), np.float32) * K**-0.5
    B = rng.standard_normal((K, r), np.float32) * K**-0.5
    A = rng.standard_normal((r, 3 * N), np.float32)
    tab = (rng.standard_normal((4, r)) * 0.3).astype(np.float32)
    seg = np.array([0, 1, 2, 3, 1, 0], np.int32)
    Wt, At = torch.from_numpy(W).to(dt), torch.from_numpy(A).bfloat16()
    Bt = torch.from_numpy(B).bfloat16()
    Ws, As = Wt[:, 2 * N:], At[:, 2 * N:]
    assert not Ws.is_contiguous() and Ws.stride(0) == 3 * N
    jW = jnp.asarray(W).astype(jdt)[:, 2 * N:]
    jB, jA = jnp.asarray(B).astype(jnp.bfloat16), jnp.asarray(A).astype(jnp.bfloat16)[:, 2 * N:]
    xt, jxx = torch.from_numpy(x).to(dt), jnp.asarray(x).astype(jdt)
    got = ops.qrlora_bgmv(xt, Ws, Bt, As, torch.from_numpy(tab), torch.from_numpy(seg), 0.7)
    want = jref.qrlora_bgmv_ref(jxx, jW, jB, jA, jnp.asarray(tab), jnp.asarray(seg), 0.7)
    tol = 1e-5 if x_dtype == "float32" else 2**-7
    _close(got.float(), np.asarray(want.astype(jnp.float32)), atol=tol, rtol=tol)
    lam = torch.from_numpy(tab[1])
    got = ops.qrlora_matmul(xt, Ws, Bt, As, lam, 0.7)
    want = jref.qrlora_matmul_ref(jxx, jW, jB, jA, jnp.asarray(tab[1]), 0.7)
    _close(got.float(), np.asarray(want.astype(jnp.float32)), atol=tol, rtol=tol)
