"""λ-only training of the recurrent families (reduced xlstm-125m and
jamba-1.5-large-398b, float32, CPU) against the JAX package: step 0's λ
gradients of the port's train step against ``jax.grad`` of the reference's
loss on the same weights (crossed by ``interop.py``, nonzero λ), the
hybrid's moe aux in the loss.

Bound: λ gradients within 5e-5 of the largest (the backward runs through
the exponential gates, the sLSTM recurrence and the Mamba scan, summed in
another order: measured ≤ 1.0e-5); the hybrid's aux within 1e-6."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced as jax_reduced
from repro.core import adapter_api as jadp
from repro.models import build_model as jax_build
from repro.training import init_train_state as j_init_state
from repro.training import steps as jsteps
from repro_torch.configs import get_reduced
from repro_torch.interop import params_from_jax
from repro_torch.models import build_model
from repro_torch.optim import AdamWConfig
from repro_torch.training import init_train_state, make_train_step

XLSTM, JAMBA = "xlstm-125m", "jamba-1.5-large-398b"
GRAD_RTOL = 5e-5


@pytest.fixture(scope="module", autouse=True)
def _threads_and_jax_caches():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)
    jax.clear_caches()


def _models(arch):
    """The reduced float32 model in both packages on the same weights, λ
    nonzero."""
    jm = jax_build(jax_reduced(arch).replace(dtype="float32", remat=False))
    npj = jax.tree_util.tree_map(np.asarray, jm.init(jax.random.PRNGKey(3)))
    rng = np.random.default_rng(1)
    for projs in npj["groups"]["adapters"].values():
        for leaf in projs.values():
            leaf["lam"] = (rng.standard_normal(leaf["lam"].shape) * 0.3).astype(np.float32)
    tm = build_model(get_reduced(arch).replace(dtype="float32"), "cpu")
    return (jm, jax.tree_util.tree_map(jnp.asarray, npj), tm,
            params_from_jax(npj, device="cpu"))


def test_xlstm_step0_lam_gradients_match_jax_grad():
    """λ-only training: step 0's λ gradients of the port's train step
    against ``jax.grad`` of the reference's loss (at the shared weights'
    nonzero λ), every adapted x_qkv with a real gradient."""
    jm, jp, tm, tp = _models(XLSTM)
    tokens = np.random.default_rng(9).integers(0, 256, size=(2, 16)).astype(np.int32)
    jstate = j_init_state(jm, None, params=jp)

    def jloss(trainable):
        params = jadp.merge(trainable, jstate["frozen"])
        kw, t, w = jsteps._model_inputs(jm.cfg, {"tokens": jnp.asarray(tokens)})
        logits, aux = jm.apply(params, train=True, **kw)
        ce, zl = jsteps.lm_loss(logits, t, w)
        return ce + jsteps.Z_LOSS_COEF * zl + jsteps.MOE_AUX_COEF * aux

    jgrads = jax.jit(jax.grad(jloss))(jstate["trainable"])
    state = init_train_state(tm, params=tp)
    _, m = make_train_step(tm, AdamWConfig(lr=1e-2))(state, {"tokens": torch.from_numpy(tokens)})
    assert np.isfinite(float(m["loss"]))
    for mod, projs in jgrads["groups"]["adapters"].items():
        for p, leaf in projs.items():
            got = state["trainable"]["groups"]["adapters"][mod][p]["lam"].grad.numpy()
            want = np.asarray(leaf["lam"])
            scale = np.abs(want).max()
            assert scale > 1e-4, (mod, p)
            np.testing.assert_allclose(got, want, atol=GRAD_RTOL * scale, rtol=0,
                                       err_msg=f"{mod}/{p}")


def test_hybrid_step0_lam_gradients_match_jax_grad():
    """λ-only training of the hybrid: step 0's λ gradients (wq and wv of the
    attention layer, at the shared weights' nonzero λ) against ``jax.grad``
    of the reference's loss, the moe layers' aux in it."""
    jm, jp, tm, tp = _models(JAMBA)
    tokens = np.random.default_rng(9).integers(0, 256, size=(2, 16)).astype(np.int32)
    jstate = j_init_state(jm, None, params=jp)

    def jloss(trainable):
        params = jadp.merge(trainable, jstate["frozen"])
        kw, t, w = jsteps._model_inputs(jm.cfg, {"tokens": jnp.asarray(tokens)})
        logits, aux = jm.apply(params, train=True, **kw)
        ce, zl = jsteps.lm_loss(logits, t, w)
        return ce + jsteps.Z_LOSS_COEF * zl + jsteps.MOE_AUX_COEF * aux, aux

    jgrads, jaux = jax.jit(jax.grad(jloss, has_aux=True))(jstate["trainable"])
    state = init_train_state(tm, params=tp)
    _, m = make_train_step(tm, AdamWConfig(lr=1e-2))(state, {"tokens": torch.from_numpy(tokens)})
    assert abs(float(m["aux"]) - float(jaux)) <= 1e-6
    for mod, projs in jgrads["groups"]["adapters"].items():
        for p, leaf in projs.items():
            got = state["trainable"]["groups"]["adapters"][mod][p]["lam"].grad.numpy()
            want = np.asarray(leaf["lam"])
            scale = np.abs(want).max()
            assert scale > 1e-4, (mod, p)
            np.testing.assert_allclose(got, want, atol=GRAD_RTOL * scale, rtol=0,
                                       err_msg=f"{mod}/{p}")
