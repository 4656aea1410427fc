"""The moe family's λ-only train step (reduced moonshot-v1-16b-a3b, float32,
CPU) against the JAX package: step 0's λ gradients and aux against
``jax.grad`` of the reference's loss, and three steps of
``make_train_step`` over two microbatches, each routing its own rows at a
capacity that drops copies (so routing the whole batch at once would give
another loss).  Bounds: λ gradients within 1e-7 and the aux within 1e-6
(float32, as ``test_torch_audio.py``), each step's loss within 1e-5."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced as jax_reduced
from repro.core import adapter_api as jadp
from repro.models import build_model as jax_build
from repro.optim import AdamWConfig as JAdamWConfig
from repro.training import init_train_state as j_init_state
from repro.training import make_train_step as j_make_step
from repro.training import steps as jsteps
from repro_torch.configs import get_reduced
from repro_torch.interop import params_from_jax
from repro_torch.models import build_model
from repro_torch.optim import AdamWConfig
from repro_torch.training import init_train_state, make_train_step

ARCH = "moonshot-v1-16b-a3b"
GRAD_ATOL = 1e-7
AUX_TOL = 1e-6
LOSS_ATOL = 1e-5


@pytest.fixture(scope="module", autouse=True)
def _threads_and_jax_caches():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)
    jax.clear_caches()


def _train_models():
    """Reduced moonshot in float32 at cf 1.0 with 2 microbatches: each
    microbatch's 32 rows overflow some experts, so routing the whole batch
    at once would drop other copies."""
    over = dict(dtype="float32", capacity_factor=1.0, microbatches=2)
    jm = jax_build(jax_reduced(ARCH).replace(**over))
    jp = jm.init(jax.random.PRNGKey(0))
    tm = build_model(get_reduced(ARCH).replace(**over), "cpu")
    return jm, jp, tm, params_from_jax(jax.tree_util.tree_map(np.asarray, jp), device="cpu")


def test_train_step_matches_jax_grad_and_steps():
    jm, jp, tm, tp = _train_models()
    tokens = np.random.default_rng(9).integers(0, 256, size=(4, 16)).astype(np.int32)
    jstate = j_init_state(jm, None, params=jp)
    mb = {"tokens": jnp.asarray(tokens[:2])}  # step 0's first microbatch

    def jloss(trainable):
        params = jadp.merge(trainable, jstate["frozen"])
        kw, t, w = jsteps._model_inputs(jm.cfg, mb)
        logits, aux = jm.apply(params, train=True, **kw)
        ce, zl = jsteps.lm_loss(logits, t, w)
        return ce + jsteps.Z_LOSS_COEF * zl + jsteps.MOE_AUX_COEF * aux, aux

    jgrads, jaux = jax.jit(jax.grad(jloss, has_aux=True))(jstate["trainable"])
    tstate = init_train_state(tm, params=tp)
    step = make_train_step(tm, AdamWConfig(lr=1e-2))
    # the port's first microbatch alone: its λ gradients and aux
    one = make_train_step(build_model(tm.cfg.replace(microbatches=1), "cpu"),
                          AdamWConfig(lr=1e-2))
    probe = init_train_state(tm, params=tp)
    _, m0 = one(probe, {"tokens": torch.from_numpy(tokens[:2])})
    assert abs(float(m0["aux"]) - float(jaux)) <= AUX_TOL
    for mod, projs in jgrads["groups"]["adapters"].items():
        for p, leaf in projs.items():
            got = probe["trainable"]["groups"]["adapters"][mod][p]["lam"].grad.numpy()
            want = np.asarray(leaf["lam"])
            np.testing.assert_allclose(got, want, atol=GRAD_ATOL, err_msg=p)
            assert np.abs(want).max() > 1e-4  # a real gradient
    # three steps over 2 microbatches against the reference's scan
    jstep = j_make_step(jm, JAdamWConfig(lr=1e-2))
    rng = np.random.default_rng(11)
    for i in range(3):
        batch = tokens if i == 0 else rng.integers(0, 256, size=(4, 16)).astype(np.int32)
        jstate, jmet = jstep(jstate, {"tokens": jnp.asarray(batch)})
        tstate, tmet = step(tstate, {"tokens": torch.from_numpy(batch)})
        np.testing.assert_allclose(float(tmet["loss"]), float(jmet["loss"]), atol=LOSS_ATOL)
        assert float(tmet["aux"]) > 0.5 * tm.cfg.n_layers
