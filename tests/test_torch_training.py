"""The port's λ-only trainer against the JAX reference (reduced smollm-135m,
float32, CPU): params initialised in JAX and crossed over with
``repro_torch.interop``, the same numpy token stream on both sides.

Bounds, measured on this config in float32: a 30-step run (the quickstart's
lr 3e-3, ``lm_batches(vocab, 8, 32, seed=0)``) reads per-step losses within
1.5e-6 and final λ within 8e-8 of JAX's; the bounds below leave ~10×
margin for summation order.  λ gradients of one step (~1e-2) agree within
1.7e-8; bound 1e-7 absolute."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced as jax_reduced
from repro.core import adapter_api as jadp
from repro.data import lm_batches as j_lm_batches
from repro.models import build_model as jax_build
from repro.optim import AdamWConfig as JAdamWConfig
from repro.training import init_train_state as j_init_state
from repro.training import make_train_step as j_make_step
from repro.training import steps as jsteps
from repro_torch.configs import get_reduced
from repro_torch.core import adapter_api as tadp
from repro_torch.data import lm_batches
from repro_torch.interop import params_from_jax
from repro_torch.launch import train as train_launch
from repro_torch.models import build_model
from repro_torch.optim import AdamWConfig
from repro_torch.training import init_train_state, lm_loss, make_train_step
from repro_torch.training.steps import _model_inputs
from repro_torch.tree import tree_leaves

LOSS_ATOL = 2e-5
LAM_ATOL = 1e-6
GRAD_ATOL = 1e-7


@pytest.fixture(scope="module")
def models():
    jcfg = jax_reduced("smollm-135m").replace(dtype="float32")
    jm = jax_build(jcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    tm = build_model(get_reduced("smollm-135m").replace(dtype="float32"), "cpu")
    return jm, jp, tm


def _torch_params(jp):
    return params_from_jax(jax.tree_util.tree_map(np.asarray, jp), device="cpu")


def _lam_leaves(trainable):
    """λ leaves (JAX or torch) by (module, projection)."""
    return {(m, p): leaf["lam"]
            for m, projs in trainable["groups"]["adapters"].items() for p, leaf in projs.items()}


def _lams(trainable):
    """λ leaves as numpy."""
    return {k: np.asarray(v.detach() if torch.is_tensor(v) else v)
            for k, v in _lam_leaves(trainable).items()}


def test_lm_batches_match_jax():
    for a, b, _ in zip(lm_batches(256, 4, 16, seed=3, start_step=2),
                       j_lm_batches(256, 4, 16, seed=3, start_step=2), range(3)):
        np.testing.assert_array_equal(a["tokens"], b["tokens"])


def test_lm_loss_and_model_inputs_match_jax():
    rng = np.random.default_rng(0)
    logits = (rng.standard_normal((2, 8, 32)) * 3).astype(np.float32)
    tokens = rng.integers(0, 32, size=(2, 8)).astype(np.int32)
    jkw, jtgt, jw = jsteps._model_inputs(jax_reduced("smollm-135m"), {"tokens": jnp.asarray(tokens)})
    ttgt, tw = _model_inputs(torch.from_numpy(tokens))
    np.testing.assert_array_equal(ttgt.numpy(), np.asarray(jtgt))
    np.testing.assert_array_equal(tw.numpy(), np.asarray(jw))
    want = jsteps.lm_loss(jnp.asarray(logits), jtgt, jw)
    got = lm_loss(torch.from_numpy(logits), ttgt, tw)
    for g, w in zip(got, want):
        np.testing.assert_allclose(float(g), float(w), rtol=1e-6)


def test_trainable_mask_matches_jax_leaf_for_leaf(models):
    jm, jp, tm = models
    params = _torch_params(jp)
    got = tm.trainable_mask(params)
    assert got == jax.tree_util.tree_map(bool, jm.trainable_mask(jp))
    assert sum(tree_leaves(got)) == 2  # the λ leaves of wq and wv
    cfg_none = tm.cfg.replace(adapter=tm.cfg.adapter.replace(mode="none"))
    assert not any(tree_leaves(tadp.trainable_mask(params, cfg_none)))


def test_partition_merge_round_trip(models):
    _, jp, tm = models
    params = _torch_params(jp)
    trainable, frozen = tadp.partition(params, tm.trainable_mask(params))
    merged = tadp.merge(trainable, frozen)
    assert all(a is b for a, b in zip(tree_leaves(merged), tree_leaves(params)))
    assert [l.shape for l in tree_leaves(trainable)] == [(3, 8)] * 2
    assert frozen["groups"]["adapters"]["attn"]["wq"]["lam"] is None
    assert trainable["embed"] is None


def test_step0_lambda_grads_match_jax(models):
    """The λ gradients of one step against ``jax.grad`` of the reference's
    loss (its ``lm_loss`` + z-loss through ``_model_inputs``), and the step's
    grad norm, loss and new λ against JAX's ``make_train_step``."""
    jm, jp, tm = models
    tokens = next(lm_batches(256, 4, 16, seed=1))["tokens"][:, :16]
    jstate = j_init_state(jm, None, params=jp)

    def jloss(trainable):
        params = jadp.merge(trainable, jstate["frozen"])
        kw, tgt, w = jsteps._model_inputs(jm.cfg, {"tokens": jnp.asarray(tokens)})
        logits, aux = jm.apply(params, train=True, **kw)
        ce, zl = jsteps.lm_loss(logits, tgt, w)
        return ce + jsteps.Z_LOSS_COEF * zl + jsteps.MOE_AUX_COEF * aux

    jgrads = jax.grad(jloss)(jstate["trainable"])
    jnew, jmet = j_make_step(jm, JAdamWConfig(lr=1e-2))(jstate, {"tokens": jnp.asarray(tokens)})

    tstate = init_train_state(tm, params=_torch_params(jp))
    tnew, tmet = make_train_step(tm, AdamWConfig(lr=1e-2))(tstate, {"tokens": torch.from_numpy(tokens)})
    tgrads = {k: lam.grad.numpy() for k, lam in _lam_leaves(tstate["trainable"]).items()}
    for key, want in _lams(jgrads).items():
        np.testing.assert_allclose(tgrads[key], want, atol=GRAD_ATOL, err_msg=str(key))
        assert np.abs(want).max() > 1e-4  # a real gradient, not a zero-vs-zero check
        assert np.all(tgrads[key][0] == 0)  # layer 0 carries no adapter
    np.testing.assert_allclose(float(tmet["loss"]), float(jmet["loss"]), atol=LOSS_ATOL)
    np.testing.assert_allclose(float(tmet["grad_norm"]), float(jmet["grad_norm"]), rtol=1e-6)
    for key, want in _lams(jnew["trainable"]).items():
        np.testing.assert_allclose(_lams(tnew["trainable"])[key], want, atol=LAM_ATOL)


def test_30_step_run_matches_jax(models):
    """The quickstart's run (lr 3e-3, batch 8 × 32): per-step loss and the
    final λ against JAX."""
    jm, jp, tm = models
    jstate = j_init_state(jm, None, params=jp)
    tstate = init_train_state(tm, params=_torch_params(jp))
    jstep = jax.jit(j_make_step(jm, JAdamWConfig(lr=3e-3)))
    tstep = make_train_step(tm, AdamWConfig(lr=3e-3))
    jl, tl = [], []
    for _, b in zip(range(30), lm_batches(256, 8, 32, seed=0)):
        tokens = b["tokens"][:, :32]
        jstate, jmet = jstep(jstate, {"tokens": jnp.asarray(tokens)})
        tstate, tmet = tstep(tstate, {"tokens": torch.from_numpy(tokens)})
        jl.append(float(jmet["loss"]))
        tl.append(float(tmet["loss"]))
    dloss = np.abs(np.array(tl) - np.array(jl))
    print(f"[parity] 30-step train: max|Δloss| {dloss.max():.2e}")
    assert dloss.max() < LOSS_ATOL
    want, got = _lams(jstate["trainable"]), _lams(tstate["trainable"])
    for key in want:
        print(f"[parity] 30-step train λ {key}: max|Δ| {np.abs(got[key] - want[key]).max():.2e}")
        np.testing.assert_allclose(got[key], want[key], atol=LAM_ATOL, err_msg=str(key))
        assert np.abs(want[key]).max() > 1e-2  # λ moved


def test_training_touches_only_lambda(models):
    """Frozen leaves stay bit-identical (the same tensors, unchanged), the
    input state's λ is not written, and λ moves."""
    _, jp, tm = models
    params = _torch_params(jp)
    frozen_before = [t.clone() for t in tree_leaves(tadp.partition(params, tm.trainable_mask(params))[1])]
    state = init_train_state(tm, params=params)
    state0 = state
    lam0 = state0["trainable"]["groups"]["adapters"]["attn"]["wq"]["lam"].detach().clone()
    step = make_train_step(tm, AdamWConfig(lr=1e-2))
    for _, b in zip(range(3), lm_batches(256, 4, 16, seed=2)):
        state, _ = step(state, {"tokens": torch.from_numpy(b["tokens"][:, :16])})
    for a, b in zip(frozen_before, tree_leaves(state["frozen"])):
        assert torch.equal(a, b)
    assert torch.equal(state0["trainable"]["groups"]["adapters"]["attn"]["wq"]["lam"], lam0)
    assert torch.equal(params["groups"]["adapters"]["attn"]["wq"]["lam"], torch.zeros(3, 8))
    assert not torch.equal(state["trainable"]["groups"]["adapters"]["attn"]["wq"]["lam"], lam0)


def test_lambda_outside_selected_layers_and_ranks_stays_zero():
    """Fixed rank 3 under a rank cap of 8 on the last 2 of 3 layers: λ of
    layer 0 and every entry past rank 3 get exactly zero gradient and stay
    exactly 0 through AdamW."""
    cfg = get_reduced("smollm-135m").replace(dtype="float32")
    cfg = cfg.replace(adapter=cfg.adapter.replace(rank_policy="fixed", rank=3))
    tm = build_model(cfg, "cpu")
    state = init_train_state(tm, torch.Generator().manual_seed(0))
    step = make_train_step(tm, AdamWConfig(lr=1e-2))
    for _, b in zip(range(3), lm_batches(256, 4, 16, seed=0)):
        state, _ = step(state, {"tokens": torch.from_numpy(b["tokens"][:, :16])})
    for lam in tree_leaves(state["trainable"]):
        assert torch.equal(lam[0], torch.zeros(8)) and torch.equal(lam[:, 3:], torch.zeros(3, 5))
        assert (lam[1:, :3] != 0).all()


def test_grad_accumulation_equivalent(models):
    """microbatches=2 gives the update of one full batch (as the
    reference's test_grad_accumulation_equivalent)."""
    _, jp, _ = models
    tokens = torch.from_numpy(np.random.default_rng(5).integers(0, 256, (4, 16)).astype(np.int32))
    results = []
    for k in (1, 2):
        cfg = get_reduced("smollm-135m").replace(dtype="float32", microbatches=k)
        tm = build_model(cfg, "cpu")
        state = init_train_state(tm, params=_torch_params(jp))
        new_state, met = make_train_step(tm, AdamWConfig(lr=1e-2))(state, {"tokens": tokens})
        results.append((float(met["loss"]),
                        new_state["trainable"]["groups"]["adapters"]["attn"]["wq"]["lam"].detach()))
    assert abs(results[0][0] - results[1][0]) < 1e-5
    np.testing.assert_allclose(results[0][1].numpy(), results[1][1].numpy(), atol=1e-5)


def test_train_launcher_runs_to_its_end_on_cpu(capsys):
    state, hist = train_launch.main(["--reduced", "--device", "cpu", "--steps", "4",
                                     "--batch", "2", "--seq", "8", "--log-every", "2"])
    out = capsys.readouterr().out
    assert len(hist) == 4 and all(np.isfinite(h["loss"]) for h in hist)
    assert "trainable params: 48" in out and "train tokens/s" in out
    assert state["opt"]["step"] == 4


@pytest.mark.parametrize("argv,err", [
    (["--peft", "lora", "--ckpt-dir", "ckpt"], NotImplementedError),  # every mode refuses it
    (["--ckpt-dir", "ckpt"], NotImplementedError),
    ([], RuntimeError),  # the default device is the card, absent here
], ids=["peft_lora", "ckpt_dir", "default_device_cuda"])
def test_train_launcher_refuses(argv, err):
    if not argv and torch.cuda.is_available():
        pytest.skip("a card is present: the default device works")
    with pytest.raises(err):
        train_launch.main(["--reduced", "--steps", "1", *argv])
