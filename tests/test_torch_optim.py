"""The port's AdamW and LR schedules against ``repro.optim``, step for step,
on the same numpy-seeded parameters and gradients (CPU).

Tolerances: both sides run the same float32 formulas; the bias corrections
(``b ** step``) and ``cos`` come from different libraries and may differ in
the last float32 ulp, so values agree to ~1e-7 relative.  Bounds: 1e-6
relative (+1e-8 absolute for entries near 0)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim import AdamWConfig as JAdamWConfig
from repro.optim import adamw_init as j_init
from repro.optim import adamw_update as j_update
from repro.optim import make_schedule as j_schedule
from repro.optim.adamw import global_norm as j_global_norm
from repro_torch.optim import AdamWConfig, adamw_init, adamw_update, global_norm, make_schedule
from repro_torch.tree import tree_leaves

TOL = dict(rtol=1e-6, atol=1e-8)


def _tree(rng, scale=1.0):
    """A partitioned trainable tree: real leaves and frozen-side Nones."""
    return {
        "groups": {
            "adapters": {"attn": {"wq": {"lam": rng.standard_normal((3, 8)) * scale,
                                         "B": None},
                                  "wv": {"lam": rng.standard_normal((3, 8)) * scale}}},
            "ln1": None,
        },
        "head": rng.standard_normal((5,)) * scale,
    }


def _conv(tree, to):
    if isinstance(tree, dict):
        return {k: _conv(v, to) for k, v in tree.items()}
    return None if tree is None else to(np.asarray(tree, np.float32))


def _assert_tree_close(got, want, what):
    g, w = tree_leaves(got), jax.tree_util.tree_leaves(want)
    assert len(g) == len(w), what
    for a, b in zip(g, w):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL, err_msg=what)


@pytest.mark.parametrize(
    "clip_norm,weight_decay,schedule",
    [(1.0, 0.01, None), (0.05, 0.1, ("cosine", 3, 12)), (0.0, 0.0, ("linear", 2, 8))],
    ids=["defaults", "clipped_decayed_cosine", "unclipped_linear"],
)
def test_adamw_matches_jax_step_for_step(clip_norm, weight_decay, schedule):
    rng = np.random.default_rng(0)
    params = _tree(rng)
    kw = dict(lr=3e-2, clip_norm=clip_norm, weight_decay=weight_decay)
    jcfg = JAdamWConfig(**kw, schedule=j_schedule(schedule[0], 3e-2, schedule[1], schedule[2])
                        if schedule else None)
    tcfg = AdamWConfig(**kw, schedule=make_schedule(schedule[0], 3e-2, schedule[1], schedule[2])
                       if schedule else None)
    jp, tp = _conv(params, jnp.asarray), _conv(params, torch.from_numpy)
    js, ts = j_init(jp), adamw_init(tp)
    for step in range(10):
        grads = _tree(rng, scale=0.3 * (step + 1))
        jp, js, jm = j_update(_conv(grads, jnp.asarray), js, jp, jcfg)
        tp, ts, tm = adamw_update(_conv(grads, torch.from_numpy), ts, tp, tcfg)
        assert ts["step"] == int(js["step"]) == step + 1
        np.testing.assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]), **TOL)
        np.testing.assert_allclose(float(tm["lr"]), float(jm["lr"]), **TOL)
        _assert_tree_close(tp, jp, f"params after step {step}")
        _assert_tree_close(ts["m"], js["m"], f"m after step {step}")
        _assert_tree_close(ts["v"], js["v"], f"v after step {step}")
    assert tp["groups"]["ln1"] is None and tp["groups"]["adapters"]["attn"]["wq"]["B"] is None


def test_adamw_keeps_zero_lambda_with_zero_grad_at_zero():
    """λ past a layer's selected rank: zero gradient and zero value stay
    exactly zero through clipping, moments and decay."""
    p = {"lam": torch.tensor([0.0, 0.5, 0.0])}
    s = adamw_init(p)
    cfg = AdamWConfig(lr=1e-1, weight_decay=0.1, clip_norm=0.5)
    for _ in range(5):
        p, s, _ = adamw_update({"lam": torch.tensor([0.0, 2.0, 0.0])}, s, p, cfg)
    assert p["lam"][0] == 0 and p["lam"][2] == 0 and p["lam"][1] != 0.5


def test_adamw_leaves_its_inputs_unchanged():
    p = {"lam": torch.ones(4, requires_grad=True)}
    s = adamw_init(p)
    new_p, new_s, _ = adamw_update({"lam": torch.ones(4)}, s, p, AdamWConfig())
    assert torch.equal(p["lam"], torch.ones(4)) and s["step"] == 0
    assert torch.equal(s["m"]["lam"], torch.zeros(4))
    assert not new_p["lam"].requires_grad and new_s["step"] == 1


def test_global_norm_matches_jax():
    tree = _tree(np.random.default_rng(3))
    np.testing.assert_allclose(float(global_norm(_conv(tree, torch.from_numpy))),
                               float(j_global_norm(_conv(tree, jnp.asarray))), **TOL)


@pytest.mark.parametrize("kind", ["constant", "linear", "cosine"])
def test_schedules_match_jax(kind):
    kw = dict(base_lr=3e-3, warmup_steps=10, total_steps=50, min_ratio=0.1)
    jfn, tfn = j_schedule(kind, **kw), make_schedule(kind, **kw)
    for step in range(0, 60):
        np.testing.assert_allclose(tfn(step), float(jfn(jnp.int32(step))), **TOL,
                                   err_msg=f"{kind} step {step}")
