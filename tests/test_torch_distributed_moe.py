"""The port's training mesh against the reference's on reduced
mixtral-8x22b (float32): the train step, remat and decode (the harness is
``test_torch_distributed.py``'s; 2×2 mesh, rank (d, j) = 2d + j).

* the QR-LoRA train step at capacity factor 1.0 (copies drop, C over each
  data shard's rows) with 2 microbatches, fsdp off as the reference's
  test: loss within 1e-5 and the updated λ within 5e-5 of max|λ| of the
  reference's sharded step, λ bitwise equal on the 4 ranks.  Beside the
  port's single-device step at capacity factor 4 (no drops): the
  cross-entropy within 2e-3 (the reference test's bound), the loss apart
  by the aux term alone.
* remat under fsdp: bitwise the step without, its recompute gathering the
  expert stacks again.
* the full fine-tuning step under fsdp (the expert stacks' d over "data",
  f over "model": each rank holds a quarter of each, their gradient
  reduce-scattered by the gather's backward): the loss within 1e-5, the
  gradient Adam took (its first moment, 0.1·g after clipping) within 5e-5
  of each leaf's largest of the reference's, and bitwise equal on the 4
  ranks.  (The updated weights are not compared: Adam's first step is
  lr·g/(|g| + 1e-8), which turns float32 noise in a gradient near 0 into
  a difference of a few percent of lr.)
* prefill and two greedy decode steps, each data rank on its 2 lanes.
"""
import numpy as np
import pytest
from test_torch_distributed import (
    JAX_PRELUDE,
    LAM_RTOL,
    LOGITS_ATOL,
    LOSS_ATOL,
    RANK_EPILOGUE,
    RANK_PRELUDE,
    SINGLE_ATOL,
    assert_grad_norm,
    leaves,
    max_err,
    run_world,
)

from repro_torch.training.steps import MOE_AUX_COEF

BATCH, SEQ, LR = 4, 16, 1e-2
FT_RTOL = 5e-5

_JAX = JAX_PRELUDE + f'''
from repro.configs import get_reduced
from repro.models import build_model
from repro.optim import AdamWConfig
from repro.training import init_train_state, make_decode_step, make_prefill_step, make_train_step

base = get_reduced("mixtral_8x22b").replace(dtype="float32")
cfg = base.replace(capacity_factor=1.0, microbatches=2)
model = build_model(cfg)
params = model.init(jax.random.PRNGKey(0))
ft_cfg = cfg.replace(adapter=cfg.adapter.replace(mode="ft"))
ft_model = build_model(ft_cfg)
ft_params = {{k: v for k, v in params.items() if k != "groups"}}
ft_params["groups"] = {{k: v for k, v in params["groups"].items() if k != "adapters"}}
tokens = np.random.default_rng(1).integers(0, cfg.vocab_size, ({BATCH}, {SEQ})).astype(np.int32)
save(f"{{tmp}}/inputs.npz", {{"params": params, "ft_params": ft_params, "tokens": tokens}})

ref = {{}}
batch = {{"tokens": jnp.asarray(tokens)}}
with shrules.axis_rules(mesh, fsdp=False):
    step = make_train_step(model, AdamWConfig(lr={LR}))
    new, m = jax.jit(step)(init_train_state(model, None, params=params), batch)
    ref["qr"] = {{"loss": m["loss"], "grad_norm": m["grad_norm"],
                 "trainable": new["trainable"]}}
with shrules.axis_rules(mesh, fsdp=True):
    step = make_train_step(ft_model, AdamWConfig(lr={LR}))
    new, m = jax.jit(step)(init_train_state(ft_model, None, params=ft_params), batch)
    ref["ft"] = {{"loss": m["loss"], "m": new["opt"]["m"]}}

# prefill and two greedy decode steps at capacity factor 1.0: each data
# shard's 2 lanes dispatch with C = 8, the floor
prompt = np.random.default_rng(2).integers(0, cfg.vocab_size, (4, 8)).astype(np.int32)
with shrules.axis_rules(mesh):
    cache = model.init_decode_state(4, 16, jnp.float32)
    logits, cache = jax.jit(make_prefill_step(model))(params, cache, {{"tokens": prompt}})
    tok, steps = jnp.argmax(logits, -1).astype(jnp.int32)[:, None], [logits]
    decode = jax.jit(make_decode_step(model))
    for _ in range(2):
        tok, logits, cache = decode(params, cache, {{"token": tok}})
        steps.append(logits)
ref["decode"] = {{"prompt": prompt, "logits": jnp.stack(steps)}}

save(f"{{tmp}}/ref.npz", ref)
'''

_RANKS = RANK_PRELUDE + f'''
from repro_torch.checkpoint.reshard import reshard_to_mesh
from repro_torch.configs import get_reduced
from repro_torch.models import build_model
from repro_torch.optim import AdamWConfig
from repro_torch.training import (init_train_state, make_decode_step, make_prefill_step,
                                  make_train_step)

wait_for(f"{{tmp}}/inputs.npz")
inputs = load(f"{{tmp}}/inputs.npz")
mesh = make_mesh((2, 2), ("data", "model"))
cfg = get_reduced("mixtral_8x22b").replace(dtype="float32", capacity_factor=1.0, microbatches=2)
params = params_from_jax(inputs["params"], "cpu")
batch = {{"tokens": t(inputs["tokens"])}}

def mesh_step(cfg, params, fsdp):
    model = build_model(cfg, "cpu")
    with shrules.axis_rules(mesh, fsdp=fsdp):
        state = init_train_state(model, params=params)
        specs = shrules.mesh_specs(state)
        new, m = make_train_step(model, AdamWConfig(lr={LR}))(shrules.local_blocks(state, specs),
                                                             batch)
        whole = coll.gather_blocks(new["trainable"], specs["trainable"])
        moment = coll.gather_blocks(new["opt"]["m"], specs["trainable"])
    return float(m["loss"]), tree_map(n, whole), tree_map(n, moment), m

loss, trainable, _, m = mesh_step(cfg, params, False)
results["qr"] = {{"loss": np.float32(loss), "grad_norm": n(m["grad_norm"]), "trainable": trainable}}
# remat on and off under fsdp: the recompute gathers the expert stacks again
runs = {{}}
for remat in (True, False):
    coll.reset_collective_counts()
    runs[remat] = mesh_step(cfg.replace(remat=remat), params, True)[:2]
    runs[remat] += (np.asarray([coll.COLLECTIVES[k] for k in ("all_reduce", "all_gather",
                                                              "reduce_scatter")]),)
results["remat"] = {{
    "bitwise": np.bool_(runs[True][0] == runs[False][0] and all(
        np.array_equal(a, b) for a, b in zip(flatten(runs[True][1]).values(),
                                              flatten(runs[False][1]).values()))),
    "on": runs[True][2], "off": runs[False][2]}}
# at the reduced config's own capacity factor 4 no copy drops, split or not
cf4 = cfg.replace(capacity_factor=4.0)
m = mesh_step(cf4, params, False)[3]
results["cf4"] = {{k: n(m[k]) for k in ("loss", "ce", "aux")}}
if rank == 0:
    model = build_model(cf4, "cpu")
    m = make_train_step(model, AdamWConfig(lr={LR}))(init_train_state(model, params=params),
                                                     batch)[1]
    results["cf4"]["single"] = np.asarray([float(m[k]) for k in ("loss", "ce", "aux")])

ft_cfg = cfg.replace(adapter=cfg.adapter.replace(mode="ft"))
loss, _, moment, _ = mesh_step(ft_cfg, params_from_jax(inputs["ft_params"], "cpu"), True)
results["ft"] = {{"loss": np.float32(loss), "m": moment}}

# prefill and decode, each data rank on its 2 lanes
model = build_model(cfg, "cpu")
with shrules.axis_rules(mesh), torch.no_grad():
    placed = reshard_to_mesh(params, "cpu", mesh=mesh)
    prompt = t(np.random.default_rng(2).integers(0, cfg.vocab_size, (4, 8)).astype(np.int32))
    cache = model.init_decode_state(2, 16, torch.float32)
    logits, cache = make_prefill_step(model)(placed, cache, {{"tokens": prompt}})
    tok, steps = torch.argmax(logits, -1).to(torch.int32)[:, None], [logits]
    for _ in range(2):
        tok, logits, cache = make_decode_step(model)(placed, cache, {{"token": tok}})
        steps.append(logits)
results["decode"] = {{"logits": n(torch.stack(steps))}}

''' + RANK_EPILOGUE


@pytest.fixture(scope="module")
def readings(tmp_path_factory):
    return run_world(_JAX, _RANKS, tmp_path_factory.mktemp("mesh_moe"))


def test_train_step_matches_the_reference_sharded_step(readings):
    ref, ranks = readings
    want = leaves(ref["qr"]["trainable"])
    scale = max(float(np.abs(w).max()) for p, w in want if p.endswith("lam"))
    for r, got in enumerate(ranks):
        assert max_err(got["qr"]["loss"], ref["qr"]["loss"]) <= LOSS_ATOL, r
        assert_grad_norm(got["qr"], ref["qr"], r)
        for (path, g), (wpath, w) in zip(leaves(got["qr"]["trainable"]), want):
            assert path == wpath and max_err(g, w) <= LAM_RTOL * scale, (r, path)
        for (_, a), (_, b) in zip(leaves(got["qr"]["trainable"]),
                                  leaves(ranks[0]["qr"]["trainable"])):
            assert np.array_equal(a, b), r


def test_train_step_beside_the_single_device_step(readings):
    """At the reduced config's own capacity factor (4: no copy drops, split
    or not) the cross-entropy is within the reference test's bound, 2e-3,
    of the single-device step's, and the loss differs from it by the aux
    term alone: the Switch aux of a shard is a product of means over its
    rows, so the mean over shards is not the whole batch's.  The loss itself
    misses 2e-3 here (the print: sharded 6.1409125 against single-device
    6.1365366), and so does the reference's sharded step, which the step
    above matches within 1e-5; the reference test's 2e-3 holds there only
    because its second ``jax.jit(step)`` reuses the single-device trace
    (the rules are read when a function is traced)."""
    _, ranks = readings
    cf4 = ranks[0]["cf4"]
    loss, ce, aux = (float(cf4[k]) for k in ("loss", "ce", "aux"))
    s_loss, s_ce, s_aux = (float(v) for v in cf4["single"])
    assert abs(ce - s_ce) <= SINGLE_ATOL
    assert abs((loss - s_loss) - MOE_AUX_COEF * (aux - s_aux)) <= LOSS_ATOL
    assert aux != s_aux
    print(f"[parity] mixtral cf 4: sharded loss {loss:.7f} ce {ce:.7f} aux {aux:.6f}; "
          f"single-device {s_loss:.7f} {s_ce:.7f} {s_aux:.6f}")


def test_remat_off_is_bitwise_remat_on_with_fewer_collectives(readings):
    """Under fsdp the step with remat is bitwise the step without, and its
    backward's recompute gathers the expert stacks again (torch's
    non-reentrant checkpoint stops the recompute at the last tensor the
    backward needs, so the model sum and aux means after the gathers are
    not issued again).  Counts: (all_reduce, all_gather, reduce_scatter)."""
    _, ranks = readings
    for got in ranks:
        rm = got["remat"]
        assert bool(rm["bitwise"])
        assert rm["on"][1] > rm["off"][1] > 0, rm
        assert rm["on"][0] == rm["off"][0] and rm["on"][2] == rm["off"][2], rm


def test_full_fine_tuning_under_fsdp_matches_the_reference(readings):
    ref, ranks = readings
    want = leaves(ref["ft"]["m"])
    for r, got in enumerate(ranks):
        assert max_err(got["ft"]["loss"], ref["ft"]["loss"]) <= LOSS_ATOL, r
        for (path, g), (wpath, w) in zip(leaves(got["ft"]["m"]), want):
            assert path == wpath, (path, wpath)
            assert max_err(g, w) <= FT_RTOL * float(np.abs(w).max()), (r, path, max_err(g, w))
        for (_, a), (_, b) in zip(leaves(got["ft"]["m"]), leaves(ranks[0]["ft"]["m"])):
            assert np.array_equal(a, b), r


def test_decode_under_the_mesh_matches_the_reference(readings):
    """Prefill and two greedy decode steps at capacity factor 1.0, each data
    rank on its 2 lanes (each shard's dispatch at C = 8, the floor): logits
    within 1e-4 of the reference's under its mesh."""
    ref, ranks = readings
    for r, got in enumerate(ranks):
        err = max_err(got["decode"]["logits"], ref["decode"]["logits"])
        assert err <= LOGITS_ATOL, (r, err)
