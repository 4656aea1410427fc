"""The port's training mesh against the reference's on reduced
jamba-1.5-large-398b (float32, 2 microbatches; the harness is
``test_torch_distributed.py``'s; 2×2 mesh, rank (d, j) = 2d + j): the
hybrid's Mamba, attention and moe layers on each data rank's rows, its moe
layers through the sharded branch (remat around each and around each
group).  The QR-LoRA step's loss within 1e-5 and the updated λ within 5e-5
of max|λ| of the reference's sharded step, λ bitwise equal on the 4 ranks;
beside the port's single-device step, the loss and the cross-entropy
within 2e-3 (the reference test's bound) and the loss apart by the aux
term alone (the Switch aux of a shard is a product of means over its
rows)."""
import json

import numpy as np
import pytest
from test_torch_distributed import (
    JAX_PRELUDE,
    LAM_RTOL,
    LOSS_ATOL,
    RANK_EPILOGUE,
    RANK_PRELUDE,
    SINGLE_ATOL,
    assert_grad_norm,
    leaves,
    max_err,
    run_world,
)

from repro_torch.configs import get_reduced
from repro_torch.models import build_model
from repro_torch.training.steps import MOE_AUX_COEF

BATCH, SEQ, LR = 4, 16, 1e-2

_JAX = JAX_PRELUDE + f'''
from repro.configs import get_reduced
from repro.models import build_model
from repro.optim import AdamWConfig
from repro.training import init_train_state, make_train_step

import json, threading

cfg = get_reduced("jamba_1_5_large_398b").replace(dtype="float32", microbatches=2)
model = build_model(cfg)
tokens = np.random.default_rng(1).integers(0, cfg.vocab_size, ({BATCH}, {SEQ})).astype(np.int32)
batch = {{"tokens": jnp.asarray(tokens)}}
step = make_train_step(model, AdamWConfig(lr={LR}))
# the sharded step compiles in a thread from the params' shapes (the port's
# meta params, which keep the reference's) while the params are drawn; the
# rules are per thread
abstract = {{}}
for path, (shape, dtype) in json.load(open(f"{{tmp}}/param_shapes.json")).items():
    node, parts = abstract, path.split("/")
    for part in parts[:-1]:
        node = node.setdefault(part, {{}})
    node[parts[-1]] = jax.ShapeDtypeStruct(tuple(shape), jnp.dtype(dtype))
abstract = jax.eval_shape(lambda p: init_train_state(model, None, params=p), abstract)
compiled = {{}}

def compile_step():
    with shrules.axis_rules(mesh, fsdp=False):
        compiled["step"] = jax.jit(step).lower(abstract, batch).compile()

worker = threading.Thread(target=compile_step)
worker.start()
params = model.init(jax.random.PRNGKey(0))
save(f"{{tmp}}/inputs.npz", {{"params": params, "tokens": tokens}})
worker.join()
new, m = compiled["step"](init_train_state(model, None, params=params), batch)
save(f"{{tmp}}/ref.npz", {{"loss": m["loss"], "grad_norm": m["grad_norm"],
                          "trainable": new["trainable"]}})
'''

_RANKS = RANK_PRELUDE + f'''
from repro_torch.configs import get_reduced
from repro_torch.models import build_model
from repro_torch.optim import AdamWConfig
from repro_torch.training import init_train_state, make_train_step

wait_for(f"{{tmp}}/inputs.npz")
inputs = load(f"{{tmp}}/inputs.npz")
cfg = get_reduced("jamba_1_5_large_398b").replace(dtype="float32", microbatches=2)
model = build_model(cfg, "cpu")
params = params_from_jax(inputs["params"], "cpu")
batch = {{"tokens": t(inputs["tokens"])}}
step = make_train_step(model, AdamWConfig(lr={LR}))
mesh = make_mesh((2, 2), ("data", "model"))
with shrules.axis_rules(mesh, fsdp=False):
    state = init_train_state(model, params=params)
    specs = shrules.mesh_specs(state)
    new, m = step(shrules.local_blocks(state, specs), batch)
results.update({{k: n(m[k]) for k in ("loss", "ce", "aux", "grad_norm")}})
results["trainable"] = tree_map(n, new["trainable"])
if rank == 0:
    m = step(init_train_state(model, params=params), batch)[1]
    results["single"] = np.asarray([float(m[k]) for k in ("loss", "ce", "aux")])
''' + RANK_EPILOGUE


def param_shapes() -> dict:
    """The params' shapes and dtypes by path, from the port's meta params
    (the reference's shapes and dtypes, leaf for leaf)."""
    cfg = get_reduced("jamba_1_5_large_398b").replace(dtype="float32", microbatches=2)
    flat = leaves(build_model(cfg, "meta").dryrun_params())
    return {path: [list(x.shape), str(x.dtype).split(".")[1]] for path, x in flat}


@pytest.fixture(scope="module")
def readings(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("mesh_hybrid")
    (tmp / "param_shapes.json").write_text(json.dumps(param_shapes()))
    return run_world(_JAX, _RANKS, tmp)


def test_train_step_matches_the_reference_sharded_step(readings):
    ref, ranks = readings
    want = leaves(ref["trainable"])
    scale = max(float(np.abs(w).max()) for p, w in want if p.endswith("lam"))
    for r, got in enumerate(ranks):
        assert max_err(got["loss"], ref["loss"]) <= LOSS_ATOL, r
        assert_grad_norm(got, ref, r)
        for (path, g), (wpath, w) in zip(leaves(got["trainable"]), want):
            assert path == wpath and max_err(g, w) <= LAM_RTOL * scale, (r, path, max_err(g, w))
        for (_, a), (_, b) in zip(leaves(got["trainable"]), leaves(ranks[0]["trainable"])):
            assert np.array_equal(a, b), r


def test_train_step_beside_the_single_device_step(readings):
    _, ranks = readings
    loss, ce, aux = (float(ranks[0][k]) for k in ("loss", "ce", "aux"))
    s_loss, s_ce, s_aux = (float(v) for v in ranks[0]["single"])
    assert abs(ce - s_ce) <= SINGLE_ATOL and abs(loss - s_loss) <= SINGLE_ATOL
    assert abs((loss - s_loss) - MOE_AUX_COEF * (aux - s_aux)) <= LOSS_ATOL
    print(f"[parity] jamba: sharded loss {loss:.7f} ce {ce:.7f} aux {aux:.6f}; single-device "
          f"{s_loss:.7f} {s_ce:.7f} {s_aux:.6f}")
