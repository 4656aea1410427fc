"""The port's training mesh against the reference's, the counterpart of
``tests/test_distributed.py``: ``moe_ffn``'s ``shard_map`` branch, the
sharded train step and decode under a ("data", "model") mesh.

Each file of this family runs one JAX subprocess on 4 virtual host devices
(``XLA_FLAGS`` set before jax is imported, as the reference's test does),
which writes the weights, the inputs and the reference's readings, and one
4-rank gloo group of the port (a file store, one thread a rank), which
waits for the inputs and writes each rank's readings.  The two run side by
side; the test compares them here.

This file, on a 2×2 mesh (rank (d, j) = 2d + j):

* ``moe_ffn`` alone, reduced mixtral-8x22b in float32 at capacity factor
  1.0 (copies drop: C is taken over each data shard's 16 rows), in six
  cases: fsdp off and on, ``dp_only``, ``replicate_batch``, a batch of 3
  rows that the 2 data ranks do not divide, and a ``d_ff`` of 63 that the
  2 model ranks do not divide.  y within 1e-5 and aux within 1e-6 of the
  reference's; with fsdp off and on and under ``dp_only``, the gradient of
  Σ y·c + aux by x, the router and the expert stacks within 1e-5 of
  ``jax.grad``'s.  The port's single-device branch misses the y bound
  against the reference's sharded y (the split changes which copies drop).
* the train step on reduced smollm-135m (float32, 2 microbatches): loss
  within 1e-5 and the updated λ within 5e-5 of max|λ| of the reference's
  sharded step, λ bitwise equal on the 4 ranks, the loss within 2e-3 of
  the port's single-device step (the reference test's own bound).
* the step in LoRA and SVD-LoRA on the same smollm, unclipped: the loss
  within 1e-5, the grad norm within 1e-3 and the gradient Adam took within
  1e-2 of each leaf's largest of the reference's sharded step (these
  gradients cancel heavily), the factors bitwise equal on the 4 ranks.
* prefill and two greedy decode steps of reduced smollm-135m under the
  mesh, each data rank on its 2 lanes: logits within 1e-4 of the
  reference's under its mesh.
"""
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parents[1]
WORLD = 4
# a run's wall-clock limit, and each gloo collective's timeout inside it
RUN_LIMIT_S = 300
GLOO_TIMEOUT_S = 240

Y_ATOL, AUX_ATOL, GRAD_ATOL = 1e-5, 1e-6, 1e-5
LOSS_ATOL, LAM_RTOL, SINGLE_ATOL, LOGITS_ATOL = 1e-5, 5e-5, 2e-3, 1e-4
MODES_NORM_RTOL, MODES_GRAD_RTOL = 1e-3, 1e-2

# trees cross between the processes as flat npz files, paths joined by "/"
# (a bfloat16 leaf as its bits, its key marked)
TREE_IO = '''
def flatten(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        key = f"{prefix}{k}"
        if isinstance(v, dict):
            out.update(flatten(v, key + "/"))
        elif v is not None:
            v = np.asarray(v)
            if v.dtype.name == "bfloat16":
                out[key + "#bf16"] = v.view(np.uint16)
            else:
                out[key] = v
    return out

def unflatten(flat):
    out = {}
    for key, v in flat.items():
        if key.endswith("#bf16"):
            import ml_dtypes
            key, v = key[:-5], v.view(ml_dtypes.bfloat16)
        node, parts = out, key.split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v
    return out

def save(path, tree):
    np.savez(path + ".tmp.npz", **flatten(tree))
    os.replace(path + ".tmp.npz", path)

def load(path):
    with np.load(path) as z:
        return unflatten({k: z[k] for k in z.files})
'''

# XLA's lowest backend optimization level: the code it generates for the
# CPU computes the same arithmetic and compiles in a fraction of the time
# (reduced jamba's init and sharded step: 30 s against 37 s)
JAX_PRELUDE = '''
import os, sys
os.environ["XLA_FLAGS"] = ("--xla_force_host_platform_device_count=4 "
                           "--xla_backend_optimization_level=0")
import jax, jax.numpy as jnp, numpy as np
from repro.launch.mesh import make_mesh
from repro.sharding import rules as shrules
tmp = sys.argv[1]
mesh = make_mesh((2, 2), ("data", "model"))
''' + TREE_IO

RANK_PRELUDE = '''
import datetime, os, sys, time
import numpy as np
import torch
import torch.distributed as dist
rank, world, tmp, timeout = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], float(sys.argv[4])
torch.set_num_threads(1)
dist.init_process_group("gloo", init_method=f"file://{tmp}/store", rank=rank, world_size=world,
                        timeout=datetime.timedelta(seconds=timeout))
from repro_torch.interop import params_from_jax
from repro_torch.launch.mesh import make_mesh
from repro_torch.sharding import collectives as coll
from repro_torch.sharding import rules as shrules
from repro_torch.tree import tree_map
''' + TREE_IO + '''
def wait_for(path):
    t0 = time.time()
    while not os.path.exists(path):
        if time.time() - t0 > timeout:
            raise TimeoutError(path)
        time.sleep(0.05)

def t(a):
    return torch.from_numpy(np.array(a, copy=True))

def n(x):  # a bfloat16 tensor widened (exactly) to float32
    x = x.detach()
    return (x.float() if x.dtype == torch.bfloat16 else x).numpy()

results = {}
'''

RANK_EPILOGUE = '''
save(f"{tmp}/rank{rank}.npz", results)
import gc
gc.collect()
dist.destroy_process_group()
'''


def run_world(jax_script: str, rank_script: str, tmp: Path):
    """The JAX script and ``WORLD`` ranks of the rank script side by side in
    ``tmp`` → (the reference's readings ``ref.npz``, each rank's
    ``rank<r>.npz``), as nested dicts of numpy arrays.  A process that fails
    ends the others (a rank may wait on a peer, the JAX script on a rank)."""
    env = {k: v for k, v in os.environ.items() if k not in ("PYTHONPATH", "XLA_FLAGS")}
    env["PYTHONPATH"] = str(ROOT / "src")
    env["JAX_PLATFORMS"] = "cpu"
    names = ["jax"] + [f"rank{r}" for r in range(WORLD)]
    argvs = [[jax_script, str(tmp)]] + [[rank_script, str(r), str(WORLD), str(tmp),
                                         str(GLOO_TIMEOUT_S)] for r in range(WORLD)]
    procs = []
    try:
        for name, argv in zip(names, argvs):
            with open(tmp / f"{name}.log", "w") as log:
                procs.append(subprocess.Popen([sys.executable, "-c", *argv], env=env, cwd=ROOT,
                                              stdout=log, stderr=subprocess.STDOUT))
        deadline = time.monotonic() + RUN_LIMIT_S
        while any(p.poll() is None for p in procs) and time.monotonic() < deadline:
            if any(p.poll() not in (None, 0) for p in procs):
                break
            time.sleep(0.1)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
    bad = [f"{name} (exit {p.returncode}):\n{(tmp / f'{name}.log').read_text()[-6000:]}"
           for name, p in zip(names, procs) if p.returncode != 0]
    assert not bad, "\n".join(bad)
    return _load(tmp / "ref.npz"), [_load(tmp / f"rank{r}.npz") for r in range(WORLD)]


def _load(path):
    ns = {"np": np, "os": os}
    exec(TREE_IO, ns)
    return ns["load"](str(path))


def max_err(a, b) -> float:
    return float(np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64)).max())


def assert_grad_norm(got, want, rank):
    """The step's grad norm within ``LAM_RTOL`` of the reference's: Adam's
    first step is blind to a gradient's scale (lr·g/|g|), so a gradient
    summed over the wrong ranks shows here, not in the updated λ."""
    err = max_err(got["grad_norm"], want["grad_norm"])
    assert err <= LAM_RTOL * float(want["grad_norm"]), (rank, float(got["grad_norm"]),
                                                         float(want["grad_norm"]))


def leaves(tree, prefix=""):
    """(path, array) pairs of a nested dict, sorted by path."""
    out = []
    for k in sorted(tree):
        v = tree[k]
        out += leaves(v, f"{prefix}{k}/") if isinstance(v, dict) else [(prefix + k, v)]
    return out


# ---------------------------------------------------------------------------
# moe_ffn alone; the smollm train step and decode
# ---------------------------------------------------------------------------

# (name, axis_rules keywords, batch rows, d_ff)
MOE_CASES = [("fsdp_off", {}, 4, 64), ("fsdp_on", {"fsdp": True}, 4, 64),
             ("dp_only", {"dp_only": True}, 4, 64),
             ("replicate_batch", {"replicate_batch": True}, 4, 64),
             ("batch_not_divisible", {}, 3, 64), ("d_ff_not_divisible", {}, 4, 63)]
GRAD_CASES = ("fsdp_off", "fsdp_on", "dp_only")
SEQ, TRAIN_BATCH, TRAIN_SEQ, LR = 8, 4, 16, 1e-2
# the step's other adapter modes beside QR-LoRA (full fine-tuning: the
# mixtral file), on smollm
OTHER_MODES = ("lora", "svd_lora")
DECODE_LANES, PROMPT, MAX_LEN = 4, 8, 16

_JAX = JAX_PRELUDE + f'''
import json
from repro.configs import get_reduced
from repro.models import build_model
from repro.models.moe import init_moe_params, moe_ffn
from repro.optim import AdamWConfig
from repro.training import init_train_state, make_decode_step, make_prefill_step, make_train_step

cases = {MOE_CASES!r}
inputs, ref = {{"moe": {{}}}}, {{"moe": {{}}}}
rng = np.random.default_rng(0)
for name, kw, B, f in cases:
    cfg = get_reduced("mixtral_8x22b").replace(dtype="float32", capacity_factor=1.0, d_ff=f)
    p = jax.tree_util.tree_map(lambda a: a[0], init_moe_params(jax.random.PRNGKey(len(name)), cfg,
                                                                1, jnp.float32))
    x = rng.standard_normal((B, {SEQ}, cfg.d_model)).astype(np.float32)
    c = rng.standard_normal(x.shape).astype(np.float32)
    inputs["moe"][name] = {{"p": p, "x": x, "c": c}}
    with shrules.axis_rules(mesh, **kw):
        y, aux = jax.jit(lambda p, x: moe_ffn(p, x, cfg))(p, jnp.asarray(x))
        out = {{"y": y, "aux": aux}}
        if name in {GRAD_CASES!r}:
            def objective(p, x):
                y, aux = moe_ffn(p, x, cfg)
                return jnp.sum(y * c) + aux
            gp, gx = jax.jit(jax.grad(objective, argnums=(0, 1)))(p, jnp.asarray(x))
            out["grad"] = {{"p": gp, "x": gx}}
    ref["moe"][name] = out

cfg = get_reduced("smollm_135m").replace(dtype="float32", microbatches=2)
model = build_model(cfg)
params = model.init(jax.random.PRNGKey(0))
tokens = rng.integers(0, cfg.vocab_size, ({TRAIN_BATCH}, {TRAIN_SEQ})).astype(np.int32)
prompt = rng.integers(0, cfg.vocab_size, ({DECODE_LANES}, {PROMPT})).astype(np.int32)
inputs["smollm"] = {{"params": params, "tokens": tokens, "prompt": prompt}}
inputs["modes"] = {{}}
for mode in {OTHER_MODES!r}:
    m_model = build_model(cfg.replace(adapter=cfg.adapter.replace(mode=mode)))
    inputs["modes"][mode] = m_model.init(jax.random.PRNGKey(1))
save(f"{{tmp}}/inputs.npz", inputs)

state = init_train_state(model, None, params=params)
with shrules.axis_rules(mesh, fsdp=False):
    step = make_train_step(model, AdamWConfig(lr={LR}))
    new, m = jax.jit(step)(state, {{"tokens": jnp.asarray(tokens)}})
    ref["train"] = {{"loss": m["loss"], "grad_norm": m["grad_norm"],
                    "trainable": new["trainable"]}}
    cache = model.init_decode_state({DECODE_LANES}, {MAX_LEN}, jnp.float32)
    logits, cache = jax.jit(make_prefill_step(model))(params, cache,
                                                      {{"tokens": jnp.asarray(prompt)}})
    tok, steps = jnp.argmax(logits, -1).astype(jnp.int32)[:, None], [logits]
    decode = jax.jit(make_decode_step(model))
    for _ in range(2):
        tok, logits, cache = decode(params, cache, {{"token": tok}})
        steps.append(logits)
    ref["decode"] = {{"logits": jnp.stack(steps)}}
ref["modes"] = {{}}
for mode in {OTHER_MODES!r}:
    m_model = build_model(cfg.replace(adapter=cfg.adapter.replace(mode=mode)))
    m_state = init_train_state(m_model, None, params=inputs["modes"][mode])
    with shrules.axis_rules(mesh, fsdp=False):
        new, m = jax.jit(make_train_step(m_model, AdamWConfig(lr={LR}, clip_norm=0.0)))(
            m_state, {{"tokens": jnp.asarray(tokens)}})
    ref["modes"][mode] = {{"loss": m["loss"], "grad_norm": m["grad_norm"], "m": new["opt"]["m"]}}
save(f"{{tmp}}/ref.npz", ref)
'''

_RANKS = RANK_PRELUDE + f'''
from repro_torch.configs import get_reduced
from repro_torch.models import build_model, moe
from repro_torch.optim import AdamWConfig
from repro_torch.training import (init_train_state, make_decode_step, make_prefill_step,
                                  make_train_step)

wait_for(f"{{tmp}}/inputs.npz")
inputs = load(f"{{tmp}}/inputs.npz")
mesh = make_mesh((2, 2), ("data", "model"))
results["moe"] = {{}}
for name, kw, B, f in {MOE_CASES!r}:
    cfg = get_reduced("mixtral_8x22b").replace(dtype="float32", capacity_factor=1.0, d_ff=f)
    case = inputs["moe"][name]
    p, x, c = params_from_jax(case["p"], "cpu"), t(case["x"]), t(case["c"])
    out = results["moe"][name] = {{}}
    if rank == 0:  # the single-device branch on the whole batch
        out["single_y"] = n(moe.moe_ffn(p, x, cfg)[0])
    with shrules.axis_rules(mesh, **kw):
        specs = shrules.mesh_specs(p)
        pl = tree_map(lambda a: a.requires_grad_(True), shrules.local_blocks(p, specs))
        split = shrules.batch_splits(B)
        xl = shrules.rank_rows(x, split).clone().requires_grad_(True)
        with shrules.data_shard(split):
            y, aux = moe.moe_ffn(pl, xl, cfg)
            # this rank's share of Σ y·c + aux (the rows it holds, the aux
            # over the data ranks that hold other rows)
            nd = shrules._axis_size(mesh, shrules.dp_axes())
            share = torch.sum(y * shrules.rank_rows(c, split)) if split else torch.sum(y * c) / nd
            (share + aux / nd).backward()
        out["y"] = n(coll.gather_dim(y, shrules.dp_axes(), 0) if split else y)
        out["aux"] = n(aux)
        gx = coll.gather_dim(xl.grad, shrules.dp_axes(), 0) if split else coll.all_reduce(
            xl.grad, shrules.dp_axes())
        gp = {{}}
        for k, v in pl.items():
            g = v.grad
            if not set(shrules.dp_axes()) & set(shrules.sharded_axes(specs[k])):
                g = coll.all_reduce(g, shrules.dp_axes())
            gp[k] = g
        gp = coll.gather_blocks(gp, specs)
        out["grad"] = {{"x": n(gx), "p": tree_map(n, gp)}}

cfg = get_reduced("smollm_135m").replace(dtype="float32", microbatches=2)
model = build_model(cfg, "cpu")
sm = inputs["smollm"]
params = params_from_jax(sm["params"], "cpu")
batch = {{"tokens": t(sm["tokens"])}}
step = make_train_step(model, AdamWConfig(lr={LR}))
with shrules.axis_rules(mesh, fsdp=False):
    state = init_train_state(model, params=params)
    state = {{**state, "trainable": shrules.local_blocks(state["trainable"],
                                                        shrules.mesh_specs(state["trainable"]))}}
    new, m = step(state, batch)
results["train"] = {{"loss": n(m["loss"]), "grad_norm": n(m["grad_norm"]),
                     "trainable": tree_map(n, new["trainable"])}}
if rank == 0:
    results["train"]["single_loss"] = n(step(init_train_state(model, params=params), batch)[1]["loss"])

with shrules.axis_rules(mesh):
    prompt = t(sm["prompt"])
    lanes = {DECODE_LANES} // 2
    cache = model.init_decode_state(lanes, {MAX_LEN}, torch.float32)
    with torch.no_grad():
        logits, cache = make_prefill_step(model)(params, cache, {{"tokens": prompt}})
        tok, steps = torch.argmax(logits, -1).to(torch.int32)[:, None], [logits]
        for _ in range(2):
            tok, logits, cache = make_decode_step(model)(params, cache, {{"token": tok}})
            steps.append(logits)
results["decode"] = {{"logits": n(torch.stack(steps))}}

results["modes"] = {{}}
for mode in {OTHER_MODES!r}:
    m_model = build_model(cfg.replace(adapter=cfg.adapter.replace(mode=mode)), "cpu")
    m_params = params_from_jax(inputs["modes"][mode], "cpu")
    with shrules.axis_rules(mesh, fsdp=False):
        new, m = make_train_step(m_model, AdamWConfig(lr={LR}, clip_norm=0.0))(
            init_train_state(m_model, params=m_params), batch)
    results["modes"][mode] = {{"loss": n(m["loss"]), "grad_norm": n(m["grad_norm"]),
                              "m": tree_map(n, new["opt"]["m"]),
                              "trainable": tree_map(n, new["trainable"])}}
''' + RANK_EPILOGUE


@pytest.fixture(scope="module")
def readings(tmp_path_factory):
    return run_world(_JAX, _RANKS, tmp_path_factory.mktemp("mesh"))


@pytest.mark.parametrize("case", [c[0] for c in MOE_CASES])
def test_moe_ffn_sharded_branch_matches_the_reference(readings, case):
    ref, ranks = readings
    want = ref["moe"][case]
    for r, got in enumerate(ranks):
        got = got["moe"][case]
        assert max_err(got["y"], want["y"]) <= Y_ATOL, (case, r, max_err(got["y"], want["y"]))
        assert max_err(got["aux"], want["aux"]) <= AUX_ATOL, (case, r)
        if case in GRAD_CASES:
            assert max_err(got["grad"]["x"], want["grad"]["x"]) <= GRAD_ATOL, (case, r)
            for (path, g), (wpath, w) in zip(leaves(got["grad"]["p"]), leaves(want["grad"]["p"])):
                assert path == wpath and max_err(g, w) <= GRAD_ATOL, (case, r, path, max_err(g, w))


def test_the_data_split_changes_the_result(readings):
    """Capacity over each data shard's rows drops other copies than over
    the whole batch: the port's single-device branch misses the bound
    against the reference's sharded y, by far."""
    ref, ranks = readings
    err = max_err(ranks[0]["moe"]["fsdp_off"]["single_y"], ref["moe"]["fsdp_off"]["y"])
    assert err > 100 * Y_ATOL, err


def test_train_step_matches_the_reference_sharded_step(readings):
    ref, ranks = readings
    want = leaves(ref["train"]["trainable"])
    scale = max(float(np.abs(w).max()) for p, w in want if p.endswith("lam"))
    for r, got in enumerate(ranks):
        assert max_err(got["train"]["loss"], ref["train"]["loss"]) <= LOSS_ATOL, r
        assert_grad_norm(got["train"], ref["train"], r)
        for (path, g), (wpath, w) in zip(leaves(got["train"]["trainable"]), want):
            assert path == wpath and max_err(g, w) <= LAM_RTOL * scale, (r, path)
    for got in ranks[1:]:  # every rank applied the same update
        for (_, a), (_, b) in zip(leaves(got["train"]["trainable"]),
                                  leaves(ranks[0]["train"]["trainable"])):
            assert np.array_equal(a, b)
    single = ranks[0]["train"]["single_loss"]
    assert abs(float(ranks[0]["train"]["loss"]) - float(single)) <= SINGLE_ATOL


@pytest.mark.parametrize("mode", OTHER_MODES)
def test_train_step_in_the_other_adapter_modes(readings, mode):
    """LoRA's and SVD-LoRA's B and A through the sharded step, unclipped
    (so a gradient summed over the wrong ranks shows in its size): the loss
    within 1e-5 and the grad norm within 1e-3 of the reference's sharded
    step; the gradient Adam took (its first moment, 0.1·g) within 1e-2 of
    each leaf's largest; the updated factors bitwise equal on the 4 ranks.
    These gradients cancel heavily, so the float32 summation order alone
    moves them past λ's 5e-5 (the reference's own step does, when only its
    microbatching changes), and they are held to 1e-2."""
    ref, ranks = readings
    want = ref["modes"][mode]
    for r, got in enumerate(ranks):
        got = got["modes"][mode]
        assert max_err(got["loss"], want["loss"]) <= LOSS_ATOL, (mode, r)
        assert max_err(got["grad_norm"], want["grad_norm"]) <= MODES_NORM_RTOL * float(
            want["grad_norm"]), (mode, r, float(got["grad_norm"]), float(want["grad_norm"]))
        for (path, g), (wpath, w) in zip(leaves(got["m"]), leaves(want["m"])):
            assert path == wpath and max_err(g, w) <= MODES_GRAD_RTOL * float(np.abs(w).max()), (
                mode, r, path, max_err(g, w))
    for got in ranks[1:]:
        for (_, a), (_, b) in zip(leaves(got["modes"][mode]["trainable"]),
                                  leaves(ranks[0]["modes"][mode]["trainable"])):
            assert np.array_equal(a, b)


def test_decode_under_the_mesh_matches_the_reference(readings):
    ref, ranks = readings
    for r, got in enumerate(ranks):
        err = max_err(got["decode"]["logits"], ref["decode"]["logits"])
        assert err <= LOGITS_ATOL, (r, err)
