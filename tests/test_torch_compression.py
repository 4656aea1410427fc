"""The port's gradient compression (``repro_torch.optim.compression``)
against the reference's ``repro.optim.compression``: the counterparts of
``tests/test_optim.py``'s quantization and error-feedback cases and of
``tests/test_extensions.py``'s two top-k cases; ``quantize_leaf``,
``topk_sparsify`` (ties included) and a world-of-one
``compressed_grad_sync`` bitwise the JAX functions on the same inputs (the
JAX sync under ``shard_map`` on a one-device mesh); a 2-rank gloo group
bitwise the reference's formula (``compression.py:201-211``) evaluated in
JAX on the stacked per-rank gradients.  The port sums the ranks' int8 codes
exactly in int32 where the reference's psum is int16, so every comparison
is bitwise."""
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh
from jax.sharding import PartitionSpec as P

from repro.compat import shard_map
from repro.optim import compression as jc
from repro_torch.optim.compression import (
    compressed_grad_sync,
    dequantize_leaf,
    init_error_state,
    quantize_leaf,
    topk_grad_sync,
    topk_sparsify,
)

ROOT = Path(__file__).resolve().parents[1]
GROUP_LIMIT_S = 120


@pytest.fixture(scope="module", autouse=True)
def _clear_jax_caches():
    yield
    jax.clear_caches()


def _grads(seed, shapes=((3, 8), (17,), (2, 3, 5))):
    """A gradient tree of float32 leaves of several magnitudes, and a None."""
    rng = np.random.default_rng(seed)
    tree = {f"g{i}": (rng.standard_normal(s) * 10.0 ** rng.integers(-4, 2)).astype(np.float32)
            for i, s in enumerate(shapes)}
    tree["frozen"] = None
    return tree


def _torch(tree):
    return {k: None if v is None else torch.from_numpy(np.array(v)) for k, v in tree.items()}


def _equal(got, want):
    """A torch tree bitwise a JAX/numpy tree (None where it has None)."""
    assert got.keys() == want.keys()
    for k in want:
        if want[k] is None:
            assert got[k] is None, k
            continue
        w = np.asarray(want[k])
        assert got[k].numpy().dtype == w.dtype, k
        np.testing.assert_array_equal(got[k].numpy(), w, err_msg=k)


# ---------------------------------------------------------------------------
# tests/test_optim.py and tests/test_extensions.py, on the port
# ---------------------------------------------------------------------------


def test_quantization_roundtrip_error_bounded():
    rng = np.random.default_rng(0)
    g = torch.from_numpy(rng.normal(size=(256,)).astype(np.float32))
    q, scale = quantize_leaf(g)
    back = dequantize_leaf(q, scale)
    assert q.dtype == torch.int16
    assert float((back - g).abs().max()) <= float(scale) / 2 + 1e-9


def test_compression_error_feedback_converges():
    """int8+EF gradient descent reaches the optimum despite quantization."""
    w = torch.tensor([2.0, -3.0, 1.0, 0.5])
    err = torch.zeros_like(w)
    lr = 0.05
    for _ in range(400):
        g = 2 * w  # ∇ of ||w||²
        ge = g + err
        q, scale = quantize_leaf(ge)
        gq = dequantize_leaf(q, scale)
        err = ge - gq
        w = w - lr * gq
    assert float(w.abs().max()) < 1e-2


def test_topk_sparsify_keeps_largest():
    g = torch.tensor([0.1, -5.0, 0.2, 3.0, -0.05, 0.0, 1.0, -0.3])
    kept, resid = topk_sparsify(g, frac=0.25)
    assert set(torch.nonzero(kept).flatten().tolist()) == {1, 3}  # |−5| and |3|
    assert torch.equal(kept + resid, g)


def test_topk_error_feedback_converges():
    w = torch.from_numpy(np.random.default_rng(0).normal(size=32).astype(np.float32)) * 3
    err = None
    for _ in range(600):
        synced, err = topk_grad_sync({"w": 2 * w}, err, frac=0.1)
        w = w - 0.05 * synced["w"]
    assert float(w.abs().max()) < 5e-2


# ---------------------------------------------------------------------------
# bitwise the JAX functions
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_quantize_and_topk_bitwise_jax(seed):
    for key, g in _grads(seed).items():
        if g is None:
            continue
        qj, sj = jc.quantize_leaf(jnp.asarray(g))
        qt, st = quantize_leaf(torch.from_numpy(g))
        _equal({"q": qt, "s": st}, {"q": qj, "s": sj})
        for frac in (0.01, 0.1, 0.5):
            kj, rj = jc.topk_sparsify(jnp.asarray(g), frac)
            kt, rt = topk_sparsify(torch.from_numpy(g), frac)
            _equal({"k": kt, "r": rt}, {"k": kj, "r": rj})


def test_topk_keeps_every_tie_as_the_reference():
    """Every entry at the k-th largest magnitude stays, so more than k may:
    k = 2 of these keeps the three entries of magnitude 3."""
    g = np.array([1.0, -3.0, 3.0, 0.5, -3.0, 2.0], np.float32)
    kt, rt = topk_sparsify(torch.from_numpy(g), 2 / 6)
    kj, rj = jc.topk_sparsify(jnp.asarray(g), 2 / 6)
    _equal({"k": kt, "r": rt}, {"k": kj, "r": rj})
    assert int((kt != 0).sum()) == 3


def _jax_world_of_one(grads, err):
    """The reference's ``compressed_grad_sync`` inside ``shard_map`` on a
    one-device mesh (axis "data")."""
    mesh = Mesh(np.array(jax.devices()[:1]), ("data",))
    fn = shard_map(lambda g, e: jc.compressed_grad_sync(g, e, mesh, ("data",)),
                   mesh=mesh, in_specs=(P(), P()), out_specs=(P(), P()))
    return fn(jax.tree_util.tree_map(jnp.asarray, grads),
              jax.tree_util.tree_map(jnp.asarray, err))


@pytest.mark.parametrize("seed", [0, 3])
def test_world_of_one_sync_bitwise_jax(seed):
    """Two rounds (the second with the first's residual): synced gradients
    and residuals bitwise the reference's, with no process group up (no
    collective) as in a world of one."""
    grads = _grads(seed)
    dense = {k: v for k, v in grads.items() if v is not None}
    s1, e1 = compressed_grad_sync(_torch(grads), None)
    js1, je1 = _jax_world_of_one(dense, jax.tree_util.tree_map(np.zeros_like, dense))
    _equal({k: v for k, v in s1.items() if v is not None}, js1)
    _equal({k: v for k, v in e1.items() if v is not None}, je1)
    assert s1["frozen"] is None and e1["frozen"] is None
    s2, e2 = compressed_grad_sync(_torch(grads), e1)
    js2, je2 = _jax_world_of_one(dense, je1)
    _equal({k: v for k, v in s2.items() if v is not None}, js2)
    _equal({k: v for k, v in e2.items() if v is not None}, je2)
    assert init_error_state(_torch(dense))["g0"].dtype == torch.float32


# ---------------------------------------------------------------------------
# a 2-rank gloo group against the reference's formula
# ---------------------------------------------------------------------------

_RANK_SCRIPT = textwrap.dedent(
    """
    import datetime, json, sys
    import numpy as np
    import torch
    import torch.distributed as dist

    rank, world, store, inputs, out = (int(sys.argv[1]), int(sys.argv[2]), sys.argv[3],
                                       sys.argv[4], sys.argv[5])
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank,
                            world_size=world, timeout=datetime.timedelta(seconds=100))
    from repro_torch.optim.compression import compressed_grad_sync, topk_grad_sync

    data = np.load(inputs)
    g = {k: torch.from_numpy(data[k][rank].copy()) for k in ("a", "b")}
    e = {k: torch.from_numpy(data["e_" + k][rank].copy()) for k in ("a", "b")}
    synced, new_e = compressed_grad_sync(g, e)
    tk, tk_e = topk_grad_sync(g, None, frac=0.25)
    res = {f"{name}_{k}": t[k].numpy().tolist() for name, t in
           (("synced", synced), ("err", new_e), ("topk", tk), ("topk_err", tk_e)) for k in g}
    res = {k: np.asarray(v, np.float32).view(np.int32).tolist() for k, v in res.items()}
    with open(out.format(rank=rank), "w") as f:
        json.dump(res, f)
    dist.destroy_process_group()
    """
)


def _reference_formula(G, E):
    """``repro/optim/compression.py:201-211`` on the ranks' stacked leaves
    G, E (world, ...): the shared scale, the int16 sum of the codes, the
    synced gradient and each rank's residual."""
    n = G.shape[0]
    g32 = G.astype(jnp.float32) + E
    scale = jnp.maximum(jnp.max(jnp.abs(g32.reshape(n, -1)), axis=1), 1e-12) / 127.0
    smax = jnp.max(scale)
    q2 = jnp.clip(jnp.round(g32 / smax), -127, 127).astype(jnp.int16)
    qsum = jnp.sum(q2, axis=0, dtype=jnp.int16)
    return qsum.astype(jnp.float32) * smax / n, g32 - q2.astype(jnp.float32) * smax


def test_two_rank_gloo_sync_bitwise_the_reference_formula(tmp_path):
    world = 2
    rng = np.random.default_rng(7)
    inputs = {"a": rng.standard_normal((world, 4, 6)).astype(np.float32),
              "b": (rng.standard_normal((world, 33)) * 1e-3).astype(np.float32)}
    # the second rank's leaf a larger, so the shared scale is its
    inputs["a"][1] *= 3.0
    for k in ("a", "b"):
        inputs["e_" + k] = (rng.standard_normal(inputs[k].shape) * 1e-2).astype(np.float32)
    np.savez(tmp_path / "inputs.npz", **inputs)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(ROOT / "src")
    out = str(tmp_path / "rank{rank}.json")
    procs = [subprocess.Popen(
        [sys.executable, "-c", _RANK_SCRIPT, str(r), str(world), str(tmp_path / "store"),
         str(tmp_path / "inputs.npz"), out], env=env, cwd=ROOT, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(world)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=GROUP_LIMIT_S)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert all(p.returncode == 0 for p in procs), "\n".join(logs)
    for r in range(world):
        res = {k: np.asarray(v, np.int32).view(np.float32)
               for k, v in json.loads(Path(out.format(rank=r)).read_text()).items()}
        for k in ("a", "b"):
            synced, err = _reference_formula(jnp.asarray(inputs[k]), jnp.asarray(inputs["e_" + k]))
            np.testing.assert_array_equal(res[f"synced_{k}"].reshape(synced.shape),
                                          np.asarray(synced))
            np.testing.assert_array_equal(res[f"err_{k}"].reshape(err[r].shape),
                                          np.asarray(err[r]))
            # top-k: each rank's kept entries summed (a two-term sum is exact
            # in either order), the residual its own
            kept = [np.asarray(jc.topk_sparsify(jnp.asarray(inputs[k][i]), 0.25)[0])
                    for i in range(world)]
            np.testing.assert_array_equal(res[f"topk_{k}"].reshape(kept[0].shape),
                                          kept[0] + kept[1])
            np.testing.assert_array_equal(
                res[f"topk_err_{k}"].reshape(kept[0].shape),
                np.asarray(jc.topk_sparsify(jnp.asarray(inputs[k][r]), 0.25)[1]))
