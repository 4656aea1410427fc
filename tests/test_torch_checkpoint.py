"""The port's checkpoints (``repro_torch.checkpoint``) against the
reference's ``repro.checkpoint``: the five cases of
``tests/test_checkpoint.py`` on torch trees, the on-disk format read across
both packages in both directions (float32, bf16, int32 and None leaves, and
the reduced smollm-135m λ-only train state with its optimizer step), the
same manifest text for the same tree, and the elastic restart cutting the
QR factors to each rank's ``shard_ba`` share.  Every comparison is bitwise:
a checkpoint stores the bits of each leaf."""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import restore_pytree as j_restore
from repro.checkpoint import save_pytree as j_save
from repro.configs import get_reduced as jax_reduced
from repro.models import build_model as jax_build
from repro.training import init_train_state as j_init_state
from repro_torch.checkpoint import CheckpointManager, reshard_to_mesh, restore_pytree, save_pytree
from repro_torch.checkpoint.manager import _flatten, load_metadata
from repro_torch.configs import get_reduced
from repro_torch.interop import _leaf_to_torch, params_from_jax
from repro_torch.models import build_model
from repro_torch.sharding.rules import shard_factors
from repro_torch.training import init_train_state


@pytest.fixture(scope="module", autouse=True)
def _clear_jax_caches():
    yield
    jax.clear_caches()


def _tree(seed=0):
    """``tests/test_checkpoint.py``'s tree on torch leaves, from numpy."""
    rng = np.random.default_rng(seed)
    return {
        "a": torch.from_numpy(rng.standard_normal((4, 8)).astype(np.float32)),
        "b": {"c": torch.from_numpy(rng.standard_normal(3).astype(np.float32)).to(torch.bfloat16),
              "d": None},
        "step": torch.tensor(7, dtype=torch.int32),
    }


def _np(leaf):
    """A leaf's bits as numpy (bf16 as its uint16 pattern), None as None."""
    if leaf is None:
        return None
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach()
        return t.view(torch.int16).numpy().view(np.uint16) if t.dtype == torch.bfloat16 else t.numpy()
    if isinstance(leaf, int):
        return np.asarray(leaf, np.int32)
    arr = np.asarray(leaf)
    return arr.view(np.uint16) if arr.dtype == jnp.bfloat16 else arr


def _same_bits(a, b):
    """Two trees (any mix of packages) hold the same leaves bit for bit, with
    None where the other has None."""
    fa, fb = _flatten(a), _flatten(b)
    assert [k for k, _ in fa] == [k for k, _ in fb]
    for (key, x), (_, y) in zip(fa, fb):
        x, y = _np(x), _np(y)
        assert (x is None) == (y is None), key
        if x is not None:
            assert x.dtype == y.dtype and x.shape == y.shape, key
            np.testing.assert_array_equal(x, y, err_msg=key)


# ---------------------------------------------------------------------------
# tests/test_checkpoint.py, on the port
# ---------------------------------------------------------------------------


def test_roundtrip(tmp_path):
    t = _tree()
    save_pytree(t, str(tmp_path / "ck"), {"step": 7})
    r = restore_pytree(t, str(tmp_path / "ck"))
    _same_bits(t, r)
    assert r["b"]["d"] is None
    assert r["b"]["c"].dtype == torch.bfloat16
    assert load_metadata(str(tmp_path / "ck")) == {"step": 7}


def test_manager_retention_and_latest(tmp_path):
    m = CheckpointManager(str(tmp_path), keep=2)
    t = _tree()
    for s in (10, 20, 30):
        m.save(s, t, blocking=True)
    assert m.latest_step() == 30
    assert m.all_steps() == [20, 30]  # 10 GC'd


def test_manager_async_save(tmp_path):
    """The async save writes the values of the save call: the tree changed
    in place right after it does not reach the checkpoint."""
    m = CheckpointManager(str(tmp_path), keep=3)
    t = _tree()
    want = {k: (v.clone() if isinstance(v, torch.Tensor) else v) for k, v in t.items()}
    m.save(5, t, blocking=False)
    t["a"].add_(1.0)  # the next step, racing the background write
    m.wait()
    r, meta = m.restore(t)
    assert meta["step"] == 5
    np.testing.assert_array_equal(r["a"].numpy(), want["a"].numpy())


def test_restore_missing_leaf_raises(tmp_path):
    t = _tree()
    save_pytree(t, str(tmp_path / "ck"))
    bad = dict(t)
    bad["zz"] = torch.zeros(3)
    with pytest.raises(KeyError):
        restore_pytree(bad, str(tmp_path / "ck"))


def test_no_tmp_dirs_left(tmp_path):
    m = CheckpointManager(str(tmp_path), keep=3)
    m.save(1, _tree(), blocking=True)
    assert not [d for d in os.listdir(tmp_path) if d.endswith(".tmp")]


# ---------------------------------------------------------------------------
# the on-disk format across both packages
# ---------------------------------------------------------------------------


def _jax_tree(seed=1):
    rng = np.random.default_rng(seed)
    return {
        "f32": jnp.asarray(rng.standard_normal((5, 3)).astype(np.float32)),
        "nest": {"bf16": jnp.asarray(rng.standard_normal((2, 7)), jnp.bfloat16),
                 "i32": jnp.asarray(rng.integers(-9, 9, (4,)), jnp.int32),
                 "none": None},
        "scalar": jnp.asarray(3, jnp.int32),
    }


def _torch_like(jtree):
    return {"f32": torch.zeros(5, 3), "nest": {"bf16": torch.zeros(2, 7, dtype=torch.bfloat16),
                                               "i32": torch.zeros(4, dtype=torch.int32),
                                               "none": None},
            "scalar": torch.zeros((), dtype=torch.int32)}


def test_reference_checkpoint_restores_in_the_port(tmp_path):
    jt = _jax_tree()
    j_save(jt, str(tmp_path), {"step": 3})
    r = restore_pytree(_torch_like(jt), str(tmp_path))
    _same_bits(jt, r)
    assert r["nest"]["bf16"].dtype == torch.bfloat16 and r["nest"]["none"] is None


def _to_torch(tree):
    """A JAX tree's leaves as torch tensors (bf16 by bit pattern), None kept."""
    if isinstance(tree, dict):
        return {k: _to_torch(v) for k, v in tree.items()}
    return None if tree is None else _leaf_to_torch(np.asarray(tree), "cpu")


def test_port_checkpoint_restores_in_the_reference(tmp_path):
    jt = _jax_tree()
    save_pytree(_to_torch(jt), str(tmp_path), {"step": 3})
    r = j_restore(jax.tree_util.tree_map(jnp.zeros_like, jt), str(tmp_path))
    _same_bits(jt, r)
    assert r["nest"]["bf16"].dtype == jnp.bfloat16 and r["nest"]["none"] is None


def test_both_packages_write_the_same_manifest(tmp_path):
    """The same tree saved by each package: the manifest text is the same
    (leaf keys in order, shapes, dtypes, None leaves, metadata) and so is
    every stored array."""
    jt = _jax_tree()
    j_save(jt, str(tmp_path / "jax"), {"step": 3})
    save_pytree(restore_pytree(_torch_like(jt), str(tmp_path / "jax")), str(tmp_path / "port"),
                {"step": 3})
    texts = [(tmp_path / d / "manifest.json").read_text() for d in ("jax", "port")]
    assert texts[0] == texts[1]
    with np.load(tmp_path / "jax" / "proc0.npz") as a, np.load(tmp_path / "port" / "proc0.npz") as b:
        assert sorted(a.files) == sorted(b.files) == sorted(json.loads(texts[0])["leaves"].keys()
                                                            - {"nest§none"})
        for k in a.files:
            assert a[k].dtype == b[k].dtype
            np.testing.assert_array_equal(a[k], b[k])


def _train_states():
    """The reduced smollm-135m λ-only train state in both packages from one
    JAX init (float32; the QR factors bf16), λ and Adam's moments made
    nonzero so the crossing moves real values."""
    jcfg = jax_reduced("smollm-135m").replace(dtype="float32")
    jm = jax_build(jcfg)
    js = j_init_state(jm, jax.random.PRNGKey(0))
    rng = np.random.default_rng(4)
    fill = lambda x: None if x is None else jnp.asarray(
        rng.standard_normal(x.shape).astype(np.float32))
    js["trainable"] = jax.tree_util.tree_map(fill, js["trainable"], is_leaf=lambda x: x is None)
    js["opt"] = {"step": jnp.asarray(5, jnp.int32),
                 "m": jax.tree_util.tree_map(fill, js["opt"]["m"], is_leaf=lambda x: x is None),
                 "v": jax.tree_util.tree_map(fill, js["opt"]["v"], is_leaf=lambda x: x is None)}
    model = build_model(get_reduced("smollm-135m").replace(dtype="float32"), "cpu")
    params = params_from_jax(jax.tree_util.tree_map(np.asarray, jm.init(jax.random.PRNGKey(0))),
                             device="cpu")
    return js, init_train_state(model, params=params)


def test_train_state_crosses_both_ways(tmp_path):
    """The reference's train state restores into the port's (the optimizer
    step back as an int, λ requiring grad again), and the port's into the
    reference's, every leaf bitwise."""
    js, ts = _train_states()
    j_save(js, str(tmp_path / "jax"))
    got = restore_pytree(ts, str(tmp_path / "jax"))
    _same_bits(js, got)
    assert got["opt"]["step"] == 5 and isinstance(got["opt"]["step"], int)
    lam = got["trainable"]["groups"]["adapters"]["attn"]["wq"]["lam"]
    assert lam.requires_grad and lam.dtype == torch.float32
    save_pytree(got, str(tmp_path / "port"))
    back = j_restore(js, str(tmp_path / "port"))
    _same_bits(js, back)
    assert back["opt"]["step"].dtype == jnp.int32


# ---------------------------------------------------------------------------
# the elastic restart
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("world", [1, 2])
def test_reshard_cuts_each_rank_its_share(tmp_path, world):
    """A params tree checkpointed whole and restored at ``world`` ranks gives
    rank r ``shard_factors(full, r, world)`` bitwise (world 1: the tree
    itself); without ``shard_ba`` every rank holds the whole tree."""
    model = build_model(get_reduced("smollm-135m").replace(dtype="float32"), "cpu")
    full = model.init(torch.Generator().manual_seed(0))
    CheckpointManager(str(tmp_path)).save(3, full)
    restored, meta = CheckpointManager(str(tmp_path)).restore(full)
    assert meta["step"] == 3
    for rank in range(world):
        got = reshard_to_mesh(restored, "cpu", shard_ba=True, rank=rank, world=world)
        _same_bits(shard_factors(full, rank, world) if world > 1 else full, got)
        _same_bits(full, reshard_to_mesh(restored, "cpu", rank=rank, world=world))
    B = reshard_to_mesh(restored, "cpu", shard_ba=True, rank=0, world=world)[
        "groups"]["adapters"]["attn"]["wq"]["B"]
    assert B.shape[-1] == full["groups"]["adapters"]["attn"]["wq"]["B"].shape[-1] // world
