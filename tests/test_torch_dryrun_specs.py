"""The dry-run's stand-ins and placements in the PyTorch port against the
JAX reference, at full width, for all ten archs of the reference's grid.

The port's meta tensors (``Model.dryrun_params``, ``launch.specs``) against
the reference's ``jax.ShapeDtypeStruct`` trees (``jax.eval_shape``, also
allocation-free): the same paths (the port keeps the reference's layouts,
so ``interop``'s key mapping is the identity), shapes and dtypes, for the
params, the train state, every applicable cell's batch and decode cache,
and ``shape_applicable`` over the grid.  Per-device bytes of params, train
state, cache and batch under both production meshes against the sum of the
reference's shard shapes, its specs from ``launch.specs`` on a device-free
``jax.sharding.AbstractMesh``.  Everything compared is an integer or a
name, so every match is exact (no tolerance).
"""
import math

import jax
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh, NamedSharding

from repro.configs import SHAPES as J_SHAPES
from repro.configs import all_archs as j_all_archs
from repro.configs import get_config as jax_config
from repro.configs import shape_applicable as j_shape_applicable
from repro.launch import specs as JS
from repro.models import build_model as jax_build
from repro_torch.configs import SHAPES, all_archs, get_config, shape_applicable
from repro_torch.launch import specs as S
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import build_model
from repro_torch.sharding import rules as shrules

ARCHS = j_all_archs()
MESHES = {False: ((16, 16), ("data", "model")), True: ((2, 16, 16), ("pod", "data", "model"))}


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _port_leaves(tree, prefix=()):
    """path → (shape, dtype name) of the non-None leaves of a port tree."""
    if tree is None:
        return {}
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_port_leaves(v, prefix + (str(k),)))
        return out
    assert tree.device.type == "meta", prefix
    return {prefix: (tuple(tree.shape), str(tree.dtype).split(".")[-1])}


def _jax_leaves(tree):
    flat = jax.tree_util.tree_flatten_with_path(tree)[0]
    return {tuple(str(getattr(p, "key", getattr(p, "idx", ""))) for p in path):
            (tuple(leaf.shape), str(leaf.dtype)) for path, leaf in flat}


def _cells(arch):
    return [name for name in SHAPES if shape_applicable(get_config(arch), SHAPES[name])]


@pytest.fixture(scope="module")
def jax_models():
    return {a: jax_build(jax_config(a)) for a in ARCHS}


@pytest.fixture(scope="module")
def port_models():
    return {a: build_model(get_config(a), "meta") for a in ARCHS}


def test_the_grid_is_the_reference_grid():
    """The same ten arch names in the same order, the same four cells, and
    the same applicability over every arch × shape."""
    assert all_archs() == ARCHS
    assert {n: (s.name, s.seq_len, s.global_batch, s.kind) for n, s in SHAPES.items()} == {
        n: (s.name, s.seq_len, s.global_batch, s.kind) for n, s in J_SHAPES.items()}
    for arch in ARCHS:
        for name in SHAPES:
            assert shape_applicable(get_config(arch), SHAPES[name]) == j_shape_applicable(
                jax_config(arch), J_SHAPES[name]), (arch, name)
        assert (get_config(arch).fsdp, get_config(arch).dp_only) == (
            jax_config(arch).fsdp, jax_config(arch).dp_only), arch


@pytest.mark.parametrize("arch", ARCHS)
def test_dryrun_params_match_the_reference(arch, jax_models, port_models):
    """Leaf for leaf the reference's ``dryrun_params`` (path, shape,
    dtype), every leaf a meta tensor; the param count follows."""
    got = _port_leaves(port_models[arch].dryrun_params())
    want = _jax_leaves(jax_models[arch].dryrun_params())
    assert got == want


@pytest.mark.parametrize("arch", ARCHS)
def test_train_state_and_batches_match_the_reference(arch, jax_models, port_models):
    """``train_state_shapes`` (the trainable/frozen split, float32 m and v,
    the int32 step) and ``input_specs`` of every applicable cell."""
    assert _port_leaves(S.train_state_shapes(port_models[arch])) == _jax_leaves(
        JS.train_state_shapes(jax_models[arch]))
    for name in _cells(arch):
        assert _port_leaves(S.input_specs(get_config(arch), SHAPES[name])) == _jax_leaves(
            JS.input_specs(jax_config(arch), J_SHAPES[name])), name


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_caches_match_the_reference(arch, jax_models, port_models):
    """``decode_cache_shapes`` of every applicable prefill and decode cell,
    long_500k's half-million positions included (nothing is allocated)."""
    for name in _cells(arch):
        if SHAPES[name].kind == "train":
            continue
        got = _port_leaves(S.decode_cache_shapes(port_models[arch], SHAPES[name]))
        assert got == _jax_leaves(JS.decode_cache_shapes(jax_models[arch], J_SHAPES[name])), name


def _jax_device_bytes(tree, shardings) -> int:
    total = []
    jax.tree_util.tree_map(
        lambda leaf, s: total.append(math.prod(s.shard_shape(leaf.shape)) * leaf.dtype.itemsize),
        tree, shardings)
    return sum(total)


@pytest.mark.parametrize("multi_pod", [False, True], ids=["16x16", "2x16x16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_per_device_bytes_match_the_reference(arch, multi_pod, jax_models, port_models):
    """Per-device bytes of the params, the train state, and each applicable
    cell's batch and cache under the production mesh: the port's rule table
    against the sum of the reference's shard shapes."""
    jmesh = AbstractMesh(*MESHES[multi_pod])
    mesh = make_production_mesh(multi_pod=multi_pod)
    assert (mesh.dims, mesh.axis_names) == MESHES[multi_pod] and mesh.size == math.prod(
        MESHES[multi_pod][0])
    cfg, jcfg = get_config(arch), jax_config(arch)
    pm, jm = port_models[arch], jax_models[arch]

    params, jparams = pm.dryrun_params(), jm.dryrun_params()
    assert S.per_device_bytes(params, S.params_shardings(params, mesh, fsdp=cfg.fsdp), mesh) == (
        _jax_device_bytes(jparams, JS.params_shardings(jparams, jmesh, fsdp=jcfg.fsdp)))
    state, jstate = S.train_state_shapes(pm), JS.train_state_shapes(jm)
    assert S.per_device_bytes(state, S.train_state_shardings(state, mesh, fsdp=cfg.fsdp),
                              mesh) == _jax_device_bytes(
        jstate, JS.train_state_shardings(jstate, jmesh, fsdp=jcfg.fsdp))
    for name in _cells(arch):
        shape, jshape = SHAPES[name], J_SHAPES[name]
        batch = S.input_specs(cfg, shape)
        assert S.per_device_bytes(batch, S.batch_shardings(cfg, shape, mesh), mesh) == (
            _jax_device_bytes(JS.input_specs(jcfg, jshape),
                              JS.batch_shardings(jcfg, jshape, jmesh))), name
        if shape.kind == "train":
            continue
        cache, jcache = S.decode_cache_shapes(pm, shape), JS.decode_cache_shapes(jm, jshape)
        assert S.per_device_bytes(cache, S.decode_cache_shardings(cache, cfg, shape, mesh),
                                  mesh) == _jax_device_bytes(
            jcache, JS.decode_cache_shardings(jcache, jcfg, jshape, jmesh)), name


@pytest.mark.parametrize("multi_pod", [False, True], ids=["16x16", "2x16x16"])
def test_param_specs_are_the_reference_specs(multi_pod, jax_models, port_models):
    """Spec for spec on jamba-1.5-large-398b (FSDP; attention, Mamba, experts,
    adapters) and xlstm-125m: the port's tuples are the reference's
    ``PartitionSpec`` entries (which name a one-axis tuple by its axis, as
    ``PartitionSpec`` does)."""
    one = lambda entry: entry[0] if isinstance(entry, tuple) and len(entry) == 1 else entry
    jmesh = AbstractMesh(*MESHES[multi_pod])
    mesh = make_production_mesh(multi_pod=multi_pod)
    for arch in ("jamba_1_5_large_398b", "xlstm_125m"):
        cfg = get_config(arch)
        params = port_models[arch].dryrun_params()
        got = {}

        def walk(node, path=()):
            if isinstance(node, dict):
                for k, v in node.items():
                    walk(v, path + (k,))
            else:
                got[path] = tuple(map(one, node))

        walk(S.params_shardings(params, mesh, fsdp=cfg.fsdp))
        jparams = jax_models[arch].dryrun_params()
        jspecs = JS.params_shardings(jparams, jmesh, fsdp=cfg.fsdp)
        flat = jax.tree_util.tree_flatten_with_path(
            jspecs, is_leaf=lambda x: isinstance(x, NamedSharding))[0]
        want = {tuple(str(p.key) for p in path): tuple(s.spec) + (None,) * (
            len(got[tuple(str(p.key) for p in path)]) - len(s.spec)) for path, s in flat}
        assert got == want, arch


class _SizedMesh(AbstractMesh):
    """An ``AbstractMesh`` whose ``devices`` has the mesh's size (the
    reference's ``dp_only`` batch reads ``mesh.devices.size``, which an
    abstract mesh does not implement); no device is made."""

    @property
    def devices(self):
        return np.empty(self.size)


RULE_OPTIONS = ({}, {"fsdp": True}, {"dp_only": True}, {"replicate_batch": True},
                {"fsdp": True, "replicate_batch": True})


@pytest.mark.parametrize("multi_pod", [False, True], ids=["16x16", "2x16x16"])
@pytest.mark.parametrize("opts", RULE_OPTIONS, ids=lambda o: "-".join(o) or "default")
def test_rule_table_is_the_reference_table(opts, multi_pod):
    """``default_rules`` under each option is the reference's dict, and
    ``logical_spec`` over it gives the reference's ``PartitionSpec``
    entries under the same rules (which name a one-axis tuple by its axis)."""
    from repro.sharding import rules as jrules

    jmesh = AbstractMesh(*MESHES[multi_pod])
    rules = shrules.default_rules(make_production_mesh(multi_pod=multi_pod), **opts)
    assert rules == jrules.default_rules(jmesh, **opts)
    names = ("batch", None, "heads", "fsdp", "vocab", "kv_seq")
    with jrules.axis_rules(jmesh, **opts):
        want = tuple(jrules.logical_spec(*names))
    one = lambda entry: entry[0] if isinstance(entry, tuple) and len(entry) == 1 else entry
    assert tuple(map(one, shrules.logical_spec(rules, *names))) == want


@pytest.mark.parametrize("multi_pod", [False, True], ids=["16x16", "2x16x16"])
@pytest.mark.parametrize("flag", ["decode_weight_stationary", "dp_only"])
def test_batch_specs_follow_the_reference_flags(flag, multi_pod):
    """Batch specs of every cell with weight-stationary decode (the batch
    replicated on decode cells only) or ``dp_only`` (the batch on every
    axis where the global batch divides the mesh) are the reference's."""
    one = lambda entry: entry[0] if isinstance(entry, tuple) and len(entry) == 1 else entry
    jmesh = _SizedMesh(*MESHES[multi_pod])
    mesh = make_production_mesh(multi_pod=multi_pod)
    cfg = get_config("llama_3_2_vision_11b").replace(**{flag: True})
    jcfg = jax_config("llama_3_2_vision_11b").replace(**{flag: True})
    for name in SHAPES:
        got = S.batch_shardings(cfg, SHAPES[name], mesh)
        want = JS.batch_shardings(jcfg, J_SHAPES[name], jmesh)
        assert got.keys() == want.keys(), name
        for k, spec in got.items():
            spec = tuple(map(one, spec))
            assert spec == tuple(want[k].spec) + (None,) * (len(spec) - len(want[k].spec)), (
                name, k)


def test_shard_shape_refuses_an_uneven_split():
    mesh = make_production_mesh()
    assert shrules.shard_shape((64, 32), ("data", "model"), mesh) == (4, 2)
    assert shrules.shard_shape((512, 32), (("data", "model"), None), mesh) == (2, 32)
    with pytest.raises(ValueError, match="does not divide"):
        shrules.shard_shape((24, 32), ("data", None), mesh)
