"""Logical-axis sharding rules (port of ``repro/sharding/rules.py``): the
serve's sharded λ tables and QR factors, the training mesh, the logical
rule table, and the per-replica device groups of multi-replica serving.

The reference maps *logical* axis names onto mesh axes through a rule table
installed by the launcher (:func:`axis_rules`).  The port installs one of
two things.

A process group (the multi-tenant serve, every rank running the whole
engine), with the logical axes the engine maps onto it:

    lam_slots → the slot axis of the packed λ tables (``shard_lam``): each
                rank holds n_slots / world rows, and the adapted
                projections reassemble a batch's λ rows with a masked local
                gather and an all-reduce (``kernels/qrlora_bgmv.py``)
    qr_rank   → the rank dim of the shared QR factors B (..., K, r) and
                A (..., r, N) (``shard_ba``), reassembled by an exact
                all-gather before the contraction

A mesh (``launch/mesh.py``: a runtime :class:`~repro_torch.launch.mesh.Mesh`
of process groups, or a :class:`~repro_torch.launch.mesh.MeshSpec`
description) with the reference's rule table (:func:`default_rules`): the
batch over the data axes, each moe expert's hidden dim over "model", and
under ``fsdp`` the expert stacks' d over the data axes.  On a runtime mesh
each rank computes the rows of its data shard (:func:`data_shard`), every
non-expert leaf whole (:func:`mesh_specs`), and ``moe_ffn`` runs the
reference's ``shard_map`` branch on its expert slices with the collectives
of :mod:`repro_torch.sharding.collectives`.

With nothing installed (the default, and outside :func:`axis_rules`)
nothing is sharded, so model code never branches on distribution.

The rule table's pure functions (:func:`default_rules`,
:func:`logical_spec`, :func:`param_sharding_rules`) also take a mesh
description alone (``.shape``, a dict of axis sizes, and ``.axis_names``),
which the dry-run (``launch/specs.py``) reads to place params, optimizer
state, caches and batches on the reference's production meshes.  A spec is
one entry per dim, as a ``PartitionSpec`` holds them: ``None``
(replicated), an axis name, or a tuple of axis names.
"""
from __future__ import annotations

import math
import threading
from contextlib import contextmanager
from typing import Any, Dict, Optional, Sequence, Tuple

import torch

from repro_torch.tree import Tree

_state = threading.local()


def get_group():
    """The process group of the installed serve rules, or None."""
    return getattr(_state, "group", None)


def get_mesh():
    """The installed mesh, or None."""
    return getattr(_state, "mesh", None)


def _rules() -> Dict[str, Any]:
    return getattr(_state, "rules", {})


@contextmanager
def axis_rules(where, rules: Optional[Dict[str, Any]] = None, *, fsdp: bool = False,
               dp_only: bool = False, replicate_batch: bool = False):
    """Install sharding rules inside the block; the previous ones come back
    on exit.

    ``where`` a mesh (anything with ``.axis_names``): the rule table
    ``rules``, or :func:`default_rules` of the mesh with ``fsdp``,
    ``dp_only`` and ``replicate_batch`` (the reference's ``axis_rules(mesh,
    fsdp=...)``).  ``where`` a process group: shard the serve's logical axes
    named in ``rules`` (``{"lam_slots": "model", "qr_rank": "model"}``, any
    subset) over it; a None group shards nothing."""
    prev = snapshot()
    if hasattr(where, "axis_names"):
        _state.group, _state.mesh = None, where
        _state.rules = dict(rules) if rules is not None else default_rules(
            where, fsdp=fsdp, dp_only=dp_only, replicate_batch=replicate_batch)
    else:
        _state.group, _state.mesh = where, None
        _state.rules = dict(rules or {}) if where is not None else {}
    _state.split = None
    try:
        yield
    finally:
        _state.group, _state.mesh, _state.rules, _state.split = prev


def snapshot() -> Tuple:
    """The installed rules, mesh, group and data-shard flag as one value
    (the state is per thread: a remat recompute may run on the autograd
    engine's thread, and re-installs it with :func:`installed`)."""
    return get_group(), get_mesh(), _rules(), getattr(_state, "split", None)


@contextmanager
def installed(snap: Tuple):
    """Inside the block, the state of :func:`snapshot` ``snap``."""
    prev = snapshot()
    _state.group, _state.mesh, _state.rules, _state.split = snap
    try:
        yield
    finally:
        _state.group, _state.mesh, _state.rules, _state.split = prev


def _runtime_mesh():
    """The installed mesh when it is a runtime one (process groups), else
    None."""
    mesh = get_mesh()
    return mesh if hasattr(mesh, "group") else None


def _as_axes(ax) -> Tuple[str, ...]:
    return () if ax is None else ((ax,) if isinstance(ax, str) else tuple(ax))


def dp_axes() -> Tuple[str, ...]:
    """The installed rules' data axes (the reference's ``dp_axes``; the
    batch's, and the expert stacks' d under ``fsdp``); () with no mesh."""
    return _as_axes(_rules().get("dp_axes")) if get_mesh() is not None else ()


def batch_splits(rows: int) -> bool:
    """Whether a batch of ``rows`` splits over the data axes under the
    installed rules (the reference's ``batch_shardable``): the batch mapped
    onto them and the rows dividing."""
    mesh = get_mesh()
    if mesh is None or _rules().get("batch") is None or not dp_axes():
        return False
    if _as_axes(_rules()["batch"]) != dp_axes():
        raise ValueError(f"the batch on {_rules()['batch']} and the data axes {dp_axes()} "
                         f"differ: the data-parallel steps split the batch over the data axes")
    return rows % _axis_size(mesh, dp_axes()) == 0


@contextmanager
def data_shard(split: bool):
    """Inside the block the activations of each rank of the installed
    runtime mesh hold its own rows of the batch (``split``: the contiguous
    block at its index over the data axes, :func:`rank_rows`) or every row
    (the batch does not divide).  The data-parallel steps set it;
    ``moe_ffn``'s sharded branch reads it (:func:`rows_split`)."""
    prev = getattr(_state, "split", None)
    _state.split = bool(split)
    try:
        yield
    finally:
        _state.split = prev


def rows_split() -> bool:
    """Whether this rank holds its data shard's rows (:func:`data_shard`);
    raises outside a data-parallel step, where no one has said."""
    split = getattr(_state, "split", None)
    if split is None:
        raise RuntimeError("under a runtime mesh that shards the batch, say whose rows the "
                           "activations hold: run inside shrules.data_shard(split) (the "
                           "data-parallel steps of training/steps.py do)")
    return split


def rank_rows(x: torch.Tensor, split: bool) -> torch.Tensor:
    """This rank's rows of ``x`` (dim 0) when ``split``, else all of them."""
    if not split:
        return x
    mesh, axes = get_mesh(), dp_axes()
    n = x.shape[0] // _axis_size(mesh, axes)
    return x.narrow(0, mesh.index(axes) * n, n)


def _axis_group(name: str):
    group = get_group()
    return group if group is not None and _rules().get(name) is not None else None


def lam_slot_group():
    """Process group the packed λ tables' *slot* axis is sharded over (the
    ``lam_slots`` logical axis), or None when they are replicated.
    ``adapted_matmul``'s multi-tenant path consults this to gather λ rows
    from local shards."""
    return _axis_group("lam_slots")


def qr_rank_group():
    """Process group the shared QR factors' *rank* dim is sharded over (the
    ``qr_rank`` logical axis), or None when B/A are replicated.
    ``adapted_matmul`` consults this to all-gather the factors before the
    contraction."""
    return _axis_group("qr_rank")


def rank_dim(name: str, ndim: int) -> int:
    """The rank dim of a QR factor leaf: B (..., K, r) dim -1, A (..., r, N)
    dim -2."""
    return ndim - 1 if name == "B" else ndim - 2


def shard_factors(params, rank: int, world: int):
    """``params`` with every adapter's B and A cut to ``rank``'s share of
    the rank dim (contiguous, in rank order), the placement ``shard_ba``
    gives them; every other leaf is shared.  As in the reference's rule, a
    factor whose rank dim the world does not divide stays whole (the
    engine then leaves ``qr_rank`` unmapped: every factor of a model has
    the same rank cap)."""
    groups = dict(params["groups"])
    adapters = groups.get("adapters", {})

    def cut(name: str, leaf: torch.Tensor) -> torch.Tensor:
        dim = rank_dim(name, leaf.ndim)
        n = leaf.shape[dim]
        if n % world:
            return leaf
        return leaf.narrow(dim, rank * (n // world), n // world).contiguous()

    groups["adapters"] = {
        mod: {proj: {k: cut(k, v) if k in ("A", "B") else v for k, v in leaf.items()}
              for proj, leaf in projs.items()}
        for mod, projs in adapters.items()
    }
    return {**params, "groups": groups}


def rank_divides(params, world: int) -> bool:
    """Whether ``world`` divides the rank dim of every QR factor of
    ``params`` (so :func:`shard_factors` cuts them all)."""
    return all(
        leaf[name].shape[rank_dim(name, leaf[name].ndim)] % world == 0
        for projs in params["groups"].get("adapters", {}).values()
        for leaf in projs.values() for name in ("A", "B")
    )


def default_group():
    """The default process group, raising when none is initialized."""
    import torch.distributed as dist

    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError(
            "shard_lam/shard_ba shard over the default torch.distributed process "
            "group, and none is initialized: start one before building the engine "
            "(torchrun, or torch.distributed.init_process_group(backend, "
            "init_method='file://<path>' or 'tcp://localhost:<port>', world_size=N, "
            "rank=i); 'nccl' for cuda, 'gloo' for cpu)"
        )
    return dist.group.WORLD


def replica_device_groups(n: int) -> list:
    """Partition the local devices into ``n`` per-replica groups — the
    placement seam of multi-replica serving (``serving/replica.py``).

    Replicas are data-parallel copies of the whole engine, so they split the
    cards: with ``d`` cards, replica ``i`` owns cards ``i*d//n :
    (i+1)*d//n``.  On the CPU, or with fewer cards than replicas, every
    group is the whole device list and the replicas time-share it (two
    replicas on one card share ``cuda:0``)."""
    if n < 1:
        raise ValueError(f"n={n} must be >= 1")
    count = torch.cuda.device_count() if torch.cuda.is_available() else 0
    devices = [torch.device("cuda", i) for i in range(count)] or [torch.device("cpu")]
    if len(devices) < n:
        return [list(devices) for _ in range(n)]
    return [devices[i * len(devices) // n: (i + 1) * len(devices) // n] for i in range(n)]


# ---------------------------------------------------------------------------
# The logical rule table (the dry-run's placement on a production mesh)
# ---------------------------------------------------------------------------


def default_rules(mesh, *, fsdp: bool = False, dp_only: bool = False,
                  replicate_batch: bool = False) -> Dict[str, Any]:
    """Logical axis → mesh axes, as the reference's table maps them: batch
    over ("pod", "data"), heads/ff/vocab/expert_ff over "model", params also
    over the data axes under ``fsdp``; ``dp_only`` puts the batch on every
    axis and replicates the weights; ``replicate_batch`` (weight-stationary
    decode) replicates the batch."""
    axes = tuple(mesh.axis_names)
    dp: Tuple[str, ...] = tuple(a for a in ("pod", "data") if a in axes)
    model = "model" if "model" in axes else None
    if dp_only:
        return {"batch": axes, "heads": None, "ff": None, "vocab": None, "expert_ff": None,
                "kv_seq": None, "fsdp": None, "lam_slots": None, "qr_rank": None,
                "dp_axes": axes, "model_axis": None}
    return {
        "batch": None if replicate_batch else (dp or None),
        "heads": model,
        "ff": model,
        "vocab": model,
        "expert_ff": model,
        "kv_seq": None,
        "fsdp": (dp if fsdp else None),
        "lam_slots": None,
        "qr_rank": None,
        "dp_axes": dp,
        "model_axis": model,
    }


def logical_spec(rules: Dict[str, Any], *names) -> Tuple:
    """The spec of a tensor whose dims carry the logical ``names`` (None:
    replicated)."""
    return tuple(None if n is None else rules.get(n) for n in names)


def _axis_size(mesh, ax) -> int:
    """Devices along ``ax``: an axis name, a tuple of them, or None (1)."""
    if ax is None:
        return 1
    return math.prod(mesh.shape[a] for a in (ax if isinstance(ax, tuple) else (ax,)))


# Path suffix → logical axes of each weight kind; a leading stacked-layer dim
# ((G, ...) or (G, k, ...)) is replicated.
_PARAM_LOGICAL: Dict[str, Tuple] = {
    # token / position embeddings
    "embed": ("vocab", None),
    "pos_embed": (None, None),
    "unembed": ("fsdp", "vocab"),
    # attention (column-parallel qkv, row-parallel o)
    "wq": ("fsdp", "heads"),
    "wk": ("fsdp", "heads"),
    "wv": ("fsdp", "heads"),
    "wo": ("heads", "fsdp"),
    "bq": ("heads",),
    "bk": ("heads",),
    "bv": ("heads",),
    # mlp (column-parallel gate/up, row-parallel down)
    "w_gate": ("fsdp", "ff"),
    "w_up": ("fsdp", "ff"),
    "w_down": ("ff", "fsdp"),
    # MoE experts: (E, d, f) / (E, f, d); router replicated
    "we_gate": (None, "fsdp", "expert_ff"),
    "we_up": (None, "fsdp", "expert_ff"),
    "we_down": (None, "expert_ff", "fsdp"),
    "w_router": (None, None),
    # mamba
    "m_in": ("fsdp", "ff"),
    "m_gate": ("fsdp", "ff"),
    "m_conv": ("ff", None),
    "m_xproj": ("ff", None),
    "m_dt_w": (None, "ff"),
    "m_dt_b": ("ff",),
    "m_A_log": ("ff", None),
    "m_D": ("ff",),
    "m_out": ("ff", "fsdp"),
    # xlstm
    "x_qkv": ("fsdp", "heads"),
    "x_gates": ("fsdp", "heads"),
    "x_rec": (None, "heads", None),
    "x_up": ("fsdp", "ff"),
    "x_down": ("ff", "fsdp"),
    # vlm
    "img_proj": (None, None),
    "xa_gate": (),
    # norms / scalars / head
    "scale": (None,),
    "bias": (None,),
    "cls_w": (None, None),
    "cls_b": (None,),
}


def _spec_for_path(path: Sequence[str], shape: Tuple[int, ...], rules: Dict[str, Any],
                   mesh) -> Tuple:
    """The spec of the param at ``path`` (its keys) of ``shape``.  Adapter
    leaves replicate (the rule table maps no ``qr_rank``: rank-dim sharding
    of B/A is the serving engine's opt-in, above).  Other leaves take
    :data:`_PARAM_LOGICAL`'s axes, each dropped where it does not divide
    its dim (uneven shards of a contracting dim hurt more than
    replication)."""
    logical = _PARAM_LOGICAL.get(path[-1])
    if "adapters" in path or logical is None:
        return (None,) * len(shape)
    mapped = [None] * (len(shape) - len(logical)) + [rules.get(a) if a else None
                                                     for a in logical]
    return tuple(ax if ax is None or dim % _axis_size(mesh, ax) == 0 else None
                 for dim, ax in zip(shape, mapped))


def param_sharding_rules(params: Tree, mesh, rules: Dict[str, Any]) -> Tree:
    """The tree of specs beside ``params`` (a ``None`` leaf stays
    ``None``)."""

    def walk(node, path):
        if node is None:
            return None
        if isinstance(node, dict):
            return {k: walk(v, path + (str(k),)) for k, v in node.items()}
        return _spec_for_path(path, tuple(node.shape), rules, mesh)

    return walk(params, ())


def shard_shape(shape: Sequence[int], spec: Sequence, mesh) -> Tuple[int, ...]:
    """One device's block of a tensor of ``shape`` placed by ``spec``; every
    sharded dim must divide evenly, as the rule table makes them."""
    out = []
    for dim, ax in zip(shape, spec):
        n = _axis_size(mesh, ax)
        if dim % n:
            raise ValueError(f"dim {dim} of {tuple(shape)} does not divide over {ax} ({n})")
        out.append(dim // n)
    return tuple(out)


# ---------------------------------------------------------------------------
# Placement on a runtime mesh
# ---------------------------------------------------------------------------

# the leaves a runtime mesh shards: the moe expert stacks
_EXPERT_LEAVES = ("we_gate", "we_up", "we_down")


def mesh_specs(tree: Tree) -> Tree:
    """The spec of each leaf of ``tree`` (whole leaves) on the installed mesh:
    the rule table's for the moe expert stacks (f over "model", and d over
    the data axes under ``fsdp``, each where it divides), replicated for
    every other leaf, since each rank computes every other op whole;
    ``None`` for a leaf that is not a tensor.  Optimizer moments take their
    leaf's spec (the same path ends in the same name)."""
    mesh, rules = get_mesh(), _rules()

    def walk(node, path):
        if isinstance(node, dict):
            return {k: walk(v, path + (str(k),)) for k, v in node.items()}
        if not isinstance(node, torch.Tensor):
            return None
        if path and path[-1] in _EXPERT_LEAVES and mesh is not None:
            return _spec_for_path(path, tuple(node.shape), rules, mesh)
        return (None,) * node.ndim

    return walk(tree, ())


def sharded_axes(spec) -> Tuple[str, ...]:
    """The mesh axes a spec shards over, in mesh order of first use."""
    out = []
    for ax in spec or ():
        out += [a for a in _as_axes(ax) if a not in out]
    return tuple(out)


def local_blocks(tree: Tree, specs: Tree) -> Tree:
    """``tree`` (whole leaves) with each leaf cut to this rank's block of its
    spec on the installed runtime mesh: along each sharded dim the block at
    the rank's index over that dim's axes.  A cut leaf is a new tensor
    (requiring grad where the leaf does); a whole one is the leaf itself."""
    mesh = _runtime_mesh()
    if mesh is None:
        raise RuntimeError("local_blocks places a tree on a runtime mesh: install one with "
                           "axis_rules(make_local_mesh(...))")

    def cut(x, spec):
        if spec is None or not sharded_axes(spec):
            return x
        out = x.detach()
        for dim, ax in enumerate(spec):
            if ax is not None:
                n = out.shape[dim] // mesh.axis_size(ax)
                out = out.narrow(dim, mesh.index(ax) * n, n)
        return out.clone(memory_format=torch.contiguous_format).requires_grad_(x.requires_grad)

    def walk(node, spec):
        if isinstance(node, dict):
            return {k: walk(v, spec[k]) for k, v in node.items()}
        return cut(node, spec)

    return walk(tree, specs)
