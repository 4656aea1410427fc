"""The collectives of the training mesh, over the process groups of the
installed runtime mesh (:func:`repro_torch.sharding.rules.axis_rules`).

The reference's ``shard_map`` block transposes its collectives itself.
Here each one that sits on a differentiated path is a
``torch.autograd.Function`` whose backward is stated beside it.  They
follow one convention: each data rank's loss is its share of the global
loss (the shares summing over the data axes to it), and the ranks of one
data shard along "model" compute the same loss.

* :func:`psum_out` — the sum of the moe's partial outputs over "model".
  The sum feeds compute every model rank repeats, each with the same
  cotangent, and each partial's cotangent is the sum's: the backward is the
  identity (``psum``'s transpose in the reference), not another all-reduce.
* :func:`enter` — the entry of that model-split region: the identity
  forward, the sum over "model" backward, so the cotangent of the token
  rows and gates that every model rank reads sums each slice's part.
* :func:`pmean` — the mean over some axes (the moe aux): forward and
  backward both the mean, so a share-scaled cotangent on each data rank
  reaches each rank's own aux as d(loss)/d(aux_r).
* :func:`all_gather` — the fsdp gather of the expert stacks' d: the
  backward is the reduce-scatter over the same axes (each data rank's
  gradient of the whole stack, summed, cut back to its block).

Every call counts itself in :data:`COLLECTIVES` by kind (a test reads how
many a step issued, a remat recompute included).
"""
from __future__ import annotations

from collections import Counter
from typing import Tuple

import torch
import torch.distributed as dist

from repro_torch.sharding import rules as shrules
from repro_torch.tree import Tree

COLLECTIVES: Counter = Counter()


def reset_collective_counts() -> None:
    COLLECTIVES.clear()


def _mesh(mesh=None):
    mesh = shrules.get_mesh() if mesh is None else mesh
    if not hasattr(mesh, "group"):
        raise RuntimeError("a collective of the training mesh needs a runtime mesh installed "
                           "(axis_rules(make_local_mesh(...)))")
    return mesh


def all_reduce(x: torch.Tensor, axes, mesh=None) -> torch.Tensor:
    """The sum of ``x`` over ``axes`` of ``mesh`` (default: the installed
    one) as a new tensor; no autograd."""
    out = x.detach().clone()
    COLLECTIVES["all_reduce"] += 1
    dist.all_reduce(out, group=_mesh(mesh).group(axes))
    return out


def gather_dim(x: torch.Tensor, axes, dim: int, mesh=None) -> torch.Tensor:
    """Every rank's block of ``x`` along ``axes``, concatenated on ``dim`` in
    their order over the axes; no autograd."""
    mesh = _mesh(mesh)
    parts = [torch.empty_like(x, memory_format=torch.contiguous_format)
             for _ in range(mesh.axis_size(axes))]
    COLLECTIVES["all_gather"] += 1
    dist.all_gather(parts, x.detach().contiguous(), group=mesh.group(axes))
    return torch.cat(parts, dim)


def scatter_dim(x: torch.Tensor, axes, dim: int, mesh=None) -> torch.Tensor:
    """The sum of ``x`` over ``axes``, cut on ``dim`` to this rank's block
    (a reduce-scatter); no autograd."""
    mesh = _mesh(mesh)
    chunks = [c.contiguous() for c in x.detach().chunk(mesh.axis_size(axes), dim)]
    out = torch.empty_like(chunks[0])
    COLLECTIVES["reduce_scatter"] += 1
    dist.reduce_scatter(out, chunks, group=mesh.group(axes))
    return out


# Each Function keeps the installed mesh from its forward: its backward may
# run on the autograd engine's thread, where no rules are installed.


class _PsumOut(torch.autograd.Function):
    """Forward: the sum over ``axes``.  Backward: the identity."""

    @staticmethod
    def forward(ctx, x, axes):
        return all_reduce(x, axes)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _Enter(torch.autograd.Function):
    """Forward: the identity.  Backward: the sum over ``axes``."""

    @staticmethod
    def forward(ctx, x, axes):
        ctx.axes, ctx.mesh = axes, _mesh()
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g, ctx.axes, ctx.mesh), None


class _Pmean(torch.autograd.Function):
    """Forward: the mean over ``axes``.  Backward: the mean of the
    cotangents over ``axes``."""

    @staticmethod
    def forward(ctx, x, axes):
        ctx.axes, ctx.mesh = axes, _mesh()
        ctx.n = ctx.mesh.axis_size(axes)
        return all_reduce(x, axes) / ctx.n

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g, ctx.axes, ctx.mesh) / ctx.n, None


class _AllGather(torch.autograd.Function):
    """Forward: the blocks over ``axes`` concatenated on ``dim``.
    Backward: the reduce-scatter of the cotangent over ``axes`` on
    ``dim``."""

    @staticmethod
    def forward(ctx, x, axes, dim):
        ctx.axes, ctx.dim, ctx.mesh = axes, dim, _mesh()
        return gather_dim(x, axes, dim)

    @staticmethod
    def backward(ctx, g):
        return scatter_dim(g, ctx.axes, ctx.dim, ctx.mesh), None, None


def psum_out(x: torch.Tensor, axes) -> torch.Tensor:
    return _PsumOut.apply(x, axes)


def enter(x: torch.Tensor, axes) -> torch.Tensor:
    return _Enter.apply(x, axes)


def pmean(x: torch.Tensor, axes) -> torch.Tensor:
    return _Pmean.apply(x, axes)


def all_gather(x: torch.Tensor, axes, dim: int) -> torch.Tensor:
    return _AllGather.apply(x, axes, dim)


def gather_blocks(tree: Tree, specs: Tree) -> Tree:
    """The whole leaves from every rank's blocks (the inverse of
    :func:`repro_torch.sharding.rules.local_blocks`): each sharded dim
    all-gathered over its axes.  Every rank of the mesh must call it, with
    the same tree structure."""

    def whole(x, spec):
        if spec is None or not shrules.sharded_axes(spec):
            return x
        out = x.detach()
        for dim, ax in enumerate(spec):
            if ax is not None:
                out = gather_dim(out, ax, dim)
        return out

    def walk(node, spec):
        if isinstance(node, dict):
            return {k: walk(v, spec[k]) for k, v in node.items()}
        return whole(node, spec)

    return walk(tree, specs)


def sum_sq_over(tree: Tree, specs: Tree) -> torch.Tensor:
    """Σ x² over every leaf of the whole tree that ``tree`` holds this rank's
    blocks of: a replicated leaf counted once, a sharded leaf's block summed
    over the axes it is sharded on (one all-reduce per set of axes).  The
    leaves add up in ``tree_leaves`` order, as ``global_norm`` adds them."""
    parts = {}

    def walk(node, spec):
        if isinstance(node, dict):
            for k in sorted(node):
                walk(node[k], spec[k])
        elif isinstance(node, torch.Tensor):
            key: Tuple[str, ...] = tuple(sorted(shrules.sharded_axes(spec),
                                                key=_mesh().axis_names.index))
            s = torch.sum(torch.square(node.float()))
            parts[key] = s if key not in parts else parts[key] + s

    walk(tree, specs)
    total = parts.pop((), None)
    for axes, s in parts.items():
        s = all_reduce(s, axes)
        total = s if total is None else total + s
    return torch.zeros(()) if total is None else total
