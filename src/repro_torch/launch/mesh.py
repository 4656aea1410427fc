"""Meshes (port of ``repro/launch/mesh.py``).

The reference's meshes are JAX device meshes of TPU chips.  The port has
two kinds.  The production meshes are descriptions (:class:`MeshSpec`):
axis names and sizes, no devices, so the dry-run can place a cell on 256
or 512 devices from one host (or none).  The local mesh
(:func:`make_local_mesh`, :class:`Mesh`) lays the ranks of a
``torch.distributed`` group out over ("data", "model") and holds a process
group per axis, for the training mesh of ``launch/train.py
--model-parallel``.  Both are what :mod:`repro_torch.sharding.rules`'
logical rule table reads.
"""
from __future__ import annotations

import dataclasses
import itertools
import math
from typing import Dict, Tuple


@dataclasses.dataclass(frozen=True)
class MeshSpec:
    """A mesh with no devices: ``dims`` along ``axis_names``."""

    dims: Tuple[int, ...]
    axis_names: Tuple[str, ...]

    @property
    def shape(self) -> Dict[str, int]:
        """Axis name → size, as a JAX mesh's ``.shape`` gives it."""
        return dict(zip(self.axis_names, self.dims))

    @property
    def size(self) -> int:
        return math.prod(self.dims)


def make_production_mesh(*, multi_pod: bool = False) -> MeshSpec:
    """The reference's production meshes: 16×16 ("data", "model") and, over
    two pods, 2×16×16 ("pod", "data", "model")."""
    if multi_pod:
        return MeshSpec((2, 16, 16), ("pod", "data", "model"))
    return MeshSpec((16, 16), ("data", "model"))



class Mesh:
    """A runtime mesh: the default process group's ranks laid out over
    ``dims`` along ``axis_names``.  Rank r sits at the row-major coordinates
    of r, the order ``jax.make_mesh`` gives the host's devices, so on a
    ("data", "model") mesh of model size m rank (d, j) is ``d·m + j``.

    ``.shape`` and ``.axis_names`` read as :class:`MeshSpec`'s, so the rule
    table (:func:`repro_torch.sharding.rules.default_rules`) takes either.
    :meth:`group` is the process group of this rank's ranks along an axis or
    a tuple of axes (the other coordinates held), in which a rank's group
    rank is its row-major position over those axes: a tiled all-gather
    over it concatenates the blocks in the reference's order.

    Every rank builds every group, in the same order (``new_group`` is
    collective), when the mesh is made."""

    def __init__(self, dims: Tuple[int, ...], axis_names: Tuple[str, ...]):
        import torch.distributed as dist

        if not (dist.is_available() and dist.is_initialized()):
            raise RuntimeError(
                "a runtime mesh lays out the default torch.distributed process group, and "
                "none is initialized: start one first (torchrun, or "
                "torch.distributed.init_process_group(backend, init_method='file://<path>' or "
                "'tcp://localhost:<port>', world_size=N, rank=i))")
        if len(dims) != len(axis_names) or len(set(axis_names)) != len(axis_names):
            raise ValueError(f"mesh dims {dims} and axis names {axis_names} do not match")
        world = dist.get_world_size()
        if math.prod(dims) != world:
            raise ValueError(f"a {'×'.join(map(str, dims))} mesh needs {math.prod(dims)} ranks, "
                             f"the world has {world}")
        self.dims, self.axis_names = tuple(dims), tuple(axis_names)
        self.rank = dist.get_rank()
        self.coords = dict(zip(self.axis_names, _unravel(self.rank, self.dims)))
        self._groups = {}
        names = self.axis_names
        for r in range(1, len(names) + 1):
            for axes in itertools.combinations(names, r):
                held = [a for a in names if a not in axes]
                for fixed in itertools.product(*(range(self.shape[a]) for a in held)):
                    where = dict(zip(held, fixed))
                    ranks = [q for q in range(world) if all(
                        c == where[a] for a, c in zip(names, _unravel(q, self.dims))
                        if a in where)]
                    group = dist.new_group(ranks)
                    if self.rank in ranks:
                        self._groups[axes] = group

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.dims))

    @property
    def size(self) -> int:
        return math.prod(self.dims)

    def axes(self, axes) -> Tuple[str, ...]:
        """``axes`` (a name, a tuple of names, or None) as a tuple in mesh
        order; an unknown name or another order raises."""
        t = () if axes is None else ((axes,) if isinstance(axes, str) else tuple(axes))
        if any(a not in self.axis_names for a in t) or list(t) != sorted(
                t, key=self.axis_names.index):
            raise ValueError(f"axes {t} are not axes of {self.axis_names} in mesh order")
        return t

    def group(self, axes):
        """The process group along ``axes`` holding this rank."""
        t = self.axes(axes)
        if not t:
            raise ValueError("a collective needs at least one mesh axis")
        return self._groups[t]

    def axis_size(self, axes) -> int:
        return math.prod(self.shape[a] for a in self.axes(axes))

    def index(self, axes) -> int:
        """This rank's row-major position along ``axes`` (0 for none)."""
        i = 0
        for a in self.axes(axes):
            i = i * self.shape[a] + self.coords[a]
        return i


def _unravel(rank: int, dims: Tuple[int, ...]) -> Tuple[int, ...]:
    out = []
    for n in reversed(dims):
        rank, c = divmod(rank, n)
        out.append(c)
    return tuple(reversed(out))


def make_mesh(dims: Tuple[int, ...], axis_names: Tuple[str, ...]) -> Mesh:
    return Mesh(tuple(dims), tuple(axis_names))


def make_local_mesh(model_parallel: int = 1) -> Mesh:
    """The default group's world as a ("data", "model") mesh of
    ``world / model_parallel`` × ``model_parallel`` (the reference's
    ``make_local_mesh``, over ranks where it lays out the host's devices);
    a world that ``model_parallel`` does not divide raises."""
    import torch.distributed as dist

    # with no group, the mesh itself raises
    world = dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1
    if model_parallel < 1 or world % model_parallel:
        raise ValueError(f"--model-parallel {model_parallel} does not divide the world of "
                         f"{world} ranks")
    return Mesh((world // model_parallel, model_parallel), ("data", "model"))
