"""Elastic restart: lay a restored tree onto this run's placement (port of
``repro/checkpoint/reshard.py``).

Checkpoints store logical, whole arrays; placement is a property of the
run, not of the data.  The reference re-derives every leaf's partition spec
from ``repro.sharding.rules`` under the new mesh.  The port's one sharded
layout is the serve's ``shard_ba`` (:mod:`repro_torch.sharding.rules`):
every rank holds its contiguous share of the QR factors' rank dim.  So
:func:`reshard_to_mesh` moves each leaf to this run's device and, for a
``shard_ba`` serve, cuts the factors to this rank's share with
:func:`~repro_torch.sharding.rules.shard_factors`; a checkpoint written at
one world size restores at any other.
"""
from __future__ import annotations

from typing import Any, Optional

import torch

from repro_torch.device import resolve_device
from repro_torch.sharding import rules as shrules
from repro_torch.tree import tree_map

Tree = Any


def _rank_world(rank: Optional[int], world: Optional[int]):
    import torch.distributed as dist

    up = dist.is_available() and dist.is_initialized()
    if rank is None:
        rank = dist.get_rank() if up else 0
    if world is None:
        world = dist.get_world_size() if up else 1
    return rank, world


def reshard_to_mesh(tree: Tree, device=None, *, shard_ba: bool = False,
                    rank: Optional[int] = None, world: Optional[int] = None) -> Tree:
    """``tree`` (whole logical leaves) on ``device`` (default ``cuda``);
    with ``shard_ba``, a params tree's QR factors cut to ``rank``'s share of
    ``world`` (default: the default process group's rank and size, or a
    world of one), left whole where the world does not divide their rank
    dim, as the engine leaves them.  Non-tensor leaves pass through."""
    dev = resolve_device(device)
    out = tree_map(lambda x: x.to(dev) if isinstance(x, torch.Tensor) else x, tree)
    rank, world = _rank_world(rank, world)
    if shard_ba and world > 1 and shrules.rank_divides(out, world):
        out = shrules.shard_factors(out, rank, world)
    return out
