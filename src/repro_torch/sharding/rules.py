"""Logical-axis sharding rules of the multi-tenant serve (port of
``repro/sharding/rules.py``, cut to what the sharded serve reads, and
the per-replica device groups of multi-replica serving).

The reference maps *logical* axis names onto mesh axes through a rule table
installed by the launcher.  The port's serve has one axis, a
``torch.distributed`` process group (every rank runs the whole engine), and
two logical axes the engine can map onto it:

    lam_slots → the slot axis of the packed λ tables (``shard_lam``): each
                rank holds n_slots / world rows, and the adapted
                projections reassemble a batch's λ rows with a masked local
                gather and an all-reduce (``kernels/qrlora_bgmv.py``)
    qr_rank   → the rank dim of the shared QR factors B (..., K, r) and
                A (..., r, N) (``shard_ba``), reassembled by an exact
                all-gather before the contraction

With no rules installed (the default, and outside :func:`axis_rules`)
nothing is sharded, so model code never branches on distribution.
"""
from __future__ import annotations

import threading
from contextlib import contextmanager
from typing import Dict

import torch

_state = threading.local()


def get_group():
    """The process group of the installed rules, or None."""
    return getattr(_state, "group", None)


def _rules() -> Dict[str, str]:
    return getattr(_state, "rules", {})


@contextmanager
def axis_rules(group, rules: Dict[str, str]):
    """Shard the logical axes named in ``rules`` (``{"lam_slots": "model",
    "qr_rank": "model"}``, any subset) over ``group`` inside the block; a
    None group shards nothing.  Restores the previous rules on exit."""
    prev = get_group(), _rules()
    _state.group = group
    _state.rules = dict(rules) if group is not None else {}
    try:
        yield
    finally:
        _state.group, _state.rules = prev


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
