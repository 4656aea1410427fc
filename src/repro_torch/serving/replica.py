"""Engine replicas and the transport seam under the multi-replica router
(port of ``repro/serving/replica.py``).

One :class:`EngineReplica` wraps one :class:`~repro_torch.serving.engine.
MultiTenantEngine` with a replica identity (id, role, device group) and the
load signal the router's spillover policy reads.  N replicas share ONE
frozen parameter tree: per-tenant state is a λ vector over shared factors,
so a replica costs KV cache and λ tables, not another copy of the base
weights.  Each replica's λ tables are its own (``LamStore.install`` builds a
new view dict over the shared tree, so no replica writes into it).

Transport seam
==============

Replicas exchange two payload kinds, host numpy dicts built by the engine's
export hooks:

* **prefix** — full-block K/V of a cached prompt prefix
  (``engine.export_prefix`` → ``engine.import_prefix``), shipped when a
  sibling already prefilled the prompt family this replica is about to.
* **prefill** — a committed prompt's blocks and first-token logits
  (``engine.export_request_state`` → ``engine.inject_prefilled``), the
  prefill→decode disaggregation handoff.

:class:`LocalTransport` moves them by reference (the replicas share a
process) but meters every shipment in bytes, the datum a transport between
hosts would pay for.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np

from repro_torch.serving.config import EngineConfig
from repro_torch.serving.engine import MultiTenantEngine
from repro_torch.sharding.rules import replica_device_groups

#: Replica roles under prefill/decode disaggregation.  ``"both"`` is the
#: symmetric default; a ``"prefill"`` replica only runs prompt prefill (its
#: requests are exported after their first committed token), a ``"decode"``
#: replica only decodes (its prompts arrive prefilled).
ROLES = ("both", "prefill", "decode")


def payload_nbytes(payload: Optional[Dict[str, Any]]) -> int:
    """Wire size of an export payload: array bytes plus a nominal 8 per
    scalar or None field (what a length-prefixed header would carry)."""
    if payload is None:
        return 0
    return sum(v.nbytes if isinstance(v, np.ndarray) else 8 for v in payload.values())


class Transport:
    """Seam between replicas: ship export payloads, meter the bytes."""

    def ship(self, payload: Dict[str, Any], src: "EngineReplica",
             dst: "EngineReplica", kind: str) -> Dict[str, Any]:
        raise NotImplementedError

    def stats(self) -> Dict[str, Any]:
        raise NotImplementedError


class LocalTransport(Transport):
    """In-process transport: payloads move by reference, the meter runs as
    if they crossed a wire (shipments and bytes per kind)."""

    def __init__(self):
        self.shipments: Dict[str, int] = {}
        self.bytes: Dict[str, int] = {}

    def ship(self, payload, src, dst, kind):
        self.shipments[kind] = self.shipments.get(kind, 0) + 1
        self.bytes[kind] = self.bytes.get(kind, 0) + payload_nbytes(payload)
        return payload

    def total_bytes(self) -> int:
        return sum(self.bytes.values())

    def stats(self) -> Dict[str, Any]:
        return {"shipments": dict(self.shipments), "bytes": dict(self.bytes),
                "total_bytes": self.total_bytes()}


class EngineReplica:
    """One engine and its replica identity under the router."""

    def __init__(self, replica_id: int, engine: MultiTenantEngine, *,
                 role: str = "both", devices: Optional[Sequence[Any]] = None):
        if role not in ROLES:
            raise ValueError(f"role={role!r} must be one of {ROLES}")
        self.replica_id = replica_id
        self.engine = engine
        self.role = role
        #: the device group this replica would own on a host with a card per
        #: replica (``sharding.rules.replica_device_groups``); informational:
        #: the replicas share one params tree on the engine's device
        self.devices = list(devices) if devices is not None else []
        self.alive = True

    @property
    def name(self) -> str:
        return f"r{self.replica_id}"

    def load(self) -> int:
        """Queued + active requests: the router's spillover signal."""
        sched = self.engine.scheduler
        return len(sched.queue) + len(sched.active())

    def has_work(self) -> bool:
        return self.alive and self.engine.scheduler.has_work

    def __repr__(self) -> str:
        return (f"EngineReplica({self.name}, role={self.role!r}, load={self.load()}, "
                f"alive={self.alive})")


def build_replicas(
    cfg, config: EngineConfig, n: int, *, params=None, device=None,
    config_overrides: Optional[Callable[[int, EngineConfig], EngineConfig]] = None,
) -> List[EngineReplica]:
    """Build ``n`` replicas on ``device`` sharing one frozen parameter tree.

    Replica 0 initializes (or adopts ``params``); the rest are built with
    ``params=`` the same tree — no re-init, no copy.  Every replica starts
    as ``"both"``; a disaggregating :class:`~repro_torch.serving.router.Router`
    assigns the prefill and decode roles.  ``config_overrides(i, config)``
    gives replica ``i`` its own engine config (each replica its own
    ``cold_path``, say: the cold catalog is per-store state)."""
    if n < 1:
        raise ValueError(f"n={n} must be >= 1")
    groups = replica_device_groups(n)
    replicas: List[EngineReplica] = []
    for i in range(n):
        rcfg = config if config_overrides is None else config_overrides(i, config)
        eng = MultiTenantEngine(cfg, rcfg, params=params, device=device)
        if params is None:
            params = eng.params  # replica 0 initialized; its siblings share
        replicas.append(EngineReplica(i, eng, devices=groups[i]))
    return replicas
