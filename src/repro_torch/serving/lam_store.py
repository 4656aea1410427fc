"""λ-store for multi-tenant QR-LoRA serving, hot tier (port of
``repro/serving/lam_store.py``; the cold tier, batch register and sharded
tables come with later slices).

Every QR-LoRA adapter of a layer shares the frozen pivoted-QR factors
(B, A), so a tenant is its λ tree ``{module: {proj: λ (n_layers,
rank_cap)}}``.  The store packs those trees into per-projection device
tables in the *install layout*

    Λ[proj] : (n_layers, n_slots, rank_cap)  fp32

indexed by slot id on the second-to-last axis.  Slot 0 is the base model
(λ ≡ 0) and never changes; other slots are managed LRU.  ``pin`` marks a
slot referenced by an in-flight request; ``protect`` is a residency pin
kept as a **count** (two protects need two unprotects).  A register,
hot-swap or eviction writes one λ row across all tables in place.

``install(params)`` returns a parameter view whose adapter ``lam`` leaves
*are* the tables, so a layer's slice is the ``(n_slots, rank_cap)`` table
the BGMV kernel reads; every other leaf is shared with ``params``.
"""
from __future__ import annotations

import hashlib
from collections import OrderedDict
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

BASE_TENANT = "__base__"

Key = Tuple[str, str]


def _host_rows(flat: Dict[Key, Any]) -> Dict[Key, np.ndarray]:
    return {
        k: (v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v))
        .astype(np.float32)
        for k, v in flat.items()
    }


def _lam_digest(flat: Dict[Key, Any]) -> bytes:
    """Content hash of a λ tree — the tenant-*family* identity (tenants with
    bit-identical λ produce bit-identical K/V).  Same bytes as the
    reference's digest for the same λ values."""
    h = hashlib.sha1()
    rows = _host_rows(flat)
    for key in sorted(rows):
        leaf = rows[key]
        h.update(repr((key, leaf.shape)).encode())
        h.update(np.ascontiguousarray(leaf).tobytes())
    return h.digest()


def _flatten(lam_tree) -> Dict[Key, Any]:
    return {
        (mod, proj): leaf for mod, projs in lam_tree.items() for proj, leaf in projs.items()
    }


def lam_digest(lam_tree: Dict[str, Dict[str, Any]]) -> bytes:
    """Content hash of a nested ``{module: {proj: λ}}`` tree — the digest
    :meth:`LamStore.register` assigns, computable without a store."""
    return _lam_digest(_flatten(lam_tree))


def extract_lambda(params) -> Dict[str, Dict[str, torch.Tensor]]:
    """The λ coefficient tree of a parameter tree."""
    adapters = params["groups"].get("adapters", {})
    return {
        mod: {proj: leaf["lam"] for proj, leaf in projs.items()}
        for mod, projs in adapters.items()
    }


def random_lambda(gen: torch.Generator, params, scale: float = 0.05):
    """A synthetic tenant: i.i.d. normal λ (stand-in for a fine-tuned one),
    drawn on the generator's device and moved to the params' device."""
    return {
        mod: {
            proj: (torch.randn(lam.shape, generator=gen, device=gen.device) * scale).to(lam.device)
            for proj, lam in projs.items()
        }
        for mod, projs in extract_lambda(params).items()
    }


class LamStore:
    """Hot-tier λ pool: packed device tables, slot 0 base, LRU with pins
    and residency protects, in-place slot writes."""

    def __init__(self, lam_shapes: Dict[Key, Tuple[int, ...]], n_slots: int = 8, *,
                 device=None):
        if n_slots < 2:
            raise ValueError("need slot 0 (base) plus at least one tenant slot")
        self._lam_shapes = {k: tuple(s) for k, s in lam_shapes.items()}
        self.n_slots = n_slots
        # (module, proj) → (*lead, n_slots, cap) fp32, zeros: every unused
        # slot (and slot 0) is the base model
        self._tables: Dict[Key, torch.Tensor] = {
            key: torch.zeros((*shape[:-1], n_slots, shape[-1]), dtype=torch.float32,
                             device=device)
            for key, shape in self._lam_shapes.items()
        }
        # LRU order: least-recently-used first.  Slot 0 is permanently pinned.
        self._slots: "OrderedDict[str, int]" = OrderedDict({BASE_TENANT: 0})
        self._pins: Dict[str, int] = {BASE_TENANT: 1}
        self._protect: Dict[str, int] = {}
        self._free = list(range(n_slots - 1, 0, -1))
        self._digests: Dict[str, bytes] = {
            BASE_TENANT: _lam_digest(
                {k: np.zeros(s, np.float32) for k, s in self._lam_shapes.items()}
            )
        }
        self._install_params = None
        self._install_view = None

    @classmethod
    def from_params(cls, params, n_slots: int = 8, **kw) -> "LamStore":
        shapes = {key: tuple(leaf.shape) for key, leaf in _flatten(extract_lambda(params)).items()}
        if not shapes:
            raise ValueError("params carry no adapters — nothing to serve")
        return cls(shapes, n_slots=n_slots, device=params["embed"].device, **kw)

    # -- bookkeeping --------------------------------------------------------

    def __contains__(self, tenant: str) -> bool:
        return tenant in self._slots

    def lookup(self, tenant: str) -> int:
        """Slot id of a resident tenant (touches LRU recency)."""
        slot = self._slots[tenant]
        self._slots.move_to_end(tenant)
        return slot

    def pin(self, tenant: str) -> int:
        """Mark a tenant's slot as referenced by an in-flight request."""
        slot = self.lookup(tenant)
        self._pins[tenant] = self._pins.get(tenant, 0) + 1
        return slot

    def unpin(self, tenant: str) -> None:
        _dec(self._pins, tenant)

    def protect(self, tenant: str) -> None:
        """Residency pin, counted: the tenant stays in the store until as
        many ``unprotect`` calls as ``protect`` calls."""
        if tenant not in self:
            raise KeyError(f"unknown tenant {tenant!r}")
        self._protect[tenant] = self._protect.get(tenant, 0) + 1

    def unprotect(self, tenant: str) -> None:
        _dec(self._protect, tenant)

    def digest(self, tenant: str) -> bytes:
        """λ content hash of a resident tenant (prefix-sharing family id)."""
        return self._digests[tenant]

    # -- slot writes ----------------------------------------------------------

    def _write_slot(self, slot: int, rows: Dict[Key, np.ndarray]) -> None:
        """Every table gets its row at ``slot`` overwritten in place."""
        for key, tab in self._tables.items():
            tab[..., slot, :] = torch.from_numpy(rows[key]).to(tab.device)

    def _zero_rows(self) -> Dict[Key, np.ndarray]:
        return {k: np.zeros(s, np.float32) for k, s in self._lam_shapes.items()}

    def _try_evict_lru(self) -> Optional[int]:
        """Free the least-recently-used slot that is neither pinned nor
        protected (scrubbed to zero, base-safe); None when there is none."""
        for tenant in self._slots:
            if self._pins.get(tenant, 0) or self._protect.get(tenant, 0):
                continue
            slot = self._slots.pop(tenant)
            self._digests.pop(tenant, None)
            self._write_slot(slot, self._zero_rows())
            return slot
        return None

    # -- registration / hot-swap -------------------------------------------

    def _validate(self, tenant: str, lam_tree) -> Tuple[Dict[Key, np.ndarray], bytes]:
        if tenant == BASE_TENANT:
            raise ValueError("slot 0 (base tenant) is immutable")
        flat = _flatten(lam_tree)
        if set(flat) != set(self._lam_shapes):
            raise ValueError(
                f"λ tree keys {sorted(flat)} != store keys {sorted(self._lam_shapes)}"
            )
        for key, leaf in flat.items():
            if tuple(leaf.shape) != self._lam_shapes[key]:
                raise ValueError(f"λ[{key}] shape {tuple(leaf.shape)} != {self._lam_shapes[key]}")
        rows = _host_rows(flat)
        return rows, _lam_digest(rows)

    def register(self, tenant: str, lam_tree) -> int:
        """Load (or hot-swap) a tenant's λ; returns its slot id."""
        rows, dg = self._validate(tenant, lam_tree)
        if tenant in self and (self._pins.get(tenant, 0) or self._protect.get(tenant, 0)):
            raise RuntimeError(
                f"tenant {tenant!r} is referenced by in-flight requests — "
                "hot-swapping its λ mid-generation would mix adapters"
            )
        if tenant in self._slots:
            slot = self.lookup(tenant)  # hot-swap in place
        else:
            slot = self._free.pop() if self._free else self._try_evict_lru()
            if slot is None:
                raise RuntimeError(
                    f"λ-pool exhausted: all {self.n_slots} slots pinned or protected "
                    "by in-flight requests (raise n_slots or drain the queue)"
                )
            self._slots[tenant] = slot
        self._write_slot(slot, rows)
        self._digests[tenant] = dg
        return slot

    def evict(self, tenant: str) -> None:
        """Drop a tenant (must not be pinned or protected)."""
        if tenant == BASE_TENANT:
            raise ValueError("slot 0 (base tenant) cannot be evicted")
        if self._pins.get(tenant, 0):
            raise RuntimeError(f"tenant {tenant!r} is pinned by in-flight requests")
        if self._protect.get(tenant, 0):
            raise RuntimeError(f"tenant {tenant!r} is protected by queued requests")
        slot = self._slots.pop(tenant)
        self._digests.pop(tenant, None)
        self._write_slot(slot, self._zero_rows())
        self._free.append(slot)

    # -- parameter view -----------------------------------------------------

    @property
    def tables(self) -> Dict[Key, torch.Tensor]:
        """Slot-major ``(n_slots, *lead, cap)`` copies of the tables
        (introspection; the serving path reads the install layout)."""
        return {key: torch.movedim(tab, -2, 0) for key, tab in self._tables.items()}

    def install(self, params):
        """Params view whose adapter λ leaves are the packed slot tables.
        Slot writes update the tables in place, so the view is built once
        per params object and reused."""
        if params is self._install_params:
            return self._install_view
        groups = dict(params["groups"])
        adapters = {mod: dict(projs) for mod, projs in groups.get("adapters", {}).items()}
        for (mod, proj), table in self._tables.items():
            adapters[mod][proj] = {**adapters[mod][proj], "lam": table}
        groups["adapters"] = adapters
        self._install_params = params
        self._install_view = {**params, "groups": groups}
        return self._install_view

def _dec(counts: Dict[str, int], tenant: str) -> None:
    n = counts.get(tenant, 0) - 1
    if n <= 0:
        counts.pop(tenant, None)
    else:
        counts[tenant] = n
