"""λ-store for multi-tenant QR-LoRA serving, hot tier (port of
``repro/serving/lam_store.py``; the cold tier comes with a later slice).

Every QR-LoRA adapter of a layer shares the frozen pivoted-QR factors
(B, A), so a tenant is its λ tree ``{module: {proj: λ (n_layers,
rank_cap)}}``.  The store packs those trees into per-projection device
tables in the *install layout*

    Λ[proj] : (n_layers, n_slots, rank_cap)  fp32

indexed by slot id on the second-to-last axis.  Slot 0 is the base model
(λ ≡ 0) and never changes; other slots are managed LRU.  ``pin`` marks a
slot referenced by an in-flight request; ``protect`` is a residency pin
kept as a **count** (two protects need two unprotects).  A register,
hot-swap or eviction writes one λ row across all tables in place; a batch
register (``register_many``) writes all its new rows in one indexed write
per table.

``install(params)`` returns a parameter view whose adapter ``lam`` leaves
*are* the tables, so a layer's slice is the ``(n_slots, rank_cap)`` table
the BGMV kernel reads; every other leaf is shared with ``params``.

Sharded tables (the serve's ``shard_lam``): given a ``torch.distributed``
``group`` of ``world`` ranks, ``n_slots`` is padded up to a multiple of
``world`` and each rank allocates only its ``n_slots / world`` consecutive
slots (rank i holds slots ``i·n_local …``).  The bookkeeping — LRU order,
pins, protects, the free list — stays global and identical on every rank
(every rank sees the same calls), and a slot write lands only on the rank
that owns the slot.
"""
from __future__ import annotations

import hashlib
from collections import OrderedDict
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.device import resolve_device

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
    and residency protects, in-place slot writes.  The tables live on
    ``device``: ``cuda`` unless the caller names another (``"cpu"``)."""

    def __init__(self, lam_shapes: Dict[Key, Tuple[int, ...]], n_slots: int = 8, *,
                 device=None, group=None):
        if n_slots < 2:
            raise ValueError("need slot 0 (base) plus at least one tenant slot")
        self._lam_shapes = {k: tuple(s) for k, s in lam_shapes.items()}
        self.world, self.rank = 1, 0
        if group is not None:
            self.world, self.rank = dist.get_world_size(group), dist.get_rank(group)
            n_slots = -(-n_slots // self.world) * self.world  # pad to an even shard
        self.n_slots = n_slots
        self.n_local = n_slots // self.world
        device = resolve_device(device)
        # (module, proj) → (*lead, n_local, cap) fp32, zeros: every unused
        # slot (and slot 0) is the base model
        self._tables: Dict[Key, torch.Tensor] = {
            key: torch.zeros((*shape[:-1], self.n_local, shape[-1]), dtype=torch.float32,
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
        # called as on_drop(tenant, digest) when LRU pressure drops a tenant
        # (the engine reclaims that prefix-cache family)
        self.on_drop = None
        self.slot_writes = 0  # table writes (register, evict, batch register)
        self.lru_drops = 0  # tenants dropped by LRU pressure

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

    def digest_refcount(self, dg: bytes) -> int:
        """Resident tenants carrying this λ digest — 0 means the family is
        extinct and its prefix-cache entries can never match again."""
        return sum(d == dg for d in self._digests.values())

    # -- slot writes ----------------------------------------------------------

    def _write_slot(self, slot: int, rows: Dict[Key, np.ndarray]) -> None:
        """Every table gets its row at ``slot`` overwritten in place, on the
        rank that owns the slot."""
        self.slot_writes += 1
        owner, local = divmod(slot, self.n_local)
        if owner != self.rank:
            return
        for key, tab in self._tables.items():
            tab[..., local, :] = torch.from_numpy(rows[key]).to(tab.device)

    def _write_slots(self, slots: List[int], rows_list: List[Dict[Key, np.ndarray]]) -> None:
        """Batched :meth:`_write_slot`: k λ rows land in k slots in one
        indexed write per table (this rank's slots only)."""
        self.slot_writes += 1
        mine = [(slot % self.n_local, rows) for slot, rows in zip(slots, rows_list)
                if slot // self.n_local == self.rank]
        if not mine:
            return
        for key, tab in self._tables.items():
            idx = torch.tensor([local for local, _ in mine], device=tab.device)
            stacked = np.stack([rows[key] for _, rows in mine], axis=-2)
            tab[..., idx, :] = torch.from_numpy(stacked).to(tab.device)

    def _zero_rows(self) -> Dict[Key, np.ndarray]:
        return {k: np.zeros(s, np.float32) for k, s in self._lam_shapes.items()}

    def _try_evict_lru(self) -> Optional[int]:
        """Free the least-recently-used slot that is neither pinned nor
        protected (scrubbed to zero, base-safe); None when there is none."""
        for tenant in self._slots:
            if self._pins.get(tenant, 0) or self._protect.get(tenant, 0):
                continue
            slot = self._slots.pop(tenant)
            dg = self._digests.pop(tenant, None)
            self._write_slot(slot, self._zero_rows())
            self.lru_drops += 1
            if self.on_drop is not None:
                self.on_drop(tenant, dg)
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
                raise self._exhausted()
            self._slots[tenant] = slot
        self._write_slot(slot, rows)
        self._digests[tenant] = dg
        return slot

    def register_many(self, lam_trees: Dict[str, Any]) -> Dict[str, int]:
        """Batch :meth:`register`: every *new* tenant's λ row lands in one
        indexed write per table; already-resident tenants take the
        single-tenant hot-swap path (its in-flight guard applies).  Where
        the reference would spill a tenant to its cold tier, this hot-only
        store raises the exhaustion :meth:`register` raises, after landing
        the rows that already got slots.  Returns tenant → slot id."""
        result: Dict[str, int] = {}
        fresh = []
        for tenant, tree in lam_trees.items():
            if tenant in self:
                result[tenant] = self.register(tenant, tree)
            else:
                fresh.append((tenant, *self._validate(tenant, tree)))
        slots: List[int] = []
        rows_list = []
        for tenant, rows, dg in fresh:
            slot = self._free.pop() if self._free else self._try_evict_lru()
            if slot is None:
                if slots:
                    self._write_slots(slots, rows_list)
                raise self._exhausted()
            slots.append(slot)
            rows_list.append(rows)
            self._slots[tenant] = slot
            self._digests[tenant] = dg
            result[tenant] = slot
        if slots:
            self._write_slots(slots, rows_list)
        return result

    def _exhausted(self) -> RuntimeError:
        return RuntimeError(
            f"λ-pool exhausted: all {self.n_slots} slots pinned or protected "
            "by in-flight requests (raise n_slots or drain the queue)"
        )

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
        """Slot-major ``(n_local, *lead, cap)`` views of this rank's tables
        (all ``n_slots`` unsharded; introspection — the serving path reads
        the install layout)."""
        return {key: torch.movedim(tab, -2, 0) for key, tab in self._tables.items()}

    def table_bytes(self, per_rank: bool = False) -> int:
        """Device bytes of the packed tables: all slots over the group, or
        (``per_rank``) the slots this rank holds."""
        per_slot = 4 * sum(int(np.prod(s)) for s in self._lam_shapes.values())
        return per_slot * (self.n_local if per_rank else self.n_slots)

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

    # -- accounting ---------------------------------------------------------

    def attach_metrics(self, registry) -> None:
        """Hot-tier occupancy and churn through a
        :class:`~repro_torch.obs.metrics.MetricsRegistry`, sampled from the
        counters the store already keeps (nothing on the register path).
        The reference's cold-tier series come with the cold tier."""
        cb = registry.callback
        cb("lam_hot_slots_in_use", lambda: len(self._slots) - 1,
           help="hot-tier λ slots holding a tenant (base slot 0 excluded)")
        cb("lam_hot_slots_capacity", lambda: self.n_slots - 1,
           help="usable hot-tier λ slots")
        cb("lam_table_bytes", self.table_bytes,
           help="device bytes of the packed hot-tier λ tables")
        cb("lam_lru_drops_total", lambda: self.lru_drops, kind="counter",
           help="tenants dropped from the store by tier pressure")
        cb("lam_slot_writes_total", lambda: self.slot_writes, kind="counter",
           help="device slot writes (register/evict/batch register)")


def _dec(counts: Dict[str, int], tenant: str) -> None:
    n = counts.get(tenant, 0) - 1
    if n <= 0:
        counts.pop(tenant, None)
    else:
        counts[tenant] = n
