"""Hierarchical λ-store for multi-tenant QR-LoRA serving (port of
``repro/serving/lam_store.py``).

Every QR-LoRA adapter of a layer shares the frozen pivoted-QR factors
(B, A), so a tenant is its λ tree ``{module: {proj: λ (n_layers,
rank_cap)}}``.  The store keeps those trees in two tiers.

**Hot tier** — per-projection device tables in the *install layout*

    Λ[proj] : (n_layers, n_slots, rank_cap)  fp32

indexed by slot id on the second-to-last axis.  Slot 0 is the base model
(λ ≡ 0) and never changes; other slots are managed LRU.  ``pin`` marks a
slot referenced by an active lane; ``protect`` is a residency pin (the
tenant must stay in the store, in either tier) kept as a **count** (two
protects need two unprotects).  A register, hot-swap, promotion or
eviction writes one λ row across all tables in place; the batch calls
(``register_many``, ``promote_many``, ``spill_many``) write all their rows
in one indexed write per table.  On the card every row goes up through
pinned host memory with an asynchronous copy and the slot writes are
device-side copies, so a slot write never makes the host wait for the card
(a promotion runs inside a step's admission).

**Cold tier** (``cold_slots > 0``) — host λ rows, up to ``cold_slots``
tenants, LRU.  Hot pressure *spills* the least-recently-used unpinned
tenant to the host instead of dropping it, and admission promotes it back
on demand, so the tenant count is bounded by host RAM (``bytes_per_tenant``
each), not by device memory.  ``cold_path`` backs the tier with an mmap
record file and a JSON catalog (:class:`MmapColdTier`, byte-compatible with
the reference's), so the spilled tenants survive a restart.

A spill needs no read of the device: the store keeps a host copy of every
hot tenant's rows (λ rows are only ever written whole, so the copy is
bitwise the slot's contents), and spilling moves that copy to the cold tier
and scrubs the slot to zero on the device.  That keeps spills sync-free and
collective-free under sharding, where only the owner rank holds a slot.

``install(params)`` returns a parameter view whose adapter ``lam`` leaves
*are* the tables, so a layer's slice is the ``(n_slots, rank_cap)`` table
the BGMV kernel reads; every other leaf is shared with ``params``.

Sharded tables (the serve's ``shard_lam``): given a ``torch.distributed``
``group`` of ``world`` ranks, ``n_slots`` is padded up to a multiple of
``world`` and each rank allocates only its ``n_slots / world`` consecutive
slots (rank i holds slots ``i·n_local …``).  The bookkeeping — LRU order,
pins, protects, the free list, both tiers — stays global and identical on
every rank (every rank sees the same calls), and a slot write lands only on
the rank that owns the slot.
"""
from __future__ import annotations

import hashlib
import json
import os
from collections import OrderedDict
from typing import Any, Dict, Iterable, Iterator, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.device import resolve_device

BASE_TENANT = "__base__"

#: register() return value for a tenant that landed in the host cold tier
#: (hot slots exhausted and pinned); promote() assigns the real slot later.
COLD_SLOT = -1

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


class MmapColdTier:
    """Restart-surviving cold tier: λ rows in an mmap-backed record file.

    The in-memory ``OrderedDict`` cold tier's mapping surface (membership,
    LRU-ordered iteration coldest first, ``pop`` / ``__setitem__`` /
    ``move_to_end``).  Every tenant's λ rows flatten, keys in sorted order,
    into one fixed-size fp32 record of the data file; the tenant → record
    catalog (schema, capacity, tenants in LRU order with their λ digests,
    the free list) persists as a JSON file beside it, written atomically.
    A restarted server passing the same ``cold_path`` to :class:`LamStore`
    reopens both and finds its spilled tenants, digests included.  The
    record layout and the catalog are the reference's byte for byte, so a
    file written by either package opens in the other."""

    def __init__(self, path: str, lam_shapes: Dict[Key, Tuple[int, ...]], capacity: int):
        self.path = str(path)
        self.catalog_path = self.path + ".json"
        self._keys = sorted(lam_shapes)
        self._shapes = {k: tuple(lam_shapes[k]) for k in self._keys}
        self._sizes = [int(np.prod(self._shapes[k])) for k in self._keys]
        self._row_floats = int(sum(self._sizes))
        self.capacity = int(capacity)
        # tenant → (record index, digest hex); insertion order is LRU order
        self._index: "OrderedDict[str, Tuple[int, str]]" = OrderedDict()
        self._free: List[int] = []
        if os.path.exists(self.catalog_path):
            self._load_catalog()
        else:
            os.makedirs(os.path.dirname(os.path.abspath(self.path)), exist_ok=True)
            self._free = list(range(self.capacity - 1, -1, -1))
        mode = "r+" if os.path.exists(self.path) else "w+"
        self._mm = np.memmap(self.path, np.float32, mode=mode,
                             shape=(self.capacity, max(self._row_floats, 1)))

    def _schema(self) -> list:
        return [[list(k), list(self._shapes[k])] for k in self._keys]

    def _load_catalog(self) -> None:
        with open(self.catalog_path) as f:
            cat = json.load(f)
        if cat["schema"] != self._schema():
            raise ValueError(
                f"cold catalog {self.catalog_path} was written for a different λ schema "
                "(other model or adapter config)"
            )
        # the record file's geometry wins: a larger requested capacity grows
        # the file, a smaller one is ignored (records would dangle)
        stored = int(cat["capacity"])
        grown = list(range(self.capacity - 1, stored - 1, -1))
        self.capacity = max(self.capacity, stored)
        self._free = grown + [int(i) for i in cat["free"]]
        for tenant, rec, dg in cat["tenants"]:
            self._index[tenant] = (int(rec), dg)

    def _save(self) -> None:
        cat = {
            "schema": self._schema(),
            "capacity": self.capacity,
            "tenants": [[t, rec, dg] for t, (rec, dg) in self._index.items()],
            "free": self._free,
        }
        tmp = self.catalog_path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(cat, f)
        os.replace(tmp, self.catalog_path)  # atomic: never a torn catalog

    def digests(self) -> Dict[str, bytes]:
        """Per-tenant λ digests from the catalog (the store seeds its
        digest refcounts from them on reopen)."""
        return {t: bytes.fromhex(dg) for t, (_, dg) in self._index.items()}

    # -- the OrderedDict surface the store drives ------------------------------

    def __contains__(self, tenant: str) -> bool:
        return tenant in self._index

    def __len__(self) -> int:
        return len(self._index)

    def __iter__(self) -> Iterator[str]:
        return iter(self._index)

    def _rows(self, flat: np.ndarray) -> Dict[Key, np.ndarray]:
        rows, off = {}, 0
        for key, size in zip(self._keys, self._sizes):
            rows[key] = flat[off: off + size].reshape(self._shapes[key])
            off += size
        return rows

    def pop(self, tenant: str, *default):
        if tenant not in self._index:
            if default:
                return default[0]
            raise KeyError(tenant)
        rec, _ = self._index.pop(tenant)
        flat = np.array(self._mm[rec])  # copy out before the record recycles
        self._free.append(rec)
        self._save()
        return self._rows(flat)

    def __setitem__(self, tenant: str, rows) -> None:
        if tenant in self._index:
            rec, _ = self._index.pop(tenant)
        elif self._free:
            rec = self._free.pop()
        else:
            # unreachable through LamStore (its cold-room accounting runs
            # first); guards direct misuse
            raise RuntimeError(f"mmap cold tier full (capacity={self.capacity})")
        rows = {k: np.asarray(rows[k], np.float32) for k in self._keys}
        self._mm[rec] = np.concatenate(
            [rows[k].reshape(-1) for k in self._keys]) if self._row_floats else 0.0
        self._mm.flush()
        self._index[tenant] = (rec, _lam_digest(rows).hex())
        self._save()

    def move_to_end(self, tenant: str) -> None:
        self._index.move_to_end(tenant)
        self._save()


class LamStore:
    """Hierarchical λ-pool: packed device tables (slot 0 the base) and an
    optional host cold tier, LRU with two pin levels, in-place slot writes.
    The tables live on ``device``: ``cuda`` unless the caller names another
    (``"cpu"``).

    * ``pin``/``unpin`` — hot-slot pins: the slot is referenced by an
      active decode lane and must not be recycled or spilled.
    * ``protect``/``unprotect`` — residency pins: the tenant belongs to a
      queued request and must stay in the store (it may spill to the cold
      tier, but never drops out).
    """

    def __init__(self, lam_shapes: Dict[Key, Tuple[int, ...]], n_slots: int = 8, *,
                 cold_slots: int = 0, cold_path: Optional[str] = None, device=None,
                 group=None):
        if n_slots < 2:
            raise ValueError("need slot 0 (base) plus at least one tenant slot")
        self._lam_shapes = {k: tuple(s) for k, s in lam_shapes.items()}
        self.world, self.rank = 1, 0
        if group is not None:
            self.world, self.rank = dist.get_world_size(group), dist.get_rank(group)
            n_slots = -(-n_slots // self.world) * self.world  # pad to an even shard
        self.n_slots = n_slots
        self.n_local = n_slots // self.world
        self.cold_slots = int(cold_slots)
        device = resolve_device(device)
        self._device = device
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
        # host copy of each hot tenant's rows (what its slot holds): spills
        # read it instead of the device
        self._hot_rows: Dict[str, Dict[Key, np.ndarray]] = {}
        # cold tier: tenant → {key: λ row}, LRU order (coldest first); with
        # cold_path an mmap record file with the same mapping surface
        if cold_path is not None:
            if cold_slots <= 0:
                raise ValueError("cold_path requires cold_slots > 0")
            self._cold: Any = MmapColdTier(cold_path, self._lam_shapes, cold_slots)
            self.cold_slots = self._cold.capacity  # the file's geometry wins
        else:
            self._cold = OrderedDict()
        # tenant → λ digest (the prefix-sharing family id), and the count of
        # resident tenants per digest so the engine can tell when a family
        # went extinct; the base tenant's digest is the all-zeros tree's
        self._digests: Dict[str, bytes] = {}
        self._digest_refs: Dict[bytes, int] = {}
        self._digest_add(BASE_TENANT, _lam_digest(self._zero_rows()))
        if isinstance(self._cold, MmapColdTier):
            # a reopened catalog: its tenants are resident, digests included
            for tenant, dg in self._cold.digests().items():
                self._digest_add(tenant, dg)
        self._install_params = None
        self._install_view = None
        # called as on_drop(tenant, digest) when tier pressure drops a tenant
        # (the engine reclaims that prefix-cache family)
        self.on_drop = None
        self.slot_writes = 0  # table writes (register/spill/evict/promote, batches)
        self.spills = 0  # hot → cold demotions
        self.promotes = 0  # cold → hot promotions
        self.cold_registers = 0  # registers that landed directly in the cold tier
        self.lru_drops = 0  # tenants dropped by tier pressure

    @classmethod
    def from_params(cls, params, n_slots: int = 8, **kw) -> "LamStore":
        shapes = {key: tuple(leaf.shape) for key, leaf in _flatten(extract_lambda(params)).items()}
        if not shapes:
            raise ValueError("params carry no adapters — nothing to serve")
        return cls(shapes, n_slots=n_slots, device=params["embed"].device, **kw)

    # -- bookkeeping --------------------------------------------------------

    def __contains__(self, tenant: str) -> bool:
        return tenant in self._slots or tenant in self._cold

    def __len__(self) -> int:
        return len(self._slots) + len(self._cold)

    @property
    def tenants(self) -> Tuple[str, ...]:
        return tuple(self._slots) + tuple(self._cold)

    @property
    def hot_tenants(self) -> Tuple[str, ...]:
        return tuple(self._slots)

    @property
    def cold_tenants(self) -> Tuple[str, ...]:
        return tuple(self._cold)

    def is_hot(self, tenant: str) -> bool:
        return tenant in self._slots

    def is_cold(self, tenant: str) -> bool:
        return tenant in self._cold

    def lookup(self, tenant: str) -> int:
        """Slot id of a hot tenant (touches LRU recency)."""
        if tenant in self._cold:
            raise KeyError(f"tenant {tenant!r} is in the cold tier — promote() first")
        slot = self._slots[tenant]
        self._slots.move_to_end(tenant)
        return slot

    def pin(self, tenant: str) -> int:
        """Mark a hot tenant's slot as referenced by an active decode lane."""
        slot = self.lookup(tenant)
        self._pins[tenant] = self._pins.get(tenant, 0) + 1
        return slot

    def unpin(self, tenant: str) -> None:
        _dec(self._pins, tenant)

    def protect(self, tenant: str) -> None:
        """Residency pin, counted: the tenant stays in the store (either
        tier) until as many ``unprotect`` calls as ``protect`` calls."""
        if tenant not in self:
            raise KeyError(f"unknown tenant {tenant!r}")
        self._protect[tenant] = self._protect.get(tenant, 0) + 1

    def unprotect(self, tenant: str) -> None:
        _dec(self._protect, tenant)

    # -- digest bookkeeping -------------------------------------------------

    def digest(self, tenant: str) -> bytes:
        """λ content hash of a resident tenant (prefix-sharing family id)."""
        return self._digests[tenant]

    def digest_refcount(self, dg: bytes) -> int:
        """Resident tenants (hot or cold) carrying this λ digest — 0 means
        the family is extinct and its prefix-cache entries can never match
        again."""
        return self._digest_refs.get(dg, 0)

    def _digest_add(self, tenant: str, dg: bytes) -> None:
        old = self._digests.get(tenant)
        if old == dg:
            return
        if old is not None:
            _dec(self._digest_refs, old)
        self._digests[tenant] = dg
        self._digest_refs[dg] = self._digest_refs.get(dg, 0) + 1

    def _digest_remove(self, tenant: str) -> None:
        dg = self._digests.pop(tenant, None)
        if dg is not None:
            _dec(self._digest_refs, dg)

    # -- slot writes ----------------------------------------------------------

    def _zero_rows(self) -> Dict[Key, np.ndarray]:
        return {k: np.zeros(s, np.float32) for k, s in self._lam_shapes.items()}

    def _mine(self, slots: List[int]) -> List[Tuple[int, int]]:
        """(position in ``slots``, local slot) of the slots this rank owns."""
        return [(i, slot % self.n_local) for i, slot in enumerate(slots)
                if slot // self.n_local == self.rank]

    def _upload(self, arr: np.ndarray) -> torch.Tensor:
        """``arr`` on the tables' device without a host sync: on the card
        through a fresh pinned buffer and an asynchronous copy (the host
        allocator keeps the buffer until the copy has run), on the CPU the
        array itself."""
        host = torch.from_numpy(arr)
        if self._device.type != "cuda":
            return host
        return host.pin_memory().to(self._device, non_blocking=True)

    def _write_slots(self, slots: List[int], rows_list: List[Dict[Key, np.ndarray]]) -> None:
        """k λ rows land in k slots, one indexed write per table (this
        rank's slots only): one upload of every row, no host sync."""
        self.slot_writes += 1
        mine = self._mine(slots)
        if not mine:
            return
        flat = np.concatenate([np.stack([rows_list[i][key] for i, _ in mine], axis=-2)
                               .reshape(-1) for key in self._tables])
        dev = self._upload(flat)
        idx = self._upload(np.asarray([local for _, local in mine], np.int64))
        off = 0
        for key, tab in self._tables.items():
            shape = (*tab.shape[:-2], len(mine), tab.shape[-1])
            n = int(np.prod(shape))
            tab.index_copy_(tab.ndim - 2, idx, dev[off:off + n].view(shape))
            off += n

    def _write_slot(self, slot: int, rows: Dict[Key, np.ndarray]) -> None:
        """Every table gets its row at ``slot`` overwritten in place."""
        self._write_slots([slot], [rows])

    def _scrub_slots(self, slots: List[int]) -> None:
        """Zero the rows at ``slots`` (base-model-safe until overwritten):
        device-side fills, nothing uploaded."""
        self.slot_writes += 1
        mine = [local for _, local in self._mine(slots)]
        if not mine:
            return
        for tab in self._tables.values():
            if len(mine) == 1:
                tab[..., mine[0], :] = 0.0
            else:
                tab.index_fill_(tab.ndim - 2, self._upload(np.asarray(mine, np.int64)), 0.0)

    def _take_slot(self, tenant: str, slot: int, rows: Dict[Key, np.ndarray]) -> None:
        """Bookkeeping of a tenant now hot at ``slot`` (most recently used)."""
        self._slots[tenant] = slot
        self._slots.move_to_end(tenant)
        self._hot_rows[tenant] = rows

    # -- tiering ------------------------------------------------------------

    def _make_cold_room(self) -> bool:
        """Ensure the cold tier can take one more tenant, dropping the
        coldest unprotected entry if full; False when it can't."""
        if self.cold_slots <= 0:
            return False
        if len(self._cold) < self.cold_slots:
            return True
        for tenant in self._cold:  # LRU first
            if self._protect.get(tenant, 0) or self._pins.get(tenant, 0):
                continue
            self._cold.pop(tenant)
            self._dropped(tenant)
            return True
        return False

    def _dropped(self, tenant: str) -> None:
        """Bookkeeping for a tenant tier pressure pushed out of the store."""
        dg = self._digests.get(tenant)
        self._digest_remove(tenant)
        self.lru_drops += 1
        if self.on_drop is not None:
            self.on_drop(tenant, dg)

    def _spill_to_cold(self, tenant: str) -> int:
        """Demote a hot tenant: its host rows → the cold tier, its slot
        scrubbed; returns the freed slot (the caller reuses it or returns
        it to the free list)."""
        slot = self._slots.pop(tenant)
        self._cold[tenant] = self._hot_rows.pop(tenant)
        self._cold.move_to_end(tenant)
        self._scrub_slots([slot])
        self.spills += 1
        return slot

    def _try_evict_lru(self) -> Optional[int]:
        """Free one hot slot, least-recently-used first: spill to the cold
        tier when there is room (protected tenants too), else drop outright
        (unprotected tenants only).  None when every hot slot is pinned, or
        protected with no cold room: the caller defers or lands cold."""
        for tenant in self._slots:
            if tenant == BASE_TENANT or self._pins.get(tenant, 0):
                continue
            if self._make_cold_room():
                return self._spill_to_cold(tenant)
            if not self._protect.get(tenant, 0):
                slot = self._slots.pop(tenant)
                self._hot_rows.pop(tenant, None)
                self._dropped(tenant)
                self._scrub_slots([slot])
                return slot
        return None

    def _acquire(self) -> Optional[int]:
        return self._free.pop() if self._free else self._try_evict_lru()

    def spill(self, tenant: str) -> None:
        """Explicitly demote a hot tenant's λ to the host cold tier."""
        if tenant == BASE_TENANT:
            raise ValueError("slot 0 (base tenant) cannot be spilled")
        if tenant in self._cold:
            return
        if tenant not in self._slots:
            raise KeyError(f"unknown tenant {tenant!r}")
        if self._pins.get(tenant, 0):
            raise RuntimeError(f"tenant {tenant!r} is pinned by an active lane")
        if not self._make_cold_room():
            raise RuntimeError(
                f"cold tier {'full of protected tenants' if self.cold_slots else 'disabled'}"
                f" (cold_slots={self.cold_slots}) — cannot spill {tenant!r}"
            )
        self._free.append(self._spill_to_cold(tenant))

    def promote(self, tenant: str) -> Optional[int]:
        """Host → device promotion of a cold tenant; returns its hot slot,
        or None when no hot slot can be freed (the caller defers admission,
        as a full block pool defers it)."""
        if tenant in self._slots:
            return self.lookup(tenant)
        # pop before freeing a slot: the promotion itself vacates one cold
        # entry, and the LRU eviction below may need exactly that room to
        # spill its victim (it must never recycle the tenant's own rows)
        rows = self._cold.pop(tenant, None)
        if rows is None:
            raise KeyError(f"unknown tenant {tenant!r}")
        slot = self._acquire()
        if slot is None:
            self._cold[tenant] = rows  # deferred: back into the cold tier
            return None
        self._write_slot(slot, rows)
        self._take_slot(tenant, slot, rows)
        self.promotes += 1
        return slot

    def promote_many(self, tenants: Iterable[str]) -> Dict[str, Optional[int]]:
        """Batch :meth:`promote`: every promotable cold tenant's row lands
        hot in one write per table.  Per-tenant results as ``promote()``'s:
        the slot id, or None when no hot slot could be freed (the tenant
        stays cold; the caller defers)."""
        result: Dict[str, Optional[int]] = {}
        slots: List[int] = []
        rows_list = []
        for tenant in dict.fromkeys(tenants):
            if tenant in self._slots:
                result[tenant] = self.lookup(tenant)
                continue
            rows = self._cold.pop(tenant, None)
            if rows is None:
                raise KeyError(f"unknown tenant {tenant!r}")
            slot = self._acquire()
            if slot is None:
                self._cold[tenant] = rows  # deferred: back into the cold tier
                result[tenant] = None
                continue
            slots.append(slot)
            rows_list.append(rows)
            self._take_slot(tenant, slot, rows)
            self.promotes += 1
            result[tenant] = slot
        if slots:
            self._write_slots(slots, rows_list)
        return result

    def spill_many(self, tenants: Iterable[str]) -> None:
        """Batch :meth:`spill`: all victims' slots scrubbed in one write per
        table.  Cold-tier room for the whole cohort is checked up front, so
        the batch either lands whole or raises before any slot changes."""
        victims: List[str] = []
        for tenant in dict.fromkeys(tenants):
            if tenant == BASE_TENANT:
                raise ValueError("slot 0 (base tenant) cannot be spilled")
            if tenant in self._cold:
                continue
            if tenant not in self._slots:
                raise KeyError(f"unknown tenant {tenant!r}")
            if self._pins.get(tenant, 0):
                raise RuntimeError(f"tenant {tenant!r} is pinned by an active lane")
            victims.append(tenant)
        if not victims:
            return
        droppable = sum(1 for t in self._cold
                        if not (self._protect.get(t, 0) or self._pins.get(t, 0)))
        if self.cold_slots - len(self._cold) + droppable < len(victims):
            raise RuntimeError(
                f"cold tier cannot absorb {len(victims)} spills (cold_slots={self.cold_slots})")
        slots = [self._slots.pop(t) for t in victims]
        self._scrub_slots(slots)
        for tenant, slot in zip(victims, slots):
            self._make_cold_room()  # cannot fail: room was checked
            self._cold[tenant] = self._hot_rows.pop(tenant)
            self._cold.move_to_end(tenant)
            self._free.append(slot)
            self.spills += 1

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

    def _exhausted(self) -> RuntimeError:
        return RuntimeError(
            f"λ-pool exhausted: all {self.n_slots} slots pinned by in-flight requests and "
            f"the cold tier is {'full' if self.cold_slots else 'disabled'} (raise "
            "n_slots/cold_slots or drain the queue)"
        )

    def _land_cold(self, tenant: str, rows, dg: bytes) -> bool:
        """A new tenant straight into the cold tier, when it has room."""
        if not self._make_cold_room():
            return False
        self._cold[tenant] = rows
        self._digest_add(tenant, dg)
        self.cold_registers += 1
        return True

    def register(self, tenant: str, lam_tree) -> int:
        """Load (or hot-swap) a tenant's λ; returns its hot slot id, or
        :data:`COLD_SLOT` when it landed in the host cold tier."""
        rows, dg = self._validate(tenant, lam_tree)
        if tenant in self and (self._pins.get(tenant, 0) or self._protect.get(tenant, 0)):
            # pins cover active lanes; protects cover queued and preempted
            # requests (a swap under them would mix adapters in one generation)
            raise RuntimeError(
                f"tenant {tenant!r} is referenced by in-flight requests — "
                "hot-swapping its λ mid-generation would mix adapters"
            )
        if tenant in self._slots:
            slot = self.lookup(tenant)  # hot-swap in place
            self._write_slot(slot, rows)
            self._hot_rows[tenant] = rows
            self._digest_add(tenant, dg)
            return slot
        if tenant in self._cold:
            # cold hot-swap: replace the host rows, no device traffic
            self._cold[tenant] = rows
            self._cold.move_to_end(tenant)
            self._digest_add(tenant, dg)
            return COLD_SLOT
        slot = self._acquire()
        if slot is None:
            if self._land_cold(tenant, rows, dg):
                return COLD_SLOT
            raise self._exhausted()
        self._write_slot(slot, rows)
        self._take_slot(tenant, slot, rows)
        self._digest_add(tenant, dg)
        return slot

    def register_many(self, lam_trees: Dict[str, Any]) -> Dict[str, int]:
        """Batch :meth:`register`: every *new* tenant's λ row lands in one
        indexed write per table; already-resident tenants take the
        single-tenant hot-swap path (its in-flight guard applies).  A new
        tenant that finds no hot slot lands in the cold tier, or raises the
        exhaustion after the rows that already got slots have landed.
        Returns tenant → hot slot id or :data:`COLD_SLOT`."""
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
            slot = self._acquire()
            if slot is None:
                if not self._land_cold(tenant, rows, dg):
                    if slots:  # land what already got slots first
                        self._write_slots(slots, rows_list)
                    raise self._exhausted()
                result[tenant] = COLD_SLOT
                continue
            slots.append(slot)
            rows_list.append(rows)
            self._take_slot(tenant, slot, rows)
            self._digest_add(tenant, dg)
            result[tenant] = slot
        if slots:
            self._write_slots(slots, rows_list)
        return result

    def evict(self, tenant: str) -> None:
        """Drop a tenant from both tiers (must not be pinned or protected)."""
        if tenant == BASE_TENANT:
            raise ValueError("slot 0 (base tenant) cannot be evicted")
        if self._pins.get(tenant, 0):
            raise RuntimeError(f"tenant {tenant!r} is pinned by in-flight requests")
        if self._protect.get(tenant, 0):
            raise RuntimeError(f"tenant {tenant!r} is protected by queued requests")
        if tenant in self._cold:
            self._cold.pop(tenant)
            self._digest_remove(tenant)
            return
        slot = self._slots.pop(tenant)
        self._hot_rows.pop(tenant, None)
        self._digest_remove(tenant)
        self._scrub_slots([slot])
        self._free.append(slot)

    # -- parameter view -----------------------------------------------------

    @property
    def tables(self) -> Dict[Key, torch.Tensor]:
        """Slot-major ``(n_local, *lead, cap)`` views of this rank's tables
        (all ``n_slots`` unsharded; introspection — the serving path reads
        the install layout)."""
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

    # -- accounting ---------------------------------------------------------

    def attach_metrics(self, registry) -> None:
        """Tier occupancy and churn through a
        :class:`~repro_torch.obs.metrics.MetricsRegistry`, sampled from the
        counters and containers the store already keeps (nothing on the
        register, promote or evict paths)."""
        cb = registry.callback
        cb("lam_hot_slots_in_use", lambda: len(self._slots) - 1,
           help="hot-tier λ slots holding a tenant (base slot 0 excluded)")
        cb("lam_hot_slots_capacity", lambda: self.hot_capacity,
           help="usable hot-tier λ slots")
        cb("lam_cold_tenants", lambda: len(self._cold),
           help="tenants resident in the host cold tier")
        cb("lam_cold_capacity", lambda: self.cold_slots,
           help="host cold-tier capacity (tenants)")
        cb("lam_table_bytes", self.table_bytes,
           help="device bytes of the packed hot-tier λ tables")
        cb("lam_cold_bytes", self.cold_bytes,
           help="host bytes currently held by the cold tier")
        cb("lam_spills_total", lambda: self.spills, kind="counter",
           help="hot → cold λ demotions")
        cb("lam_promotes_total", lambda: self.promotes, kind="counter",
           help="cold → hot λ promotions")
        cb("lam_cold_registers_total", lambda: self.cold_registers,
           kind="counter", help="registers that landed directly in the cold tier")
        cb("lam_lru_drops_total", lambda: self.lru_drops, kind="counter",
           help="tenants dropped from the store by tier pressure")
        cb("lam_slot_writes_total", lambda: self.slot_writes, kind="counter",
           help="device slot writes (register/spill/evict/promote)")

    @property
    def hot_capacity(self) -> int:
        """Usable hot slots (the reserved base slot 0 excluded)."""
        return self.n_slots - 1

    def bytes_per_tenant(self) -> int:
        """Bytes of one tenant's λ state: its row across all tables (the
        same on the device, hot, and on the host, cold)."""
        return 4 * sum(int(np.prod(s)) for s in self._lam_shapes.values())

    def table_bytes(self, per_rank: bool = False) -> int:
        """Device bytes of the packed tables: all slots over the group, or
        (``per_rank``) the slots this rank holds."""
        return self.bytes_per_tenant() * (self.n_local if per_rank else self.n_slots)

    def cold_bytes(self) -> int:
        """Host bytes the cold tier holds (the hot tier's host copies are
        not counted)."""
        return self.bytes_per_tenant() * len(self._cold)


def _dec(counts: Dict[Any, int], key: Any) -> None:
    n = counts.get(key, 0) - 1
    if n <= 0:
        counts.pop(key, None)
    else:
        counts[key] = n
