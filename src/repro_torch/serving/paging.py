"""Block allocator and prefix cache for the paged KV cache (port of
``repro/serving/paging.py``).

One global pool of fixed-size blocks per layer,
``(n_blocks, block_size, n_kv_heads, d_head)``, plus a per-lane block table
of pool indices: a sequence of ``T`` tokens holds ``ceil(T / block_size)``
blocks.  This is the host-side bookkeeping: a ref-counted free list and the
hash-chain :class:`PrefixCache` that lets requests sharing a prompt prefix
hold the same physical blocks (copy-on-write sharing).

* **Block 0 is reserved** as the trash block: idle lanes, padded table
  entries and redirected writes into cached prefix blocks point at it, so
  the shared scatter needs no per-lane branching.
* **Reference counts**: ``alloc`` hands out blocks at refcount 1; sharing a
  block (a second lane, or the prefix cache itself) is an ``incref``;
  releasing one side is a ``decref``; the block returns to the free list
  when its count reaches 0.  A block with refcount > 1 is shared and is
  never written — a writer first forks a private copy (``fork``).
"""
from __future__ import annotations

import hashlib
from collections import OrderedDict
from typing import Dict, List, Sequence

import numpy as np

from repro_torch.obs.metrics import NULL


class PoolExhausted(RuntimeError):
    """Raised when an allocation cannot be satisfied from the free list."""


class BlockAllocator:
    """Ref-counted free list over ``n_blocks`` KV blocks; block 0 reserved
    for trash (never allocated, never freed, never shared).

    With a ``metrics`` registry, pool occupancy is tracked as gauges
    (``kv_pool_blocks_in_use`` / ``kv_pool_blocks_peak``) updated on every
    alloc and free, so the footprint numbers are exact whenever they are
    sampled."""

    def __init__(self, n_blocks: int, block_size: int, *, metrics=None):
        if n_blocks < 2:
            raise ValueError("need block 0 (trash) plus at least one usable block")
        if block_size < 1:
            raise ValueError("block_size must be >= 1")
        self.n_blocks = n_blocks
        self.block_size = block_size
        # LIFO free list: lowest ids handed out first (stable test behavior)
        self._free: List[int] = list(range(n_blocks - 1, 0, -1))
        self._refs: Dict[int, int] = {}
        self.peak_in_use = 0  # high-water mark of blocks out of the free list
        self._g_in_use = self._g_peak = NULL
        if metrics is not None:
            self.attach_metrics(metrics)

    def attach_metrics(self, registry) -> None:
        """Wire pool occupancy into a :class:`~repro_torch.obs.metrics.
        MetricsRegistry` (no-op instruments when the registry is disabled)."""
        self._g_in_use = registry.gauge(
            "kv_pool_blocks_in_use", "KV pool blocks out of the free list")
        self._g_peak = registry.gauge(
            "kv_pool_blocks_peak", "high-water mark of KV pool blocks in use")
        registry.callback(
            "kv_pool_blocks_capacity", lambda: self.capacity,
            help="usable KV pool blocks (excludes the trash block)")

    def _track(self) -> None:
        """Occupancy bookkeeping after any alloc or free."""
        n = self.n_in_use
        if n > self.peak_in_use:
            self.peak_in_use = n
        self._g_in_use.set(n)
        self._g_peak.set(self.peak_in_use)

    # -- capacity -----------------------------------------------------------

    @property
    def n_free(self) -> int:
        return len(self._free)

    @property
    def n_in_use(self) -> int:
        return self.capacity - self.n_free

    @property
    def capacity(self) -> int:
        """Usable blocks (excludes the reserved trash block)."""
        return self.n_blocks - 1

    def blocks_for(self, n_tokens: int) -> int:
        """Blocks needed to hold ``n_tokens`` cache positions."""
        return -(-max(int(n_tokens), 0) // self.block_size)

    def can_alloc(self, n: int) -> bool:
        return n <= self.n_free

    # -- refcounts ----------------------------------------------------------

    def ref_count(self, b: int) -> int:
        return self._refs.get(b, 0)

    def is_shared(self, b: int) -> bool:
        return self.ref_count(b) > 1

    def incref(self, b: int) -> None:
        """Add an owner to an allocated block (a sharing lane or the prefix
        cache).  Sharing the trash block or a free block raises."""
        if b == 0:
            raise ValueError("block 0 is reserved and never shared")
        if b not in self._refs:
            raise ValueError(f"incref of unallocated block {b}")
        self._refs[b] += 1

    def decref(self, b: int) -> bool:
        """Drop one owner; True when the block went back to the free list.
        Decref of the trash block or a free block raises (double free)."""
        if b == 0:
            raise ValueError("block 0 is reserved and never allocated")
        n = self._refs.get(b, 0)
        if n <= 0:
            raise ValueError(f"double free / foreign block {b}")
        if n == 1:
            del self._refs[b]
            self._free.append(b)
            self._track()
            return True
        self._refs[b] = n - 1
        return False

    # -- alloc / free -------------------------------------------------------

    def alloc(self, n: int) -> List[int]:
        """Pop ``n`` blocks at refcount 1; raises :class:`PoolExhausted`
        (allocating nothing) when fewer are free."""
        if n < 0:
            raise ValueError("cannot allocate a negative block count")
        if n > self.n_free:
            raise PoolExhausted(f"need {n} blocks, {self.n_free}/{self.capacity} free")
        ids = [self._free.pop() for _ in range(n)]
        for b in ids:
            self._refs[b] = 1
        self._track()
        return ids

    def free(self, ids: Sequence[int]) -> None:
        """Drop one reference per block; shared blocks survive until their
        last owner lets go."""
        for b in ids:
            self.decref(b)

    def fork(self, b: int) -> int:
        """Copy-on-write split: allocate a private block to replace shared
        block ``b`` for one of its owners, moving that owner's reference to
        it.  The caller copies the device contents and repoints its table."""
        if not self.is_shared(b):
            raise ValueError(f"fork of unshared block {b} (refcount {self.ref_count(b)})")
        [new] = self.alloc(1)
        self.decref(b)
        return new


class PrefixCache:
    """Hash-chain prompt-prefix cache: full-block token prefixes → block ids.

    Entry ``k`` of a prompt's chain is keyed by the family key (the tenant's
    λ digest and the prefill bucket: K/V depends on the adapter, so only
    identical λ share) chained through the first ``k·block_size`` prompt
    tokens by sha1, as the reference chains them.  ``match`` returns the
    longest cached run of leading full blocks; ``insert`` files the blocks a
    prefill just wrote, the cache holding its own reference on each, so
    prefixes survive lane retirement and go only by LRU eviction.  Only
    full blocks are cached: a prompt's partial tail keeps receiving decode
    writes and stays private to its lane.
    """

    def __init__(self, allocator: BlockAllocator, *, metrics=None):
        self.allocator = allocator
        self.block_size = allocator.block_size
        # key → block id, least-recently-used first
        self._entries: "OrderedDict[bytes, int]" = OrderedDict()
        # entry key → the seed its chain hashed from, and seed → its keys
        self._seed_of: Dict[bytes, bytes] = {}
        self._by_seed: Dict[bytes, "OrderedDict[bytes, None]"] = {}
        self.hits = 0  # blocks reused across all matches
        self.misses = 0  # full blocks prefilled that were not cached
        if metrics is not None:
            self.attach_metrics(metrics)

    def attach_metrics(self, registry) -> None:
        """Sampled occupancy and efficacy metrics (resolved at snapshot
        time, nothing on the match/insert path)."""
        registry.callback(
            "kv_prefix_cached_blocks", lambda: len(self._entries),
            help="prefix-cache entries currently holding a block reference")
        registry.callback(
            "kv_prefix_hit_rate", self.hit_rate,
            help="blocks adopted from the cache / full blocks requested")

    def hit_rate(self) -> float:
        total = self.hits + self.misses
        return self.hits / total if total else 0.0

    def __len__(self) -> int:
        return len(self._entries)

    @property
    def cached_blocks(self) -> int:
        return len(self._entries)

    def _chain(self, digest: bytes, tokens: np.ndarray):
        """One key per leading full block: key_k = sha1(key_{k-1} ‖ tokens
        of block k), seeded by ``digest``."""
        prev, bs = digest, self.block_size
        for k in range(len(tokens) // bs):
            h = hashlib.sha1(prev)
            h.update(np.ascontiguousarray(tokens[k * bs:(k + 1) * bs], np.int32).tobytes())
            prev = h.digest()
            yield prev

    def match(self, digest: bytes, tokens: np.ndarray) -> List[int]:
        """Block ids of the longest cached chain of ``tokens``' leading full
        blocks under ``digest`` (no refcount change: the caller increfs
        what it adopts)."""
        out: List[int] = []
        for key in self._chain(digest, tokens):
            b = self._entries.get(key)
            if b is None:
                break
            self._entries.move_to_end(key)
            out.append(b)
        return out

    def insert(self, digest: bytes, tokens: np.ndarray, block_ids: Sequence[int]) -> None:
        """File a prompt's leading full blocks (``block_ids[k]`` holds tokens
        ``[k·bs, (k+1)·bs)``); links already cached are left alone, new
        ones take a cache-owned reference."""
        full = min(len(tokens) // self.block_size, len(block_ids))
        for k, key in enumerate(self._chain(digest, tokens)):
            if k >= full:
                break
            if key in self._entries:
                self._entries.move_to_end(key)
                continue
            self.allocator.incref(block_ids[k])
            self._entries[key] = block_ids[k]
            self._seed_of[key] = digest
            self._by_seed.setdefault(digest, OrderedDict())[key] = None

    def _forget(self, key: bytes) -> None:
        seed = self._seed_of.pop(key, None)
        if seed is not None:
            keys = self._by_seed.get(seed)
            if keys is not None:
                keys.pop(key, None)
                if not keys:
                    del self._by_seed[seed]

    def evict_one(self) -> bool:
        """Drop the least-recently-used entry; True if its block went back
        to the pool (the cache was its last owner)."""
        if not self._entries:
            return False
        key, b = self._entries.popitem(last=False)
        self._forget(key)
        return self.allocator.decref(b)

    def drop_family(self, seed_prefix: bytes) -> int:
        """Evict every entry whose chain seed starts with ``seed_prefix`` (a
        λ digest drops every bucket of that family); returns the blocks
        actually returned to the pool."""
        freed = 0
        for seed in [s for s in self._by_seed if s.startswith(seed_prefix)]:
            for key in list(self._by_seed.get(seed, ())):
                b = self._entries.pop(key)
                self._forget(key)
                freed += bool(self.allocator.decref(b))
        return freed

    def clear(self) -> int:
        """Drop every entry; returns the blocks freed to the pool."""
        freed = 0
        while self._entries:
            freed += bool(self.evict_one())
        return freed
