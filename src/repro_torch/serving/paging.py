"""Block allocator for the paged KV cache (port of the ``BlockAllocator`` of
``repro/serving/paging.py``, without metrics; the prefix cache comes with the
prefix-sharing slice).

One global pool of fixed-size blocks per layer,
``(n_blocks, block_size, n_kv_heads, d_head)``, plus a per-lane block table
of pool indices: a sequence of ``T`` tokens holds ``ceil(T / block_size)``
blocks.  This is the host-side bookkeeping.

* **Block 0 is reserved** as the trash block: idle lanes and padded table
  entries point at it, so the shared scatter needs no per-lane branching.
* **Reference counts**: ``alloc`` hands out blocks at refcount 1, ``decref``
  returns a block to the free list when its count reaches 0 (sharing a
  block, ``incref``, comes with prefix sharing).
"""
from __future__ import annotations

from typing import Dict, List


class PoolExhausted(RuntimeError):
    """Raised when an allocation cannot be satisfied from the free list."""


class BlockAllocator:
    """Ref-counted free list over ``n_blocks`` KV blocks; block 0 reserved
    for trash (never allocated, never freed, never shared)."""

    def __init__(self, n_blocks: int, block_size: int):
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

    def _track(self) -> None:
        self.peak_in_use = max(self.peak_in_use, self.n_in_use)

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
