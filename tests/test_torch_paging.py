"""The port's block allocator refcounts and prefix cache against the JAX
package's: the same operation sequences through both, the same refcounts,
free lists, hits, chain keys and block ids (host bookkeeping, exact)."""
import numpy as np
import pytest

from _hypothesis_compat import given, settings, st
from repro.serving.paging import BlockAllocator as JBlockAllocator
from repro.serving.paging import PrefixCache as JPrefixCache
from repro_torch.serving import BlockAllocator, PoolExhausted, PrefixCache


def _same_state(mine, ref):
    assert (mine.n_free, mine.n_in_use, mine.peak_in_use) == (
        ref.n_free, ref.n_in_use, ref.peak_in_use)
    assert mine._free == ref._free and mine._refs == ref._refs


# ---------------------------------------------------------------------------
# allocator refcounts (copies of tests/test_paging.py:34 and :93-165)
# ---------------------------------------------------------------------------


def test_allocator_basics_and_free():
    al = BlockAllocator(n_blocks=5, block_size=8)
    assert al.capacity == 4 and al.n_free == 4
    assert [al.blocks_for(n) for n in (0, 1, 8, 9)] == [0, 1, 1, 2]
    a, b = al.alloc(2), al.alloc(2)
    assert 0 not in a + b and len(set(a + b)) == 4 and al.n_free == 0
    with pytest.raises(PoolExhausted):
        al.alloc(1)
    al.free(a)
    assert al.n_free == 2 and set(al.alloc(2)) == set(a), "freed blocks are reused"
    with pytest.raises(ValueError):
        al.free([0])  # trash block is never allocated


def test_allocator_refcounts_and_fork():
    for al in (BlockAllocator(n_blocks=5, block_size=8), JBlockAllocator(n_blocks=5, block_size=8)):
        [b] = al.alloc(1)
        assert al.ref_count(b) == 1 and not al.is_shared(b)
        al.incref(b)
        assert al.ref_count(b) == 2 and al.is_shared(b)
        assert not al.decref(b), "shared block must survive one decref"
        assert al.ref_count(b) == 1
        with pytest.raises(ValueError):
            al.fork(b)  # fork of an unshared block is a bug
        al.incref(b)
        new = al.fork(b)  # transfers one owner's ref to a private copy
        assert new != b and al.ref_count(new) == 1 and al.ref_count(b) == 1
        with pytest.raises(ValueError):
            al.incref(0)  # trash block never shared
        with pytest.raises(ValueError):
            al.incref(new + 1 if new + 1 < al.n_blocks else 1)  # free block
        al.free([b, new])
        assert al.n_free == al.capacity


@settings(max_examples=40, deadline=None)
@given(n_blocks=st.integers(2, 24), seed=st.integers(0, 10_000))
def test_allocator_refcount_traffic_matches_reference(n_blocks, seed):
    """Any interleaving of alloc/incref/decref/fork: the port's allocator
    hands out the reference's block ids, keeps its refcounts and free list,
    never hands out block 0, and drains back to a full free list."""
    rng = np.random.default_rng(seed)
    mine, ref = BlockAllocator(n_blocks, 8), JBlockAllocator(n_blocks, 8)
    refs = {}  # block → expected refcount
    for _ in range(80):
        p = rng.random()
        if refs and p < 0.25:
            b = list(refs)[rng.integers(len(refs))]
            refs[b] += 1
            mine.incref(b)
            ref.incref(b)
        elif refs and p < 0.5:
            b = list(refs)[rng.integers(len(refs))]
            freed = mine.decref(b)
            assert freed == ref.decref(b)
            refs[b] -= 1
            assert freed == (refs[b] == 0)
            if not refs[b]:
                del refs[b]
        elif refs and p < 0.6:
            shared = [b for b, n in refs.items() if n > 1]
            if shared:
                b = shared[rng.integers(len(shared))]
                if mine.n_free == 0:
                    with pytest.raises(PoolExhausted):
                        mine.fork(b)
                    continue
                new = mine.fork(b)
                assert new == ref.fork(b)
                refs[b] -= 1
                refs[new] = 1
        else:
            n = int(rng.integers(0, max(mine.capacity // 2, 1) + 1))
            if n > mine.n_free:
                with pytest.raises(PoolExhausted):
                    mine.alloc(n)
                continue
            ids = mine.alloc(n)
            assert ids == ref.alloc(n) and 0 not in ids and len(set(ids)) == n
            for b in ids:
                assert b not in refs, "block handed out twice"
                refs[b] = 1
        for b, n in refs.items():
            assert mine.ref_count(b) == n
        assert len(refs) + mine.n_free == mine.capacity, "blocks leaked"
        _same_state(mine, ref)
    for b, n in list(refs.items()):
        for _ in range(n):
            mine.decref(b)
    assert mine.n_free == mine.capacity


# ---------------------------------------------------------------------------
# prefix cache (copy of tests/test_paging.py:167, then random sequences)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("impl", ["port", "reference"])
def test_prefix_cache_match_insert_evict(impl):
    Alloc, Cache = ((BlockAllocator, PrefixCache) if impl == "port"
                    else (JBlockAllocator, JPrefixCache))
    al = Alloc(n_blocks=9, block_size=4)
    pc = Cache(al)
    fam = b"family-0"
    toks = np.arange(2, 12, dtype=np.int32)  # 10 tokens → 2 full blocks
    ids = al.alloc(3)  # 2 full + 1 tail
    assert pc.match(fam, toks) == []
    pc.insert(fam, toks, ids)
    assert len(pc) == pc.cached_blocks == 2, "only full blocks are cached, never the tail"
    assert al.ref_count(ids[0]) == al.ref_count(ids[1]) == 2  # cache-owned
    assert al.ref_count(ids[2]) == 1
    assert pc.match(fam, toks) == ids[:2]
    other = toks.copy()
    other[5] = 99  # shares only the first block
    assert pc.match(fam, other) == ids[:1]
    assert pc.match(b"family-1", toks) == [], "a different λ digest shares nothing"
    al.free(ids)  # the lane retires; the cache keeps the full blocks alive
    assert al.n_free == al.capacity - 2
    assert pc.match(fam, toks) == ids[:2]
    assert pc.evict_one() and pc.evict_one()  # LRU-first, back to the pool
    assert len(pc) == 0 and al.n_free == al.capacity
    assert pc.match(fam, toks) == [] and not pc.evict_one()


def test_prefix_cache_chain_keys_are_the_reference_keys():
    """Both packages chain sha1 from the family digest, so a prompt files
    under the same keys in both (the cross-package family identity)."""
    rng = np.random.default_rng(0)
    toks = rng.integers(2, 256, size=37).astype(np.int32)
    fam = bytes(range(24)) + (64).to_bytes(4, "little")
    mine, ref = PrefixCache(BlockAllocator(12, 8)), JPrefixCache(JBlockAllocator(12, 8))
    assert list(mine._chain(fam, toks)) == list(ref._chain(fam, toks))
    assert len(list(mine._chain(fam, toks))) == 37 // 8


@pytest.mark.parametrize("seed", range(6))
def test_prefix_cache_random_operations_match_reference(seed):
    """Random insert/match/evict_one/drop_family/clear sequences over a few
    families and prompts sharing prefixes: the same matches, hits, entries
    (keys, block ids, LRU order), refcounts and freed counts."""
    rng = np.random.default_rng(seed)
    bs = 4
    mine_al, ref_al = BlockAllocator(40, bs), JBlockAllocator(40, bs)
    mine, ref = PrefixCache(mine_al), JPrefixCache(ref_al)
    digests = [bytes([d]) * 20 for d in range(3)]
    families = [d + int(b).to_bytes(4, "little") for d in digests for b in (16, 32)]
    base = rng.integers(2, 50, size=24).astype(np.int32)
    prompts = []
    for _ in range(8):
        p = base[: int(rng.integers(4, 25))].copy()
        if rng.random() < 0.4:
            p[int(rng.integers(len(p)))] = 99  # diverges somewhere
        prompts.append(p)
    held = []  # lane-held blocks, dropped at random
    for _ in range(60):
        op = rng.random()
        fam = families[int(rng.integers(len(families)))]
        toks = prompts[int(rng.integers(len(prompts)))]
        if op < 0.4:
            n = -(-len(toks) // bs)
            if mine_al.n_free < n:
                continue
            cached = mine.match(fam, toks)
            assert cached == ref.match(fam, toks)
            for b in cached:
                mine_al.incref(b)
                ref_al.incref(b)
            new = mine_al.alloc(n - len(cached))
            assert new == ref_al.alloc(n - len(cached))
            blocks = cached + new
            mine.insert(fam, toks, blocks)
            ref.insert(fam, toks, blocks)
            held += blocks
        elif op < 0.6:
            assert mine.match(fam, toks) == ref.match(fam, toks)
        elif op < 0.75 and held:
            for b in held[: int(rng.integers(1, len(held) + 1))]:
                assert mine_al.decref(b) == ref_al.decref(b)
                held.remove(b)
        elif op < 0.9:
            assert mine.evict_one() == ref.evict_one()
        elif op < 0.97:
            d = digests[int(rng.integers(len(digests)))]
            assert mine.drop_family(d) == ref.drop_family(d)
        else:
            assert mine.clear() == ref.clear()
        assert list(mine._entries.items()) == list(ref._entries.items())
        assert (mine.hits, mine.misses, mine.cached_blocks) == (
            ref.hits, ref.misses, len(ref))
        _same_state(mine_al, ref_al)
    for b in held:
        mine_al.decref(b)
    mine.clear()
    assert mine_al.n_free == mine_al.capacity
