"""The port's hierarchical λ-store against the reference's
(``repro/serving/lam_store.py``): the same calls on a JAX store and a port
store (CPU) give the same return values, the same tiers, LRU order, free
list and counters, and the same λ rows bit for bit — hot rows in the
tables, cold rows on the host.  The reference's own store tests
(``tests/test_lam_store.py:107-320``) are ported here in that form, with its
random-traffic property (protection modelled as a count, as both stores
keep it); the mmap catalog crosses between the packages both ways; and a
2-rank gloo group holds spill → promote under sharded tables bitwise the
replicated store."""
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import numpy as np
import pytest

from _hypothesis_compat import given, settings, st
from repro.serving import EngineConfig as JEngineConfig
from repro.serving.lam_store import LamStore as JLamStore
from repro.serving.lam_store import MmapColdTier as JMmapColdTier
from repro.serving.lam_store import _lam_digest as j_lam_digest
from repro_torch.serving import BASE_TENANT, COLD_SLOT, EngineConfig, LamStore, MmapColdTier
from repro_torch.serving.lam_store import _lam_digest

ROOT = Path(__file__).resolve().parents[1]
SHAPES = {("attn", "wq"): (3, 8), ("mlp", "w_up"): (3, 8)}


@pytest.fixture(scope="module", autouse=True)
def _clear_jax_caches():
    """The reference stores jit per instance; leave no executables behind
    for the worker's other files."""
    yield
    jax.clear_caches()


def _lam_tree(value, shapes=SHAPES):
    out = {}
    for (mod, proj), shape in shapes.items():
        out.setdefault(mod, {})[proj] = np.full(shape, value, np.float32)
    return out


def _flat(tree):
    return {(mod, proj): leaf for mod, projs in tree.items() for proj, leaf in projs.items()}


def _state(store, tables):
    """Everything the two stores must agree on, λ rows as bytes."""
    return {
        "slots": list(store._slots.items()),
        "cold": list(store._cold),
        "free": list(store._free),
        "pins": dict(store._pins),
        "protect": dict(store._protect),
        "digests": dict(store._digests),
        "counters": {n: getattr(store, n) for n in (
            "spills", "promotes", "cold_registers", "lru_drops", "slot_writes")},
        "cold_slots": store.cold_slots,
        "cold_bytes": store.cold_bytes(),
        "tables": {k: v.tobytes() for k, v in sorted(tables.items())},
        "cold_rows": {t: {k: np.asarray(store._cold[t][k], np.float32).tobytes()
                          for k in sorted(SHAPES)} for t in store._cold},
    }


class Pair:
    """A JAX store and a port store driven by the same calls."""

    def __init__(self, *args, **kw):
        self.j = JLamStore(*args, **kw)
        self.t = LamStore(*args, **kw, device="cpu")

    def __getattr__(self, name):
        def call(*args, **kw):
            out = []
            for store in (self.j, self.t):
                try:
                    out.append(("ok", getattr(store, name)(*args, **kw)))
                except Exception as e:  # noqa: BLE001 - both must raise alike
                    out.append(("raise", type(e)))
            assert out[0] == out[1], (name, args, out)
            self.check()
            if out[1][0] == "raise":
                raise out[1][1](f"{name} raised in both stores")
            return out[1][1]
        return call

    def check(self):
        js = _state(self.j, {k: np.asarray(v) for k, v in self.j.tables.items()})
        ts = _state(self.t, {k: v.numpy() for k, v in self.t.tables.items()})
        assert js == ts

    def row(self, slot, key=("attn", "wq")):
        return self.t.tables[key][slot].numpy()


# ---------------------------------------------------------------------------
# cold tier: spill → promote round trip, overflow registration, deferral
# (tests/test_lam_store.py:107-193)
# ---------------------------------------------------------------------------


def test_cold_tier_spill_promote_roundtrip_bit_identical():
    s = Pair(SHAPES, n_slots=3, cold_slots=4)  # 2 usable hot slots
    vals = {f"t{i}": float(i + 1) * 0.37 for i in range(4)}
    for name, v in vals.items():
        s.register(name, _lam_tree(v))
    assert s.t.is_cold("t0") and s.t.is_cold("t1")
    assert s.t.is_hot("t2") and s.t.is_hot("t3")
    assert s.t.cold_bytes() == 2 * s.t.bytes_per_tenant()
    for name in ("t0", "t1"):
        assert s.t.digest(name) == _lam_digest(_flat(_lam_tree(vals[name])))
    slot = s.promote("t0")
    assert slot is not None and s.t.is_hot("t0")
    np.testing.assert_array_equal(s.row(slot), np.full((3, 8), vals["t0"], np.float32))
    np.testing.assert_array_equal(s.row(0), 0.0)  # the base slot survived the churn


def test_register_lands_cold_when_hot_pinned_and_raises_without_cold():
    def fill_and_pin(cold_slots):
        s = Pair(SHAPES, n_slots=3, cold_slots=cold_slots)
        s.register("a", _lam_tree(1.0))
        s.register("b", _lam_tree(2.0))
        s.pin("a")
        s.pin("b")
        return s

    s = fill_and_pin(cold_slots=0)
    with pytest.raises(RuntimeError):  # the hot-only store fails hard
        s.register("c", _lam_tree(3.0))
    s = fill_and_pin(cold_slots=2)
    assert s.register("c", _lam_tree(3.0)) == COLD_SLOT
    assert s.t.is_cold("c") and s.t.cold_registers == 1
    assert s.promote("c") is None, "promotion must defer while all pinned"
    s.unpin("a")
    slot = s.promote("c")
    assert slot is not None and s.t.is_hot("c") and s.t.is_cold("a")


def test_hot_swap_refuses_protected_tenants_in_both_tiers():
    s = Pair(SHAPES, n_slots=3, cold_slots=2)
    s.register("a", _lam_tree(1.0))
    s.protect("a")
    with pytest.raises(RuntimeError):
        s.register("a", _lam_tree(2.0))  # hot + protected
    s.spill("a")
    with pytest.raises(RuntimeError):
        s.register("a", _lam_tree(2.0))  # cold + protected
    s.unprotect("a")
    assert s.register("a", _lam_tree(2.0)) == COLD_SLOT
    slot = s.promote("a")
    np.testing.assert_array_equal(s.row(slot), 2.0)


def test_protect_blocks_drop_but_allows_spill():
    s = Pair(SHAPES, n_slots=3, cold_slots=1)
    s.register("a", _lam_tree(1.0))
    s.protect("a")
    s.register("b", _lam_tree(2.0))
    s.register("c", _lam_tree(3.0))  # a is LRU and unpinned: it may spill
    assert s.t.is_cold("a") and "a" in s.t
    s.register("d", _lam_tree(4.0))  # the cold tier is full of it: never dropped
    assert "a" in s.t, "protected tenant dropped from the store"
    with pytest.raises(RuntimeError):
        s.evict("a")
    s.unprotect("a")
    s.evict("a")
    assert "a" not in s.t


# ---------------------------------------------------------------------------
# batch register/promote/spill: one write per table per cohort
# (tests/test_lam_store.py:195-266)
# ---------------------------------------------------------------------------


def test_register_many_single_write_bit_identical():
    s = Pair(SHAPES, n_slots=6)
    writes0 = s.t.slot_writes
    vals = {f"t{i}": float(i + 1) * 0.31 for i in range(4)}
    slots = s.register_many({t: _lam_tree(v) for t, v in vals.items()})
    assert s.t.slot_writes == writes0 + 1, "batch register must be one write"
    for t, v in vals.items():
        assert s.t.is_hot(t)
        np.testing.assert_array_equal(s.row(slots[t]), np.full((3, 8), v, np.float32))
        assert s.t.digest(t) == _lam_digest(_flat(_lam_tree(v)))
    np.testing.assert_array_equal(s.row(0), 0.0, err_msg="slot 0 mutated")


def test_register_many_overflow_lands_cold_and_guards_in_flight():
    s = Pair(SHAPES, n_slots=3, cold_slots=2)
    s.register("a", _lam_tree(1.0))
    s.register("b", _lam_tree(2.0))
    s.pin("a")
    s.pin("b")
    res = s.register_many({"c": _lam_tree(3.0), "d": _lam_tree(4.0)})
    assert res == {"c": COLD_SLOT, "d": COLD_SLOT} and s.t.cold_registers == 2
    with pytest.raises(RuntimeError):  # the hot-swap guard applies in a batch
        s.register_many({"a": _lam_tree(9.0)})
    # the cold tier full of unpinned tenants: a fresh one drops the coldest
    s.unpin("a")
    s.unpin("b")
    s.pin("a")
    s.pin("b")
    assert s.register_many({"e": _lam_tree(5.0)}) == {"e": COLD_SLOT}
    assert "c" not in s.t and s.t.lru_drops == 1


def test_spill_many_promote_many_roundtrip_single_write():
    s = Pair(SHAPES, n_slots=5, cold_slots=4)
    vals = {f"t{i}": float(i + 7) / 3.0 for i in range(4)}
    s.register_many({t: _lam_tree(v) for t, v in vals.items()})
    writes0 = s.t.slot_writes
    s.spill_many(list(vals))
    assert s.t.slot_writes == writes0 + 1, "batch spill must be one write"
    assert all(s.t.is_cold(t) for t in vals)
    np.testing.assert_array_equal(s.t.tables[("attn", "wq")].numpy(), 0.0)  # scrubbed
    back = s.promote_many(list(vals))
    assert s.t.slot_writes == writes0 + 2, "batch promote must be one write"
    for t, v in vals.items():
        assert s.t.is_hot(t)
        np.testing.assert_array_equal(s.row(back[t]), np.full((3, 8), v, np.float32))


def test_spill_many_prechecks_room_and_pins_before_touching_slots():
    s = Pair(SHAPES, n_slots=4, cold_slots=1)
    for i in range(3):
        s.register(f"t{i}", _lam_tree(float(i + 1)))
    writes0 = s.t.slot_writes
    with pytest.raises(RuntimeError):
        s.spill_many(["t0", "t1", "t2"])  # the cold tier holds one
    assert s.t.slot_writes == writes0, "a failed batch spill touched the tables"
    assert all(s.t.is_hot(f"t{i}") for i in range(3))
    s.pin("t0")
    with pytest.raises(RuntimeError):
        s.spill_many(["t0"])


def test_promote_many_defers_when_every_hot_slot_is_pinned():
    s = Pair(SHAPES, n_slots=3, cold_slots=2)
    s.register("a", _lam_tree(1.0))
    s.register("b", _lam_tree(2.0))
    s.spill("a")
    s.register("c", _lam_tree(3.0))
    s.pin("b")
    s.pin("c")
    assert s.promote_many(["a"]) == {"a": None}
    assert s.t.is_cold("a"), "a deferred promotion must leave the tenant cold"
    s.unpin("b")
    assert s.promote_many(["a"])["a"] is not None and s.t.is_hot("a")


# ---------------------------------------------------------------------------
# mmap cold tier: the spilled-tenant catalog survives a restart, and the
# file crosses between the packages (tests/test_lam_store.py:268-320)
# ---------------------------------------------------------------------------


def _mmap_pair(tmp_path, **kw):
    """A pair on two files, so that each store owns its own catalog."""
    j = JLamStore(SHAPES, cold_path=str(tmp_path / "j.lam"), **kw)
    t = LamStore(SHAPES, cold_path=str(tmp_path / "t.lam"), device="cpu", **kw)
    return j, t


def test_mmap_cold_tier_survives_restart(tmp_path):
    vals = {f"t{i}": float(i + 1) * 0.41 for i in range(4)}
    j, t = _mmap_pair(tmp_path, n_slots=3, cold_slots=4)
    for name, v in vals.items():
        assert j.register(name, _lam_tree(v)) == t.register(name, _lam_tree(v))
    assert t.is_cold("t0") and t.is_cold("t1") and t.cold_tenants == j.cold_tenants
    digests = {name: t.digest(name) for name in t.cold_tenants}
    del j, t
    # the catalogs of the two packages are the same bytes
    assert (tmp_path / "j.lam.json").read_bytes() == (tmp_path / "t.lam.json").read_bytes()
    assert (tmp_path / "j.lam").read_bytes() == (tmp_path / "t.lam").read_bytes()
    j, t = _mmap_pair(tmp_path, n_slots=3, cold_slots=4)
    assert set(t.cold_tenants) == set(digests) == set(j.cold_tenants)
    for name in sorted(digests):
        assert t.digest(name) == digests[name] == j.digest(name) == _lam_digest(
            _flat(_lam_tree(vals[name]))), "family identity lost across restart"
        assert t.digest_refcount(digests[name]) == 1
        slot = t.promote(name)
        assert slot == j.promote(name)
        np.testing.assert_array_equal(t.tables[("attn", "wq")][slot].numpy(),
                                      np.full((3, 8), vals[name], np.float32))


def test_mmap_cold_tier_rejects_schema_mismatch(tmp_path):
    path = str(tmp_path / "cold.lam")
    store = LamStore(SHAPES, n_slots=3, cold_slots=2, cold_path=path, device="cpu")
    store.register("a", _lam_tree(1.0))
    store.spill("a")
    del store
    other = {("attn", "wq"): (3, 8)}  # another model's λ schema
    for make in (lambda: LamStore(other, n_slots=3, cold_slots=2, cold_path=path, device="cpu"),
                 lambda: JLamStore(other, n_slots=3, cold_slots=2, cold_path=path)):
        with pytest.raises(ValueError, match="schema"):
            make()


def test_cold_path_requires_cold_slots(tmp_path):
    with pytest.raises(ValueError, match="cold_slots"):
        LamStore(SHAPES, n_slots=3, cold_path=str(tmp_path / "c.lam"), device="cpu")
    for cls in (EngineConfig, JEngineConfig):
        with pytest.raises(ValueError, match="cold_slots"):
            cls(cold_path=str(tmp_path / "c.lam"))


@pytest.mark.parametrize("writer", ["repro", "repro_torch"])
def test_mmap_catalog_crosses_between_the_packages(tmp_path, writer):
    """A cold tier written by one package's ``MmapColdTier`` opens in the
    other's: the same tenants in the same LRU order, the same digests and
    the rows bitwise; a store of the reader's package then promotes them."""
    path = str(tmp_path / "cold.lam")
    write_cls, read_cls = ((JMmapColdTier, MmapColdTier) if writer == "repro"
                           else (MmapColdTier, JMmapColdTier))
    rng = np.random.default_rng(7)
    rows = {f"t{i}": {k: rng.standard_normal(s).astype(np.float32) for k, s in SHAPES.items()}
            for i in range(4)}
    tier = write_cls(path, SHAPES, 6)
    for name, r in rows.items():
        tier[name] = r
    tier.move_to_end("t1")
    tier.pop("t2")
    del tier
    back = read_cls(path, SHAPES, 6)
    assert list(back) == ["t0", "t3", "t1"]
    digests = back.digests()
    for name in ("t0", "t3", "t1"):
        assert digests[name] == _lam_digest(rows[name]) == j_lam_digest(rows[name])
        got = back.pop(name)
        for key in SHAPES:
            np.testing.assert_array_equal(got[key], rows[name][key])
        back[name] = got  # back in, at the LRU end: the order is unchanged
    del back
    reader = (LamStore(SHAPES, n_slots=4, cold_slots=6, cold_path=path, device="cpu")
              if writer == "repro" else JLamStore(SHAPES, n_slots=4, cold_slots=6, cold_path=path))
    assert reader.cold_tenants == ("t0", "t3", "t1")
    for name in ("t0", "t3", "t1"):
        assert reader.digest(name) == digests[name]
        slot = reader.promote(name)
        for key in SHAPES:
            np.testing.assert_array_equal(np.asarray(reader.tables[key][slot]), rows[name][key])
    cat = json.loads(Path(path + ".json").read_text())
    assert cat["schema"] == [[list(k), list(SHAPES[k])] for k in sorted(SHAPES)]


# ---------------------------------------------------------------------------
# the random-traffic property (tests/test_lam_store.py:325), protection as a
# count; and the same traffic through both stores
# ---------------------------------------------------------------------------


def _random_traffic(store, rng, names, steps, on_step=None):
    """Random register/pin/unpin/protect/evict/spill/promote/hot-swap calls;
    the model the invariants read: the last value registered per tenant,
    each pinned tenant's slot and pin count, each tenant's protect count."""
    lam_val, pinned, protected = {}, {}, {}
    for _ in range(steps):
        op = int(rng.integers(0, 8))
        name = names[int(rng.integers(0, len(names)))]
        if op == 0 or name not in store:  # register / hot-swap
            val = float(rng.integers(1, 1000)) / 7.0
            in_flight = name in store and (name in pinned or name in protected)
            if in_flight:
                with pytest.raises(RuntimeError):
                    store.register(name, _lam_tree(val))
            else:
                try:
                    store.register(name, _lam_tree(val))
                    lam_val[name] = val
                except RuntimeError:
                    assert not store._free, "register failed with free slots"
        elif op == 1 and store.is_hot(name):
            slot = store.pin(name)
            pinned.setdefault(name, [slot, 0])[1] += 1
        elif op == 2 and name in pinned:
            store.unpin(name)
            pinned[name][1] -= 1
            if not pinned[name][1]:
                del pinned[name]
        elif op == 3:
            store.protect(name)
            protected[name] = protected.get(name, 0) + 1
        elif op == 4 and name in protected:
            store.unprotect(name)
            protected[name] -= 1
            if not protected[name]:
                del protected[name]
        elif op == 5:
            if name in pinned or name in protected:
                with pytest.raises(RuntimeError):
                    store.evict(name)
            else:
                store.evict(name)
                lam_val.pop(name, None)
        elif op == 6 and store.is_hot(name) and name not in pinned:
            try:
                store.spill(name)
            except RuntimeError:
                assert store.cold_slots == 0 or len(store._cold) >= store.cold_slots
        elif op == 7 and store.is_cold(name):
            if store.promote(name) is None:
                assert not store._free and all(
                    t == BASE_TENANT or store._pins.get(t, 0) for t in store._slots), (
                    "promotion deferred needlessly")
        if on_step is not None:
            on_step()
        _invariants(store, lam_val, pinned, protected)
    return lam_val


def _invariants(store, lam_val, pinned, protected):
    slots = dict(store._slots)
    assert slots[BASE_TENANT] == 0 and 0 not in store._free
    used = list(slots.values())
    assert len(set(used)) == len(used), "slot double-booked"
    assert set(used).isdisjoint(store._free)
    assert len(used) + len(store._free) == store.n_slots, "slot leaked"
    assert len(store._cold) <= store.cold_slots
    for t, (s, _) in pinned.items():
        assert store._slots.get(t) == s, "pinned slot recycled or moved"
    for t in protected:
        assert t in store, "protected tenant left the store"
    for t in store.tenants:
        if t != BASE_TENANT:
            assert store.digest(t) == _lam_digest(_flat(_lam_tree(lam_val[t])))
            assert store.digest_refcount(store.digest(t)) >= 1
    tabs = {k: v.numpy() for k, v in store.tables.items()}
    for key, shape in SHAPES.items():
        np.testing.assert_array_equal(tabs[key][0], 0.0, err_msg="slot 0 mutated")
        for t, s in slots.items():
            if t != BASE_TENANT:
                np.testing.assert_array_equal(tabs[key][s], np.full(shape, lam_val[t], np.float32),
                                              err_msg=f"hot λ row of {t} diverged")
        for s in store._free:
            np.testing.assert_array_equal(tabs[key][s], 0.0)  # unused slots base-safe
        for t in store._cold:
            np.testing.assert_array_equal(store._cold[t][key],
                                          np.full(shape, lam_val[t], np.float32),
                                          err_msg=f"cold λ row of {t} diverged")


@settings(max_examples=12, deadline=None)
@given(seed=st.integers(0, 10_000), n_slots=st.integers(2, 6), cold_slots=st.integers(0, 4))
def test_lam_store_random_traffic_invariants(seed, n_slots, cold_slots):
    """Random traffic: slot 0 stays zero, pinned slots are never recycled,
    hot slots and the free list partition the table, the cold tier never
    exceeds its capacity, a protected tenant never leaves the store, and
    every resident tenant's λ and digest are what was last registered for
    it, bit for bit, in both tiers."""
    store = LamStore(SHAPES, n_slots=n_slots, cold_slots=cold_slots, device="cpu")
    names = [f"t{i}" for i in range(n_slots + cold_slots + 2)]
    _random_traffic(store, np.random.default_rng(seed), names, 50)


@pytest.mark.parametrize("seed,n_slots,cold_slots", [(6104, 3, 2), (11, 4, 3)])
def test_random_traffic_matches_the_reference_store(seed, n_slots, cold_slots):
    """The property's traffic through both stores at once (the reference
    store fails the reference's set-model of protection at seed 6104; it
    keeps a count, as the port does): every call returns alike and the
    two stores agree after each, λ rows bitwise."""
    s = Pair(SHAPES, n_slots=n_slots, cold_slots=cold_slots)

    class Both:  # the port store's surface, each call mirrored on the pair
        def __getattr__(self, name):
            if name in ("register", "pin", "unpin", "protect", "unprotect", "evict", "spill",
                        "promote"):
                return getattr(s, name)
            return getattr(s.t, name)

        def __contains__(self, tenant):
            return tenant in s.t

    names = [f"t{i}" for i in range(n_slots + cold_slots + 2)]
    _random_traffic(Both(), np.random.default_rng(seed), names, 60)


# ---------------------------------------------------------------------------
# sharded tables: spill → promote on a 2-rank gloo group, bitwise replicated
# ---------------------------------------------------------------------------

_RANK_SCRIPT = textwrap.dedent("""
    import json, sys
    import numpy as np
    import torch
    import torch.distributed as dist
    from repro_torch.serving import LamStore

    rank, world, store_path, out = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4]
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store_path}", rank=rank,
                            world_size=world)
    shapes = {("attn", "wq"): (3, 8), ("attn", "wv"): (3, 8)}

    def tree(i):
        r = np.random.default_rng(i)
        return {"attn": {p: r.standard_normal((3, 8)).astype(np.float32) for p in ("wq", "wv")}}

    def drive(store):
        for i in range(7):
            store.register(f"t{i}", tree(i))  # 3 hot slots: four spill
        store.pin("t6")
        store.promote("t0")
        store.promote_many(["t1", "t2"])
        store.spill_many(["t1"])
        store.register_many({"t7": tree(7), "t8": tree(8)})
        store.evict("t2")
        store.promote("t3")
        return {"slots": list(store._slots.items()), "cold": list(store._cold),
                "counters": [store.spills, store.promotes, store.slot_writes]}

    sharded = LamStore(shapes, n_slots=4, cold_slots=8, device="cpu", group=dist.group.WORLD)
    replicated = LamStore(shapes, n_slots=4, cold_slots=8, device="cpu")
    got, want = drive(sharded), drive(replicated)
    ok = got == want and sharded.n_local == 2
    for key, tab in sharded._tables.items():
        parts = [torch.empty_like(tab) for _ in range(world)]
        dist.all_gather(parts, tab)
        whole = torch.cat(parts, dim=-2)
        ok &= bool(torch.equal(whole, replicated._tables[key]))
    if rank == 0:
        json.dump({"ok": ok, "slots": got["slots"], "spills": got["counters"][0],
                   "promotes": got["counters"][1]}, open(out, "w"))
    dist.barrier()
    dist.destroy_process_group()
""")


def test_sharded_spill_promote_bitwise_replicated_on_two_ranks(tmp_path):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(ROOT / "src")
    out = tmp_path / "out.json"
    procs = [subprocess.Popen([sys.executable, "-c", _RANK_SCRIPT, str(r), "2",
                               str(tmp_path / "store"), str(out)], env=env, cwd=ROOT,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(2)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=240)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert all(p.returncode == 0 for p in procs), logs
    res = json.loads(out.read_text())
    assert res["ok"], res
    assert res["spills"] > 0 and res["promotes"] > 0
