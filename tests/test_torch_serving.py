"""Multi-tenant serving of the PyTorch port: the engine against the JAX
engine and against its own merged-weight reference, and the λ-store,
block allocator, scheduler and engine config against their reference
counterparts (reduced smollm-135m, float32, CPU)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced as jax_reduced
from repro.models import build_model as jax_build
from repro.serving import EngineConfig as JEngineConfig
from repro.serving import MultiTenantEngine as JEngine
from repro.serving import engine as jengine_mod
from repro.serving.lam_store import lam_digest as j_lam_digest
from repro.serving.paging import BlockAllocator as JBlockAllocator
from repro.serving.scheduler import ContinuousBatchScheduler as JScheduler
from repro_torch.configs import get_reduced
from repro_torch.interop import params_from_jax
from repro_torch.launch import serve_multi
from repro_torch.serving import (
    BASE_TENANT,
    BlockAllocator,
    ContinuousBatchScheduler,
    EngineConfig,
    LamStore,
    MultiTenantEngine,
    PoolExhausted,
    lam_digest,
    reference_decode,
)
from repro_torch.serving import config as tconfig
from repro_torch.serving import engine as tengine_mod

# Engine logits against the JAX engine and the merged-weight reference:
# float32 through 3 layers, two formulas for the adapter (fused multi-λ vs
# merged weight) — measured ~5e-6; tokens must match exactly.
LOGIT_TOL = 1e-4


@pytest.fixture(scope="module", autouse=True)
def _clear_jax_caches():
    """Leave no compiled JAX executables behind: the JAX engines here share
    jit caches with other test files in the same worker process (the
    λ-store's slot-write compile count in ``tests/test_lam_store.py``)."""
    yield
    jax.clear_caches()


# ---------------------------------------------------------------------------
# the engine, end to end
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def served():
    """One JAX engine run and one port engine run on the same params, λ and
    prompts, through a pool small enough to force block-pressure preemption."""
    jcfg = jax_reduced("smollm-135m").replace(dtype="float32")
    cfg = get_reduced("smollm-135m").replace(dtype="float32")
    jp = jax_build(jcfg).init(jax.random.PRNGKey(3))
    tp = params_from_jax(jax.tree_util.tree_map(np.asarray, jp), device="cpu")
    rng = np.random.default_rng(0)
    lam_shape = np.asarray(jp["groups"]["adapters"]["attn"]["wq"]["lam"]).shape
    lams = {
        f"t{i}": {"attn": {p: (rng.standard_normal(lam_shape) * 0.3).astype(np.float32)
                           for p in ("wq", "wv")}}
        for i in range(4)
    }
    reqs = [(f"t{i % 4}", rng.integers(2, 256, size=int(rng.integers(3, 30))).astype(np.int32),
             int(rng.integers(4, 14))) for i in range(6)]
    common = dict(n_lanes=3, n_slots=6, max_len=48, collect_logits=True, block_size=8,
                  n_blocks=9)
    jeng = JEngine(jcfg, JEngineConfig(telemetry=False, **common), params=jp)
    teng = MultiTenantEngine(cfg, EngineConfig(**common), params=tp, device="cpu")
    for t, lam in lams.items():
        jeng.add_tenant(t, jax.tree_util.tree_map(jnp.asarray, lam))
        teng.add_tenant(t, lam)
    for tenant, prompt, n in reqs:
        jeng.submit(tenant, prompt, n)
        teng.submit(tenant, prompt, n)
    return cfg, tp, lams, jeng, jeng.run(), teng, teng.run()


def test_engine_token_streams_match_jax_engine(served):
    _, _, _, jeng, jdone, teng, tdone = served
    assert sorted(jdone) == sorted(tdone) == list(range(6))
    for uid in jdone:
        assert tdone[uid].tokens == jdone[uid].tokens, f"request {uid}"
        np.testing.assert_allclose(np.stack(tdone[uid].logits), np.stack(jdone[uid].logits),
                                   atol=LOGIT_TOL)
    worst = max(np.abs(np.stack(tdone[u].logits) - np.stack(jdone[u].logits)).max()
                for u in jdone)
    print(f"[parity] engine vs JAX engine: {len(jdone)} requests, "
          f"{teng.preemptions} preemptions, logits max|Δ| {worst:.2e}")
    # the same schedule: steps, preemptions, pool high-water mark
    assert teng.preemptions == jeng.preemptions > 0
    assert teng.steps == jeng.steps
    assert teng.allocator.peak_in_use == jeng.allocator.peak_in_use
    assert teng.allocator.n_in_use == jeng.allocator.n_in_use == 0


def test_engine_matches_its_merged_weight_reference(served):
    cfg, tp, lams, _, _, teng, tdone = served
    for req in tdone.values():
        toks, logits = reference_decode(cfg, tp, lams[req.tenant], req.prompt,
                                        req.max_new_tokens, teng.max_len)
        assert req.tokens == toks
        np.testing.assert_allclose(np.stack(req.logits), logits, atol=LOGIT_TOL)


def test_engine_rejects_impossible_requests():
    cfg = get_reduced("smollm-135m").replace(dtype="float32")
    eng = MultiTenantEngine(cfg, EngineConfig(max_len=32, block_size=8, n_blocks=3),
                            device="cpu")
    with pytest.raises(KeyError):
        eng.submit("nobody", [1, 2, 3], 2)
    with pytest.raises(ValueError):  # longer than max_len
        eng.submit(BASE_TENANT, np.arange(30), 4)
    with pytest.raises(ValueError):  # needs 3 blocks, the pool has 2
        eng.submit(BASE_TENANT, np.arange(20), 4)


def test_serve_multi_driver_verifies_every_tenant():
    done = serve_multi.main(["--reduced", "--device", "cpu", "--tenants", "3", "--lanes", "2",
                             "--gen-len", "5", "--prompt-len", "9", "--max-len", "32"])
    assert len(done) == 3 and all(len(r.tokens) == 5 for r in done.values())


@pytest.mark.parametrize("floor", [8, 16])
def test_bucket_len_matches_jax(floor):
    for n in range(1, 140):
        assert tengine_mod._bucket_len(n, 128, floor) == jengine_mod._bucket_len(n, 128, floor)


# ---------------------------------------------------------------------------
# engine config
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kw", [dict(share_prefix=True), dict(prefill_chunk=32),
                                dict(watermark=1), dict(prefill_chunk=16, block_size=8)])
def test_engine_config_accepts_the_serving_fields(kw):
    for cls in (EngineConfig, JEngineConfig):
        c = cls(**kw)
        assert all(getattr(c, k) == v for k, v in kw.items())


# the reference's validation cases for these fields (tests/test_engine_config.py:35-47,
# and its cold-tier checks, repro/serving/config.py:132-135)
@pytest.mark.parametrize(
    "kw",
    [
        dict(layout="paged", prefill_chunk=24),  # not a block multiple
        dict(layout="paged", prefill_chunk=8),  # below one block
        dict(prefill_chunk=0),
        dict(watermark=-1),
        dict(layout="paged", speculate_k=2, prefill_chunk=16),  # verify vs chunk
        dict(cold_slots=-1),
        dict(cold_path="/x"),  # a cold file needs cold slots
    ],
    ids=lambda kw: ",".join(f"{k}={v}" for k, v in kw.items()),
)
def test_engine_config_rejects_incoherent_serving_fields(kw):
    with pytest.raises(ValueError):
        EngineConfig(**kw)
    with pytest.raises(ValueError):
        JEngineConfig(**kw)


def test_serving_preset_is_the_production_posture():
    """The port's copy of ``tests/test_engine_config.py:88``, field for
    field against the reference's preset."""
    cfg = EngineConfig.serving()
    assert cfg.layout == "paged" and cfg.share_prefix and cfg.watermark == 1
    assert cfg.prefill_chunk == 2 * cfg.block_size
    # the chunk budget tracks a block_size override unless pinned explicitly
    assert EngineConfig.serving(block_size=8).prefill_chunk == 16
    assert EngineConfig.serving(prefill_chunk=64).prefill_chunk == 64
    for kw in ({}, dict(block_size=8), dict(prefill_chunk=64, n_lanes=2)):
        mine, ref = EngineConfig.serving(**kw), JEngineConfig.serving(**kw)
        for f in ("layout", "share_prefix", "watermark", "prefill_chunk", "block_size",
                  "n_lanes", "max_len"):
            assert getattr(mine, f) == getattr(ref, f), (kw, f)


@pytest.mark.parametrize("field", ["shard_lam", "shard_ba"])
def test_engine_config_accepts_sharding(field):
    """Sharding is served (``tests/test_torch_sharding.py``), as in the
    reference's config."""
    assert getattr(EngineConfig(**{field: True}), field) is True
    assert getattr(JEngineConfig(**{field: True}), field) is True


@pytest.mark.parametrize("base_dtype", ["bf16", "int8", "fp8"])
def test_engine_config_accepts_base_dtypes(base_dtype):
    assert EngineConfig(base_dtype=base_dtype).base_dtype == base_dtype
    assert JEngineConfig(base_dtype=base_dtype).base_dtype == base_dtype


@pytest.mark.parametrize("base_dtype", ["int4", "float16", "BF16"])
def test_engine_config_rejects_unknown_base_dtypes(base_dtype):
    with pytest.raises(ValueError, match="base_dtype"):
        EngineConfig(base_dtype=base_dtype)
    with pytest.raises(ValueError, match="base_dtype"):
        JEngineConfig(base_dtype=base_dtype)


def test_engine_config_rejects_fp8_without_support(monkeypatch):
    monkeypatch.setattr(tconfig, "FP8_SUPPORTED", False)
    with pytest.raises(ValueError, match="float8_e4m3fn"):
        EngineConfig(base_dtype="fp8")
    assert EngineConfig(base_dtype="int8").base_dtype == "int8"


def test_model_config_validates_base_dtype():
    cfg = get_reduced("smollm-135m")
    assert cfg.base_dtype == "bf16" and cfg.replace(base_dtype="fp8").base_dtype == "fp8"
    with pytest.raises(ValueError, match="base_dtype"):
        cfg.replace(base_dtype="int4")


def test_engine_base_dtype_knob_wins_over_the_model_config():
    """The engine knob decides the deployment dtype; with the knob at bf16
    the model config's base_dtype applies; a quantized tree passes through."""
    from repro_torch.core.quantize import is_quantized

    cfg = get_reduced("smollm-135m").replace(dtype="float32", base_dtype="fp8")
    small = dict(n_lanes=1, n_slots=2, max_len=16)
    eng = MultiTenantEngine(cfg, EngineConfig(**small), device="cpu")
    assert eng.base_dtype == "fp8"
    assert eng.params["groups"]["attn"]["wq"]["q"].dtype == torch.float8_e4m3fn
    eng2 = MultiTenantEngine(cfg, EngineConfig(base_dtype="int8", **small), device="cpu")
    assert eng2.base_dtype == "int8" and eng2.params["groups"]["attn"]["wq"]["q"].dtype == torch.int8
    again = MultiTenantEngine(cfg, EngineConfig(base_dtype="int8", **small),
                              params=eng2.params, device="cpu")
    assert again.params["groups"]["attn"]["wq"] is eng2.params["groups"]["attn"]["wq"]
    assert not is_quantized(again.params["groups"]["attn"]["wk"])


@pytest.mark.parametrize("base_dtype", ["int8", "fp8"])
def test_serve_multi_verifies_a_quantized_base(base_dtype):
    done = serve_multi.main(["--reduced", "--device", "cpu", "--base-dtype", base_dtype,
                             "--tenants", "3", "--lanes", "2", "--gen-len", "5",
                             "--prompt-len", "9", "--max-len", "32"])
    assert len(done) == 3 and all(len(r.tokens) == 5 for r in done.values())


def test_engine_config_defaults_and_layout():
    c = EngineConfig()
    j = JEngineConfig()
    for f in ("layout", "n_lanes", "n_slots", "max_len", "block_size", "n_blocks",
              "watermark", "seed", "collect_logits"):
        assert getattr(c, f) == getattr(j, f), f
    assert c.resolved_layout("dense") == j.resolved_layout("dense") == "paged"
    dense = EngineConfig(layout="oracle_dense")
    assert dense.resolved_layout("dense") == JEngineConfig(
        layout="oracle_dense").resolved_layout("dense") == "oracle_dense"
    with pytest.raises(ValueError):
        EngineConfig(layout="sparse")
    with pytest.raises(ValueError):
        EngineConfig(n_lanes=0)


# ---------------------------------------------------------------------------
# λ-store
# ---------------------------------------------------------------------------

SHAPES = {("attn", "wq"): (3, 8), ("attn", "wv"): (3, 8)}


def _lam_tree(value):
    return {"attn": {p: np.full((3, 8), value, np.float32) for p in ("wq", "wv")}}


def test_lam_store_slot0_lru_and_pins():
    reg = LamStore(SHAPES, n_slots=3, device="cpu")  # slots 1, 2 usable
    assert BASE_TENANT in reg and reg.lookup(BASE_TENANT) == 0
    sa = reg.register("a", _lam_tree(1.0))
    sb = reg.register("b", _lam_tree(2.0))
    reg.lookup("a")  # b is now least recently used
    sc = reg.register("c", _lam_tree(3.0))
    assert "b" not in reg and sc == sb
    tab = reg.tables[("attn", "wq")]
    assert (tab[0] == 0).all() and (tab[sa] == 1).all() and (tab[sc] == 3).all()
    reg.pin("a")
    reg.pin("c")
    with pytest.raises(RuntimeError):
        reg.register("d", _lam_tree(4.0))  # everything pinned
    reg.unpin("c")
    assert reg.register("d", _lam_tree(4.0)) == sc
    with pytest.raises(ValueError):
        reg.register(BASE_TENANT, _lam_tree(1.0))


def test_lam_store_defaults_to_the_card():
    """A store built without a device puts its tables on ``cuda``, like every
    other entry point of the port; without a card that raises."""
    if torch.cuda.is_available():
        assert LamStore(SHAPES, n_slots=3).tables[("attn", "wq")].device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            LamStore(SHAPES, n_slots=3)


def test_lam_store_protect_is_a_count():
    """Two protects need two unprotects before the tenant can go (the
    reference store counts too; its property test models a set — ROADMAP
    Queue 3)."""
    reg = LamStore(SHAPES, n_slots=3, device="cpu")
    reg.register("a", _lam_tree(1.0))
    reg.protect("a")
    reg.protect("a")
    reg.unprotect("a")
    with pytest.raises(RuntimeError):
        reg.evict("a")
    reg.unprotect("a")
    reg.evict("a")
    assert "a" not in reg and (reg.tables[("attn", "wq")][1:] == 0).all()


def test_lam_store_hot_swap_install_and_digest():
    reg = LamStore(SHAPES, n_slots=3, device="cpu")
    s = reg.register("a", _lam_tree(1.0))
    assert reg.register("a", _lam_tree(9.0)) == s  # hot-swap in place
    assert (reg.tables[("attn", "wv")][s] == 9).all()
    assert reg.digest("a") == lam_digest(_lam_tree(9.0))
    # the same digest bytes as the reference for the same λ values
    assert lam_digest(_lam_tree(9.0)) == j_lam_digest(_lam_tree(9.0))
    params = {"embed": torch.zeros(1), "groups": {"adapters": {"attn": {
        p: {"B": torch.ones(3, 4, 8), "A": torch.ones(3, 8, 5), "lam": torch.zeros(3, 8)}
        for p in ("wq", "wv")}}}}
    view = reg.install(params)
    leaf = view["groups"]["adapters"]["attn"]["wq"]
    assert leaf["lam"].shape == (3, 3, 8) and leaf["B"] is params["groups"]["adapters"]["attn"]["wq"]["B"]
    assert (leaf["lam"][:, s] == 9).all()
    assert reg.install(params) is view  # one view per params object
    reg.pin("a")
    with pytest.raises(RuntimeError):
        reg.register("a", _lam_tree(2.0))  # no hot-swap under an in-flight request


# ---------------------------------------------------------------------------
# block allocator and scheduler: the same traffic through both packages
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", range(3))
def test_block_allocator_matches_reference_under_random_traffic(seed):
    rng = np.random.default_rng(seed)
    mine, ref = BlockAllocator(9, 4), JBlockAllocator(9, 4)
    held = []
    for _ in range(200):
        if held and rng.random() < 0.5:
            b = held.pop(int(rng.integers(len(held))))
            assert mine.decref(b) == ref.decref(b)
        else:
            n = int(rng.integers(0, 4))
            if n > mine.n_free:
                with pytest.raises(PoolExhausted):
                    mine.alloc(n)
                continue
            ids = mine.alloc(n)
            assert ids == ref.alloc(n) and 0 not in ids
            held += ids
        assert (mine.n_free, mine.n_in_use, mine.peak_in_use) == (
            ref.n_free, ref.n_in_use, ref.peak_in_use)
    for b in held:
        mine.decref(b)
    with pytest.raises(ValueError):
        mine.decref(held[0] if held else 1)  # double free
    with pytest.raises(ValueError):
        mine.decref(0)  # trash block


def test_scheduler_matches_reference():
    mine, ref = ContinuousBatchScheduler(2), JScheduler(2)
    for s in (mine, ref):
        for i in range(4):
            s.submit(f"t{i}", np.arange(3 + i), 2)
    gate = lambda r: r.prompt.size != 4  # refuses the second request
    a, b = mine.admit(gate), ref.admit(gate)
    assert [r.uid for r in a] == [r.uid for r in b] == [0]
    a[0].slot, b[0].slot = 5, 5
    assert (mine.batch_composition() == ref.batch_composition()).all()
    a[0].tokens.append(7)
    mine.preempt(a[0])
    ref.preempt(b[0])
    assert [r.uid for r in mine.queue] == [r.uid for r in ref.queue] == [0, 1, 2, 3]
    assert a[0].tokens == [] and a[0].preemptions == 1
    assert [r.uid for r in mine.admit()] == [r.uid for r in ref.admit()] == [0, 1]
    assert mine.has_work and not mine.free_lanes()
