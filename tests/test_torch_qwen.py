"""The dense family's two attention options (QKV bias, QK-norm) and the
three qwen configs of the PyTorch port against the JAX reference: weights
initialised in JAX with random nonzero biases and norm scales (the
reference initialises them to zeros and ones, which a port that dropped them
would pass), crossed with ``repro_torch.interop``; float32 on the CPU.

Bounds: attention output and logits 2e-5 absolute (as for smollm-135m in
``test_torch_models.py``: the same float32 arithmetic in another summation
order, measured ~2e-6); prefill-then-decode against the full forward
3e-5 of the largest |logit| (``tests/test_decode_consistency.py``'s bound);
engine logits 1e-4 with identical tokens (``test_torch_serving.py``'s)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.configs import get_reduced as jax_reduced
from repro.models import attention as jattn
from repro.models import build_model as jax_build
from repro.serving import EngineConfig as JEngineConfig
from repro.serving import MultiTenantEngine as JEngine
from repro_torch.configs import get_config, get_reduced
from repro_torch.interop import params_from_jax
from repro_torch.models import attention as tattn
from repro_torch.models import build_model
from repro_torch.serving import EngineConfig, MultiTenantEngine, reference_decode

ATOL = 2e-5
ENGINE_LOGIT_TOL = 1e-4
QWEN = ["qwen2-0.5b", "qwen3-14b", "qwen2.5-32b"]
_NEW_LEAVES = ("bq", "bk", "bv", "q_norm", "k_norm")


@pytest.fixture(scope="module", autouse=True)
def _clear_jax_caches():
    yield
    jax.clear_caches()


def _perturb(attn: dict, rng) -> None:
    """Random nonzero biases (around 0) and norm scales (around 1), in place."""
    for name in _NEW_LEAVES:
        if name in attn:
            noise = rng.standard_normal(attn[name].shape).astype(np.float32)
            attn[name] = (noise * 0.5 + (1.0 if "norm" in name else 0.0)).astype(np.float32)


def _jax_params(arch: str, seed: int = 1):
    """Reduced float32 JAX params (numpy leaves) with perturbed new leaves."""
    jcfg = jax_reduced(arch).replace(dtype="float32")
    params = jax.tree_util.tree_map(np.asarray, jax_build(jcfg).init(jax.random.PRNGKey(seed)))
    _perturb(params["groups"]["attn"], np.random.default_rng(seed))
    return jcfg, params


def _tokens(shape, seed=0, vocab=256):
    return np.random.default_rng(seed).integers(2, vocab, size=shape).astype(np.int32)


# ---------------------------------------------------------------------------
# configs and interop
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", QWEN)
def test_configs_are_the_reference_numbers(arch):
    for mine, ref in ((get_config(arch), jax_config(arch)), (get_reduced(arch), jax_reduced(arch))):
        for f in ("name", "family", "n_layers", "d_model", "n_heads", "n_kv_heads", "d_ff",
                  "vocab_size", "d_head", "qkv_bias", "qk_norm", "rope_theta", "norm_eps",
                  "dtype", "microbatches"):
            assert getattr(mine, f) == getattr(ref, f), f
        assert mine.adapter == type(mine.adapter)(**{
            k: getattr(ref.adapter, k) for k in mine.adapter.__dataclass_fields__})


@pytest.mark.parametrize("name", ["qwen2.5-32b", "qwen2_5_32b", "qwen2_5-32b", "qwen2-0.5b",
                                  "qwen2_0_5b", "qwen3_14b", "smollm_135m"])
def test_names_resolve_as_the_reference_registry(name):
    assert get_config(name).name == jax_config(name).name
    assert get_reduced(name).name == jax_reduced(name).name


def test_unknown_arch_is_refused():
    with pytest.raises(NotImplementedError, match="the port has"):
        get_config("xlstm-125m")


@pytest.mark.parametrize("arch", QWEN)
def test_interop_crosses_the_new_leaves(arch):
    jcfg, jp = _jax_params(arch)
    tp = params_from_jax(jp, device="cpu")
    want = {n for n in _NEW_LEAVES if n in jp["groups"]["attn"]}
    assert want == ({"bq", "bk", "bv"} if jcfg.qkv_bias else set()) | (
        {"q_norm", "k_norm"} if jcfg.qk_norm else set())
    assert want, "a qwen config without either option"
    for name in want:
        got, ref = tp["groups"]["attn"][name], jp["groups"]["attn"][name]
        assert tuple(got.shape) == ref.shape and got.dtype == torch.float32
        np.testing.assert_array_equal(got.numpy(), ref)
    # the port's own init makes the same leaves, zeros and ones, stacked
    tparams = build_model(get_reduced(arch), "cpu").init(torch.Generator().manual_seed(0))
    attn = tparams["groups"]["attn"]
    assert {n for n in _NEW_LEAVES if n in attn} == want
    for name in want:
        assert tuple(attn[name].shape) == jp["groups"]["attn"][name].shape
        assert bool((attn[name] == (1.0 if "norm" in name else 0.0)).all())


# ---------------------------------------------------------------------------
# the attention options
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ["qwen2-0.5b", "qwen3-14b"])
def test_attention_with_bias_or_qk_norm_matches_jax(arch):
    """One layer's attention over a causal sequence, the new leaves random:
    the port matches the JAX ``attention``; the same leaves set back to
    their init values move the output by far more than the bound."""
    jcfg = jax_reduced(arch).replace(dtype="float32")
    cfg = get_reduced(arch).replace(dtype="float32")
    p = jax.tree_util.tree_map(
        lambda a: np.asarray(a)[0],
        jattn.init_attn_params(jax.random.PRNGKey(4), jcfg, 1, jnp.float32))
    _perturb(p, np.random.default_rng(2))
    x = np.random.default_rng(3).standard_normal((2, 9, jcfg.d_model)).astype(np.float32)
    pos = np.arange(9, dtype=np.int32)
    want, _ = jattn.attention(jax.tree_util.tree_map(jnp.asarray, p), jnp.asarray(x), jcfg,
                              positions=jnp.asarray(pos))
    tp = params_from_jax(p, device="cpu")
    got = tattn.attention(tp, torch.from_numpy(x), cfg, positions=torch.from_numpy(pos))
    err = np.abs(got.numpy() - np.asarray(want)).max()
    print(f"[parity] {arch} attention: max|Δ| {err:.2e}")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)
    plain = {k: (torch.ones_like(v) if "norm" in k else torch.zeros_like(v))
             if k in _NEW_LEAVES else v for k, v in tp.items()}
    moved = (tattn.attention(plain, torch.from_numpy(x), cfg, positions=torch.from_numpy(pos))
             - got).abs().max()
    assert moved > 100 * ATOL, f"the options move the output by only {moved:.2e}"


# ---------------------------------------------------------------------------
# the model: logits, prefill-then-decode
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", QWEN)
def test_apply_logits_match_jax(arch):
    jcfg, jp = _jax_params(arch)
    toks = _tokens((2, 11))
    want, _ = jax_build(jcfg).apply(jax.tree_util.tree_map(jnp.asarray, jp),
                                    tokens=jnp.asarray(toks), train=False)
    got = build_model(get_reduced(arch).replace(dtype="float32"), "cpu").apply(
        params_from_jax(jp, device="cpu"), torch.from_numpy(toks))
    err = np.abs(got.numpy() - np.asarray(want)).max()
    print(f"[parity] {arch} apply logits: max|Δ| {err:.2e}")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


@pytest.mark.parametrize("arch", QWEN)
def test_prefill_then_decode_matches_full_forward(arch):
    """The port's copy of ``tests/test_decode_consistency.py:27`` for the
    qwen cases (new leaves random): prefill S-1 tokens and decode the last
    one through the lock-step dense cache, against the full forward."""
    _, jp = _jax_params(arch, seed=0)
    m = build_model(get_reduced(arch).replace(dtype="float32"), "cpu")
    params = params_from_jax(jp, device="cpu")
    B, S = 2, 12
    toks = torch.from_numpy(_tokens((B, S), seed=1))
    full = m.apply(params, toks)
    cache = m.init_decode_state(B, 32, torch.float32)
    lg_pre, cache = m.prefill(params, cache, toks[:, : S - 1])
    lg_dec, cache = m.decode_step(params, cache, toks[:, S - 1:])
    atol = 3e-5 * max(float(full.abs().max()), 1.0)
    np.testing.assert_allclose(lg_pre.numpy(), full[:, S - 2].numpy(), atol=atol)
    np.testing.assert_allclose(lg_dec.numpy(), full[:, S - 1].numpy(), atol=atol)


# ---------------------------------------------------------------------------
# the engine on reduced qwen2-0.5b
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def served_qwen():
    """A copy of ``test_torch_serving.py``'s ``served`` on reduced
    qwen2-0.5b with random biases: one JAX engine run and one port engine
    run, a pool small enough to force preemption."""
    jcfg, jp = _jax_params("qwen2-0.5b", seed=3)
    cfg = get_reduced("qwen2-0.5b").replace(dtype="float32")
    tp = params_from_jax(jp, device="cpu")
    rng = np.random.default_rng(0)
    lam_shape = jp["groups"]["adapters"]["attn"]["wq"]["lam"].shape
    lams = {f"t{i}": {"attn": {p: (rng.standard_normal(lam_shape) * 0.3).astype(np.float32)
                               for p in ("wq", "wv")}} for i in range(4)}
    reqs = [(f"t{i % 4}", rng.integers(2, 256, size=int(rng.integers(3, 30))).astype(np.int32),
             int(rng.integers(4, 14))) for i in range(6)]
    common = dict(n_lanes=3, n_slots=6, max_len=48, collect_logits=True, block_size=8,
                  n_blocks=9)
    jeng = JEngine(jcfg, JEngineConfig(telemetry=False, **common),
                   params=jax.tree_util.tree_map(jnp.asarray, jp))
    teng = MultiTenantEngine(cfg, EngineConfig(**common), params=tp, device="cpu")
    for t, lam in lams.items():
        jeng.add_tenant(t, jax.tree_util.tree_map(jnp.asarray, lam))
        teng.add_tenant(t, lam)
    for tenant, prompt, n in reqs:
        jeng.submit(tenant, prompt, n)
        teng.submit(tenant, prompt, n)
    return cfg, tp, lams, jeng, jeng.run(), teng, teng.run()


def test_engine_token_streams_match_jax_engine(served_qwen):
    _, _, _, jeng, jdone, teng, tdone = served_qwen
    assert sorted(jdone) == sorted(tdone) == list(range(6))
    for uid in jdone:
        assert tdone[uid].tokens == jdone[uid].tokens, f"request {uid}"
        np.testing.assert_allclose(np.stack(tdone[uid].logits), np.stack(jdone[uid].logits),
                                   atol=ENGINE_LOGIT_TOL)
    worst = max(np.abs(np.stack(tdone[u].logits) - np.stack(jdone[u].logits)).max()
                for u in jdone)
    print(f"[parity] qwen2-0.5b engine vs JAX engine: logits max|Δ| {worst:.2e}, "
          f"{teng.preemptions} preemptions")
    assert teng.preemptions == jeng.preemptions > 0
    assert teng.steps == jeng.steps
    assert teng.allocator.peak_in_use == jeng.allocator.peak_in_use
    assert teng.allocator.n_in_use == jeng.allocator.n_in_use == 0


def test_engine_matches_its_merged_weight_reference(served_qwen):
    cfg, tp, lams, _, _, teng, tdone = served_qwen
    for req in tdone.values():
        toks, logits = reference_decode(cfg, tp, lams[req.tenant], req.prompt,
                                        req.max_new_tokens, teng.max_len)
        assert req.tokens == toks
        np.testing.assert_allclose(np.stack(req.logits), logits, atol=ENGINE_LOGIT_TOL)
