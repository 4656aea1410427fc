"""The quantized frozen base of the PyTorch port against the JAX package
(``repro/core/quantize.py`` and its kernels), on the CPU at reduced size.

* ``quantize_weight`` gives q and scale bit-identical to JAX's, int8 and
  fp8-e4m3, on inputs with an all-zero column, tied amax, exact halves
  (round-half-even) and values near ±448; quantized trees cross from JAX
  leaf for leaf (fp8 by bit pattern).
* The plain versions of the two quantized kernels against the reference's
  jitted oracles and its Pallas kernels in interpret mode, at the
  reference's single-k-block shapes with bf16 factors: float32 within 1e-6
  of the largest |y| (summation order), bfloat16 within one bf16 ulp.
* ``Model.apply`` on a quantized tree with one λ against JAX's (2e-5), the
  int8 and fp8 engines against the JAX engine with the same config
  (identical streams, schedule and preemptions; logits 1e-4), and the
  reference's documented int8 ε contract.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _hypothesis_compat import given, settings, st

from repro.configs import get_reduced as jax_reduced
from repro.core import quantize as jq
from repro.kernels import ref as jref
from repro.kernels.qrlora_bgmv import qrlora_bgmv_quant_kernel
from repro.kernels.qrlora_matmul import qrlora_matmul_quant_kernel
from repro.models import build_model as jax_build
from repro.serving import EngineConfig as JEngineConfig
from repro.serving import MultiTenantEngine as JEngine
from repro_torch import kernels
from repro_torch.configs import get_reduced
from repro_torch.core import adapter_api as tadp
from repro_torch.core import quantize as tq
from repro_torch.interop import params_from_jax
from repro_torch.kernels import ops
from repro_torch.kernels import qrlora_bgmv as tbgmv
from repro_torch.kernels import qrlora_matmul as tmm
from repro_torch.kernels import ref as tref
from repro_torch.models import build_model
from repro_torch.serving import EngineConfig, MultiTenantEngine, reference_decode

QUANT = ["int8", "fp8"]
# the reference's single-k-block shapes (tests/test_quantize.py)
M, K, N, R = 8, 256, 128, 16
BLK = dict(bm=8, bn=128, bk=256)
MODEL_ATOL = 2e-5  # float32 logits through 3 layers in another summation order
ENGINE_TOL = 1e-4  # the unquantized engine parity bound (test_torch_serving.py)


def _bits(t: torch.Tensor) -> np.ndarray:
    return t.view(torch.uint8 if t.element_size() == 1 else torch.int32).numpy()


def _jbits(a) -> np.ndarray:
    a = np.asarray(a)
    return a.view(np.uint8 if a.dtype.itemsize == 1 else np.int32)


@pytest.fixture(scope="module", autouse=True)
def _clear_jax_caches():
    """Leave no compiled JAX executables behind: the JAX engines here share
    jit caches with other test files in the same worker process (the
    λ-store's slot-write compile count in ``tests/test_lam_store.py``)."""
    yield
    jax.clear_caches()


# ---------------------------------------------------------------------------
# quantize_weight: bit-identical to JAX
# ---------------------------------------------------------------------------


def _edge_weight(base_dtype, seed):
    """(2, 64, 12) weights whose columns hit the edge cases: all zero, tied
    amax, entries landing on exact halves of the grid, values near ±Q."""
    rng = np.random.default_rng(seed)
    W = (rng.standard_normal((2, 64, 12)) * 10.0 ** rng.uniform(-3, 3, size=(1, 1, 12)))
    W = W.astype(np.float32)
    W[:, :, 0] = 0.0  # all zero: scale 1, q 0
    W[:, 3, 1] = W[:, 9, 1] = np.abs(W[:, :, 1]).max(axis=-1) * 1.5  # tied amax
    W[:, 10, 1] *= -1
    qmax = 127.0 if base_dtype == "int8" else 448.0
    W[:, :, 2] = rng.integers(-40, 40, size=(2, 64)) + 0.5  # halves, scale → 1 below
    W[:, 0, 2] = qmax
    if base_dtype == "int8":
        W[:, 1:6, 3] = [[126.5, -126.5, 0.5, -1.5, 2.5]] * 2
        W[:, 0, 3] = 127.0
    else:  # e4m3 near the top: 432 ties 416/448, 400 ties 384/416, tiny → subnormal
        W[:, 1:7, 3] = [[432.0, -432.0, 400.0, 447.9, -440.0, 1e-3]] * 2
        W[:, 0, 3] = 448.0
    return W


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("base_dtype", QUANT)
def test_quantize_weight_bit_identical_to_jax(base_dtype, seed):
    W = _edge_weight(base_dtype, seed)
    want = jq.quantize_weight(jnp.asarray(W), base_dtype)
    got = tq.quantize_weight(torch.from_numpy(W), base_dtype)
    assert got["q"].dtype == (torch.int8 if base_dtype == "int8" else tq.FP8_DTYPE)
    np.testing.assert_array_equal(_bits(got["q"]), _jbits(want["q"]))
    np.testing.assert_array_equal(_bits(got["scale"]), _jbits(want["scale"]))
    assert float(got["scale"][0, 0]) == 1.0 and not got["q"][:, :, 0].float().any()
    # dequantization too, bit for bit
    np.testing.assert_array_equal(
        tq.dequantize_weight(got).numpy(), np.asarray(jq.dequantize_weight(want)))
    with pytest.raises(ValueError, match="not quantized"):
        tq.quantize_weight(torch.from_numpy(W), "bf16")


@given(seed=st.integers(0, 50), log_mag=st.floats(-3.0, 3.0))
@settings(max_examples=25, deadline=None)
def test_int8_round_trip_error_bounded(seed, log_mag):
    """|W − dequant(quantize(W))| ≤ scale/2 per entry, at any magnitude."""
    W = torch.from_numpy(
        np.random.default_rng(seed).standard_normal((32, 24)).astype(np.float32)
        * np.float32(10.0 ** log_mag))
    qW = tq.quantize_weight(W, "int8")
    assert qW["q"].dtype == torch.int8 and qW["scale"].shape == (24,)
    err = (W - tq.dequantize_weight(qW)).abs()
    assert bool((err <= tq.quantization_error_bound(qW) + 1e-12).all())


def test_fp8_round_trip_error_bounded():
    """fp8-e4m3: ≤ 1/16 relative per entry for normals; entries tiny
    against the channel amax (subnormal after scaling) within one scale."""
    W = torch.from_numpy(np.random.default_rng(7).standard_normal((64, 48)).astype(np.float32))
    qW = tq.quantize_weight(W, "fp8")
    err = (W - tq.dequantize_weight(qW)).abs()
    rel = err / W.abs().clamp_min(1e-6)
    assert bool(((rel <= 1.0 / 16 + 1e-6) | (err <= qW["scale"][None, :])).all())


@pytest.mark.parametrize("base_dtype", QUANT)
def test_quantized_trees_cross_from_jax_leaf_for_leaf(base_dtype):
    """A JAX-quantized {q, scale} tree crosses through params_from_jax: fp8
    by its 8-bit pattern, int8 as it is."""
    W = np.random.default_rng(3).standard_normal((3, 16, 8)).astype(np.float32)
    qW = jax.tree_util.tree_map(np.asarray, jq.quantize_weight(jnp.asarray(W), base_dtype))
    got = params_from_jax({"attn": {"wq": qW}}, device="cpu")["attn"]["wq"]
    assert got["q"].dtype == (torch.int8 if base_dtype == "int8" else torch.float8_e4m3fn)
    np.testing.assert_array_equal(got["q"].view(torch.uint8).numpy(), qW["q"].view(np.uint8))
    np.testing.assert_array_equal(got["scale"].numpy(), qW["scale"])


# ---------------------------------------------------------------------------
# params trees
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def jax_params():
    jcfg = jax_reduced("smollm-135m").replace(dtype="float32")
    return jcfg, jax_build(jcfg).init(jax.random.PRNGKey(1))


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.mark.parametrize("base_dtype", QUANT)
def test_quantize_base_params_matches_jax(jax_params, base_dtype):
    _, jp = jax_params
    tp = params_from_jax(_np(jp), device="cpu")
    qp = tq.quantize_base_params(tp, base_dtype)
    want = jq.quantize_base_params(jp, base_dtype)
    attn, mlp = qp["groups"]["attn"], qp["groups"]["mlp"]
    for proj in ("wq", "wk", "wv", "wo"):  # only the adapted projections
        assert tq.is_quantized(attn[proj]) == (proj in ("wq", "wv")), proj
        assert tq.is_quantized(want["groups"]["attn"][proj]) == tq.is_quantized(attn[proj])
    assert not any(tq.is_quantized(w) for w in mlp.values())
    for proj in ("wq", "wv"):
        np.testing.assert_array_equal(_bits(attn[proj]["q"]),
                                      _jbits(want["groups"]["attn"][proj]["q"]))
        np.testing.assert_array_equal(attn[proj]["scale"].numpy(),
                                      np.asarray(want["groups"]["attn"][proj]["scale"]))
    # adapters, norms and embeddings stay plain tensors, the same objects
    assert qp["groups"]["adapters"] is tp["groups"]["adapters"] and qp["embed"] is tp["embed"]
    # idempotent, leaf for leaf, and the identity for bf16
    again = tq.quantize_base_params(qp, base_dtype)
    assert again["groups"]["attn"]["wq"]["q"] is attn["wq"]["q"]
    assert again["groups"]["attn"]["wv"] is attn["wv"]
    assert tq.quantize_base_params(tp, "bf16") is tp
    with pytest.raises(ValueError):
        tq.quantize_base_params(tp, "int4")
    assert tq.resident_base_bytes(qp) == jq.resident_base_bytes(want)
    qb, fb = tq.resident_base_bytes(qp)
    assert 0 < qb < fb and tq.resident_base_bytes(tp) == (0, 0)


# ---------------------------------------------------------------------------
# the plain versions against the reference's oracles and Pallas kernels
# ---------------------------------------------------------------------------


def _operands(base_dtype, x_dtype, seed=0, n_slots=4):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((M, K)) * 0.3).astype(np.float32)
    W = (rng.standard_normal((K, N)) * 0.05).astype(np.float32)
    B = (rng.standard_normal((K, R)) * 0.05).astype(np.float32)
    A = (rng.standard_normal((R, N)) * 0.05).astype(np.float32)
    lam = rng.standard_normal((R,)).astype(np.float32)
    tab = rng.standard_normal((n_slots, R)).astype(np.float32)
    tab[0] = 0.0
    seg = (np.arange(M) % n_slots).astype(np.int32)  # every slot, 0 included
    jdt = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[x_dtype]
    jqW = jq.quantize_weight(jnp.asarray(W), base_dtype)
    j = dict(x=jnp.asarray(x, jdt), q=jqW["q"], ws=jqW["scale"], B=jnp.asarray(B, jnp.bfloat16),
             A=jnp.asarray(A, jnp.bfloat16), lam=jnp.asarray(lam), tab=jnp.asarray(tab),
             seg=jnp.asarray(seg))
    t = params_from_jax(_np(j), device="cpu")
    return j, t


def _assert_close(got: torch.Tensor, want, x_dtype, what):
    want = np.asarray(want.astype(jnp.float32))
    got = got.float().numpy()
    err = float(np.abs(got - want).max())
    if x_dtype == "float32":
        bound = 1e-6 * float(np.abs(want).max())
        assert err <= bound, (what, err, bound)
    else:  # one bf16 ulp of each entry
        ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(want), 1e-30))) - 7)
        assert (np.abs(got - want) <= ulp).all(), (what, err)
    print(f"[parity] {what}: max|Δ| {err:.2e}")


@pytest.mark.parametrize("x_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("base_dtype", QUANT)
def test_matmul_quant_plain_matches_jax_oracle_and_kernel(base_dtype, x_dtype):
    j, t = _operands(base_dtype, x_dtype)
    got = tref.qrlora_matmul_quant_ref(t["x"], t["q"], t["ws"], t["B"], t["A"], t["lam"], 0.5)
    assert got.dtype == t["x"].dtype and got.shape == (M, N)
    oracle = jax.jit(jref.qrlora_matmul_quant_ref, static_argnames="scale")(
        j["x"], j["q"], j["ws"], j["B"], j["A"], j["lam"], scale=0.5)
    kernel = qrlora_matmul_quant_kernel(j["x"], j["q"], j["ws"], j["B"], j["A"], j["lam"],
                                        scale=0.5, interpret=True, **BLK)
    _assert_close(got, oracle, x_dtype, f"matmul_quant {base_dtype} {x_dtype} vs oracle")
    _assert_close(got, kernel, x_dtype, f"matmul_quant {base_dtype} {x_dtype} vs Pallas")


@pytest.mark.parametrize("x_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("base_dtype", QUANT)
def test_bgmv_quant_plain_matches_jax_oracle_and_kernel(base_dtype, x_dtype):
    j, t = _operands(base_dtype, x_dtype, seed=1)
    got = tref.qrlora_bgmv_quant_ref(t["x"], t["q"], t["ws"], t["B"], t["A"], t["tab"],
                                     t["seg"], 0.5)
    oracle = jax.jit(jref.qrlora_bgmv_quant_ref, static_argnames="scale")(
        j["x"], j["q"], j["ws"], j["B"], j["A"], j["tab"], j["seg"], scale=0.5)
    kernel = qrlora_bgmv_quant_kernel(j["x"], j["q"], j["ws"], j["B"], j["A"], j["tab"],
                                      j["seg"][:, None], scale=0.5, interpret=True, **BLK)
    _assert_close(got, oracle, x_dtype, f"bgmv_quant {base_dtype} {x_dtype} vs oracle")
    _assert_close(got, kernel, x_dtype, f"bgmv_quant {base_dtype} {x_dtype} vs Pallas")


def test_quant_epilogue_scales_only_the_base_term():
    """Multiply, then add: the dequant scale multiplies x·q, never the
    adapter term, and is rounded before the add."""
    _, t = _operands("int8", "float32")
    x, q, ws, B, A, lam = (t[k] for k in ("x", "q", "ws", "B", "A", "lam"))
    y = tref.qrlora_matmul_quant_ref(x, q, ws, B, A, lam, 0.5)
    base = (x @ q.float()) * ws
    low = ((x @ B.float()) * lam) @ A.float()
    assert torch.equal(y, base + low * 0.5)
    assert not torch.allclose(y, (x @ q.float() + low * 0.5) * ws, atol=1e-4)


def test_ops_quant_dispatch_seg_rows_and_no_fallback():
    """Per-sequence seg ids repeat to per-row ids; CPU tensors take the
    plain versions (no launch), a tensor on another device is refused."""
    _, t = _operands("fp8", "float32")
    x3 = t["x"].reshape(2, 4, K)
    seg = torch.tensor([1, 3], dtype=torch.int32)
    kernels.reset_launch_counts()
    got = ops.qrlora_bgmv_quant(x3, t["q"], t["ws"], t["B"], t["A"], t["tab"], seg)
    want = tref.qrlora_bgmv_quant_ref(t["x"], t["q"], t["ws"], t["B"], t["A"], t["tab"],
                                      seg.repeat_interleave(4))
    assert torch.equal(got.reshape(M, N), want)
    y3 = ops.qrlora_matmul_quant(x3, t["q"], t["ws"], t["B"], t["A"], t["lam"])
    assert y3.shape == (2, 4, N)
    assert kernels.launch_counts() == {name: 0 for name in kernels.KERNEL_WRAPPERS}
    meta = {k: v.to("meta") for k, v in t.items()}
    with pytest.raises(NotImplementedError):
        tbgmv.qrlora_bgmv_quant(meta["x"], meta["q"], meta["ws"], meta["B"], meta["A"],
                                meta["tab"], meta["seg"])
    with pytest.raises(NotImplementedError):
        tmm.qrlora_matmul_quant(meta["x"], meta["q"], meta["ws"], meta["B"], meta["A"],
                                meta["lam"])


def test_quant_kernel_wrappers_validate_before_launching():
    _, t = _operands("int8", "bfloat16")
    x, q, ws, B, A, lam, tab, seg = (t[k] for k in ("x", "q", "ws", "B", "A", "lam", "tab", "seg"))
    with pytest.raises(TypeError):  # W must be quantized
        tbgmv.qrlora_bgmv_quant_cuda(x, q.float(), ws, B, A, tab, seg)
    with pytest.raises(TypeError):  # the scale is float32
        tbgmv.qrlora_bgmv_quant_cuda(x, q, ws.bfloat16(), B, A, tab, seg)
    with pytest.raises(ValueError):  # one scale per output column
        tbgmv.qrlora_bgmv_quant_cuda(x, q, ws[:-1], B, A, tab, seg)
    with pytest.raises(TypeError):  # the QR factors are bf16
        tmm.qrlora_matmul_quant_cuda(x, q, ws, B.float(), A, lam)
    with pytest.raises(ValueError):  # TMA reads q rows of 16-byte multiples
        tmm.qrlora_matmul_quant_cuda(x[:, :248].contiguous(), q[:248].contiguous(), ws,
                                     B[:248].contiguous(), A, lam)
    with pytest.raises(ValueError):  # ... from 16-byte aligned addresses
        shifted = torch.zeros(K * N + 1, dtype=torch.int8)[1:].view(K, N)
        tmm.qrlora_matmul_quant_cuda(x, shifted, ws, B, A, lam)
    assert kernels.launch_counts()["qrlora_matmul_quant"] == 0


def test_quant_forward_refuses_autograd():
    """The quantized one-λ matmul is forward only: asked for a gradient it
    raises, it does not detach."""
    _, t = _operands("int8", "float32")
    lam = t["lam"].clone().requires_grad_(True)
    with pytest.raises(NotImplementedError, match="forward only"):
        ops.qrlora_matmul_quant(t["x"], t["q"], t["ws"], t["B"], t["A"], lam)
    with pytest.raises(NotImplementedError, match="forward only"):
        tadp.adapted_matmul(t["x"].clone().requires_grad_(True),
                            {"q": t["q"], "scale": t["ws"]},
                            {"B": t["B"], "A": t["A"], "lam": t["lam"]})
    with torch.no_grad():
        ops.qrlora_matmul_quant(t["x"], t["q"], t["ws"], t["B"], t["A"], lam)


@pytest.mark.parametrize("base_dtype", QUANT)
def test_adapted_matmul_quant_branches_and_merge_match_jax(base_dtype):
    """The three branches of adapted_matmul on a quantized W (no adapter,
    seg, one λ) and the dequantizing merge against the reference's."""
    from repro.core import adapter_api as jadp

    j, t = _operands(base_dtype, "float32", seed=2)
    jW, tW = {"q": j["q"], "scale": j["ws"]}, {"q": t["q"], "scale": t["ws"]}
    cases = [
        (None, None),
        ({"B": j["B"], "A": j["A"], "lam": j["tab"], "seg": j["seg"]},
         {"B": t["B"], "A": t["A"], "lam": t["tab"], "seg": t["seg"]}),
        ({"B": j["B"], "A": j["A"], "lam": j["lam"]}, {"B": t["B"], "A": t["A"], "lam": t["lam"]}),
    ]
    for jadp_, tadp_ in cases:
        want = jadp.adapted_matmul(j["x"], jW, jadp_)
        got = tadp.adapted_matmul(t["x"], tW, tadp_)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)
    adp_j, adp_t = cases[2]
    merged = tadp.merge_adapter(tW, adp_t)
    assert merged.dtype == torch.bfloat16  # dequantized to the factors' dtype
    np.testing.assert_array_equal(
        merged.float().numpy(), np.asarray(jadp.merge_adapter(jW, adp_j).astype(jnp.float32)))
    assert tadp.merge_adapter(tW, None).dtype == torch.float32


# ---------------------------------------------------------------------------
# the model and the engine
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("base_dtype", QUANT)
def test_apply_on_quantized_tree_with_one_lambda_matches_jax(jax_params, base_dtype):
    jcfg, jp = jax_params
    rng = np.random.default_rng(5)
    adapters = {mod: {p: {**leaf, "lam": jnp.asarray(
        rng.standard_normal(np.shape(leaf["lam"])).astype(np.float32) * 0.3)}
        for p, leaf in projs.items()} for mod, projs in jp["groups"]["adapters"].items()}
    jq_params = jq.quantize_base_params(
        {**jp, "groups": {**jp["groups"], "adapters": adapters}}, base_dtype)
    tp = params_from_jax(_np(jq_params), device="cpu")
    assert tq.is_quantized(tp["groups"]["attn"]["wq"])
    toks = rng.integers(2, 256, size=(2, 11)).astype(np.int32)
    want, _ = jax_build(jcfg).apply(jq_params, tokens=jnp.asarray(toks), train=False)
    tm = build_model(get_reduced("smollm-135m").replace(dtype="float32"), "cpu")
    got = tm.apply(tp, torch.from_numpy(toks))
    err = float(np.abs(got.numpy() - np.asarray(want)).max())
    print(f"[parity] apply on a {base_dtype} tree, one λ: max|Δ| {err:.2e}")
    assert err <= MODEL_ATOL


def _serve_both(base_dtype):
    """The JAX engine and the port's on the same params, λ and prompts with
    ``base_dtype``, through a pool small enough to force preemption."""
    jcfg = jax_reduced("smollm-135m").replace(dtype="float32")
    cfg = get_reduced("smollm-135m").replace(dtype="float32")
    jp = jax_build(jcfg).init(jax.random.PRNGKey(3))
    tp = params_from_jax(_np(jp), device="cpu")
    rng = np.random.default_rng(0)
    lam_shape = np.asarray(jp["groups"]["adapters"]["attn"]["wq"]["lam"]).shape
    lams = {f"t{i}": {"attn": {p: (rng.standard_normal(lam_shape) * 0.3).astype(np.float32)
                               for p in ("wq", "wv")}} for i in range(4)}
    reqs = [(f"t{i % 4}", rng.integers(2, 256, size=int(rng.integers(3, 30))).astype(np.int32),
             int(rng.integers(4, 14))) for i in range(6)]
    common = dict(n_lanes=3, n_slots=6, max_len=48, collect_logits=True, block_size=8,
                  n_blocks=9, base_dtype=base_dtype)
    jeng = JEngine(jcfg, JEngineConfig(telemetry=False, **common), params=jp)
    teng = MultiTenantEngine(cfg, EngineConfig(**common), params=tp, device="cpu")
    for name, lam in lams.items():
        jeng.add_tenant(name, jax.tree_util.tree_map(jnp.asarray, lam))
        teng.add_tenant(name, lam)
    for tenant, prompt, n in reqs:
        jeng.submit(tenant, prompt, n)
        teng.submit(tenant, prompt, n)
    return jeng, jeng.run(), teng, teng.run()


@pytest.mark.parametrize("base_dtype", QUANT)
def test_quantized_engine_matches_jax_engine(base_dtype):
    jeng, jdone, teng, tdone = _serve_both(base_dtype)
    assert teng.base_dtype == jeng.base_dtype == base_dtype
    for proj in ("wq", "wv"):
        mine, ref = teng.params["groups"]["attn"][proj], jeng.params["groups"]["attn"][proj]
        np.testing.assert_array_equal(_bits(mine["q"]), _jbits(ref["q"]))
    assert sorted(jdone) == sorted(tdone) == list(range(6))
    for uid in jdone:
        assert tdone[uid].tokens == jdone[uid].tokens, f"request {uid}"
        np.testing.assert_allclose(np.stack(tdone[uid].logits), np.stack(jdone[uid].logits),
                                   atol=ENGINE_TOL)
    worst = max(np.abs(np.stack(tdone[u].logits) - np.stack(jdone[u].logits)).max()
                for u in jdone)
    print(f"[parity] {base_dtype} engine vs JAX engine: {len(jdone)} requests, "
          f"{teng.preemptions} preemptions, logits max|Δ| {worst:.2e}")
    assert teng.preemptions == jeng.preemptions > 0
    assert teng.steps == jeng.steps
    assert teng.allocator.peak_in_use == jeng.allocator.peak_in_use


def test_int8_engine_logits_within_documented_eps():
    """The reference's contract, ported: the int8-base float32 engine stays
    within INT8_LOGIT_EPS of the unquantized merged-weight reference at
    matched-context positions, decodes the tokens of the quantized merged
    reference, and agrees with it within 0.05."""
    from repro_torch.serving import random_lambda

    cfg = get_reduced("smollm-135m").replace(dtype="float32")
    pristine = MultiTenantEngine(cfg, EngineConfig(n_lanes=1, n_slots=2, max_len=32),
                                 device="cpu").params
    eng = MultiTenantEngine(cfg, EngineConfig(n_lanes=2, n_slots=4, max_len=32,
                                              collect_logits=True, base_dtype="int8"),
                            params=pristine, device="cpu")
    assert eng.base_dtype == "int8" and tq.is_quantized(eng.params["groups"]["attn"]["wq"])
    assert not tq.is_quantized(pristine["groups"]["attn"]["wq"])
    lam = random_lambda(torch.Generator().manual_seed(1), eng.params, 0.3)
    eng.add_tenant("t1", lam)
    prompt = np.random.default_rng(0).integers(2, cfg.vocab_size, size=9).astype(np.int32)
    gen = 5
    req = eng.submit("t1", prompt, gen)
    eng.run()
    got = np.stack(req.logits)
    toks_fp32, fp32_logits = reference_decode(cfg, pristine, lam, prompt, gen, 32)
    lcp = 0
    while lcp < gen and req.tokens[lcp] == toks_fp32[lcp]:
        lcp += 1
    n_cmp = min(lcp + 1, gen)  # position i's context is tokens[:i]
    eps = float(np.abs(got[:n_cmp] - fp32_logits[:n_cmp]).max())
    toks_q, q_logits = reference_decode(cfg, eng.params, lam, prompt, gen, 32)
    dq = float(np.abs(got - q_logits).max())
    print(f"[parity] int8 engine: ε vs unquantized {eps:.2e} over {n_cmp} positions, "
          f"vs quantized merged {dq:.2e}")
    assert eps < tq.INT8_LOGIT_EPS
    assert req.tokens == toks_q
    assert dq < 0.05
