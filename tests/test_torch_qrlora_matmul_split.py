"""The one-λ kernels' tensor-core arithmetic on the CPU.

``ref.qrlora_matmul_split_ref`` mirrors what the bf16 route of
``csrc/qrlora_matmul.cu`` computes: ``P' = (x·B)·(scale·λ)`` split into two
bf16 halves, then one fp32 K loop over ``[x | P_hi | P_lo]`` against
``[W ; A ; A]``, a quantized base's x·q sum scaled by w_scale before the
first P step.  Here it is held against the JAX reference's
``qrlora_matmul_kernel`` and ``qrlora_matmul_quant_kernel`` in interpret
mode (small blocks, as ``tests/test_quantize.py`` runs them) and against the
port's plain ``qrlora_matmul_ref`` / ``qrlora_matmul_quant_ref``, for
float32 and bfloat16 x, int8 and fp8 q, ragged M and r ∈ {8, 40, 128}.
Inputs are made with numpy from a seed.

Tolerances:
* float32 x: |Δ| ≤ 2⁻¹⁶·(|P'|·|A|) + 1e-6·max|y|.  The pair P_hi + P_lo
  is within 2⁻¹⁶·|P'| of P' (each bf16 rounding is within 2⁻⁸ of its
  value), A is exact, and the rest is fp32 summation order.
* bfloat16 x: the limit the card holds the kernels to,
  ``kernel_bench.TOL["qrlora_matmul"]`` / ``["qrlora_matmul_quant"]``
  (1e-3 + 2⁻⁷·|y|): both sides round an fp32 sum to bf16.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import quantize as jq
from repro.kernels.qrlora_matmul import qrlora_matmul_kernel, qrlora_matmul_quant_kernel
from repro_torch.benchmarks.common import err_over_bound
from repro_torch.benchmarks.kernel_bench import TOL
from repro_torch.kernels import ref as tref

K, N, STEP = 192, 80, 64
SCALE = 0.7
J_DT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
T_DT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _inputs(M, r, seed, x_dtype):
    """numpy operands → (jax, torch) dicts with the same values: x and W in
    the model dtype, bf16 QR factors, fp32 λ."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((M, K)).astype(np.float32)
    W = (rng.standard_normal((K, N)) / np.sqrt(K)).astype(np.float32)
    B = (rng.standard_normal((K, r)) / np.sqrt(K)).astype(np.float32)
    A = rng.standard_normal((r, N)).astype(np.float32)
    lam = (rng.standard_normal((r,)) * 0.3).astype(np.float32)
    j = dict(x=jnp.asarray(x, J_DT[x_dtype]), W=jnp.asarray(W, J_DT[x_dtype]),
             B=jnp.asarray(B, jnp.bfloat16), A=jnp.asarray(A, jnp.bfloat16), lam=jnp.asarray(lam))
    t = dict(x=torch.from_numpy(x).to(T_DT[x_dtype]), W=torch.from_numpy(W).to(T_DT[x_dtype]),
             B=torch.from_numpy(B).bfloat16(), A=torch.from_numpy(A).bfloat16(),
             lam=torch.from_numpy(lam))
    return j, t


def _quantized(j, t, base_dtype):
    """q and w_scale from the reference's quantizer, crossed bit for bit."""
    qW = jq.quantize_weight(j["W"].astype(jnp.float32), base_dtype)
    q = np.array(qW["q"])
    tq = (torch.from_numpy(q.view(np.uint8)).view(torch.float8_e4m3fn) if base_dtype == "fp8"
          else torch.from_numpy(q))
    return (qW["q"], qW["scale"]), (tq, torch.from_numpy(np.array(qW["scale"])))


def _fp32_bound(t, want):
    """2⁻¹⁶·(|P'|·|A|) + 1e-6·max|y|, elementwise."""
    p = (t["x"].float() @ t["B"].float()) * (SCALE * t["lam"])
    return 2.0**-16 * (p.abs() @ t["A"].float().abs()) + 1e-6 * float(want.abs().max())


def _assert_close(got, want, x_dtype, kind, t, what):
    want = (want.float() if isinstance(want, torch.Tensor)
            else torch.from_numpy(np.array(jnp.asarray(want, jnp.float32))))
    d = (got.float() - want).abs()
    if x_dtype == "float32":
        bound = _fp32_bound(t, want)
    else:
        atol, rtol, _ = TOL[kind][torch.bfloat16]
        bound = atol + rtol * want.abs()
    ratio = float(torch.where(d == 0, torch.zeros_like(d), d / bound).max())
    print(f"[parity] {what}: max|Δ| {float(d.max()):.2e}, {ratio:.3f} of the bound")
    assert ratio <= 1.0, (what, float(d.max()))


@pytest.mark.parametrize("r", [8, 40, 128])
@pytest.mark.parametrize("M", [37, 64])
@pytest.mark.parametrize("x_dtype", ["float32", "bfloat16"])
def test_split_ref_matches_jax_kernel_and_plain(x_dtype, M, r):
    j, t = _inputs(M, r, seed=M + r, x_dtype=x_dtype)
    got = tref.qrlora_matmul_split_ref(t["x"], t["W"], None, t["B"], t["A"], t["lam"], SCALE)
    assert got.dtype == T_DT[x_dtype] and got.shape == (M, N)
    kernel = qrlora_matmul_kernel(j["x"], j["W"], j["B"], j["A"], j["lam"], scale=SCALE,
                                  bm=M, bn=N, bk=STEP, interpret=True)
    _assert_close(got, kernel, x_dtype, "qrlora_matmul", t, f"split {x_dtype} M={M} r={r} vs Pallas")
    plain = tref.qrlora_matmul_ref(t["x"], t["W"], t["B"], t["A"], t["lam"], SCALE)
    _assert_close(got, plain, x_dtype, "qrlora_matmul", t, f"split {x_dtype} M={M} r={r} vs plain")


@pytest.mark.parametrize("r", [8, 40, 128])
@pytest.mark.parametrize("x_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("base_dtype", ["int8", "fp8"])
def test_split_ref_quant_matches_jax_kernel_and_plain(base_dtype, x_dtype, r):
    M = 37
    j, t = _inputs(M, r, seed=r, x_dtype=x_dtype)
    (jq_, jws), (tq, tws) = _quantized(j, t, base_dtype)
    got = tref.qrlora_matmul_split_ref(t["x"], tq, tws, t["B"], t["A"], t["lam"], SCALE)
    assert got.dtype == T_DT[x_dtype] and got.shape == (M, N)
    kernel = qrlora_matmul_quant_kernel(j["x"], jq_, jws, j["B"], j["A"], j["lam"], scale=SCALE,
                                        bm=M, bn=N, bk=STEP, interpret=True)
    what = f"split {base_dtype} {x_dtype} r={r}"
    _assert_close(got, kernel, x_dtype, "qrlora_matmul_quant", t, f"{what} vs Pallas")
    plain = tref.qrlora_matmul_quant_ref(t["x"], tq, tws, t["B"], t["A"], t["lam"], SCALE)
    _assert_close(got, plain, x_dtype, "qrlora_matmul_quant", t, f"{what} vs plain")


def test_split_ref_dequantizes_before_the_adapter_steps():
    """The full x·q sum is scaled, then the P steps are added: scaling after
    them (the scale on the adapter term too) is far from the reference."""
    j, t = _inputs(16, 40, seed=3, x_dtype="float32")
    _, (q, ws) = _quantized(j, t, "int8")
    got = tref.qrlora_matmul_split_ref(t["x"], q, ws, t["B"], t["A"], t["lam"], SCALE)
    late = tref.qrlora_matmul_split_ref(t["x"], q, None, t["B"], t["A"], t["lam"], SCALE) * ws
    plain = tref.qrlora_matmul_quant_ref(t["x"], q, ws, t["B"], t["A"], t["lam"], SCALE)
    assert bool(((got - plain).abs() <= _fp32_bound(t, plain)).all())
    assert float((late - plain).abs().max()) > 1e3 * float((got - plain).abs().max())


def test_single_bf16_p_errs_more_than_the_pair():
    """The numeric reason for P_lo: at full rank a single bf16 P' is off by
    ≈ 2⁻⁹ of each product, the pair by ≈ 2⁻¹⁷."""
    _, t = _inputs(64, 128, seed=11, x_dtype="float32")
    args = (t["x"], t["W"], None, t["B"], t["A"], t["lam"], SCALE)
    plain = tref.qrlora_matmul_ref(t["x"], t["W"], t["B"], t["A"], t["lam"], SCALE)
    pair = float((tref.qrlora_matmul_split_ref(*args) - plain).abs().max())
    single_y = tref.qrlora_matmul_split_ref(*args, lo_half=False)
    single = float((single_y - plain).abs().max())
    bound = _fp32_bound(t, plain)
    d = (single_y - plain).abs()
    print(f"[parity] single bf16 P' max|Δ| {single:.2e} against the pair's {pair:.2e}; "
          f"{float((d / bound).max()):.1f} of the pair's bound")
    assert single > 30 * pair
    assert bool((d > bound).any())


def test_single_bf16_p_breaks_the_bf16_limit_where_terms_cancel():
    """Where x·W cancels the adapter term, y is small and so is its bf16
    limit: a single bf16 P' breaks TOL["qrlora_matmul"], the pair holds."""
    _, t = _inputs(64, 128, seed=5, x_dtype="float32")
    dW = (t["B"].float() * (SCALE * t["lam"])) @ t["A"].float()
    W = (t["W"] * 2.0**-8 - dW).bfloat16()
    x = t["x"].bfloat16()
    args = (x, W, None, t["B"], t["A"], t["lam"], SCALE)
    plain = tref.qrlora_matmul_ref(x, W, t["B"], t["A"], t["lam"], SCALE)
    tol = TOL["qrlora_matmul"][torch.bfloat16]
    pair = err_over_bound(tref.qrlora_matmul_split_ref(*args), plain, tol)
    single = err_over_bound(tref.qrlora_matmul_split_ref(*args, lo_half=False), plain, tol)
    print(f"[parity] cancelling terms, bf16: pair {pair:.3f}, single bf16 P' {single:.3f} "
          f"of the limit; max|y| {float(plain.float().abs().max()):.3f}")
    assert pair <= 1.0 < single


@pytest.mark.parametrize("fault", ["x_step", "last_p_step", "one_rank"])
def test_split_ref_planted_faults_are_seen(fault):
    """The faults the card check plants, each far outside the bf16 limit:
    one x·W step left out; the last P step of each half at full rank; the
    steps of one cluster rank (8 ranks, 6 on x steps: K = 576 at r = 128)."""
    M, r, Kf = 64, 128, 576
    rng = np.random.default_rng(7)
    x = torch.from_numpy(rng.standard_normal((M, Kf)).astype(np.float32)).bfloat16()
    W = torch.from_numpy((rng.standard_normal((Kf, N)) / np.sqrt(Kf)).astype(np.float32)).bfloat16()
    B = torch.from_numpy((rng.standard_normal((Kf, r)) / np.sqrt(Kf)).astype(np.float32)).bfloat16()
    A = torch.from_numpy(rng.standard_normal((r, N)).astype(np.float32)).bfloat16()
    lam = torch.from_numpy((rng.standard_normal((r,)) * 0.3).astype(np.float32))
    nkx, nkr = Kf // STEP, r // STEP
    skip = {"x_step": (3,), "last_p_step": (nkx + nkr - 1, nkx + 2 * nkr - 1),
            "one_rank": tuple(range(1, nkx, 6))}[fault]
    plain = tref.qrlora_matmul_ref(x, W, B, A, lam, SCALE)
    tol = TOL["qrlora_matmul"][torch.bfloat16]
    sound = err_over_bound(tref.qrlora_matmul_split_ref(x, W, None, B, A, lam, SCALE), plain, tol)
    got = err_over_bound(tref.qrlora_matmul_split_ref(x, W, None, B, A, lam, SCALE,
                                                      skip_steps=skip), plain, tol)
    print(f"[parity] planted {fault} (steps {skip}): {got:.1f} of the limit, sound {sound:.3f}")
    assert sound <= 1.0 and got > 10.0


@pytest.mark.parametrize("step", range(7))
def test_split_ref_every_step_is_seen_in_float32(step):
    """Every step of the K loop (K = 192, r = 128: three x·W steps, two
    P_hi steps, two P_lo steps) carries weight the float32 check sees: left
    out alone, P_lo's included, it is outside the float32 bound."""
    j, t = _inputs(37, 128, seed=11, x_dtype="float32")
    args = (t["x"], t["W"], None, t["B"], t["A"], t["lam"], SCALE)
    plain = tref.qrlora_matmul_ref(t["x"], t["W"], t["B"], t["A"], t["lam"], SCALE)
    bound = _fp32_bound(t, plain)
    sound = float(((tref.qrlora_matmul_split_ref(*args) - plain).abs() / bound).max())
    got = float(((tref.qrlora_matmul_split_ref(*args, skip_steps=(step,)) - plain).abs()
                 / bound).max())
    print(f"[parity] float32, step {step} left out: {got:.1f} of the bound, sound {sound:.3f}")
    assert sound <= 1.0 < got
