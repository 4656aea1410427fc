"""The one-launch BGMV kernel's arithmetic on the CPU.

``ref.qrlora_bgmv_split_ref`` mirrors what ``csrc/qrlora_bgmv.cu`` computes
(the BGMV kernel, its quantized twin and the rows kernel): K cut into the 8
slices of a thread-block cluster, each slice's x·W and x·B in fp32, the
slices summed in rank order; on an int8/fp8 q (widened exactly) that sum
times ``w_scale`` once; λ times the summed x·B; P·A cut into 8 slices of
rank columns, summed in rank order; the adapter term scaled and added once.
Here it is held against the JAX reference's ``qrlora_bgmv_kernel``,
``qrlora_bgmv_quant_kernel`` and ``qrlora_bgmv_rows_kernel`` (W in x's dtype
and its ``widen`` route on a q) in interpret mode (blocks as large as the
operands, as ``tests/test_torch_sharding.py`` runs the rows kernel) and
against the port's plain ``qrlora_bgmv_ref`` / ``qrlora_bgmv_quant_ref`` /
``qrlora_bgmv_rows_ref``, for float32 and bfloat16 x, int8 and fp8 q
(quantized by the reference, crossed bit for bit), ragged M, K and N,
r ∈ {8, 40, 128}, and a slot id outside the table.  Inputs are made with
numpy from a seed.

Tolerance: the limit the card holds the kernels to,
``kernel_bench.TOL["qrlora_bgmv"]`` / ``["qrlora_bgmv_quant"]`` /
``["qrlora_bgmv_rows"]``: float32 1e-4 + 1e-5·|y| (the same products summed
in another order), bfloat16 1e-3 + 2⁻⁷·|y| (both sides round an fp32 sum to
bf16).  Readings (largest over the cases, of the limit): W in x's dtype
float32 0.045, bfloat16 0.772; on a q float32 0.034, bfloat16 0.737 (fp8;
int8 0.098).  The planted faults (a cluster rank's slices dropped, λ taken
from slot 0, the adapter term left out; on a q a rank dropped, λ from slot
0, ``w_scale`` dropped, ``w_scale`` on the adapter term too) are each seen
in float32, at 26,000 to 63,000,000 of the limit.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.quantize import FP8_SUPPORTED as J_FP8, quantize_weight as j_quantize_weight
from repro.kernels.qrlora_bgmv import (
    qrlora_bgmv_kernel,
    qrlora_bgmv_quant_kernel,
    qrlora_bgmv_rows_kernel,
)
from repro_torch.benchmarks.common import err_over_bound
from repro_torch.benchmarks.kernel_bench import TOL
from repro_torch.interop import params_from_jax
from repro_torch.kernels import ref as tref

K, N, N_SLOTS = 192, 80, 5
SCALE = 0.7
J_DT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
T_DT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _inputs(M, r, seed, x_dtype, k=K, n=N):
    """numpy operands → (jax, torch) dicts with the same values: x and W in
    the model dtype, bf16 QR factors, an fp32 λ table with slot 0 zero, and
    per-row slot ids over every slot, the last row's outside the table."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((M, k)).astype(np.float32)
    W = (rng.standard_normal((k, n)) / np.sqrt(k)).astype(np.float32)
    B = (rng.standard_normal((k, r)) / np.sqrt(k)).astype(np.float32)
    A = rng.standard_normal((r, n)).astype(np.float32)
    tab = (rng.standard_normal((N_SLOTS, r)) * 0.3).astype(np.float32)
    tab[0] = 0.0
    seg = (np.arange(M) % N_SLOTS).astype(np.int32)
    seg[-1] = N_SLOTS  # no such slot: a zero λ row
    j = dict(x=jnp.asarray(x, J_DT[x_dtype]), W=jnp.asarray(W, J_DT[x_dtype]),
             B=jnp.asarray(B, jnp.bfloat16), A=jnp.asarray(A, jnp.bfloat16),
             tab=jnp.asarray(tab), seg=jnp.asarray(seg))
    t = dict(x=torch.from_numpy(x).to(T_DT[x_dtype]), W=torch.from_numpy(W).to(T_DT[x_dtype]),
             B=torch.from_numpy(B).bfloat16(), A=torch.from_numpy(A).bfloat16(),
             tab=torch.from_numpy(tab), seg=torch.from_numpy(seg))
    return j, t


def _rows(t, slot=None):
    """Each row's λ: its slot's table row, zeros for a slot outside the
    table; every row slot ``slot``'s if given."""
    seg = t["seg"].long() if slot is None else torch.full_like(t["seg"].long(), slot)
    ok = (seg >= 0) & (seg < N_SLOTS)
    return torch.where(ok[:, None], t["tab"][seg.clamp(0, N_SLOTS - 1)], 0.0)


def _plain_bgmv(t):
    """The plain BGMV on a table padded with a zero row for the out-of-table
    slot (its ``take`` has no out-of-range rule)."""
    tab = torch.cat([t["tab"], torch.zeros_like(t["tab"][:1])])
    return tref.qrlora_bgmv_ref(t["x"], t["W"], t["B"], t["A"], tab, t["seg"], SCALE)


def _ratio(got, want, x_dtype, kind="qrlora_bgmv"):
    want = (want.float() if isinstance(want, torch.Tensor)
            else torch.from_numpy(np.array(jnp.asarray(want, jnp.float32))))
    return err_over_bound(got, want, TOL[kind][T_DT[x_dtype]])


@pytest.mark.parametrize("r", [8, 40, 128])
@pytest.mark.parametrize("M", [4, 37])
@pytest.mark.parametrize("x_dtype", ["float32", "bfloat16"])
def test_split_ref_matches_jax_bgmv_kernel_and_plain(x_dtype, M, r):
    j, t = _inputs(M, r, seed=M + r, x_dtype=x_dtype)
    got = tref.qrlora_bgmv_split_ref(t["x"], t["W"], t["B"], t["A"], _rows(t), SCALE)
    assert got.dtype == T_DT[x_dtype] and got.shape == (M, N)
    kernel = qrlora_bgmv_kernel(j["x"], j["W"], j["B"], j["A"], j["tab"], j["seg"][:, None],
                                scale=SCALE, bm=M, bn=N, bk=K, interpret=True)
    vs_kernel, vs_plain = _ratio(got, kernel, x_dtype), _ratio(got, _plain_bgmv(t), x_dtype)
    print(f"[parity] bgmv split {x_dtype} M={M} r={r}: {vs_kernel:.3f} of the limit against "
          f"Pallas, {vs_plain:.3f} against plain")
    assert vs_kernel <= 1.0 and vs_plain <= 1.0


@pytest.mark.parametrize("r", [8, 40, 128])
@pytest.mark.parametrize("x_dtype", ["float32", "bfloat16"])
def test_split_ref_matches_jax_rows_kernel_and_plain(x_dtype, r):
    """The rows kernel with W in x's dtype: the JAX kernel takes its
    all-ones w_scale, the port's plain version none."""
    M = 37
    j, t = _inputs(M, r, seed=100 + r, x_dtype=x_dtype)
    rows = _rows(t)
    got = tref.qrlora_bgmv_split_ref(t["x"], t["W"], t["B"], t["A"], rows, SCALE)
    kernel = qrlora_bgmv_rows_kernel(j["x"], j["W"], jnp.ones((N,), jnp.float32), j["B"],
                                     j["A"], jnp.asarray(rows.numpy()), scale=SCALE, bm=M, bn=N,
                                     bk=K, interpret=True)
    plain = tref.qrlora_bgmv_rows_ref(t["x"], t["W"], None, t["B"], t["A"], rows, SCALE)
    vs_kernel = _ratio(got, kernel, x_dtype, "qrlora_bgmv_rows")
    vs_plain = _ratio(got, plain, x_dtype, "qrlora_bgmv_rows")
    print(f"[parity] rows split {x_dtype} r={r}: {vs_kernel:.3f} of the limit against Pallas, "
          f"{vs_plain:.3f} against plain")
    assert vs_kernel <= 1.0 and vs_plain <= 1.0


@pytest.mark.parametrize("x_dtype", ["float32", "bfloat16"])
def test_split_ref_ragged_shapes_match_plain(x_dtype):
    """K, N and r that no vector width divides (K = 100: slices of 16, the
    last rank's empty; N = 50; r = 20: P slices of 4, three ranks idle)."""
    j, t = _inputs(9, 20, seed=9, x_dtype=x_dtype, k=100, n=50)
    got = tref.qrlora_bgmv_split_ref(t["x"], t["W"], t["B"], t["A"], _rows(t), SCALE)
    tab = torch.cat([t["tab"], torch.zeros_like(t["tab"][:1])])
    plain = tref.qrlora_bgmv_ref(t["x"], t["W"], t["B"], t["A"], tab, t["seg"], SCALE)
    kernel = qrlora_bgmv_kernel(j["x"], j["W"], j["B"], j["A"], j["tab"], j["seg"][:, None],
                                scale=SCALE, bm=9, bn=50, bk=100, interpret=True)
    assert _ratio(got, plain, x_dtype) <= 1.0 and _ratio(got, kernel, x_dtype) <= 1.0


def test_out_of_table_slot_gives_the_base_projection():
    """A slot id outside the table adds no adapter term, in the JAX kernel
    and in the mirror alike: that row is x·W alone."""
    j, t = _inputs(6, 40, seed=4, x_dtype="float32")
    got = tref.qrlora_bgmv_split_ref(t["x"], t["W"], t["B"], t["A"], _rows(t), SCALE)
    kernel = np.asarray(qrlora_bgmv_kernel(j["x"], j["W"], j["B"], j["A"], j["tab"],
                                           j["seg"][:, None], scale=SCALE, bm=6, bn=N, bk=K,
                                           interpret=True))
    base = (t["x"][-1] @ t["W"]).numpy()
    np.testing.assert_allclose(got[-1].numpy(), base, atol=1e-5)
    np.testing.assert_allclose(kernel[-1], base, atol=1e-5)


@pytest.mark.parametrize("x_dtype", ["float32", "bfloat16"])
def test_rows_ref_takes_no_w_scale_for_w_in_x_dtype(x_dtype):
    """For W in x's dtype the rows plain version takes no w_scale; an
    all-ones one gives the same bits (×1.0 is exact), and both are the BGMV
    plain version's bits with rows = Λ[seg]."""
    _, t = _inputs(8, 16, seed=2, x_dtype=x_dtype)
    t["seg"][-1] = 1
    rows = t["tab"][t["seg"].long()]
    args = (t["x"], t["W"])
    none = tref.qrlora_bgmv_rows_ref(*args, None, t["B"], t["A"], rows, SCALE)
    ones = tref.qrlora_bgmv_rows_ref(*args, torch.ones(N), t["B"], t["A"], rows, SCALE)
    bgmv = tref.qrlora_bgmv_ref(*args, t["B"], t["A"], t["tab"], t["seg"], SCALE)
    assert torch.equal(none, ones) and torch.equal(none, bgmv)


def _fault(t, fault):
    rows = _rows(t)
    if fault.startswith("rank"):
        rank = int(fault[4:])
        return tref.qrlora_bgmv_split_ref(t["x"], t["W"], t["B"], t["A"], rows, SCALE,
                                          skip_ranks=(rank,))
    if fault == "lam_slot0":
        return tref.qrlora_bgmv_split_ref(t["x"], t["W"], t["B"], t["A"], _rows(t, 0), SCALE)
    assert fault == "adapter_left_out"
    return tref.qrlora_bgmv_split_ref(t["x"], t["W"], t["B"], t["A"], rows, 0.0)


@pytest.mark.parametrize("fault", [f"rank{c}" for c in range(8)]
                         + ["lam_slot0", "adapter_left_out"])
def test_split_ref_planted_faults_are_seen_in_float32(fault):
    """What a kernel that drops one cluster rank's partials (each of the 8,
    at K = 192 and r = 128: 24 K rows and 16 rank columns a rank), reads
    every λ row from slot 0, or leaves the adapter term out would give: each
    far outside the float32 limit, where the sound mirror is within it."""
    _, t = _inputs(16, 128, seed=3, x_dtype="float32")
    plain = _plain_bgmv(t)
    sound = _ratio(tref.qrlora_bgmv_split_ref(t["x"], t["W"], t["B"], t["A"], _rows(t), SCALE),
                   plain, "float32")
    got = _ratio(_fault(t, fault), plain, "float32")
    print(f"[parity] planted {fault}: {got:.1f} of the float32 limit, sound {sound:.3f}")
    assert sound <= 1.0 and got > 100.0


# ---------------------------------------------------------------------------
# the quantized routes: #5 and the rows kernel on an int8/fp8 q
# ---------------------------------------------------------------------------

QUANTS = ["int8"] + (["fp8"] if J_FP8 else [])


def _q_inputs(M, r, seed, x_dtype, base, k=K, n=N):
    """:func:`_inputs` with W quantized per column by the reference
    (``quantize_weight``) and crossed to the port bit for bit: each dict
    gains ``q`` and ``ws``."""
    j, t = _inputs(M, r, seed, x_dtype, k=k, n=n)
    qW = j_quantize_weight(jnp.asarray(j["W"], jnp.float32), base)
    j["q"], j["ws"] = qW["q"], qW["scale"]
    crossed = params_from_jax({"q": np.asarray(qW["q"]), "ws": np.asarray(qW["scale"])},
                              device="cpu")
    t["q"], t["ws"] = crossed["q"], crossed["ws"]
    return j, t


def _split_q(t, rows, **kw):
    return tref.qrlora_bgmv_split_ref(t["x"], t["q"], t["B"], t["A"], rows, SCALE,
                                      w_scale=t["ws"], **kw)


def _plain_quant(t):
    tab = torch.cat([t["tab"], torch.zeros_like(t["tab"][:1])])
    return tref.qrlora_bgmv_quant_ref(t["x"], t["q"], t["ws"], t["B"], t["A"], tab, t["seg"],
                                      SCALE)


@pytest.mark.parametrize("r", [8, 40, 128])
@pytest.mark.parametrize("M", [4, 37])
@pytest.mark.parametrize("x_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("base", QUANTS)
def test_split_ref_on_a_q_matches_jax_quant_kernel_and_plain(base, x_dtype, M, r):
    j, t = _q_inputs(M, r, seed=200 + M + r, x_dtype=x_dtype, base=base)
    got = _split_q(t, _rows(t))
    assert got.dtype == T_DT[x_dtype] and got.shape == (M, N)
    kernel = qrlora_bgmv_quant_kernel(j["x"], j["q"], j["ws"], j["B"], j["A"], j["tab"],
                                      j["seg"][:, None], scale=SCALE, bm=M, bn=N, bk=K,
                                      interpret=True)
    vs_kernel = _ratio(got, kernel, x_dtype, "qrlora_bgmv_quant")
    vs_plain = _ratio(got, _plain_quant(t), x_dtype, "qrlora_bgmv_quant")
    print(f"[parity] bgmv quant split {base} {x_dtype} M={M} r={r}: {vs_kernel:.3f} of the "
          f"limit against Pallas, {vs_plain:.3f} against plain")
    assert vs_kernel <= 1.0 and vs_plain <= 1.0


@pytest.mark.parametrize("r", [8, 40, 128])
@pytest.mark.parametrize("x_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("base", QUANTS)
def test_split_ref_on_a_q_matches_jax_rows_kernel_and_plain(base, x_dtype, r):
    """The rows kernel's ``widen`` route: an int8/fp8 q and its w_scale."""
    M = 37
    j, t = _q_inputs(M, r, seed=300 + r, x_dtype=x_dtype, base=base)
    rows = _rows(t)
    got = _split_q(t, rows)
    kernel = qrlora_bgmv_rows_kernel(j["x"], j["q"], j["ws"], j["B"], j["A"],
                                     jnp.asarray(rows.numpy()), scale=SCALE, bm=M, bn=N, bk=K,
                                     interpret=True)
    plain = tref.qrlora_bgmv_rows_ref(t["x"], t["q"], t["ws"], t["B"], t["A"], rows, SCALE)
    vs_kernel = _ratio(got, kernel, x_dtype, "qrlora_bgmv_rows")
    vs_plain = _ratio(got, plain, x_dtype, "qrlora_bgmv_rows")
    print(f"[parity] rows quant split {base} {x_dtype} r={r}: {vs_kernel:.3f} of the limit "
          f"against Pallas, {vs_plain:.3f} against plain")
    assert vs_kernel <= 1.0 and vs_plain <= 1.0


@pytest.mark.parametrize("x_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("base", QUANTS)
def test_split_ref_on_a_q_ragged_shapes_match_plain(base, x_dtype):
    """K = 100, N = 50 (no 16-byte row of q), r = 20, M = 9: both JAX
    kernels and both plain versions."""
    j, t = _q_inputs(9, 20, seed=19, x_dtype=x_dtype, base=base, k=100, n=50)
    rows = _rows(t)
    got = _split_q(t, rows)
    quant = qrlora_bgmv_quant_kernel(j["x"], j["q"], j["ws"], j["B"], j["A"], j["tab"],
                                     j["seg"][:, None], scale=SCALE, bm=9, bn=50, bk=100,
                                     interpret=True)
    by_rows = qrlora_bgmv_rows_kernel(j["x"], j["q"], j["ws"], j["B"], j["A"],
                                      jnp.asarray(rows.numpy()), scale=SCALE, bm=9, bn=50,
                                      bk=100, interpret=True)
    plain = tref.qrlora_bgmv_rows_ref(t["x"], t["q"], t["ws"], t["B"], t["A"], rows, SCALE)
    for want in (quant, _plain_quant(t)):
        assert _ratio(got, want, x_dtype, "qrlora_bgmv_quant") <= 1.0
    for want in (by_rows, plain):
        assert _ratio(got, want, x_dtype, "qrlora_bgmv_rows") <= 1.0


@pytest.mark.parametrize("base", QUANTS)
def test_out_of_table_slot_on_a_q_gives_the_dequantized_base_projection(base):
    """A slot id outside the table adds no adapter term on a q either: that
    row is (x·q)·w_scale alone, in the JAX kernel and the mirror alike."""
    j, t = _q_inputs(6, 40, seed=5, x_dtype="float32", base=base)
    got = _split_q(t, _rows(t))
    kernel = np.asarray(qrlora_bgmv_quant_kernel(
        j["x"], j["q"], j["ws"], j["B"], j["A"], j["tab"], j["seg"][:, None], scale=SCALE,
        bm=6, bn=N, bk=K, interpret=True))
    base_row = ((t["x"][-1] @ t["q"].float()) * t["ws"]).numpy()
    np.testing.assert_allclose(got[-1].numpy(), base_row, atol=1e-5)
    np.testing.assert_allclose(kernel[-1], base_row, atol=1e-5)


def _q_fault(t, fault):
    rows = _rows(t)
    if fault.startswith("rank"):
        return _split_q(t, rows, skip_ranks=(int(fault[4:]),))
    if fault == "lam_slot0":
        return _split_q(t, _rows(t, 0))
    no_scale = tref.qrlora_bgmv_split_ref(t["x"], t["q"], t["B"], t["A"], rows, SCALE)
    if fault == "w_scale_dropped":
        return no_scale
    assert fault == "w_scale_on_adapter"  # (Σx·q + ΣP·A·scale)·w_scale
    return no_scale * t["ws"]


@pytest.mark.parametrize("fault", [f"rank{c}" for c in range(8)]
                         + ["lam_slot0", "w_scale_dropped", "w_scale_on_adapter"])
@pytest.mark.parametrize("base", QUANTS)
def test_split_ref_on_a_q_planted_faults_are_seen_in_float32(base, fault):
    """What a quantized kernel that drops one cluster rank's partials (each
    of the 8), reads every λ row from slot 0, drops the dequant scale, or
    multiplies the adapter term by it too would give: each far outside the
    float32 limit, where the sound mirror is within it."""
    _, t = _q_inputs(16, 128, seed=6, x_dtype="float32", base=base)
    plain = _plain_quant(t)
    sound = _ratio(_split_q(t, _rows(t)), plain, "float32", "qrlora_bgmv_quant")
    got = _ratio(_q_fault(t, fault), plain, "float32", "qrlora_bgmv_quant")
    print(f"[parity] planted {base} {fault}: {got:.1f} of the float32 limit, sound {sound:.3f}")
    assert sound <= 1.0 and got > 100.0


def test_q_wrappers_refuse_a_rank_past_the_cluster_cap():
    """The q routes share the one-launch kernel's rank cap (``MAX_RANK``):
    r = 264 is refused by both wrappers before any library is loaded."""
    from repro_torch.kernels import qrlora_bgmv as tbgmv

    _, t = _q_inputs(4, tbgmv.MAX_RANK + 8, seed=7, x_dtype="float32", base="int8")
    rows = _rows(t)
    with pytest.raises(ValueError, match="rank"):
        tbgmv.qrlora_bgmv_quant_cuda(t["x"], t["q"], t["ws"], t["B"], t["A"], t["tab"],
                                     t["seg"])
    with pytest.raises(ValueError, match="rank"):
        tbgmv.qrlora_bgmv_rows_cuda(t["x"], t["q"], t["ws"], t["B"], t["A"], rows)
    assert tbgmv.qrlora_bgmv_quant_cuda.launches == tbgmv.qrlora_bgmv_rows_cuda.launches == 0
