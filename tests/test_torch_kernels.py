"""The port's kernel wrappers on the CPU: the plain versions against the JAX
reference oracles (``repro/kernels/ref.py``), the batching conventions and
the one-λ matmul's autograd rule in ``kernels/ops.py`` (against ``jax.grad``
through the reference's custom VJP), and the rule that a wrapper never falls back between
kernel and plain version.  The CUDA kernels themselves are held against the
plain versions on the card (``chip_smoke.py``, ``tests/test_torch_cuda.py``)."""
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch import kernels
from repro_torch.kernels import _build, ops
from repro_torch.kernels import paged_attention as tpaged
from repro_torch.kernels import qrlora_bgmv as tbgmv
from repro_torch.kernels import qrlora_matmul as tmm
from repro_torch.kernels import ref as tref

# float32: same arithmetic in another summation order (~1e-6).  bfloat16:
# both sides round an fp32 result to bf16 — one bf16 ulp (2^-7 relative)
# where a value straddles a rounding boundary; the paged reference also
# rounds its probabilities to bf16 inside a bf16 einsum.
TOL = {"float32": dict(atol=1e-5, rtol=1e-5), "bfloat16": dict(atol=2e-2, rtol=2**-7)}
J_DT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
T_DT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


# x on a device that is neither the CPU, a card nor meta (the dispatchers
# read x's device first and refuse it before touching anything else)
_ELSEWHERE = types.SimpleNamespace(device=torch.device("xpu"))


def _bgmv_np(M, K=48, N=16, r=8, n_slots=4, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((M, K)).astype(np.float32)
    W = (rng.standard_normal((K, N)) / np.sqrt(K)).astype(np.float32)
    B = (rng.standard_normal((K, r)) / np.sqrt(K)).astype(np.float32)
    A = rng.standard_normal((r, N)).astype(np.float32)
    lam = (rng.standard_normal((n_slots, r)) * 0.3).astype(np.float32)
    lam[0] = 0.0
    seg = rng.integers(0, n_slots, size=M).astype(np.int32)
    seg[0] = 0
    return x, W, B, A, lam, seg


def _to_jax(arrs, dt):
    x, W, B, A, lam, seg = arrs
    return (jnp.asarray(x, dt), jnp.asarray(W, dt), jnp.asarray(B, dt), jnp.asarray(A, dt),
            jnp.asarray(lam), jnp.asarray(seg))


def _to_torch(arrs, dt):
    x, W, B, A, lam, seg = (torch.from_numpy(a) for a in arrs)
    return x.to(dt), W.to(dt), B.to(dt), A.to(dt), lam, seg


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("M", [1, 4, 37])
def test_bgmv_plain_matches_jax_ref(dtype, M):
    arrs = _bgmv_np(M, seed=M)
    want = np.asarray(jref.qrlora_bgmv_ref(*_to_jax(arrs, J_DT[dtype]), scale=0.5),
                      np.float32)
    got = tbgmv.qrlora_bgmv(*_to_torch(arrs, T_DT[dtype]), scale=0.5)
    assert got.dtype == T_DT[dtype] and got.shape == (M, 16)
    np.testing.assert_allclose(got.float().numpy(), want, **TOL[dtype])
    print(f"[parity] bgmv plain {dtype} M={M}: max|Δ| {np.abs(got.float().numpy() - want).max():.2e}")


def test_bgmv_plain_mixed_dtypes_matches_jax_ref():
    """float32 activations with bfloat16 factors — the reference's QR
    factors stay bf16 under a float32 model."""
    arrs = _bgmv_np(9)
    x, W, B, A, lam, seg = arrs
    bf = lambda a: np.asarray(jnp.asarray(a, jnp.bfloat16), np.float32)
    want = jref.qrlora_bgmv_ref(jnp.asarray(x), jnp.asarray(W), jnp.asarray(B, jnp.bfloat16),
                                jnp.asarray(A, jnp.bfloat16), jnp.asarray(lam), jnp.asarray(seg))
    got = tbgmv.qrlora_bgmv(torch.from_numpy(x), torch.from_numpy(W),
                            torch.from_numpy(bf(B)).bfloat16(), torch.from_numpy(bf(A)).bfloat16(),
                            torch.from_numpy(lam), torch.from_numpy(seg))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL["float32"])


def test_ops_bgmv_per_sequence_seg_and_base_slot():
    x, W, B, A, lam, seg = _to_torch(_bgmv_np(12), torch.float32)
    x3 = x.reshape(3, 4, -1)
    y = ops.qrlora_bgmv(x3, W, B, A, lam, seg[:3])
    rows = seg[:3].repeat_interleave(4)  # tokens inherit their sequence's slot
    np.testing.assert_allclose(y.reshape(12, -1).numpy(),
                               tref.qrlora_bgmv_ref(x, W, B, A, lam, rows).numpy(), atol=1e-6)
    # slot 0 is λ ≡ 0: exactly the base product
    base = ops.qrlora_bgmv(x, W, B, A, lam, torch.zeros(12, dtype=torch.int32))
    np.testing.assert_allclose(base.numpy(), (x @ W).numpy(), atol=1e-5)


def _paged_np(lengths, B=None, H=6, KV=2, dh=8, bs=4, max_blocks=5, seed=0):
    rng = np.random.default_rng(seed)
    B = len(lengths)
    n_blocks = 1 + B * max_blocks
    q = rng.standard_normal((B, H, dh)).astype(np.float32)
    kp = rng.standard_normal((n_blocks, bs, KV, dh)).astype(np.float32)
    vp = rng.standard_normal((n_blocks, bs, KV, dh)).astype(np.float32)
    kp[0] = vp[0] = 1e4  # trash block: must never contribute
    tbl = (rng.permutation(n_blocks - 1) + 1).reshape(B, max_blocks).astype(np.int32)
    for b, n in enumerate(lengths):
        tbl[b, -(-n // bs)::2] = 0  # trash and stale entries past the length
    return q, kp, vp, tbl, np.asarray(lengths, np.int32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("lengths", [(1, 4, 5, 20), (13, 2, 7, 9)])
def test_paged_plain_matches_jax_ref(dtype, lengths):
    q, kp, vp, tbl, lens = _paged_np(lengths, seed=sum(lengths))
    want = jref.paged_decode_attention_ref(
        jnp.asarray(q, J_DT[dtype]), jnp.asarray(kp, J_DT[dtype]), jnp.asarray(vp, J_DT[dtype]),
        jnp.asarray(tbl), jnp.asarray(lens))
    t = lambda a: torch.from_numpy(a).to(T_DT[dtype])
    got = tpaged.paged_decode_attention(t(q), t(kp), t(vp), torch.from_numpy(tbl),
                                        torch.from_numpy(lens))
    assert got.dtype == T_DT[dtype]
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), **TOL[dtype])
    print(f"[parity] paged plain {dtype} {lengths}: "
          f"max|Δ| {np.abs(got.float().numpy() - np.asarray(want, np.float32)).max():.2e}")
    assert np.abs(got.float().numpy()).max() < 100  # no trash-block value leaked in


def test_paged_plain_zero_length_lane_is_zeros_and_ops_keeps_rank():
    q, kp, vp, tbl, lens = (torch.from_numpy(a) for a in _paged_np((0, 3, 9)))
    o = ops.paged_decode_attention(q[:, None], kp, vp, tbl, lens)
    assert o.shape == (3, 1, 6, 8)
    assert torch.equal(o[0], torch.zeros_like(o[0])) and torch.isfinite(o).all()
    # a column slice of the table (the engine's attend bound) reads the same
    np.testing.assert_allclose(
        tpaged.paged_decode_attention(q, kp, vp, tbl[:, :3], lens).numpy(),
        o[:, 0].numpy(), atol=1e-6)


def test_wrappers_never_fall_back_off_cpu():
    """A tensor that is neither on the CPU nor on a card is refused — the
    wrappers pick kernel or plain version by device, never by failure.  The
    BGMV dispatcher, on the dry-run's path, takes meta tensors to the plain
    version (shape propagation); the paged one is on no dry-run path and
    refuses them."""
    ops = _to_torch(_bgmv_np(4), torch.float32)
    meta = tbgmv.qrlora_bgmv(*(t.to("meta") for t in ops))
    want = tbgmv.qrlora_bgmv(*ops)
    assert meta.device.type == "meta" and (meta.shape, meta.dtype) == (want.shape, want.dtype)
    with pytest.raises(NotImplementedError):
        tbgmv.qrlora_bgmv(_ELSEWHERE, *ops[1:])
    q, kp, vp, tbl, lens = (torch.from_numpy(a).to("meta") for a in _paged_np((1, 2)))
    with pytest.raises(NotImplementedError):
        tpaged.paged_decode_attention(q, kp, vp, tbl, lens)


def test_cpu_path_counts_no_launches():
    kernels.reset_launch_counts()
    tbgmv.qrlora_bgmv(*_to_torch(_bgmv_np(4), torch.float32))
    q, kp, vp, tbl, lens = (torch.from_numpy(a) for a in _paged_np((1, 2)))
    tpaged.paged_decode_attention(q, kp, vp, tbl, lens)
    assert kernels.launch_counts() == {"qrlora_bgmv": 0, "paged_decode_attention": 0,
                                      "qrlora_matmul": 0, "qrlora_bgmv_quant": 0,
                                      "qrlora_matmul_quant": 0, "flash_attention": 0,
                                      "decode_attention": 0, "qrlora_bgmv_rows": 0}


def test_build_names_libraries_by_source_hash():
    for name, src in _build.SOURCES.items():
        path = _build.library_path(name)
        assert path.parent == _build.BUILD_DIR and path.name.startswith(name + "-")
        assert path == _build.library_path(name)  # deterministic
        assert (_build._CSRC / src).is_file()
    assert any("sm_90a" in f for f in _build.NVCC_FLAGS)


def test_kernel_wrappers_validate_before_launching():
    """Bad dtypes, shapes and layouts are refused before any library is
    loaded (these checks run on CPU tensors too)."""
    x, W, B, A, lam, seg = _to_torch(_bgmv_np(4), torch.float32)
    with pytest.raises(TypeError):
        tbgmv.qrlora_bgmv_cuda(x, W, B, A, lam, seg)  # the QR factors must be bf16
    B, A = B.bfloat16(), A.bfloat16()
    with pytest.raises(TypeError):
        tbgmv.qrlora_bgmv_cuda(x, W.bfloat16(), B, A, lam, seg)  # W must match x
    with pytest.raises(TypeError):
        tbgmv.qrlora_bgmv_cuda(x, W, B, A, lam, seg.long())  # seg must be int32
    with pytest.raises(TypeError):
        tbgmv.qrlora_bgmv_cuda(x, W, B, A, lam.bfloat16(), seg)  # Λ must be fp32
    with pytest.raises(ValueError):
        tbgmv.qrlora_bgmv_cuda(x, W.t().contiguous().t(), B, A, lam, seg)  # not contiguous
    with pytest.raises(ValueError):
        tbgmv.qrlora_bgmv_cuda(x, W, B, A[:4], lam, seg)  # A rows != rank
    q, kp, vp, tbl, lens = (torch.from_numpy(a) for a in _paged_np((1, 2)))
    with pytest.raises(TypeError):
        tpaged.paged_decode_attention_cuda(q, kp, vp, tbl.long(), lens)
    with pytest.raises(TypeError):
        tpaged.paged_decode_attention_cuda(q, kp.double(), vp, tbl, lens)
    with pytest.raises(ValueError):
        tpaged.paged_decode_attention_cuda(q, kp, vp, tbl.t().contiguous().t(), lens)
    with pytest.raises(ValueError):
        tpaged.paged_decode_attention_cuda(q, kp, vp[:, :2], tbl, lens)
    assert kernels.launch_counts() == {"qrlora_bgmv": 0, "paged_decode_attention": 0,
                                      "qrlora_matmul": 0, "qrlora_bgmv_quant": 0,
                                      "qrlora_matmul_quant": 0, "flash_attention": 0,
                                      "decode_attention": 0, "qrlora_bgmv_rows": 0}


# ---------------------------------------------------------------------------
# one-λ QR-LoRA matmul (the trainable projection)
# ---------------------------------------------------------------------------


def _matmul_np(M, K=64, N=48, r=8, rank=5, lead=None, seed=0):
    """Inputs as ``qr_lora_init_single`` leaves them: the factors' columns
    past the selected ``rank`` are zero."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((*(lead or (M,)), K)).astype(np.float32)
    W = (rng.standard_normal((K, N)) / np.sqrt(K)).astype(np.float32)
    B = (rng.standard_normal((K, r)) / np.sqrt(K)).astype(np.float32)
    A = rng.standard_normal((r, N)).astype(np.float32)
    B[:, rank:] = 0.0
    A[rank:] = 0.0
    lam = (rng.standard_normal(r) * 0.3).astype(np.float32)
    return x, W, B, A, lam


def _bf16_np(a):
    """Round to bfloat16 and back, so both frameworks start from one value."""
    return np.asarray(jnp.asarray(a, jnp.bfloat16), np.float32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("M", [1, 33, 64])
def test_qrlora_matmul_plain_matches_jax_ref(dtype, M):
    x, W, B, A, lam = _matmul_np(M, seed=M)
    B, A = _bf16_np(B), _bf16_np(A)  # the QR factors are bf16 in both packages
    want = np.asarray(jref.qrlora_matmul_ref(
        jnp.asarray(x, J_DT[dtype]), jnp.asarray(W, J_DT[dtype]), jnp.asarray(B, jnp.bfloat16),
        jnp.asarray(A, jnp.bfloat16), jnp.asarray(lam), scale=0.5), np.float32)
    t = lambda a, dt: torch.from_numpy(a).to(dt)
    got = tmm.qrlora_matmul(t(x, T_DT[dtype]), t(W, T_DT[dtype]), t(B, torch.bfloat16),
                            t(A, torch.bfloat16), torch.from_numpy(lam), scale=0.5)
    assert got.dtype == T_DT[dtype] and got.shape == (M, 48)
    np.testing.assert_allclose(got.float().numpy(), want, **TOL[dtype])
    print(f"[parity] qrlora_matmul plain {dtype} M={M}: "
          f"max|Δ| {np.abs(got.float().numpy() - want).max():.2e}")


# Value and gradients of ops.qrlora_matmul against jax.grad through the
# reference's custom VJP (its Pallas forward in interpret mode).  float32
# activations: the same fp32 arithmetic in another order, ~1e-6.  bfloat16
# activations: y and dx are rounded to bf16 on both sides (one bf16 ulp,
# 2^-7 relative, where a value straddles a rounding boundary); dλ is fp32 on
# both sides from the same bf16 inputs.
GRAD_TOL = {"float32": dict(atol=1e-5, rtol=1e-5), "bfloat16": dict(atol=2e-2, rtol=2**-7)}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("lead", [(33,), (2, 16)], ids=["rows", "batched"])
def test_ops_qrlora_matmul_value_and_grads_match_jax(dtype, lead):
    x, W, B, A, lam = _matmul_np(None, lead=lead, seed=len(lead))
    B, A = _bf16_np(B), _bf16_np(A)
    cot = np.random.default_rng(9).standard_normal((*lead, 48)).astype(np.float32)
    jB, jA, jW = jnp.asarray(B, jnp.bfloat16), jnp.asarray(A, jnp.bfloat16), jnp.asarray(W, J_DT[dtype])
    jcot = jnp.asarray(cot, J_DT[dtype])

    def jloss(xx, ll):
        y = jops.qrlora_matmul(xx, jW, jB, jA, ll, 0.7)
        return jnp.sum(y.astype(jnp.float32) * jcot.astype(jnp.float32)), y

    (_, jy), (jdx, jdlam) = jax.value_and_grad(jloss, argnums=(0, 1), has_aux=True)(
        jnp.asarray(x, J_DT[dtype]), jnp.asarray(lam))

    tx = torch.from_numpy(x).to(T_DT[dtype]).requires_grad_(True)
    tlam = torch.from_numpy(lam).requires_grad_(True)
    ty = ops.qrlora_matmul(tx, torch.from_numpy(W).to(T_DT[dtype]),
                           torch.from_numpy(B).bfloat16(), torch.from_numpy(A).bfloat16(), tlam, 0.7)
    (ty.float() * torch.from_numpy(cot).to(T_DT[dtype]).float()).sum().backward()

    assert ty.shape == (*lead, 48) and tx.grad.dtype == T_DT[dtype] and tlam.grad.dtype == torch.float32
    for name, got, want in (("y", ty.detach(), jy), ("dx", tx.grad, jdx), ("dlam", tlam.grad, jdlam)):
        got, want = got.float().numpy(), np.asarray(want, np.float32)
        tol = GRAD_TOL["float32"] if name == "dlam" else GRAD_TOL[dtype]
        np.testing.assert_allclose(got, want, **tol, err_msg=name)
        print(f"[parity] ops.qrlora_matmul {dtype} {lead} {name}: "
              f"max|Δ| {np.abs(got - want).max():.2e}")
    # λ entries past the selected rank (zero factor columns) get exactly 0
    assert torch.equal(tlam.grad[5:], torch.zeros(3))


def test_ops_qrlora_matmul_grads_only_where_needed():
    """x without requires_grad (layer 0's input) gets no dx; the frozen W
    gets no gradient even when it requires one, B and A only when they
    require one (LoRA, SVD-LoRA); scale is a constant."""
    x, W, B, A, lam = (torch.from_numpy(a) for a in _matmul_np(7))
    B, A = B.bfloat16(), A.bfloat16()
    W.requires_grad_(True)
    lam.requires_grad_(True)
    ops.qrlora_matmul(x, W, B, A, lam, 0.5).sum().backward()
    assert x.grad is None and W.grad is None and lam.grad is not None
    assert B.grad is None and A.grad is None
    Bt, At = B.clone().requires_grad_(True), A.clone().requires_grad_(True)
    ops.qrlora_matmul(x, W.detach(), Bt, At, lam.detach(), 0.5).sum().backward()
    assert Bt.grad.dtype == At.grad.dtype == torch.bfloat16
    assert Bt.grad.abs().sum() > 0 and At.grad.abs().sum() > 0
    # a λ view of a stacked leaf (the model's per-layer slice) trains the leaf
    stacked = torch.zeros((3, 8), requires_grad=True)
    ops.qrlora_matmul(x, W.detach(), B, A, stacked[1], 0.5).sum().backward()
    assert torch.equal(stacked.grad[1], lam.grad)  # dλ does not depend on λ
    assert torch.equal(stacked.grad[0], torch.zeros(8)) and torch.equal(stacked.grad[2], torch.zeros(8))


def test_qrlora_matmul_wrapper_validates_and_never_falls_back():
    x, W, B, A, lam = (torch.from_numpy(a) for a in _matmul_np(4))
    with pytest.raises(TypeError):
        tmm.qrlora_matmul_cuda(x, W, B, A, lam)  # the QR factors must be bf16
    B, A = B.bfloat16(), A.bfloat16()
    with pytest.raises(TypeError):
        tmm.qrlora_matmul_cuda(x, W.bfloat16(), B, A, lam)  # W must match x
    with pytest.raises(TypeError):
        tmm.qrlora_matmul_cuda(x, W, B, A, lam.bfloat16())  # λ must be fp32
    with pytest.raises(ValueError):
        tmm.qrlora_matmul_cuda(x, W.t().contiguous().t(), B, A, lam)  # not contiguous
    with pytest.raises(ValueError):
        tmm.qrlora_matmul_cuda(x, W, B, A, lam[:4])  # λ length != rank
    xb, Wb = x.bfloat16(), W.bfloat16()
    with pytest.raises(ValueError):  # TMA reads bf16 rows of 16-byte multiples
        tmm.qrlora_matmul_cuda(xb[:, :60].contiguous(), Wb[:60].contiguous(),
                               B[:60].contiguous(), A, lam)
    with pytest.raises(ValueError):  # ... from 16-byte aligned addresses
        shifted = torch.zeros(4 * 64 + 1, dtype=torch.bfloat16)[1:].view(4, 64)
        tmm.qrlora_matmul_cuda(shifted, Wb, B, A, lam)
    meta = tmm.qrlora_matmul(*(t.to("meta") for t in (x, W, B, A, lam)))  # shape propagation
    assert meta.device.type == "meta" and meta.shape == (x.shape[0], W.shape[1])
    with pytest.raises(NotImplementedError):
        tmm.qrlora_matmul(_ELSEWHERE, W, B, A, lam)
    kernels.reset_launch_counts()
    tmm.qrlora_matmul(x, W, B, A, lam)  # CPU tensors: the plain version, no launch
    assert kernels.launch_counts()["qrlora_matmul"] == 0
