"""The port's flash and dense decode attention on the CPU (the plain versions
``ref.flash_attention_ref`` / ``ref.decode_attention_ref`` and the
model-layout wrappers ``ops.flash_attention`` / ``ops.decode_attention``)
against the JAX reference: its XLA oracles (``repro/kernels/ref.py``) and its
``ops`` wrappers, which run the Pallas kernels in interpret mode here, as
``tests/test_kernels.py`` runs them.  Inputs come from a numpy seed and
cross as the same bf16/fp32 values.  The CUDA kernels are held against the
plain versions on the card (``chip_smoke.py``, ``tests/test_torch_cuda.py``).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch import kernels
from repro_torch.benchmarks.common import err_over_bound
from repro_torch.benchmarks.kernel_bench import TOL as BENCH_TOL, abs_v_attention
from repro_torch.kernels import decode_attention as tdecode
from repro_torch.kernels import flash_attention as tflash
from repro_torch.kernels import ops
from repro_torch.kernels import ref as tref

# (atol, rtol, ptol): |port − JAX| ≤ atol + rtol·|JAX| + ptol·(P·|v|), with
# P·|v| the plain attention of |v| in fp32.  float32: the same fp32 softmax
# in another order (max|Δ| 2.4e-7 here).  bfloat16: each side rounds its
# output to bf16, one ulp apart at most (the rtol), and no absolute term.
#  * the plain versions against the JAX oracles round the same normalised
#    probabilities; an fp32 difference in exp or the sum flips a rare one by
#    a bf16 ulp.  Readings here: flash max|Δ| 4.9e-4, at most 0.49 of the
#    bound; decode exact.
#  * against the Pallas kernels in interpret mode the plain versions round
#    normalised probabilities, the flash kernel unnormalised ones as well
#    (2·2^-8 of P·|v|), the decode kernel none (2^-8): the kernel bench's
#    bf16 limits.  Readings here: flash max|Δ| 7.8e-3, at most 0.52 of the
#    bound; decode max|Δ| 9.8e-4, at most 0.34 of it.
F32_TOL = (1e-5, 1e-5, 0.0)
REF_TOL = {"float32": F32_TOL, "bfloat16": (0.0, 2**-7, 2**-10)}
INTERPRET_TOL = {kind: {"float32": F32_TOL,
                        "bfloat16": BENCH_TOL[f"{kind}_attention"][torch.bfloat16]}
                 for kind in ("flash", "decode")}
J_DT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
T_DT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _np(shape, rng):
    return (rng.standard_normal(shape) * 0.5).astype(np.float32)


def _both(arrs, dtype):
    return ([jnp.asarray(a, J_DT[dtype]) for a in arrs],
            [torch.from_numpy(a).to(T_DT[dtype]) for a in arrs])


def _close(got, want, tol, pv, what):
    want = torch.from_numpy(np.array(want, np.float32))
    over = err_over_bound(got, want, tol, pv)
    print(f"[parity] {what}: max|Δ| {(got.float() - want).abs().max():.2e}, {over:.3f} of the "
          f"bound {tol}")
    assert over <= 1.0, what


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,Sq,Sk,H,KV,dh,causal", [
    *[(*s, c) for s in [(2, 128, 128, 4, 2, 64), (1, 256, 256, 8, 8, 32), (2, 96, 96, 6, 3, 16),
                        (2, 64, 64, 9, 3, 64)]  # the reference tests' grid; smollm-135m's heads
      for c in (True, False)],
    (1, 64, 128, 4, 2, 32, True), (1, 128, 64, 9, 3, 64, True),  # Sq ≠ Sk, top-left causal
])
def test_flash_matches_jax(B, Sq, Sk, H, KV, dh, causal, dtype):
    rng = np.random.default_rng(Sq * 7 + Sk + H)
    (jq, jk, jv), (q, k, v) = _both(
        [_np((B, Sq, H, dh), rng), _np((B, Sk, KV, dh), rng), _np((B, Sk, KV, dh), rng)], dtype)
    pv = abs_v_attention(q, k, v, causal)
    case = f"{(B, Sq, Sk, H, KV, dh, causal)} {dtype}"
    plain = tref.flash_attention_ref(q, k, v, causal=causal)
    assert plain.dtype == T_DT[dtype] and plain.shape == (B, Sq, H, dh)
    _close(plain, jref.flash_attention_ref(jq, jk, jv, causal=causal), REF_TOL[dtype], pv,
           f"flash ref {case}")
    got = ops.flash_attention(q, k, v, causal=causal, bq=64, bk=64)
    _close(got, jops.flash_attention(jq, jk, jv, causal=causal, bq=64, bk=64),
           INTERPRET_TOL["flash"][dtype], pv, f"flash ops vs interpret {case}")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,S,H,KV,dh,L,as_tensor", [
    (2, 256, 4, 2, 64, 100, False), (1, 512, 8, 8, 32, 512, True),
    (3, 128, 6, 3, 16, 1, False), (2, 128, 4, 4, 32, 127, True),  # the reference tests' grid
    (2, 128, 9, 3, 64, 1, True), (2, 128, 9, 3, 64, 127, False),  # smollm-135m's heads
])
def test_decode_matches_jax(B, S, H, KV, dh, L, as_tensor, dtype):
    rng = np.random.default_rng(S + L + H)
    (jq, jk, jv), (q, kc, vc) = _both(
        [_np((B, H, dh), rng), _np((B, S, KV, dh), rng), _np((B, S, KV, dh), rng)], dtype)
    length = torch.tensor(L, dtype=torch.int32) if as_tensor else L
    pv = abs_v_attention(q, kc, vc, length)
    case = f"{(B, S, H, KV, dh, L)} {dtype}"
    plain = tref.decode_attention_ref(q, kc, vc, length)
    assert plain.dtype == T_DT[dtype] and plain.shape == (B, H, dh)
    _close(plain, jref.decode_attention_ref(jq, jk, jv, jnp.asarray(L)), REF_TOL[dtype], pv,
           f"decode ref {case}")
    got = ops.decode_attention(q[:, None], kc, vc, length, bk=64)  # the (B,1,H,dh) form
    assert got.shape == (B, 1, H, dh)
    _close(got[:, 0], jops.decode_attention(jq, jk, jv, jnp.asarray(L), bk=64),
           INTERPRET_TOL["decode"][dtype], pv, f"decode ops vs interpret {case}")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_length_zero_gives_zeros(dtype):
    """The port returns zeros for an empty cache, as the reference kernel does
    (``decode_attention.py``: no block runs, acc/max(l, 1e-30) = 0); the
    reference's XLA oracle gives NaN there."""
    rng = np.random.default_rng(0)
    (jq, jk, jv), (q, kc, vc) = _both(
        [_np((2, 9, 64), rng), _np((2, 128, 3, 64), rng), _np((2, 128, 3, 64), rng)], dtype)
    for length in (0, torch.tensor(0, dtype=torch.int32)):
        assert torch.equal(tref.decode_attention_ref(q, kc, vc, length), torch.zeros_like(q))
        assert torch.equal(ops.decode_attention(q, kc, vc, length), torch.zeros_like(q))
    kernel = np.asarray(jops.decode_attention(jq, jk, jv, jnp.asarray(0), bk=64), np.float32)
    assert (kernel == 0).all()
    assert np.isnan(np.asarray(jref.decode_attention_ref(jq, jk, jv, jnp.asarray(0)),
                               np.float32)).all()


def test_decode_positions_past_the_length_never_count():
    rng = np.random.default_rng(1)
    q, kc, vc = (torch.from_numpy(_np(s, rng)) for s in ((2, 6, 16), (2, 64, 3, 16), (2, 64, 3, 16)))
    want = tref.decode_attention_ref(q, kc, vc, 20)
    kc[:, 20:], vc[:, 20:] = 1e4, -1e4
    assert torch.equal(tref.decode_attention_ref(q, kc, vc, 20), want)


def test_attention_wrappers_never_fall_back_off_cpu():
    """A tensor that is neither on the CPU nor on a card is refused: the
    wrappers pick kernel or plain version by device, never by failure."""
    q, k = torch.zeros((1, 8, 2, 16), device="meta"), torch.zeros((1, 8, 1, 16), device="meta")
    with pytest.raises(NotImplementedError):
        tflash.flash_attention(q, k, k)
    with pytest.raises(NotImplementedError):
        tdecode.decode_attention(q[:, 0], k, k, 4)


def test_attention_ops_are_forward_only():
    """The reference kernels have no VJP: a call autograd would have to
    differentiate raises, on the CPU as on the card."""
    q = torch.zeros((1, 8, 2, 16), requires_grad=True)
    k = torch.zeros((1, 8, 1, 16))
    with pytest.raises(NotImplementedError):
        ops.flash_attention(q, k, k)
    with pytest.raises(NotImplementedError):
        ops.decode_attention(q[:, :1], k, k, 4)
    with torch.no_grad():
        assert ops.flash_attention(q, k, k).shape == q.shape


def test_attention_kernel_wrappers_validate_before_launching():
    """Bad dtypes, shapes, head dims, layouts and lengths are refused before
    any library is loaded (these checks run on CPU tensors too); no launch
    is counted."""
    kernels.reset_launch_counts()
    q, k = torch.zeros((2, 8, 4, 32)), torch.zeros((2, 8, 2, 32))
    with pytest.raises(TypeError):
        tflash.flash_attention_cuda(q, k.double(), k)
    with pytest.raises(TypeError):
        tflash.flash_attention_cuda(q.half(), k.half(), k.half())
    with pytest.raises(ValueError):
        tflash.flash_attention_cuda(q, k, k[:, :4])  # k and v shapes differ
    with pytest.raises(ValueError):
        tflash.flash_attention_cuda(torch.zeros((2, 8, 3, 32)), k, k)  # H % KV
    with pytest.raises(ValueError):
        tflash.flash_attention_cuda(torch.zeros((2, 8, 4, 48)), torch.zeros((2, 8, 2, 48)),
                                    torch.zeros((2, 8, 2, 48)))  # head dim not instantiated
    with pytest.raises(ValueError):
        kt = torch.zeros((2, 8, 32, 2)).transpose(2, 3)  # dh not unit stride
        tflash.flash_attention_cuda(q, kt, kt)
    qd, kc = torch.zeros((2, 4, 32)), torch.zeros((2, 16, 2, 32))
    with pytest.raises(TypeError):
        tdecode.decode_attention_cuda(qd, kc.bfloat16(), kc.bfloat16(), 4)
    with pytest.raises(TypeError):
        tdecode.decode_attention_cuda(qd, kc, kc, torch.tensor(4))  # int64 length
    with pytest.raises(ValueError):
        tdecode.decode_attention_cuda(qd, kc.transpose(0, 1).contiguous().transpose(0, 1), kc, 4)
    with pytest.raises(ValueError):  # head dim not instantiated
        tdecode.decode_attention_cuda(torch.zeros((2, 4, 48)), torch.zeros((2, 16, 2, 48)),
                                      torch.zeros((2, 16, 2, 48)), 4)
    with pytest.raises(ValueError):  # contiguous, but off the 16-byte grid of the 16-byte loads
        kc_off = torch.zeros(kc.numel() + 1)[1:].view(kc.shape)
        tdecode.decode_attention_cuda(qd, kc_off, kc_off, 4)
    assert all(v == 0 for v in kernels.launch_counts().values())


def test_rope_frequencies_are_kept_and_the_rotation_shared_bitwise():
    """``rope_freqs`` makes a (d_head, theta, device) table once; q and k
    rotated with one ``rope_rotation`` equal each rotated on its own, bit for
    bit, and both equal the formula of the reference's ``apply_rope``."""
    from repro.models import layers as jlayers
    from repro_torch.models import layers

    assert layers.rope_freqs(64, 10000.0, "cpu") is layers.rope_freqs(64, 10000.0, "cpu")
    rng = np.random.default_rng(7)
    q = torch.from_numpy(rng.standard_normal((2, 5, 4, 64)).astype(np.float32))
    k = torch.from_numpy(rng.standard_normal((2, 5, 2, 64)).astype(np.float32))
    pos = torch.arange(3, 8)[None, :].expand(2, 5)
    rotation = layers.rope_rotation(pos, 64, 10000.0, q.device)
    for x in (q, k, q.to(torch.bfloat16)):
        shared = layers.apply_rope(x, pos, 10000.0, rotation)
        assert torch.equal(shared, layers.apply_rope(x, pos, 10000.0))
    want = np.asarray(jlayers.apply_rope(jnp.asarray(q.numpy()), jnp.asarray(pos.numpy()), 10000.0))
    np.testing.assert_allclose(layers.apply_rope(q, pos, 10000.0, rotation).numpy(), want,
                               rtol=1e-5, atol=1e-5)
