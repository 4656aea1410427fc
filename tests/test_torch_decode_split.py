"""The dense decode kernel's split-and-merge arithmetic on the CPU.

``ref.decode_attention_split_ref`` mirrors what the CUDA kernel
(``csrc/decode_attention.cu``) computes: an fp32 softmax state (max, sum,
unnormalised accumulator) per fixed chunk of valid positions, merged under
the global max.  Here it is held against the JAX reference's
``decode_attention_kernel``, reached through ``repro.kernels.ops.
decode_attention`` in interpret mode (as ``tests/test_torch_attention.py``
reaches it), and against the port's plain ``decode_attention_ref``, at
lengths on both sides of the chunk edges.  Inputs are float32, made with
numpy from a seed.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro_torch.kernels import ref as tref

# float32 on both sides; the chunked sums, the rescaling by e^{m−M} and the
# division differ from one softmax over all positions only in rounding order
# (max|Δ| ≤ 9e-8 at max|o| 0.07-1.7 here).
ATOL, RTOL = 1e-6, 1e-6
B, S, H, KV, DH, CHUNK = 2, 512, 9, 3, 64, 64


def _inputs(seed):
    rng = np.random.default_rng(seed)
    return [(rng.standard_normal(s) * 0.5).astype(np.float32)
            for s in ((B, H, DH), (B, S, KV, DH), (B, S, KV, DH))]


@pytest.mark.parametrize("L", [1, 63, 64, 65, 300, 512])
def test_split_ref_matches_jax_kernel_and_plain(L):
    arrs = _inputs(L)
    q, kc, vc = (torch.from_numpy(a) for a in arrs)
    got = tref.decode_attention_split_ref(q, kc, vc, L, CHUNK)
    assert got.dtype == torch.float32 and got.shape == (B, H, DH)
    jax_kernel = np.asarray(jops.decode_attention(*(jnp.asarray(a) for a in arrs),
                                                  jnp.asarray(L), bk=64), np.float32)
    np.testing.assert_allclose(got.numpy(), jax_kernel, atol=ATOL, rtol=RTOL)
    for length in (L, torch.tensor(L, dtype=torch.int32)):
        np.testing.assert_allclose(got.numpy(), tref.decode_attention_ref(q, kc, vc, length),
                                   atol=ATOL, rtol=RTOL)


def test_split_ref_ignores_positions_past_the_length():
    q, kc, vc = (torch.from_numpy(a) for a in _inputs(7))
    want = tref.decode_attention_split_ref(q, kc, vc, 100, CHUNK)
    kc[:, 100:], vc[:, 100:] = 1e4, -1e4
    assert torch.equal(tref.decode_attention_split_ref(q, kc, vc, 100, CHUNK), want)


def test_split_ref_length_zero_gives_zeros():
    """Zeros, as the kernel writes them; the JAX oracle gives NaN there, so
    the port's plain version is the one to match."""
    q, kc, vc = (torch.from_numpy(a) for a in _inputs(0))
    for length in (0, torch.tensor(0, dtype=torch.int32)):
        got = tref.decode_attention_split_ref(q, kc, vc, length, CHUNK)
        assert torch.equal(got, torch.zeros_like(q))
        assert torch.equal(got, tref.decode_attention_ref(q, kc, vc, length))


def test_split_ref_dropping_the_last_chunk_is_seen():
    """The fault the card check plants (the merge loses the last valid
    chunk) moves the result far beyond the float32 tolerance."""
    q, kc, vc = (torch.from_numpy(a) for a in _inputs(300))
    want = tref.decode_attention_ref(q, kc, vc, 300)
    dropped = tref.decode_attention_split_ref(q, kc, vc, 300 // CHUNK * CHUNK, CHUNK)
    assert float((dropped - want).abs().max()) > 100 * (ATOL + RTOL * float(want.abs().max()))
