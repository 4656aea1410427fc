"""The paged decode kernel's chunk-and-merge arithmetic on the CPU.

``ref.paged_decode_attention_split_ref`` mirrors what the CUDA kernel
(``csrc/paged_attention.cu``) computes: each lane's positions go through its
table row, the table's chunks are dealt to up to 8 cluster ranks, each rank
folds its chunks into an fp32 softmax state (max, sum, unnormalised
accumulator) and the ranks' states are merged in rank order under the
global max.  Here it is held against the JAX reference's paged decode
attention, reached through ``repro.kernels.ops.paged_decode_attention``
(off the TPU that runs ``repro.kernels.ref.paged_decode_attention_ref``: the
Pallas kernel does not trace on this jax), and against the port's plain
``paged_decode_attention_ref``, at lengths on both sides of the block and
chunk edges, with stale and trash table entries poisoned.  Inputs are
float32, made with numpy from a seed.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro_torch.kernels import paged_attention as tpaged
from repro_torch.kernels import ref as tref

# float32 on both sides; the chunked sums, the rescaling by e^{m−M} and the
# division differ from one softmax over all positions only in rounding order
# (max|Δ| ≈ 1e-7 at max|o| ≈ 0.1-1 here).
ATOL, RTOL = 1e-6, 1e-6
H, KV, DH, BS = 9, 3, 64, 16
POISON = 1e4  # trash block 0 and stale blocks: any read of them shows


def _inputs(seed, lengths, max_blocks):
    """q, pools and a table whose columns past each lane's length point at
    trash block 0 or at stale blocks (both holding POISON); lengths."""
    rng = np.random.default_rng(seed)
    B = len(lengths)
    n_live = B * max_blocks
    n_blocks = 1 + n_live + 8  # trash, the lanes' blocks, 8 stale ones
    q = (rng.standard_normal((B, H, DH)) * 0.5).astype(np.float32)
    kp, vp = ((rng.standard_normal((n_blocks, BS, KV, DH)) * 0.5).astype(np.float32)
              for _ in range(2))
    stale = np.arange(1 + n_live, n_blocks)
    for pool in (kp, vp):
        pool[0] = POISON
        pool[stale] = POISON
    tbl = (rng.permutation(n_live) + 1).astype(np.int32).reshape(B, max_blocks)
    for b, n in enumerate(lengths):
        used = -(-n // BS)
        tbl[b, used::2] = 0
        tbl[b, used + 1::2] = stale[b % len(stale)]
    return q, kp, vp, tbl, np.asarray(lengths, np.int32)


def _jax(q, kp, vp, tbl, lens):
    return np.asarray(jops.paged_decode_attention(*(jnp.asarray(a) for a in (q, kp, vp)),
                                                  jnp.asarray(tbl), jnp.asarray(lens)),
                      np.float32)


def _torch(*arrs):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrs]


# (lengths, table columns, chunk): the kernel's chunks are 64 positions in
# bf16 and 32 in float32 at dh 64; 8 columns is 2-4 chunks (one a rank),
# 64 columns 16-32 chunks (2-4 a rank, folded in order)
CASES = [((1, 15, 16, 17), 8, 64), ((31, 32, 33, 128), 8, 32), ((63, 64, 65, 100), 8, 64),
         ((1000, 513, 64, 1), 64, 64), ((1000, 129, 256, 255), 64, 32),
         ((48, 33, 17, 64), 4, 64)]


@pytest.mark.parametrize("lengths,max_blocks,chunk", CASES)
def test_split_ref_matches_jax_ref_and_plain(lengths, max_blocks, chunk):
    arrs = _inputs(sum(lengths) + chunk, lengths, max_blocks)
    got = tref.paged_decode_attention_split_ref(*_torch(*arrs), chunk)
    assert got.dtype == torch.float32 and got.shape == (len(lengths), H, DH)
    np.testing.assert_allclose(got.numpy(), _jax(*arrs), atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(got.numpy(), tref.paged_decode_attention_ref(*_torch(*arrs)),
                               atol=ATOL, rtol=RTOL)


def test_split_ref_reads_a_column_slice_of_the_table():
    """The engine attends through the table's first columns
    (``tbl[:, :a_blocks]``, rows still the full table's stride) with the
    lengths clamped to them."""
    q, kp, vp, tbl, lens = _inputs(5, (100, 40, 17, 3), 8)
    t = torch.from_numpy(tbl)[:, :4]
    lw = torch.clamp(torch.from_numpy(lens), max=4 * BS)
    got = tref.paged_decode_attention_split_ref(*_torch(q, kp, vp), t, lw, 64)
    want = tref.paged_decode_attention_ref(*_torch(q, kp, vp), t.contiguous(), lw)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(got.numpy(), _jax(q, kp, vp, t.numpy(), lw.numpy()),
                               atol=ATOL, rtol=RTOL)


def test_split_ref_never_reads_past_the_length():
    """Poisoning every block the lanes do not reach changes no bit."""
    q, kp, vp, tbl, lens = _torch(*_inputs(7, (70, 33, 17, 130), 16))
    want = tref.paged_decode_attention_split_ref(q, kp, vp, tbl, lens, 64)
    for b, n in enumerate(lens.tolist()):
        for col in range(-(-n // BS), tbl.shape[1]):
            kp[tbl[b, col]] = vp[tbl[b, col]] = -POISON
    assert torch.equal(tref.paged_decode_attention_split_ref(q, kp, vp, tbl, lens, 64), want)


@pytest.mark.parametrize("entry", [-1, "n_blocks"])
def test_split_ref_out_of_range_entry_contributes_nothing(entry):
    """An entry outside [0, n_blocks) inside the length reads nothing: the
    result is the plain version over the table with that column removed
    and the length cut by one block."""
    q, kp, vp, tbl, lens = _inputs(11, (100, 70, 40, 64), 8)
    col = 1
    bad = tbl.copy()
    bad[:, col] = -1 if entry == -1 else kp.shape[0] + 3
    got = tref.paged_decode_attention_split_ref(*_torch(q, kp, vp, bad, lens), 32)
    cut = np.concatenate([tbl[:, :col], tbl[:, col + 1:], tbl[:, :1]], axis=1)
    want_t = tref.paged_decode_attention_ref(*_torch(q, kp, vp, cut, lens - BS))
    np.testing.assert_allclose(got.numpy(), want_t.numpy(), atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(got.numpy(), _jax(q, kp, vp, cut, lens - BS), atol=ATOL,
                               rtol=RTOL)


def test_split_ref_zero_length_lane_gives_zeros():
    """Zeros, as the kernel writes them; the JAX reference gives NaN there,
    so the port's plain version is the one to match."""
    q, kp, vp, tbl, lens = _torch(*_inputs(0, (0, 5, 0, 900), 64))
    got = tref.paged_decode_attention_split_ref(q, kp, vp, tbl, lens, 64)
    assert torch.equal(got[0], torch.zeros_like(got[0])) and torch.equal(got[2], got[0])
    np.testing.assert_allclose(got.numpy(), tref.paged_decode_attention_ref(q, kp, vp, tbl, lens),
                               atol=ATOL, rtol=RTOL)


def test_split_ref_dropping_one_rank_is_seen():
    """The fault the card check plants (one rank's partial left out of the
    merge) moves the result far beyond the float32 tolerance, whichever
    rank it is."""
    q, kp, vp, tbl, lens = _torch(*_inputs(3, (1000, 700, 513, 300), 64))
    want = tref.paged_decode_attention_ref(q, kp, vp, tbl, lens)
    for r in range(8):
        dropped = tref.paged_decode_attention_split_ref(q, kp, vp, tbl, lens, 64, skip_ranks=(r,))
        assert float((dropped - want).abs().max()) > 100 * (ATOL + RTOL * float(want.abs().max()))


def test_wrapper_refuses_what_the_kernel_does_not_take():
    """Before any build: a head dim without an instantiation, and a pool
    that does not start on a 16-byte boundary."""
    q, kp, vp, tbl, lens = _torch(*_inputs(1, (3, 9), 2))
    with pytest.raises(ValueError, match="head dim"):
        tpaged.paged_decode_attention_cuda(q[..., :48].contiguous(), kp[..., :48].contiguous(),
                                           vp[..., :48].contiguous(), tbl, lens)
    flat = torch.zeros(kp.numel() + 1)
    shifted = flat[1:].view(kp.shape)
    with pytest.raises(ValueError, match="16-byte"):
        tpaged.paged_decode_attention_cuda(q, shifted, vp, tbl, lens)
