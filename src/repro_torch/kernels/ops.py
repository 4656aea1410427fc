"""Model-facing wrappers around the port's kernels (port of the serving half
of ``repro/kernels/ops.py``): batching conventions on top of the 2-D/3-D
kernel wrappers, which pick the kernel (CUDA tensors) or its plain version
(CPU tensors)."""
from __future__ import annotations

import torch

from repro_torch.kernels import paged_attention as _paged
from repro_torch.kernels import qrlora_bgmv as _bgmv


def qrlora_bgmv(x, W, B, A, lam_table, seg, scale: float = 1.0) -> torch.Tensor:
    """``y[m] = x[m]·W + ((x[m]·B) * Λ[seg[m]])·A·scale``.

    ``x (..., K)``; ``seg`` is per *sequence* (``(batch,)`` for a
    ``(batch, S, K)`` input — every token of a sequence takes its tenant's
    λ) or per row (``(M,)`` matching flattened x).  ``lam_table
    (n_slots, r)`` fp32.  The reference pads rows to its block size with
    slot 0; the kernel masks its ragged last row tile the same way (rows past
    M read as zeros in slot 0), so no padded copy of x is made here.
    """
    orig_shape = x.shape
    x2 = x.reshape(-1, x.shape[-1])
    M = x2.shape[0]
    seg = seg.to(torch.int32)
    if x.ndim >= 3 and seg.shape[0] != M:
        seg = seg.repeat_interleave(M // seg.shape[0])  # tokens inherit their sequence's slot
    y = _bgmv.qrlora_bgmv(x2.contiguous(), W, B, A, lam_table, seg.contiguous(), scale)
    return y.reshape(*orig_shape[:-1], W.shape[1])


def paged_decode_attention(q, k_pool, v_pool, block_tbl, lengths) -> torch.Tensor:
    """q (B,1,H,dh) or (B,H,dh); pools (n_blocks, bs, KV, dh); block_tbl
    (B, max_blocks) int32; lengths (B,) int32 → same rank as q."""
    squeeze = q.ndim == 4
    if squeeze:
        q = q[:, 0]
    o = _paged.paged_decode_attention(q.contiguous(), k_pool, v_pool, block_tbl, lengths)
    return o[:, None] if squeeze else o
