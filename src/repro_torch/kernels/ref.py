"""Plain PyTorch versions of the port's kernels (mirroring
``repro/kernels/ref.py``): the ground truth the CUDA kernels are held to on
the card, and the path the kernel wrappers take for CPU tensors."""
from __future__ import annotations

import torch


def qrlora_matmul_ref(x, W, B, A, lam, scale: float = 1.0):
    """One-λ adapter matmul: ``y = x·W + ((x·B) * λ)·A·scale``.

    x (M,K); W (K,N); B (K,r); A (r,N); λ (r,).  Products and sums in fp32,
    result in x's dtype.
    """
    xf = x.float()
    y = xf @ W.float()
    low = ((xf @ B.float()) * lam.float()) @ A.float()
    return (y + low * scale).to(x.dtype)


def qrlora_bgmv_ref(x, W, B, A, lam_table, seg, scale: float = 1.0):
    """Batched multi-λ adapter matmul: ``y_m = x_m·W + ((x_m·B) * Λ[seg_m])·A``.

    x (M,K); W (K,N); B (K,r); A (r,N); Λ (n_slots,r) fp32; seg (M,) int —
    per-row adapter-slot ids (slot 0 is the all-zero base-model tenant).
    Products and sums in fp32, result in x's dtype.
    """
    lam_rows = lam_table[seg.long()].float()  # (M, r)
    xf = x.float()
    y = xf @ W.float()
    low = ((xf @ B.float()) * lam_rows) @ A.float()
    return (y + low * scale).to(x.dtype)


def qrlora_matmul_quant_ref(x, q, w_scale, B, A, lam, scale: float = 1.0):
    """Quantized-base one-λ matmul: ``y = (x·q)·w_scale + ((x·B)·λ)·A·scale``.

    q (K,N) int8/float8_e4m3fn; w_scale (N,) fp32 per output channel.  The
    dequant multiply comes after the contraction and is rounded in fp32
    before the adapter term is added (multiply, then add: the order the
    reference pins with ``optimization_barrier``; eager PyTorch never fuses
    the two into one FMA).  Result in x's dtype.
    """
    xf = x.float()
    y = (xf @ q.float()) * w_scale.float()
    low = ((xf @ B.float()) * lam.float()) @ A.float()
    return (y + low * scale).to(x.dtype)


def qrlora_bgmv_quant_ref(x, q, w_scale, B, A, lam_table, seg, scale: float = 1.0):
    """Quantized-base batched multi-λ matmul:
    ``y_m = (x_m·q)·w_scale + ((x_m·B) * Λ[seg_m])·A·scale``, with the
    epilogue of :func:`qrlora_matmul_quant_ref`."""
    lam_rows = lam_table[seg.long()].float()  # (M, r)
    xf = x.float()
    y = (xf @ q.float()) * w_scale.float()
    low = ((xf @ B.float()) * lam_rows) @ A.float()
    return (y + low * scale).to(x.dtype)


def paged_decode_attention_ref(q, k_pool, v_pool, block_tbl, lengths):
    """Paged decode attention via a plain block-table gather.

    q (B,H,dh); pools (n_blocks, bs, KV, dh); block_tbl (B, max_blocks)
    int pool indices; lengths (B,) int valid positions per lane → (B,H,dh).
    Logical position ``t`` of lane ``b`` lives at
    ``pool[block_tbl[b, t // bs], t % bs]``.  A lane of length 0 gives zeros
    (the kernel's convention; the JAX reference gives NaN there).
    """
    B, H, dh = q.shape
    _, bs, KV, _ = k_pool.shape
    width = block_tbl.shape[1] * bs
    tbl = block_tbl.long()
    rep = H // KV
    k = k_pool[tbl].reshape(B, width, KV, dh).repeat_interleave(rep, dim=2)
    v = v_pool[tbl].reshape(B, width, KV, dh).repeat_interleave(rep, dim=2)
    s = torch.einsum("bhd,bkhd->bhk", q.float(), k.float()) * dh**-0.5
    valid = torch.arange(width, device=q.device)[None, :] < lengths[:, None]
    s = s.masked_fill(~valid[:, None, :], float("-inf"))
    p = torch.softmax(s, dim=-1).to(v.dtype)
    o = torch.einsum("bhk,bkhd->bhd", p.float(), v.float())
    o = torch.where((lengths > 0)[:, None, None], o, torch.zeros_like(o))
    return o.to(q.dtype)
