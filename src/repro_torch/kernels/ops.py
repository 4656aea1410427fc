"""Model-facing wrappers around the port's kernels (port of
``repro/kernels/ops.py``): batching conventions on top of the 2-D/3-D
kernel wrappers, which pick the kernel (CUDA tensors) or its plain version
(CPU tensors), the autograd rule of the trainable one-λ matmul, the
forward-only quantized-base variants, and the model-layout attention
wrappers (forward only, as the reference's)."""
from __future__ import annotations

import torch

from repro_torch.kernels import decode_attention as _decode
from repro_torch.kernels import flash_attention as _flash
from repro_torch.kernels import paged_attention as _paged
from repro_torch.kernels import qrlora_bgmv as _bgmv
from repro_torch.kernels import qrlora_matmul as _mm


def qrlora_matmul_bwd(x, W, B, A, lam, scale, g, need_dx: bool = True, need_dlam: bool = True):
    """The reference's ``_qrlora_bwd`` term for term, in fp32: with
    ``gA = g·Aᵀ``, ``dx = g·Wᵀ + ((gA·λ)·Bᵀ)·scale`` and
    ``dλ = Σ_m (x·B) ⊙ gA · scale``; dx in x's dtype, dλ in λ's.  W, B and
    A are frozen and get no gradient.  Returns ``(dx, dλ)``, None where not
    needed."""
    g2 = g.reshape(-1, g.shape[-1]).float()
    gA = g2 @ A.float().T  # (M, r)
    dx = dlam = None
    if need_dx:
        dx = g2 @ W.float().T + ((gA * lam.float()) @ B.float().T) * scale
        dx = dx.reshape(x.shape).to(x.dtype)
    if need_dlam:
        x2 = x.reshape(-1, x.shape[-1]).float()
        dlam = (((x2 @ B.float()) * gA).sum(0) * scale).to(lam.dtype)
    return dx, dlam


class _QRLoRAMatmul(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, W, B, A, lam, scale):
        ctx.save_for_backward(x, W, B, A, lam)
        ctx.scale = scale
        y = _mm.qrlora_matmul(x.reshape(-1, x.shape[-1]).contiguous(), W, B, A, lam, scale)
        return y.reshape(*x.shape[:-1], W.shape[1])

    @staticmethod
    def backward(ctx, g):
        x, W, B, A, lam = ctx.saved_tensors
        dx, dlam = qrlora_matmul_bwd(x, W, B, A, lam, ctx.scale, g,
                                     ctx.needs_input_grad[0], ctx.needs_input_grad[4])
        return dx, None, None, None, dlam, None


def qrlora_matmul(x, W, B, A, lam, scale: float = 1.0) -> torch.Tensor:
    """``y = x·W + ((x·B) * λ)·A·scale`` for ``x (..., K)`` and one λ (r,),
    differentiable in x and λ (the reference's custom VJP): the forward is
    the kernel for CUDA tensors and its plain version for CPU tensors; the
    backward is :func:`qrlora_matmul_bwd` on either.  ``scale`` is a
    constant.  Rows are not padded: the kernel masks its ragged last tile."""
    return _QRLoRAMatmul.apply(x, W, B, A, lam, scale)


def qrlora_matmul_quant(x, q, w_scale, B, A, lam, scale: float = 1.0) -> torch.Tensor:
    """Quantized-base ``y = (x·q)·w_scale + ((x·B) * λ)·A·scale`` for
    ``x (..., K)``, q (K, N) int8/fp8-e4m3 and w_scale (N,) fp32.
    Inference only, as the reference's: the quantized base sits behind
    frozen-W serving and training keeps the bf16 base, so there is no
    backward — a call that autograd would have to differentiate (x or λ
    requiring grad) raises instead of returning a detached result."""
    if torch.is_grad_enabled() and (x.requires_grad or lam.requires_grad):
        raise NotImplementedError(
            "qrlora_matmul_quant is forward only (inference on a quantized base); "
            "train λ on the unquantized base"
        )
    y = _mm.qrlora_matmul_quant(x.reshape(-1, x.shape[-1]).contiguous(), q, w_scale, B, A,
                                lam, scale)
    return y.reshape(*x.shape[:-1], q.shape[1])


def _seg_rows(seg, x2, ndim: int) -> torch.Tensor:
    """Per-sequence slot ids → per-row ids (tokens inherit their sequence's
    slot); per-row ids pass through."""
    seg = seg.to(torch.int32)
    M = x2.shape[0]
    if ndim >= 3 and seg.shape[0] != M:
        seg = seg.repeat_interleave(M // seg.shape[0])
    return seg.contiguous()


def qrlora_bgmv(x, W, B, A, lam_table, seg, scale: float = 1.0) -> torch.Tensor:
    """``y[m] = x[m]·W + ((x[m]·B) * Λ[seg[m]])·A·scale``.

    ``x (..., K)``; ``seg`` is per *sequence* (``(batch,)`` for a
    ``(batch, S, K)`` input — every token of a sequence takes its tenant's
    λ) or per row (``(M,)`` matching flattened x).  ``lam_table
    (n_slots, r)`` fp32.  The reference pads rows to its block size with
    slot 0; the kernel masks its ragged last row tile the same way (rows past
    M read as zeros in slot 0), so no padded copy of x is made here.
    """
    x2 = x.reshape(-1, x.shape[-1])
    y = _bgmv.qrlora_bgmv(x2.contiguous(), W, B, A, lam_table, _seg_rows(seg, x2, x.ndim), scale)
    return y.reshape(*x.shape[:-1], W.shape[1])


def qrlora_bgmv_quant(x, q, w_scale, B, A, lam_table, seg, scale: float = 1.0) -> torch.Tensor:
    """Quantized-base BGMV ``y[m] = (x[m]·q)·w_scale + ((x[m]·B) *
    Λ[seg[m]])·A·scale``, q (K, N) int8/fp8-e4m3, w_scale (N,) fp32; x and
    seg as :func:`qrlora_bgmv`."""
    x2 = x.reshape(-1, x.shape[-1])
    y = _bgmv.qrlora_bgmv_quant(x2.contiguous(), q, w_scale, B, A, lam_table,
                                _seg_rows(seg, x2, x.ndim), scale)
    return y.reshape(*x.shape[:-1], q.shape[1])


def qrlora_bgmv_sharded(x, W, B, A, lam_local, seg, *, group, scale: float = 1.0,
                        w_scale=None) -> torch.Tensor:
    """BGMV with the λ table sharded over its slot axis across ``group``
    (``lam_local`` is this rank's ``(n_slots / world, r)`` shard): the local
    masked gather, an all-reduce of the (M, r) rows, and the rows kernel
    (:func:`repro_torch.kernels.qrlora_bgmv.qrlora_bgmv_fused_sharded`).  W
    may be int8/fp8 q with ``w_scale``; x and seg as :func:`qrlora_bgmv`.
    Every rank of the group must call it, in the same order."""
    x2 = x.reshape(-1, x.shape[-1])
    y = _bgmv.qrlora_bgmv_fused_sharded(x2.contiguous(), W, B, A, lam_local,
                                        _seg_rows(seg, x2, x.ndim), group=group, scale=scale,
                                        w_scale=w_scale)
    return y.reshape(*x.shape[:-1], W.shape[1])


def paged_decode_attention(q, k_pool, v_pool, block_tbl, lengths) -> torch.Tensor:
    """q (B,1,H,dh) or (B,H,dh); pools (n_blocks, bs, KV, dh); block_tbl
    (B, max_blocks) int32; lengths (B,) int32 → same rank as q."""
    squeeze = q.ndim == 4
    if squeeze:
        q = q[:, 0]
    o = _paged.paged_decode_attention(q.contiguous(), k_pool, v_pool, block_tbl, lengths)
    return o[:, None] if squeeze else o


def _refuse_grad(name: str, *tensors) -> None:
    """The reference's attention kernels have no VJP: a call that autograd
    would have to differentiate raises, on the CPU as on the card."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise NotImplementedError(f"{name} is forward only (the reference kernel has no VJP)")


def flash_attention(q, k, v, *, causal: bool = True, bq: int = 512, bk: int = 512):
    """q (B,Sq,H,dh); k,v (B,Sk,KV,dh) → (B,Sq,H,dh).  ``bq``/``bk`` are the
    TPU kernel's tiling, accepted so that calls match the reference; the
    Hopper kernel picks its own tiles and reads the model layout by strides,
    so no transposes are made here."""
    _refuse_grad("flash_attention", q, k, v)
    return _flash.flash_attention(q, k, v, causal)


def decode_attention(q, k_cache, v_cache, length, *, bk: int = 512):
    """q (B,1,H,dh) or (B,H,dh); caches (B,S,KV,dh); ``length`` valid leading
    positions (an int, or a one-element int32 tensor on q's device, read by
    the kernel without a host sync) → same rank as q.  ``bk`` is the TPU
    kernel's block, accepted so that calls match the reference."""
    _refuse_grad("decode_attention", q, k_cache, v_cache)
    squeeze = q.ndim == 4
    if squeeze:
        q = q[:, 0]
    o = _decode.decode_attention(q.contiguous(), k_cache, v_cache, length)
    return o[:, None] if squeeze else o
