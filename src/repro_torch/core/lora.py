"""Baselines from the paper: standard LoRA and SVD-LoRA (port of
``repro/core/lora.py``).

Both share the QR-LoRA runtime formula ``y = x·W + ((x·B)·λ)·A·scale`` with
λ frozen at 1 — only the init and the trainable set differ:

* LoRA (Hu et al., 2022): A ~ N(0, 1/r), B = 0 (ΔW = 0 at init);
  A and B trainable; scale = α/r.
* SVD-LoRA (paper §4.1): B, A initialized from the top-k singular vectors of
  W0, zero-padded to rank r, scale = α/r.  With ``svd_subtract_init`` the
  initialized component is removed from W0 (PiSSA-style) so the effective
  weight — and hence the initial loss — is unchanged at step 0.

The singular vectors come from ``torch.linalg.svd`` in float32 on the
weight's device; they are defined up to sign, so only B·A, σ and the
subtracted W are comparable with the reference's ``np.linalg.svd``.
"""
from __future__ import annotations

import math
from typing import Dict, Sequence, Tuple

import torch

from repro_torch.configs.base import AdapterConfig


def _ranks(layer_mask: Sequence[bool], r: int, device) -> torch.Tensor:
    return torch.tensor([r if m else 0 for m in layer_mask], dtype=torch.int32, device=device)


def lora_init_stacked(
    gen: torch.Generator,
    W_stacked: torch.Tensor,
    layer_mask: Sequence[bool],
    cfg: AdapterConfig,
    dtype=torch.bfloat16,
) -> Dict[str, torch.Tensor]:
    """LoRA factors for a (n_layers, d_in, d_out) stacked projection: A drawn
    from ``gen`` (on its device), B zero, λ one on the adapted layers."""
    n_layers, d_in, d_out = W_stacked.shape
    r, dev = cfg.rank, W_stacked.device
    mask = torch.tensor(layer_mask, dtype=torch.float32, device=dev)[:, None, None]
    a = torch.randn((n_layers, r, d_out), generator=gen, device=gen.device,
                    dtype=torch.float32).to(dev) / math.sqrt(r)
    return {
        "B": torch.zeros((n_layers, d_in, r), dtype=dtype, device=dev),
        "A": (a * mask).to(dtype),
        "lam": torch.ones((n_layers, r), dtype=torch.float32, device=dev) * mask[:, :, 0],
        "ranks": _ranks(layer_mask, r, dev),
    }


def svd_lora_init_stacked(
    W_stacked: torch.Tensor,
    layer_mask: Sequence[bool],
    cfg: AdapterConfig,
    dtype=torch.bfloat16,
) -> Tuple[Dict[str, torch.Tensor], torch.Tensor]:
    """Returns (adapter, W_stacked with the initialized component subtracted
    when ``svd_subtract_init``, in W's dtype).  The subtraction uses the
    float32 factors, before they are cast to ``dtype``."""
    n_layers, d_in, d_out = W_stacked.shape
    r, k = cfg.rank, min(cfg.svd_k, cfg.rank)
    scale = cfg.alpha / cfg.rank
    dev = W_stacked.device
    B = torch.zeros((n_layers, d_in, r), dtype=torch.float32, device=dev)
    A = torch.zeros((n_layers, r, d_out), dtype=torch.float32, device=dev)
    W_new = W_stacked.detach().to(torch.float32).clone()
    for l in range(n_layers):
        if not layer_mask[l]:
            continue
        U, S, Vt = torch.linalg.svd(W_new[l], full_matrices=False)
        sq = torch.sqrt(S[:k])
        B[l, :, :k] = U[:, :k] * sq[None, :]
        A[l, :k, :] = sq[:, None] * Vt[:k, :]
        if cfg.svd_subtract_init:
            W_new[l] -= scale * (B[l, :, :k] @ A[l, :k, :])
    lam = torch.tensor([[1.0] * r if m else [0.0] * r for m in layer_mask],
                       dtype=torch.float32, device=dev).reshape(n_layers, r)
    return (
        {"B": B.to(dtype), "A": A.to(dtype), "lam": lam, "ranks": _ranks(layer_mask, r, dev)},
        W_new.to(W_stacked.dtype),
    )
