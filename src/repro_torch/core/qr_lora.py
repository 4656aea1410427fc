"""QR-LoRA adapter init (port of ``repro/core/qr_lora.py``).

For a frozen weight ``W0 (d_in × d_out)`` with pivoted QR ``W0 · P = Q · R``
the update is ``ΔW = Q[:, :r] · diag(λ) · R̃[:r, :]`` with ``R̃ = R · Pᵀ``;
only the r scalars λ train (init 0).  Factors are zero-padded to a static
``rank_cap``, which makes the λ gradient of padded entries exactly zero.
"""
from __future__ import annotations

from typing import Dict, Sequence, Tuple

import torch

from repro_torch.configs.base import AdapterConfig
from repro_torch.core.pivoted_qr import qr_pivoted, select_rank, unpermute_columns


def qr_lora_init_single(
    W: torch.Tensor, cfg: AdapterConfig, dtype=torch.bfloat16
) -> Tuple[Dict[str, torch.Tensor], int]:
    """Frozen (B, A) factors + zero λ for one weight matrix; returns
    ``({"B","A","lam"}, r)`` with B (d_in, rank_cap), A (rank_cap, d_out)
    and the selected true rank r."""
    d_in, d_out = W.shape
    cap = min(cfg.rank_cap, d_in, d_out)
    Q, R, perm = qr_pivoted(W)
    r = min(select_rank(torch.diagonal(R), cfg.rank_policy, cfg.tau, cfg.rank), cap)
    Rt = unpermute_columns(R, perm)
    col_mask = (torch.arange(cap, device=W.device) < r).to(torch.float32)
    return (
        {
            "B": (Q[:, :cap] * col_mask[None, :]).to(dtype),
            "A": (Rt[:cap, :] * col_mask[:, None]).to(dtype),
            "lam": torch.zeros((cap,), dtype=torch.float32, device=W.device),
        },
        r,
    )


def qr_lora_init_stacked(
    W_stacked: torch.Tensor,
    layer_mask: Sequence[bool],
    cfg: AdapterConfig,
    dtype=torch.bfloat16,
) -> Dict[str, torch.Tensor]:
    """Adapters for a (n_layers, d_in, d_out) stacked projection.  Layers
    without an adapter get all-zero factors; an int32 ``ranks`` (n_layers,)
    vector keeps the selected ranks for the paper's parameter count."""
    n_layers, d_in, d_out = W_stacked.shape
    cap = min(cfg.rank_cap, d_in, d_out)
    dev = W_stacked.device
    B = torch.zeros((n_layers, d_in, cap), dtype=torch.float32, device=dev)
    A = torch.zeros((n_layers, cap, d_out), dtype=torch.float32, device=dev)
    ranks = torch.zeros((n_layers,), dtype=torch.int32, device=dev)
    for l in range(n_layers):
        if not layer_mask[l]:
            continue
        adp, r = qr_lora_init_single(W_stacked[l], cfg, dtype=torch.float32)
        B[l], A[l], ranks[l] = adp["B"], adp["A"], r
    return {
        "B": B.to(dtype),
        "A": A.to(dtype),
        "lam": torch.zeros((n_layers, cap), dtype=torch.float32, device=dev),
        "ranks": ranks,
    }
