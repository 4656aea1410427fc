"""Shared building blocks: RMS norm, rotary embeddings, initializers (port of
``repro/models/layers.py``)."""
from __future__ import annotations

import math

import torch


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * scale.float()).to(x.dtype)


def rope_freqs(d_head: int, theta: float, device=None) -> torch.Tensor:
    exps = torch.arange(0, d_head, 2, dtype=torch.float32, device=device) / d_head
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (..., S, n_heads, d_head); positions: broadcastable to (..., S)."""
    freqs = rope_freqs(x.shape[-1], theta, x.device)
    angles = positions[..., None].float() * freqs  # (..., S, d/2)
    cos = torch.cos(angles)[..., None, :]  # (..., S, 1, d/2)
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).to(x.dtype)


# ---------------------------------------------------------------------------
# Initializers — normal draws from an explicit generator, on its device
# ---------------------------------------------------------------------------


def normal(gen: torch.Generator, shape, std: float, dtype) -> torch.Tensor:
    t = torch.randn(shape, generator=gen, device=gen.device, dtype=torch.float32)
    return (t * std).to(dtype)


def stacked_dense_init(
    gen: torch.Generator, n: int, d_in: int, d_out: int, dtype, scale: float = 1.0
) -> torch.Tensor:
    return normal(gen, (n, d_in, d_out), scale / math.sqrt(d_in), dtype)
