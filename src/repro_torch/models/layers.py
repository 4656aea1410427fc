"""Shared building blocks: RMS and layer norms, rotary embeddings,
initializers (port of ``repro/models/layers.py``)."""
from __future__ import annotations

import math

import torch


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * scale.float()).to(x.dtype)


def layer_norm(
    x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor, eps: float = 1e-5
) -> torch.Tensor:
    """LayerNorm in fp32 (mean, biased variance, then ``rsqrt``), in x's dtype."""
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = ((xf - mu) ** 2).mean(dim=-1, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return (y * scale.float() + bias.float()).to(x.dtype)


def _rope_freqs(d_head: int, theta: float, device=None) -> torch.Tensor:
    exps = torch.arange(0, d_head, 2, dtype=torch.float32, device=device) / d_head
    return 1.0 / (theta ** exps)


_FREQS: dict = {}


def rope_freqs(d_head: int, theta: float, device=None) -> torch.Tensor:
    """The (d_head/2,) inverse frequencies, made once per (d_head, theta,
    device) and reused: a decode step would otherwise launch their kernels
    again in every layer.  Made under CUDA graph capture they are not kept
    (they would live in the graph's memory pool), nor on the meta device:
    the dry-run counts each traced step whole, whatever ran before it."""
    device = torch.device(device) if device is not None else torch.device("cpu")
    key = (d_head, theta, device)
    freqs = _FREQS.get(key)
    if freqs is None:
        freqs = _rope_freqs(d_head, theta, device)
        if device.type == "cpu" or (device.type == "cuda"
                                    and not torch.cuda.is_current_stream_capturing()):
            _FREQS[key] = freqs
    return freqs


def rope_rotation(positions: torch.Tensor, d_head: int, theta: float, device=None):
    """(cos, sin), each (..., S, 1, d_head/2), for ``positions`` (..., S): the
    rotation :func:`apply_rope` applies, made once for the q and k of a layer."""
    angles = positions[..., None].float() * rope_freqs(d_head, theta, device)  # (..., S, d/2)
    return torch.cos(angles)[..., None, :], torch.sin(angles)[..., None, :]


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float,
               rotation=None) -> torch.Tensor:
    """x: (..., S, n_heads, d_head); positions: broadcastable to (..., S).
    ``rotation``: :func:`rope_rotation` of the same positions, where the
    caller has made it already."""
    cos, sin = rotation or rope_rotation(positions, x.shape[-1], theta, x.device)
    x1, x2 = x.float().chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).to(x.dtype)


# ---------------------------------------------------------------------------
# Initializers — normal draws from an explicit generator, on its device
# ---------------------------------------------------------------------------


def normal(gen: torch.Generator, shape, std: float, dtype) -> torch.Tensor:
    t = torch.randn(shape, generator=gen, device=gen.device, dtype=torch.float32)
    return (t * std).to(dtype)


def stacked_normal(gen: torch.Generator, shape, std: float, dtype) -> torch.Tensor:
    """:func:`normal` drawn one leading index at a time into a stack
    allocated in ``dtype``: the float32 temporary is one layer's, not the
    whole stack's (moonshot-v1-16b-a3b's ``we_gate`` stack would be 35 GB
    of float32).  The distribution is :func:`normal`'s."""
    out = torch.empty(shape, dtype=dtype, device=gen.device)
    for i in range(shape[0]):
        out[i] = normal(gen, shape[1:], std, dtype)
    return out


def stacked_dense_init(
    gen: torch.Generator, n: int, d_in: int, d_out: int, dtype, scale: float = 1.0
) -> torch.Tensor:
    return normal(gen, (n, d_in, d_out), scale / math.sqrt(d_in), dtype)
