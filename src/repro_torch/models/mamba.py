"""Mamba (S6) block, the jamba hybrid's sequence mixer (port of
``repro/models/mamba.py``).

A selective SSM with input-dependent (dt, B, C):

    h_t = exp(dt_t ⊙ A) ⊙ h_{t-1} + (dt_t · xc_t) ⊗ B_t,    y_t = h_t · C_t

Decode is the O(1) recurrent step.  A prompt runs the same recurrence in
chunks of ``_CHUNK`` positions: a chunk's discretised factors exp(dt·A) and
dt·xc⊗B are built at once, (B, c, d_in, N), and the recurrence steps through
the chunk in order from the state the previous chunk carried.  The reference
scans inside a chunk with ``jax.lax.associative_scan``; torch has no stable
associative scan, so the port steps, which sums in another order (float32
state throughout; the bound is stated where the two are compared).  The
whole-prompt (B, S, d_in, N) tensor is never built.

Bucketed prefill: ``length`` (B,) marks each row's true prompt length; the
padded positions get dt = 0, so exp(dt·A) = 1 and dt·xc⊗B = 0 — each padded
step is an exact identity — and the conv carry is gathered at positions
``[length-dc+1, length)``, so the state a padded prompt leaves is the state
the unpadded one leaves.

The adapter leaves of the ``m_in`` and ``m_out`` projections (targets
``mamba_in``/``mamba_out``) are looked up under those weight names, one
Mamba layer's slice at a time.  (The reference's mixer looks them up under
the target names, which no attached adapter carries, so there they never
apply.)
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.core.adapter_api import adapted_matmul
from repro_torch.models.layers import normal, stacked_dense_init

_CHUNK = 256


def dt_rank(cfg: ModelConfig) -> int:
    return max(1, int(math.ceil(cfg.d_model / 16)))


def init_mamba_params(gen: torch.Generator, cfg: ModelConfig, n: int, dtype) -> Dict:
    """``n`` Mamba layers, stacked, on the generator's device (the
    reference's tree and distributions; the dt bias puts softplus(dt_b) in
    [1e-3, 1e-1], the mamba default)."""
    d = cfg.d_model
    di = cfg.mamba_expand * d
    N, dc, dr = cfg.mamba_d_state, cfg.mamba_d_conv, dt_rank(cfg)
    dev = gen.device
    m_in = stacked_dense_init(gen, n, d, di, dtype)
    m_gate = stacked_dense_init(gen, n, d, di, dtype)
    m_conv = normal(gen, (n, di, dc), 1.0 / math.sqrt(dc), dtype)
    m_xproj = stacked_dense_init(gen, n, di, dr + 2 * N, dtype)
    m_dt_w = stacked_dense_init(gen, n, dr, di, torch.float32)
    u = torch.rand((n, di), generator=gen, device=dev, dtype=torch.float32)
    dt_init = torch.exp(u * (math.log(0.1) - math.log(1e-3)) + math.log(1e-3))
    dt_b = dt_init + torch.log1p(-torch.exp(-dt_init))  # inverse softplus
    A = torch.arange(1, N + 1, dtype=torch.float32, device=dev).expand(n, di, N)
    return {
        "m_in": m_in,
        "m_gate": m_gate,
        "m_conv": m_conv,
        "m_xproj": m_xproj,
        "m_dt_w": m_dt_w,
        "m_dt_b": dt_b,
        "m_A_log": torch.log(A).contiguous(),
        "m_D": torch.ones((n, di), dtype=torch.float32, device=dev),
        "m_out": stacked_dense_init(gen, n, di, d, dtype, scale=1.0 / (2 * cfg.n_layers) ** 0.5),
    }


def _causal_conv(x: torch.Tensor, w: torch.Tensor, prev: Optional[torch.Tensor] = None,
                 length: Optional[torch.Tensor] = None):
    """Depthwise causal conv: x (B, S, di), w (di, dc), prev (B, dc-1, di)
    the carried inputs (zeros when None) → (out (B, S, di) in x's dtype,
    the new carry).  The taps sum in float32 in tap order, as the
    reference's.  With ``length`` (B,) the carry is each row's last dc-1
    inputs before its padding, positions ``[length-dc+1, length)``."""
    B, S, di = x.shape
    dc = w.shape[-1]
    if prev is None:
        prev = torch.zeros((B, dc - 1, di), dtype=x.dtype, device=x.device)
    xp = torch.cat([prev.to(x.dtype), x], dim=1)  # (B, S+dc-1, di)
    w32 = w.float()
    out = torch.zeros((B, S, di), dtype=torch.float32, device=x.device)
    for j in range(dc):
        out = out + xp[:, j:j + S].float() * w32[:, j]
    if dc <= 1:
        new_prev = prev
    elif length is None:
        new_prev = xp[:, -(dc - 1):]
    else:
        # xp position j holds input position j-(dc-1): the carry is xp
        # positions length + [0, dc-1)
        idx = length.long()[:, None] + torch.arange(dc - 1, device=x.device)[None, :]
        new_prev = torch.gather(xp, 1, idx[:, :, None].expand(-1, -1, di))
    return out.to(x.dtype), new_prev


def _ssm_scan_chunked(dt, xc, Bs, Cs, A, h0):
    """y_t = C_t · h_t,  h_t = exp(dt_t⊙A) ⊙ h_{t-1} + (dt_t·xc_t)⊗B_t, all
    float32.  dt/xc (B, S, di); Bs/Cs (B, S, N); A (di, N); h0 (B, di, N).
    Returns (y (B, S, di), h_S).  Each chunk's (B, c, di, N) factors are
    built at once and stepped through in order; nothing of the whole
    sequence's size in N is built."""
    B, S, di = dt.shape
    h = h0
    ys = []
    for c0 in range(0, S, _CHUNK):
        c1 = min(S, c0 + _CHUNK)
        dt_c = dt[:, c0:c1]
        a = torch.exp(dt_c[..., None] * A)  # (B, c, di, N)
        b = (dt_c * xc[:, c0:c1])[..., None] * Bs[:, c0:c1, None, :]
        hs = []
        for t in range(c1 - c0):
            h = torch.addcmul(b[:, t], a[:, t], h)
            hs.append(h)
        h_all = torch.stack(hs, dim=1)  # (B, c, di, N)
        ys.append(torch.einsum("bcdn,bcn->bcd", h_all, Cs[:, c0:c1]))
    return torch.cat(ys, dim=1), h


def mamba_mixer(p: Dict, x: torch.Tensor, cfg: ModelConfig, state: Optional[Dict] = None,
                adp: Optional[Dict] = None, length: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, Optional[Dict]]:
    """x (B, S, d) → (y (B, S, d), new state).  ``state`` {"conv", "h"}: one
    decode step when S == 1, else a prefill that also returns the state it
    leaves (None without a state).  ``length`` (B,): the true prompt lengths
    of a bucketed prefill (see the module docstring)."""
    B, S, d = x.shape
    N, dr = cfg.mamba_d_state, dt_rank(cfg)
    decode = state is not None and S == 1
    adp = adp or {}

    u = adapted_matmul(x, p["m_in"], adp.get("m_in"))  # (B, S, di)
    z = x @ p["m_gate"]
    xc, new_conv = _causal_conv(u, p["m_conv"], state["conv"] if decode else None,
                                length=None if decode else length)
    xc = F.silu(xc)

    proj = xc @ p["m_xproj"]  # (B, S, dr + 2N)
    dt_r, Bs, Cs = torch.split(proj, [dr, N, N], dim=-1)
    dt = F.softplus(dt_r.float() @ p["m_dt_w"] + p["m_dt_b"])  # (B, S, di) fp32
    A = -torch.exp(p["m_A_log"])  # (di, N)
    xc32 = xc.float()

    if decode:
        dA = torch.exp(dt[:, 0, :, None] * A)  # (B, di, N)
        dBx = (dt[:, 0] * xc32[:, 0])[..., None] * Bs.float()[:, 0, None, :]
        h = dA * state["h"] + dBx
        y = torch.einsum("bdn,bn->bd", h, Cs[:, 0].float())[:, None]
        new_state = {"conv": new_conv, "h": h}
    else:
        if length is not None:
            # dt = 0 at padded positions: each padded step is the identity
            valid = torch.arange(S, device=x.device)[None, :] < length.to(x.device)[:, None]
            dt = torch.where(valid[..., None], dt, 0.0)
        h0 = torch.zeros((B, dt.shape[2], N), dtype=torch.float32, device=x.device)
        y, h_last = _ssm_scan_chunked(dt, xc32, Bs.float(), Cs.float(), A, h0)
        new_state = {"conv": new_conv, "h": h_last} if state is not None else None
    y = y + p["m_D"] * xc32
    y = y.to(x.dtype) * F.silu(z)
    return adapted_matmul(y, p["m_out"], adp.get("m_out")), new_state


def init_mamba_state(cfg: ModelConfig, batch: int, n: Tuple[int, ...], dtype, device=None):
    """Decode state stacked over the lead axes ``n`` (e.g. (n_groups, 7)):
    the conv carry (…, batch, dc-1, d_in) in ``dtype``, h (…, batch, d_in,
    N) float32."""
    di = cfg.mamba_expand * cfg.d_model
    return {
        "conv": torch.zeros((*n, batch, cfg.mamba_d_conv - 1, di), dtype=dtype, device=device),
        "h": torch.zeros((*n, batch, di, cfg.mamba_d_state), dtype=torch.float32, device=device),
    }


def state_lane_axes(lead_ndim: int) -> Dict[str, int]:
    """LaneState protocol: the lane axis of :func:`init_mamba_state`'s
    leaves sits after the ``lead_ndim`` stacked lead axes."""
    return {"conv": lead_ndim, "h": lead_ndim}
