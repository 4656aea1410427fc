"""xLSTM blocks (arXiv:2405.04517), the ssm family's mixers (port of
``repro/models/xlstm.py``): mLSTM (matrix memory, parallelisable) and sLSTM
(scalar memory, sequential with a hidden-to-hidden recurrence).

mLSTM has two forms that compute the same function:

* prefill and training — the log-space parallel form, chunked over query
  blocks so the score memory is O(S · chunk);
* decode — the stabilised recurrent form over the state (C, n, m).

The stabiliser is the reference's, kept exactly: the gates and states stay
in float32, a key's log weight is clipped by ``exp(min(w, 0))``, the
denominator is ``max(|Σ|, exp(-stab))``, and ``m`` starts at -1e30 (so a
lane reset restores -1e30, not zero).

sLSTM steps through time in a Python loop (the reference's ``lax.scan``).

Bucketed prefill: ``length`` (B,) marks each row's true prompt length.
mLSTM gives padded positions a zero input weight (ig → -1e30) and a forget
gate of one (lf → 0), so Σ log f and the stabiliser's max stop at position
length-1; sLSTM freezes each row's carry once t ≥ length.  Either way the
state a padded prompt leaves is the unpadded prompt's.

The v projection of the mLSTM block takes the last third of ``x_qkv``'s
columns, W and the adapter's A sliced alike (a view whose rows lie 3·d_in
apart; the kernels read it by its row stride).
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.core.adapter_api import adapted_matmul
from repro_torch.models.layers import normal, rms_norm, stacked_dense_init
from repro_torch.models.mamba import _causal_conv

_Q_CHUNK = 512
#: the stabiliser's "minus infinity": m's initial value and a padded
#: position's log input gate
NEG = -1e30


# ---------------------------------------------------------------------------
# mLSTM
# ---------------------------------------------------------------------------


def init_mlstm_params(gen: torch.Generator, cfg: ModelConfig, n: int, dtype) -> Dict:
    d, H = cfg.d_model, cfg.n_heads
    di = 2 * d  # projection factor 2
    dev = gen.device
    return {
        "x_up": stacked_dense_init(gen, n, d, 2 * di, dtype),
        "m_conv": normal(gen, (n, di, 4), 0.5, dtype),
        "x_qkv": stacked_dense_init(gen, n, di, 3 * di, dtype),
        "x_gates": normal(gen, (n, di, 2 * H), 0.02, torch.float32),
        "x_gates_b": torch.cat([torch.zeros((n, H), device=dev),
                                torch.full((n, H), 3.0, device=dev)], dim=-1),
        "head_norm": torch.ones((n, di), dtype=dtype, device=dev),
        "x_down": stacked_dense_init(gen, n, di, d, dtype, scale=1.0 / (2 * cfg.n_layers) ** 0.5),
    }


def _mlstm_parallel(q, k, v, ig, lf):
    """q, k, v (B, S, H, dh); ig, lf (B, S, H) float32 log input and log
    forget gates → (B, S, H, dh) in q's dtype, chunked over queries.  The
    scores and sums are float32 (bf16 products exact), as the reference's
    ``preferred_element_type``."""
    B, S, H, dh = q.shape
    scale = dh ** -0.5
    lf_cum = torch.cumsum(lf, dim=1)  # (B, S, H) inclusive Σ log f
    a = ig - lf_cum  # a key's log weight
    m_run = torch.cummax(a, dim=1).values  # running max over keys
    kpos = torch.arange(S, device=q.device)
    k32, v32 = k.float(), v.float()
    outs = []
    for c0 in range(0, S, _Q_CHUNK):
        c1 = min(S, c0 + _Q_CHUNK)
        lfq = lf_cum[:, c0:c1]
        # w_ij = lf_cum_i - lf_cum_j + ig_j for j ≤ i, less the stabiliser
        # lf_cum_i + max_{j≤i}(ig_j - lf_cum_j)
        stab = lfq + m_run[:, c0:c1]  # (B, c, H)
        w = lfq[:, :, None, :] + a[:, None, :, :] - stab[:, :, None, :]  # (B, c, S, H)
        causal = (kpos[None, :] <= kpos[c0:c1, None])[None, :, :, None]
        wexp = torch.where(causal, torch.exp(torch.clamp(w, max=0.0)), 0.0)
        s_raw = torch.einsum("bchd,bshd->bcsh", q[:, c0:c1].float(), k32) * scale
        sw = s_raw * wexp
        num = torch.einsum("bcsh,bshd->bchd", sw, v32)
        den = torch.maximum(torch.abs(sw.sum(2)), torch.exp(-stab))  # (B, c, H)
        outs.append((num / den[..., None]).to(q.dtype))
    return torch.cat(outs, dim=1)


def _mlstm_recurrent_step(state, q, k, v, ig, lf):
    """One decode step: state C (B, H, dh, dh), n (B, H, dh), m (B, H);
    q, k, v (B, H, dh); ig, lf (B, H) → (new state, h (B, H, dh))."""
    C, n, m = state["C"], state["n"], state["m"]
    scale = q.shape[-1] ** -0.5
    m_new = torch.maximum(lf + m, ig)
    fprime = torch.exp(lf + m - m_new)[..., None]
    iprime = torch.exp(ig - m_new)[..., None]
    k32, v32, q32 = k.float(), v.float(), q.float()
    C_new = C * fprime[..., None] + iprime[..., None] * (v32[:, :, :, None] * k32[:, :, None, :])
    n_new = n * fprime + iprime * k32
    num = torch.einsum("bhvk,bhk->bhv", C_new, q32) * scale
    den = torch.maximum(torch.abs(torch.einsum("bhk,bhk->bh", n_new, q32)) * scale,
                        torch.exp(-m_new))
    h = (num / den[..., None]).to(q.dtype)
    return {"C": C_new, "n": n_new, "m": m_new}, h


def mlstm_mixer(p: Dict, x: torch.Tensor, cfg: ModelConfig, state: Optional[Dict] = None,
                adp: Optional[Dict] = None, length: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, Optional[Dict]]:
    """x (B, S, d) → (y (B, S, d), new state).  ``state`` {"conv", "C", "n",
    "m"}: one decode step when S == 1, else a prefill that also returns the
    (C, n, m) it leaves.  ``length``: see the module docstring."""
    B, S, d = x.shape
    H = cfg.n_heads
    di = 2 * d
    dh = di // H
    decode = state is not None and S == 1
    adp = adp or {}

    up = adapted_matmul(x, p["x_up"], adp.get("x_up"))
    u, z = torch.chunk(up, 2, dim=-1)  # (B, S, di) each
    xc, new_conv = _causal_conv(u, p["m_conv"], state["conv"] if decode else None,
                                length=None if decode else length)
    xc = F.silu(xc)
    # q, k from the conv'd path, v from the raw up-projection; v goes
    # through the adapter too (the served path equals the λ-merged weight,
    # whose v columns carry the adapter's delta): W's and A's last 3rd
    adp_qkv = adp.get("x_qkv")
    q, k, _ = torch.chunk(adapted_matmul(xc, p["x_qkv"], adp_qkv), 3, dim=-1)
    adp_v = None if adp_qkv is None else {**adp_qkv, "A": adp_qkv["A"][..., 2 * di:]}
    v = adapted_matmul(u, p["x_qkv"][..., 2 * di:], adp_v)
    q, k, v = (t.reshape(B, S, H, dh) for t in (q, k, v))
    gates = xc.float() @ p["x_gates"] + p["x_gates_b"]  # (B, S, 2H)
    ig, fg = torch.chunk(gates, 2, dim=-1)
    lf = F.logsigmoid(fg)
    if not decode and length is not None:
        # padded steps: zero input weight, forget gate one
        valid = (torch.arange(S, device=x.device)[None, :]
                 < length.to(x.device)[:, None])[..., None]
        ig = torch.where(valid, ig, NEG)
        lf = torch.where(valid, lf, 0.0)

    if decode:
        inner = {"C": state["C"], "n": state["n"], "m": state["m"]}
        new_inner, h = _mlstm_recurrent_step(inner, q[:, 0], k[:, 0], v[:, 0], ig[:, 0],
                                             lf[:, 0])
        h = h[:, None]
        new_state = {"conv": new_conv, **new_inner}
    else:
        h = _mlstm_parallel(q, k, v, ig, lf)
        new_state = None
        if state is not None:  # prefill: the (C, n, m) the prompt leaves
            lf_cum = torch.cumsum(lf, dim=1)
            m_end = lf_cum[:, -1] + torch.max(ig - lf_cum, dim=1).values  # (B, H)
            w = torch.exp(lf_cum[:, -1:] - lf_cum + ig - m_end[:, None])  # (B, S, H)
            kw = k.float() * w[..., None]
            C_end = torch.einsum("bshv,bshk->bhvk", v.float(), kw)
            new_state = {"conv": new_conv, "C": C_end, "n": kw.sum(dim=1), "m": m_end}
    h = rms_norm(h.reshape(B, S, di), p["head_norm"], cfg.norm_eps)
    out = adapted_matmul(h * F.silu(z), p["x_down"], adp.get("x_down"))
    return out, new_state


def init_mlstm_state(cfg: ModelConfig, batch: int, n: Tuple[int, ...], dtype, device=None):
    d, H = cfg.d_model, cfg.n_heads
    di = 2 * d
    dh = di // H
    f32 = dict(dtype=torch.float32, device=device)
    return {
        "conv": torch.zeros((*n, batch, 3, di), dtype=dtype, device=device),
        "C": torch.zeros((*n, batch, H, dh, dh), **f32),
        "n": torch.zeros((*n, batch, H, dh), **f32),
        "m": torch.full((*n, batch, H), NEG, **f32),
    }


def mlstm_state_lane_axes(lead_ndim: int) -> Dict[str, int]:
    """LaneState protocol: the lane axis of :func:`init_mlstm_state`'s
    leaves (``m`` starts at -1e30: a lane reset restores that)."""
    return {"conv": lead_ndim, "C": lead_ndim, "n": lead_ndim, "m": lead_ndim}


# ---------------------------------------------------------------------------
# sLSTM
# ---------------------------------------------------------------------------


def init_slstm_params(gen: torch.Generator, cfg: ModelConfig, n: int, dtype) -> Dict:
    d, H = cfg.d_model, cfg.n_heads
    dh = d // H
    ffd = max(1, int(4 * d / 3 / 2) * 2)
    dev = gen.device
    bias = torch.cat([torch.zeros(2 * d), torch.full((d,), 3.0), torch.zeros(d)])
    return {
        "x_qkv": stacked_dense_init(gen, n, d, 4 * d, dtype),  # z, i, f, o pre-activations
        "x_rec": normal(gen, (n, H, dh, 4 * dh), 1.0 / math.sqrt(dh), torch.float32),
        "x_gates_b": bias.to(dev).expand(n, 4 * d).contiguous(),
        "head_norm": torch.ones((n, d), dtype=dtype, device=dev),
        "x_up": stacked_dense_init(gen, n, d, 2 * ffd, dtype),
        "x_down": stacked_dense_init(gen, n, ffd, d, dtype, scale=1.0 / (2 * cfg.n_layers) ** 0.5),
    }


def _slstm_step(cfg: ModelConfig, p, state, wx_t):
    """state (c, n, h, m), each (B, d) float32; wx_t (B, 4d) the input
    pre-activations → the new state."""
    c, n, h, m = state
    B, d = c.shape
    H = cfg.n_heads
    rec = torch.einsum("bhk,hkj->bhj", h.reshape(B, H, d // H), p["x_rec"]).reshape(B, 4 * d)
    pre = wx_t.float() + rec + p["x_gates_b"]
    zt, it, ft, ot = torch.chunk(pre, 4, dim=-1)
    z = torch.tanh(zt)
    o = torch.sigmoid(ot)
    lf = F.logsigmoid(ft)
    m_new = torch.maximum(lf + m, it)
    iprime = torch.exp(it - m_new)
    fprime = torch.exp(lf + m - m_new)
    c_new = fprime * c + iprime * z
    n_new = torch.maximum(fprime * n + iprime, torch.exp(-m_new))
    return c_new, n_new, o * (c_new / n_new), m_new


def slstm_mixer(p: Dict, x: torch.Tensor, cfg: ModelConfig, state: Optional[Dict] = None,
                adp: Optional[Dict] = None, length: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, Optional[Dict]]:
    """x (B, S, d) → (y (B, S, d), new state).  ``state`` {"c", "n", "h",
    "m"}: one decode step when S == 1, else a prefill that also returns the
    state it leaves.  ``length``: each row's carry freezes once t ≥ length."""
    B, S, d = x.shape
    decode = state is not None and S == 1
    adp = adp or {}
    wx = adapted_matmul(x, p["x_qkv"], adp.get("x_qkv"))  # (B, S, 4d)
    if decode:
        st = _slstm_step(cfg, p, (state["c"], state["n"], state["h"], state["m"]), wx[:, 0])
        hs = st[2][:, None].to(x.dtype)
    else:
        zeros = torch.zeros((B, d), dtype=torch.float32, device=x.device)
        st = (zeros, zeros, zeros, torch.full((B, d), NEG, dtype=torch.float32, device=x.device))
        keep = None
        if length is not None:
            keep = (torch.arange(S, device=x.device)[:, None, None]
                    < length.to(x.device)[None, :, None])  # (S, B, 1)
        hs = []
        for t in range(S):
            new = _slstm_step(cfg, p, st, wx[:, t])
            if keep is not None:
                new = tuple(torch.where(keep[t], nw, old) for nw, old in zip(new, st))
            st = new
            hs.append(st[2])
        hs = torch.stack(hs, dim=1).to(x.dtype)
    new_state = None if state is None else {"c": st[0], "n": st[1], "h": st[2], "m": st[3]}
    hs = rms_norm(hs, p["head_norm"], cfg.norm_eps)
    # gated FFN (projection factor 4/3)
    u, g = torch.chunk(adapted_matmul(hs, p["x_up"], adp.get("x_up")), 2, dim=-1)
    return adapted_matmul(u * F.silu(g), p["x_down"], adp.get("x_down")), new_state


def init_slstm_state(cfg: ModelConfig, batch: int, n: Tuple[int, ...], dtype, device=None):
    d = cfg.d_model
    f32 = dict(dtype=torch.float32, device=device)
    return {
        "c": torch.zeros((*n, batch, d), **f32),
        "n": torch.zeros((*n, batch, d), **f32),
        "h": torch.zeros((*n, batch, d), **f32),
        "m": torch.full((*n, batch, d), NEG, **f32),
    }


def slstm_state_lane_axes(lead_ndim: int) -> Dict[str, int]:
    """LaneState protocol: the lane axis of :func:`init_slstm_state`'s leaves."""
    return {"c": lead_ndim, "n": lead_ndim, "h": lead_ndim, "m": lead_ndim}
