"""GQA attention: full-sequence, dense-cache and paged-cache paths (port of
``repro/models/attention.py`` for the dense serving slice).

Prefill attention stays plain torch (the reference leaves it to XLA); the
paged decode attend goes through :func:`repro_torch.kernels.ops.
paged_decode_attention` — the Hopper kernel for CUDA tensors.  The
projections go through :func:`repro_torch.core.adapter_api.adapted_matmul`.

Caches are written in place (the reference returns updated copies); the
decoder advances the offsets once per step after all layers have run.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.adapter_api import adapted_matmul
from repro_torch.kernels import ops
from repro_torch.models.lane_state import NO_LANE
from repro_torch.models.layers import apply_rope, stacked_dense_init

_NEG = -1e30


def init_attn_params(gen: torch.Generator, cfg: ModelConfig, n: int, dtype) -> Dict:
    H, KV, dh, d = cfg.n_heads, cfg.n_kv_heads, cfg.d_head, cfg.d_model
    return {
        "wq": stacked_dense_init(gen, n, d, H * dh, dtype),
        "wk": stacked_dense_init(gen, n, d, KV * dh, dtype),
        "wv": stacked_dense_init(gen, n, d, KV * dh, dtype),
        "wo": stacked_dense_init(gen, n, H * dh, d, dtype, scale=1.0 / (2 * cfg.n_layers) ** 0.5),
    }


def _project_qkv(p, x, cfg: ModelConfig, adp):
    """Project to q (B,S,H,dh) and k, v (B,S,KV,dh)."""
    H, KV, dh = cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    B = x.shape[0]
    adp = adp or {}
    q = adapted_matmul(x, p["wq"], adp.get("wq"))
    k = adapted_matmul(x, p["wk"], adp.get("wk"))
    v = adapted_matmul(x, p["wv"], adp.get("wv"))
    return q.reshape(B, -1, H, dh), k.reshape(B, -1, KV, dh), v.reshape(B, -1, KV, dh)


def _softmax_attend(q, k, v, mask, scale):
    """Grouped-query attention without materializing repeated K/V.

    q (B,Sq,H,dh); k, v (B,Sk,KV,dh); mask broadcastable to
    (B,1,1,Sq,Sk).  Scores and softmax in fp32; probabilities take v's
    dtype before the PV product, as in the reference."""
    B, Sq, H, dh = q.shape
    KV = k.shape[2]
    qg = q.reshape(B, Sq, KV, H // KV, dh)
    scores = torch.einsum("bqgrd,bkgd->bgrqk", qg.float(), k.float()) * scale
    scores = scores.masked_fill(~mask, _NEG)
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    out = torch.einsum("bgrqk,bkgd->bqgrd", probs.float(), v.float())
    return out.reshape(B, Sq, H, dh).to(q.dtype)


def _causal_mask(S: int, device) -> torch.Tensor:
    pos = torch.arange(S, device=device)
    return (pos[None, :] <= pos[:, None])[None, None, None]


def attention(
    p: Dict,
    x: torch.Tensor,
    cfg: ModelConfig,
    *,
    positions: torch.Tensor,
    adp: Optional[Dict] = None,
    cache: Optional[Dict] = None,
    attend_blocks: Optional[int] = None,
) -> torch.Tensor:
    """Returns the attention block's output (B,S,d).

    * ``cache=None``                     — full causal pass, no cache.
    * dense cache (``k``/``v``/``idx``)  — lock-step prefill (S > 1) or
      decode (S == 1) at the scalar offset ``idx``.
    * paged cache (``block_tbl``)        — block-aligned prefill (S > 1,
      :func:`_paged_prefill`) or one decode step (:func:`_paged_decode`).

    ``attend_blocks`` bounds the paged decode attend to the table's first
    that-many columns (the engine's active-lane high-water mark).
    """
    H, dh = cfg.n_heads, cfg.d_head
    B, S = x.shape[:2]
    scale = dh**-0.5
    q, k, v = _project_qkv(p, x, cfg, adp)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    if cache is not None and "block_tbl" in cache:
        if S != 1:
            out = _paged_prefill(q, k, v, cache, positions, scale)
        else:
            out = _paged_decode(q, k, v, cache, scale, attend_blocks)
    elif cache is not None:
        idx = int(cache["idx"])  # lock-step offset (reference decode path)
        cache["k"][:, idx: idx + S] = k.to(cache["k"].dtype)
        cache["v"][:, idx: idx + S] = v.to(cache["v"].dtype)
        if S == 1:
            kpos = torch.arange(cache["k"].shape[1], device=x.device)
            mask = (kpos <= idx)[None, None, None, None, :]
            out = _softmax_attend(
                q, cache["k"].to(q.dtype), cache["v"].to(q.dtype), mask, scale
            )
        else:
            out = _softmax_attend(q, k, v, _causal_mask(S, x.device), scale)
    else:
        out = _softmax_attend(q, k, v, _causal_mask(S, x.device), scale)
    return adapted_matmul(out.reshape(B, S, H * dh), p["wo"], (adp or {}).get("wo"))


def _scatter_rows(pool: torch.Tensor, flat: torch.Tensor, rows: torch.Tensor) -> None:
    """``pool[flat // bs, flat % bs] = rows`` in place: pool (n_blocks, bs,
    KV, dh) viewed flat over its token slots."""
    n_blocks, bs = pool.shape[:2]
    pool.view(n_blocks * bs, *pool.shape[2:])[flat] = rows.to(pool.dtype)


def _paged_prefill(q, k, v, cache, positions, scale):
    """Block-aligned prefill against a paged cache view
    (``transformer.paged_prefill_view``): ``block_tbl`` names this pass's
    write targets, trash block 0 standing in for bucket padding.  Position
    ``t`` of lane ``b`` scatters to ``pool[tbl[b, t // bs], t % bs]``; the
    attention itself is the plain causal pass over the bucketed prompt."""
    B, S = q.shape[:2]
    bs = cache["k"].shape[1]
    tbl = cache["block_tbl"].long()
    pos = positions.long()
    blk = torch.gather(tbl, 1, (pos // bs).expand(B, S))
    flat = (blk * bs + pos[None, :] % bs).reshape(-1)
    _scatter_rows(cache["k"], flat, k.reshape(B * S, *k.shape[2:]))
    _scatter_rows(cache["v"], flat, v.reshape(B * S, *v.shape[2:]))
    return _softmax_attend(q, k, v, _causal_mask(S, q.device), scale)


def _paged_decode(q, k, v, cache, scale, attend_blocks: Optional[int] = None):
    """One decode step against a paged cache: ``k``/``v`` pools (n_blocks,
    bs, KV, dh), ``block_tbl`` (B, max_blocks) int32, ``idx`` (B,) lane
    lengths.  The step's K/V scatter flat into each lane's current block
    (idle lanes point at trash block 0, so the write needs no per-lane
    branch), then the kernel attends through the table's first
    ``attend_blocks`` columns; lanes longer than that bound (idle lanes with
    stale offsets) produce outputs the engine discards."""
    bs = cache["k"].shape[1]
    tbl, idx = cache["block_tbl"], cache["idx"]
    max_blocks = tbl.shape[1]
    idx64 = idx.long()
    col = torch.clamp(idx64 // bs, 0, max_blocks - 1)[:, None]
    blk = torch.gather(tbl.long(), 1, col)[:, 0]
    flat = blk * bs + idx64 % bs
    _scatter_rows(cache["k"], flat, k[:, 0])
    _scatter_rows(cache["v"], flat, v[:, 0])

    lengths = idx + 1  # the current position is valid
    if attend_blocks is not None and attend_blocks < max_blocks:
        a_blocks = max(attend_blocks, 1)
        tbl = tbl[:, :a_blocks]
        lengths = torch.clamp(lengths, max=a_blocks * bs)
    return ops.paged_decode_attention(
        q, cache["k"], cache["v"], tbl, lengths.to(torch.int32)
    )


def paged_kv_lane_axes():
    """Lane axes of the paged KV cache: the pools are global, only
    ``block_tbl`` (G, batch, max_blocks) and ``idx`` (G, batch) are per lane."""
    return {"k": NO_LANE, "v": NO_LANE, "block_tbl": 1, "idx": 1}
