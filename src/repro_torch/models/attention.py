"""GQA attention: full-sequence, dense-cache (lock-step or per-lane) and
paged-cache paths (port of ``repro/models/attention.py`` for the dense
serving slice).

Prefill attention stays plain torch (the reference leaves it to XLA), and so
does the per-lane dense decode attend (the reference's ``_softmax_attend``
over the lane's whole ``max_len`` region, no Pallas kernel); the paged
decode attend goes through :func:`repro_torch.kernels.ops.
paged_decode_attention` — the Hopper kernel for CUDA tensors.  The
speculative verify's multi-row attend (:func:`_dense_verify`,
:func:`_paged_verify`) is plain torch in both layouts, as in the reference,
whose paged kernel is single-query.  The vlm family's cross-attention
(``cross_kv``: keys and values from the projected image rows, no RoPE, no
cache, every image row visible to every query) is plain torch too, as the
reference leaves it to XLA.  The projections go through
:func:`repro_torch.core.adapter_api.adapted_matmul`.

Caches are written in place (the reference returns updated copies); the
decoder advances the offsets once per step after all layers have run.  A
speculative draft decodes through a view whose ``write_limit`` (per lane,
an absolute position) keeps its writes inside the window the verify then
rewrites: past it a paged write goes to trash block 0 and a dense one is
dropped.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.adapter_api import adapted_matmul
from repro_torch.kernels import ops
from repro_torch.models.lane_state import NO_LANE
from repro_torch.models.layers import apply_rope, rms_norm, rope_rotation, stacked_dense_init

_NEG = -1e30


def init_attn_params(gen: torch.Generator, cfg: ModelConfig, n: int, dtype,
                     cross: bool = False) -> Dict:
    """Stacked projections; with ``qkv_bias`` zero biases ``bq``/``bk``/``bv``,
    with ``qk_norm`` unit per-head norm scales ``q_norm``/``k_norm``, and for
    a cross-attention stack (``cross``) the gate ``xa_gate`` (n,), float32
    whatever ``dtype`` and zero, as the reference initialises them."""
    H, KV, dh, d = cfg.n_heads, cfg.n_kv_heads, cfg.d_head, cfg.d_model
    p = {
        "wq": stacked_dense_init(gen, n, d, H * dh, dtype),
        "wk": stacked_dense_init(gen, n, d, KV * dh, dtype),
        "wv": stacked_dense_init(gen, n, d, KV * dh, dtype),
        "wo": stacked_dense_init(gen, n, H * dh, d, dtype, scale=1.0 / (2 * cfg.n_layers) ** 0.5),
    }
    dev = gen.device
    if cfg.qkv_bias:
        p["bq"] = torch.zeros((n, H * dh), dtype=dtype, device=dev)
        p["bk"] = torch.zeros((n, KV * dh), dtype=dtype, device=dev)
        p["bv"] = torch.zeros((n, KV * dh), dtype=dtype, device=dev)
    if cfg.qk_norm:
        p["q_norm"] = torch.ones((n, dh), dtype=dtype, device=dev)
        p["k_norm"] = torch.ones((n, dh), dtype=dtype, device=dev)
    if cross:
        p["xa_gate"] = torch.zeros((n,), dtype=torch.float32, device=dev)
    return p


def _project_qkv(p, x, cfg: ModelConfig, adp, kv_input=None):
    """Project to q (B,S,H,dh) and k, v (B,Skv,KV,dh): k and v from
    ``kv_input`` (a cross layer's image rows) when given, else from x; the
    bias (plain add, outside the adapted matmul) before the reshape, the
    per-head RMS norm after it (RoPE comes later, in :func:`attention`)."""
    H, KV, dh = cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    B = x.shape[0]
    adp = adp or {}
    kv_x = x if kv_input is None else kv_input
    q = adapted_matmul(x, p["wq"], adp.get("wq"))
    k = adapted_matmul(kv_x, p["wk"], adp.get("wk"))
    v = adapted_matmul(kv_x, p["wv"], adp.get("wv"))
    if "bq" in p:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    q, k, v = q.reshape(B, -1, H, dh), k.reshape(B, -1, KV, dh), v.reshape(B, -1, KV, dh)
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"], cfg.norm_eps)
        k = rms_norm(k, p["k_norm"], cfg.norm_eps)
    return q, k, v


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


def _cross_mask(S: int, Sk: int, device) -> torch.Tensor:
    """A cross layer's mask: every one of the ``Sk`` image rows is visible
    to each of the ``S`` queries (the reference's ``jnp.ones``)."""
    return torch.ones((1, 1, 1, S, Sk), dtype=torch.bool, device=device)


def attention(
    p: Dict,
    x: torch.Tensor,
    cfg: ModelConfig,
    *,
    positions: torch.Tensor,
    adp: Optional[Dict] = None,
    cache: Optional[Dict] = None,
    attend_blocks: Optional[int] = None,
    n_valid: Optional[torch.Tensor] = None,
    cross_kv: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Returns the attention block's output (B,S,d).

    * ``cross_kv`` (B,Sk,d)              — cross-attention: k and v from
      these rows, no RoPE, no cache, no causal mask (:func:`_cross_mask`).
    * ``cache=None``                     — full causal pass, no cache.
    * dense cache (``k``/``v``/``idx``)  — lock-step prefill (S > 1) or
      decode (S == 1) at the scalar offset ``idx``; with per-lane offsets
      (``idx`` (B,)) see :func:`_lane_prefill` and :func:`_lane_decode`.
    * paged cache (``block_tbl``)        — block-aligned prefill (S > 1,
      :func:`_paged_prefill`) or one decode step (:func:`_paged_decode`).
    * a per-lane cache with ``n_valid`` (int (B,)) — speculative verify of
      an S-token window at each lane's own offset (:func:`_dense_verify`,
      :func:`_paged_verify`): row ``s`` sees what decode at ``idx[b]+s``
      would see; rows ``s >= n_valid[b]`` write nothing a later read sees.

    ``attend_blocks`` bounds the paged decode (and verify) attend to the
    table's first that-many columns (the engine's active-lane high-water
    mark).
    """
    H, dh = cfg.n_heads, cfg.d_head
    B, S = x.shape[:2]
    scale = dh**-0.5
    q, k, v = _project_qkv(p, x, cfg, adp, kv_input=cross_kv)
    if cross_kv is not None:
        out = _softmax_attend(q, k, v, _cross_mask(S, k.shape[1], x.device), scale)
        return adapted_matmul(out.reshape(B, S, H * dh), p["wo"], (adp or {}).get("wo"))
    rotation = rope_rotation(positions, dh, cfg.rope_theta, x.device)
    q = apply_rope(q, positions, cfg.rope_theta, rotation)
    k = apply_rope(k, positions, cfg.rope_theta, rotation)
    if cache is not None and "block_tbl" in cache:
        if n_valid is not None:
            out = _paged_verify(q, k, v, cache, scale, n_valid, attend_blocks)
        elif S != 1:
            out = _paged_prefill(q, k, v, cache, positions, scale)
        else:
            out = _paged_decode(q, k, v, cache, scale, attend_blocks)
    elif cache is not None and cache["idx"].ndim:
        if n_valid is not None:
            out = _dense_verify(q, k, v, cache, scale, n_valid)
        elif S != 1:
            out = _lane_prefill(q, k, v, cache, scale)
        else:
            out = _lane_decode(q, k, v, cache, scale)
    elif cache is not None:
        # lock-step offset (merged-weight reference only), read on the device:
        # rows idx..idx+S-1, the start clamped as the reference's
        # dynamic_update_slice clamps it
        idx = cache["idx"].long()
        rows = torch.clamp(idx, max=cache["k"].shape[1] - S) + torch.arange(S, device=x.device)
        cache["k"].index_copy_(1, rows, k.to(cache["k"].dtype))
        cache["v"].index_copy_(1, rows, v.to(cache["v"].dtype))
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


def _lane_prefill(q, k, v, cache, scale):
    """Prefill against a per-lane dense cache: positions ``0..S`` of every
    lane take the prompt's K/V (the bucket's padding included, masked by the
    lane's offset later), then the plain causal pass over the prompt."""
    S = q.shape[1]
    cache["k"][:, :S] = k.to(cache["k"].dtype)
    cache["v"][:, :S] = v.to(cache["v"].dtype)
    return _softmax_attend(q, k, v, _causal_mask(S, q.device), scale)


def _masked_lane_write(cache, rows, ok, k, v) -> None:
    """``cache[k/v][b, rows[b, s]] = k/v[b, s]`` where ``ok[b, s]``, in
    place; a row not ok writes its target's own contents back, so its write
    is dropped without the mask being read on the host.  The targets of one
    lane must be distinct."""
    lanes = torch.arange(rows.shape[0], device=rows.device)[:, None].expand_as(rows)
    keep = ok[..., None, None]
    for name, new in (("k", k), ("v", v)):
        buf = cache[name]
        buf[lanes, rows] = torch.where(keep, new.to(buf.dtype), buf[lanes, rows])


def _lane_decode(q, k, v, cache, scale):
    """One decode step against a per-lane dense cache: ``k``/``v`` (B,
    max_len, KV, dh), ``idx`` (B,) each lane's write offset.  Each lane
    writes its row at its own offset (an index scatter over ``(arange(B),
    idx)``: no offset is read on the host), then attends its whole region
    under ``kpos <= idx``.  An idle lane's offset keeps advancing; its write
    is clamped to the last row, as the reference's ``dynamic_update_slice``
    clamps, and its output is discarded.  A draft view's ``write_limit``
    drops the write of a lane at or past its limit."""
    B, max_len = cache["k"].shape[:2]
    idx = cache["idx"].long()
    lanes = torch.arange(B, device=q.device)
    row = torch.clamp(idx, max=max_len - 1)
    lim = cache.get("write_limit")
    if lim is not None:
        _masked_lane_write(cache, row[:, None], (idx < lim)[:, None], k, v)
    else:
        cache["k"][lanes, row] = k[:, 0].to(cache["k"].dtype)
        cache["v"][lanes, row] = v[:, 0].to(cache["v"].dtype)
    kpos = torch.arange(max_len, device=q.device)
    mask = (kpos[None, :] <= idx[:, None])[:, None, None, None, :]
    return _softmax_attend(q, cache["k"].to(q.dtype), cache["v"].to(q.dtype), mask, scale)


def _scatter_rows(pool: torch.Tensor, flat: torch.Tensor, rows: torch.Tensor) -> None:
    """``pool[flat // bs, flat % bs] = rows`` in place: pool (n_blocks, bs,
    KV, dh) viewed flat over its token slots."""
    n_blocks, bs = pool.shape[:2]
    pool.view(n_blocks * bs, *pool.shape[2:])[flat] = rows.to(pool.dtype)


def _paged_prefill(q, k, v, cache, positions, scale):
    """Block-aligned prefill against a paged cache view
    (``transformer.paged_prefill_view``): ``block_tbl`` names this pass's
    write targets, trash block 0 standing in for cached prefix blocks and
    bucket padding.  ``positions`` are the absolute positions of this pass's
    rows: ``arange(S)`` for a whole prompt, ``start + arange(C)`` for one
    chunk of a chunked prefill.  Position ``t`` of lane ``b`` scatters to
    ``pool[tbl[b, t // bs], t % bs]``.

    Without ``read_tbl`` in the view the attention is the plain causal pass
    over the bucketed prompt.  With it (chunked prefill) the keys and values
    are gathered back from the pool through ``read_tbl`` (the monolithic
    bucket's width) after the scatter, under the absolute causal mask
    ``kpos <= positions``: a chunk sees every earlier chunk's K/V and every
    cached prefix block, and the softmax reduces over score rows as wide as
    the monolithic pass's."""
    B, S = q.shape[:2]
    bs = cache["k"].shape[1]
    tbl = cache["block_tbl"].long()
    pos = positions.long()
    blk = torch.gather(tbl, 1, (pos // bs).expand(B, S))
    flat = (blk * bs + pos[None, :] % bs).reshape(-1)
    _scatter_rows(cache["k"], flat, k.reshape(B * S, *k.shape[2:]))
    _scatter_rows(cache["v"], flat, v.reshape(B * S, *v.shape[2:]))
    read_tbl = cache.get("read_tbl")
    if read_tbl is None:
        return _softmax_attend(q, k, v, _causal_mask(S, q.device), scale)
    W = read_tbl.shape[1] * bs
    ids = read_tbl.long()
    kg = cache["k"][ids].reshape(B, W, *k.shape[2:]).to(q.dtype)
    vg = cache["v"][ids].reshape(B, W, *v.shape[2:]).to(q.dtype)
    mask = (torch.arange(W, device=q.device)[None, :] <= pos[:, None])[None, None, None]
    return _softmax_attend(q, kg, vg, mask, scale)


def _paged_decode(q, k, v, cache, scale, attend_blocks: Optional[int] = None):
    """One decode step against a paged cache: ``k``/``v`` pools (n_blocks,
    bs, KV, dh), ``block_tbl`` (B, max_blocks) int32, ``idx`` (B,) lane
    lengths.  The step's K/V scatter flat into each lane's current block
    (idle lanes point at trash block 0, so the write needs no per-lane
    branch), then the kernel attends through the table's first
    ``attend_blocks`` columns; lanes longer than that bound (idle lanes with
    stale offsets) produce outputs the engine discards.  A draft view's
    ``write_limit`` sends the write of a lane at or past its limit to trash
    block 0, so a draft never writes a shared block, or past ``max_len``
    through the clamped last column."""
    bs = cache["k"].shape[1]
    tbl, idx = cache["block_tbl"], cache["idx"]
    max_blocks = tbl.shape[1]
    idx64 = idx.long()
    col = torch.clamp(idx64 // bs, 0, max_blocks - 1)[:, None]
    blk = torch.gather(tbl.long(), 1, col)[:, 0]
    lim = cache.get("write_limit")
    if lim is not None:
        blk = torch.where(idx64 < lim, blk, torch.zeros_like(blk))
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


def _dense_verify(q, k, v, cache, scale, n_valid):
    """Speculative verify against a per-lane dense cache: W window rows per
    lane at positions ``idx[b] .. idx[b]+W-1``.

    Rows ``s >= n_valid[b]`` write nothing (idle lanes and lanes near their
    generation budget): their write is dropped in place
    (:func:`_masked_lane_write`), aimed at a position no kept row of the lane
    writes (past the window, or wrapped below ``idx`` where it would run
    past ``max_len``).  Row ``s``'s mask is ``kpos <= idx+s`` — the
    single-token decode mask at that position, so row ``s`` is what decode
    computes after committing the window's first ``s`` tokens; rejected rows
    leave K/V that stays masked until a later window overwrites it.  ``idx``
    is left unchanged: the engine advances it by the accepted length."""
    W = q.shape[1]
    L = cache["k"].shape[1]
    idx = cache["idx"].long()
    s = torch.arange(W, device=q.device)
    pos = idx[:, None] + s[None, :]  # (B, W)
    _masked_lane_write(cache, torch.where(pos < L, pos, pos - L),
                       s[None, :] < n_valid.long()[:, None], k, v)
    kpos = torch.arange(L, device=q.device)
    mask = (kpos[None, None, :] <= pos[:, :, None])[:, None, None]  # (B,1,1,W,L)
    return _softmax_attend(q, cache["k"].to(q.dtype), cache["v"].to(q.dtype), mask, scale)


def _paged_verify(q, k, v, cache, scale, n_valid, attend_blocks: Optional[int] = None):
    """Speculative verify against the paged pool: W window rows per lane
    scattered through its block table at ``idx .. idx+W-1``.

    Rows ``s >= n_valid[b]`` have their block forced to trash block 0: a
    lane whose window runs past its owned blocks (or an idle lane) writes
    only trash, never a shared block.  The attend gathers the K/V back
    through the table (plain torch: the decode kernel is single-query);
    ``attend_blocks`` truncation and the per-row mask ``kpos <= min(idx+s,
    width-1)`` reproduce :func:`_paged_decode`'s reduction, so a live row is
    what the single-token decode at that position computes.  ``idx`` is left
    unchanged: the engine commits accepted advances and rolls back the
    blocks past them."""
    B, W = q.shape[:2]
    bs = cache["k"].shape[1]
    tbl, idx = cache["block_tbl"], cache["idx"]
    max_blocks = tbl.shape[1]
    s = torch.arange(W, device=q.device)
    pos = idx.long()[:, None] + s[None, :]  # (B, W)
    blk = torch.gather(tbl.long(), 1, torch.clamp(pos // bs, 0, max_blocks - 1))
    blk = torch.where(s[None, :] < n_valid.long()[:, None], blk, torch.zeros_like(blk))
    flat = (blk * bs + pos % bs).reshape(-1)
    _scatter_rows(cache["k"], flat, k.reshape(B * W, *k.shape[2:]))
    _scatter_rows(cache["v"], flat, v.reshape(B * W, *v.shape[2:]))
    a_blocks = max_blocks
    if attend_blocks is not None and attend_blocks < max_blocks:
        a_blocks = max(attend_blocks, 1)
        tbl = tbl[:, :a_blocks]
    ids = tbl.long()
    kg = cache["k"][ids].reshape(B, a_blocks * bs, *k.shape[2:]).to(q.dtype)
    vg = cache["v"][ids].reshape(B, a_blocks * bs, *v.shape[2:]).to(q.dtype)
    kpos = torch.arange(a_blocks * bs, device=q.device)
    last = torch.clamp(pos, max=a_blocks * bs - 1)
    mask = (kpos[None, None, :] <= last[:, :, None])[:, None, None]  # (B,1,1,W,a_blocks*bs)
    return _softmax_attend(q, kg, vg, mask, scale)


def kv_lane_axes(lead_ndim: int):
    """Lane axes of a per-lane dense KV cache with ``lead_ndim`` stacked
    leading axes: k/v ``(*lead, batch, max_len, KV, dh)`` and idx ``(*lead,
    batch)`` — the lane axis follows the lead axes."""
    return {"k": lead_ndim, "v": lead_ndim, "idx": lead_ndim}


def paged_kv_lane_axes():
    """Lane axes of the paged KV cache: the pools are global, only
    ``block_tbl`` (G, batch, max_blocks) and ``idx`` (G, batch) are per lane."""
    return {"k": NO_LANE, "v": NO_LANE, "block_tbl": 1, "idx": 1}
