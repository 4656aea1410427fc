"""Decoder LM, dense family (port of ``repro/models/transformer.py``).

Parameters keep the reference's stacked layout: every per-layer leaf under
``params["groups"]`` has a leading ``(n_layers,)`` axis, adapters included
(``groups["adapters"][module][proj]``).  The reference scans over that axis;
here a Python loop takes layer ``l``'s slice of every leaf (views, no
copies).  Decode caches are written in place.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.core.adapter_api import adapted_matmul
from repro_torch.models import attention as attn_lib
from repro_torch.models.layers import normal, rms_norm, stacked_dense_init

Tree = Any


def torch_dtype(name: str) -> torch.dtype:
    return {"bfloat16": torch.bfloat16, "float32": torch.float32}[name]


def _tslice(tree: Tree, i: int) -> Tree:
    if isinstance(tree, dict):
        return {k: _tslice(v, i) for k, v in tree.items()}
    return tree[i]


def _check_family(cfg: ModelConfig) -> None:
    if cfg.family != "dense":
        raise NotImplementedError(
            f"family {cfg.family!r}: the port has the dense family only so far"
        )


def _adp_for(
    adapters: Optional[Dict], module: str, seg_ids: Optional[torch.Tensor] = None
) -> Optional[Dict]:
    if not adapters or module not in adapters:
        return None
    # drop the rank metadata before handing the leaves to adapted_matmul
    out = {
        proj: {k: v for k, v in leaf.items() if k != "ranks"}
        for proj, leaf in adapters[module].items()
    }
    if seg_ids is not None:
        # multi-tenant serving: the "lam" leaf is the packed λ table
        # (n_slots, r) and each sequence takes its slot's row (BGMV path)
        for proj in out:
            out[proj]["seg"] = seg_ids
    return out


def gated_mlp(p: Dict, x: torch.Tensor, adp: Optional[Dict] = None) -> torch.Tensor:
    adp = adp or {}
    g = adapted_matmul(x, p["w_gate"], adp.get("w_gate"))
    u = adapted_matmul(x, p["w_up"], adp.get("w_up"))
    return adapted_matmul(F.silu(g) * u, p["w_down"], adp.get("w_down"))


# ---------------------------------------------------------------------------
# Parameter init
# ---------------------------------------------------------------------------


def init_decoder_params(gen: torch.Generator, cfg: ModelConfig, dtype=None) -> Dict:
    """Random decoder params on the generator's device (same tree and
    distributions as the reference; torch draws its own numbers)."""
    _check_family(cfg)
    dtype = dtype or torch_dtype(cfg.dtype)
    d, V, G = cfg.d_model, cfg.vocab_size, cfg.n_layers
    ones = lambda *s: torch.ones(s, dtype=dtype, device=gen.device)
    down_scale = 1.0 / (2 * cfg.n_layers) ** 0.5
    groups = {
        "ln1": ones(G, d),
        "ln2": ones(G, d),
        "attn": attn_lib.init_attn_params(gen, cfg, G, dtype),
        "mlp": {
            "w_gate": stacked_dense_init(gen, G, d, cfg.d_ff, dtype),
            "w_up": stacked_dense_init(gen, G, d, cfg.d_ff, dtype),
            "w_down": stacked_dense_init(gen, G, cfg.d_ff, d, dtype, scale=down_scale),
        },
    }
    return {
        "embed": normal(gen, (V, d), 0.02, dtype),
        "final_norm": ones(d),
        "unembed": normal(gen, (d, V), d**-0.5, dtype),
        "groups": groups,
    }


# ---------------------------------------------------------------------------
# Forward passes
# ---------------------------------------------------------------------------


def _run_layers(params, cfg, x, positions, cache_layers, seg_ids=None, attend_blocks=None):
    groups = params["groups"]
    adapters = groups.get("adapters")
    for l in range(cfg.n_layers):
        p = _tslice({k: v for k, v in groups.items() if k != "adapters"}, l)
        adp = _tslice(adapters, l) if adapters else None
        h = rms_norm(x, p["ln1"], cfg.norm_eps)
        x = x + attn_lib.attention(
            p["attn"], h, cfg, positions=positions,
            adp=_adp_for(adp, "attn", seg_ids),
            cache=_tslice(cache_layers["attn"], l) if cache_layers else None,
            attend_blocks=attend_blocks,
        )
        h = rms_norm(x, p["ln2"], cfg.norm_eps)
        x = x + gated_mlp(p["mlp"], h, _adp_for(adp, "mlp", seg_ids))
    return x


def _logits(params, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    return x.float() @ params["unembed"].float()  # fp32 logits, as the reference


def decoder_apply(params, cfg: ModelConfig, tokens, seg_ids=None) -> torch.Tensor:
    """Full-sequence forward → logits (B, S, V) in fp32."""
    x = params["embed"][tokens]
    positions = torch.arange(x.shape[1], device=x.device)
    return _logits(params, cfg, _run_layers(params, cfg, x, positions, None, seg_ids))


def init_decode_state(
    cfg: ModelConfig, batch: int, max_len: int, dtype=torch.bfloat16, *,
    paged: bool = False, block_size: int = 16, n_blocks: Optional[int] = None,
    device=None,
) -> Dict:
    """Decode cache.

    ``paged=False``: the lock-step dense cache the merged-weight reference
    decodes with — k/v ``(n_layers, batch, max_len, KV, dh)`` and one scalar
    offset per layer.  ``paged=True``: per-lane offsets (``idx``
    (n_layers, batch), ``pos`` (batch,)) over a global block pool
    ``(n_layers, n_blocks, block_size, KV, dh)`` and per-lane block tables
    ``(n_layers, batch, max_len / block_size)`` int32; block 0 is the
    reserved trash block (``serving/paging.py``).  The reference's per-lane
    dense layout comes with a later slice.
    """
    _check_family(cfg)
    G, KV, dh = cfg.n_layers, cfg.n_kv_heads, cfg.d_head
    zeros = lambda *s, dt=dtype: torch.zeros(s, dtype=dt, device=device)
    if not paged:
        return {
            "pos": zeros(dt=torch.int32),
            "layers": {"attn": {
                "k": zeros(G, batch, max_len, KV, dh),
                "v": zeros(G, batch, max_len, KV, dh),
                "idx": zeros(G, dt=torch.int32),
            }},
        }
    if max_len % block_size:
        raise ValueError(f"max_len={max_len} must be a multiple of block_size={block_size}")
    max_blocks = max_len // block_size
    if n_blocks is None:
        n_blocks = 1 + batch * max_blocks  # worst case + trash block
    return {
        "pos": zeros(batch, dt=torch.int32),
        "layers": {"attn": {
            "k": zeros(G, n_blocks, block_size, KV, dh),
            "v": zeros(G, n_blocks, block_size, KV, dh),
            "block_tbl": zeros(G, batch, max_blocks, dt=torch.int32),
            "idx": zeros(G, batch, dt=torch.int32),
        }},
    }


def decode_state_lane_axes(cfg: ModelConfig) -> Dict:
    """LaneState protocol: the lane axis of each leaf of the paged cache."""
    _check_family(cfg)
    return {"pos": 0, "layers": {"attn": attn_lib.paged_kv_lane_axes()}}


def paged_prefill_view(cfg: ModelConfig, cache, write_ids: torch.Tensor) -> Dict:
    """1-lane paged-cache view for block-aligned admission prefill: it
    aliases the engine cache's pools, and its single block-table row is
    ``write_ids`` (ceil(bucket / block_size),) — this pass's write targets,
    trash block 0 standing in for bucket padding."""
    a = cache["layers"]["attn"]
    G = a["idx"].shape[0]
    dev = a["idx"].device
    return {
        "pos": torch.zeros((1,), dtype=torch.int32, device=dev),
        "layers": {"attn": {
            "k": a["k"],
            "v": a["v"],
            "block_tbl": write_ids.to(torch.int32).expand(G, 1, -1),
            "idx": torch.zeros((G, 1), dtype=torch.int32, device=dev),
        }},
    }


def commit_paged_prefill(cfg: ModelConfig, cache, filled, lane: int,
                         table_row: torch.Tensor, length: int) -> Dict:
    """Adopt a block-aligned prefill into lane ``lane``: the view already
    wrote the pools in place; point the lane's block-table row at its blocks
    (``table_row`` (max_blocks,), tail entries trash block 0) and set its
    offsets to the true prompt ``length``."""
    a = cache["layers"]["attn"]
    cache["pos"][lane] = length
    a["block_tbl"][:, lane, :] = table_row.to(torch.int32)
    a["idx"][:, lane] = length
    return cache


def decoder_prefill(params, cfg: ModelConfig, cache, tokens, seg_ids=None, length=None):
    """Fill the cache with a prompt; returns (last-position logits (B,V),
    cache).  ``length`` (int (B,)) marks the true prompt length when
    ``tokens`` is right-padded to a bucket: logits come from row
    ``length - 1`` and the offsets are set to ``length``."""
    x = params["embed"][tokens]
    S = x.shape[1]
    positions = torch.arange(S, device=x.device)
    x = _run_layers(params, cfg, x, positions, cache["layers"], seg_ids)
    attn = cache["layers"]["attn"]
    if length is None:
        x_last = x[:, -1:]
        cache["pos"].fill_(S)
        attn["idx"].fill_(S)
    else:
        length = torch.as_tensor(length, dtype=torch.int32, device=x.device)
        row = (length.long() - 1)[:, None, None].expand(-1, 1, x.shape[-1])
        x_last = torch.gather(x, 1, row)
        cache["pos"][...] = length
        attn["idx"][...] = length
    return _logits(params, cfg, x_last)[:, 0], cache


def decoder_decode(params, cfg: ModelConfig, cache, token, seg_ids=None, attend_blocks=None):
    """One decode step; ``token`` (B, 1) int.  ``attend_blocks`` bounds the
    paged attend to the table's first that-many columns."""
    x = params["embed"][token]
    pos = cache["pos"]
    positions = pos[None] if pos.ndim == 0 else pos[:, None]
    x = _run_layers(params, cfg, x, positions, cache["layers"], seg_ids, attend_blocks)
    cache["pos"] += 1
    cache["layers"]["attn"]["idx"] += 1
    return _logits(params, cfg, x)[:, 0], cache
