"""RoBERTa-style bidirectional encoder and classification head (port of
``repro/models/encoder.py``).

The paper's experimental substrate (RoBERTa-base, 125M): 12 layers, d=768,
12 heads, FFN 3072, learned positions, post-LN layers, a GELU FFN (the tanh
form, ``jax.nn.gelu``'s default), [CLS] pooling through a tanh pooler and
an fp32 task head.  QR-LoRA / LoRA / SVD-LoRA hook the attention
projections (``attn``: wq, wk, wv, wo) through
:func:`repro_torch.core.adapter_api.adapted_matmul`, so every adapted
projection runs the one-λ kernel on the card.  The attention itself is
plain torch ops, as the reference's einsum is: fp32 scores, masked with
-1e30, softmax.  Parameters keep the reference's stacked layout; a Python
loop takes layer ``l``'s slice of every leaf.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.core.adapter_api import adapted_matmul
from repro_torch.models.layers import layer_norm, normal, stacked_dense_init
from repro_torch.models.transformer import _layer_slices, torch_dtype


def init_encoder_params(gen: torch.Generator, cfg: ModelConfig, dtype=None) -> Dict:
    """Random encoder params on the generator's device (same tree and
    distributions as the reference; torch draws its own numbers)."""
    dtype = dtype or torch_dtype(cfg.dtype)
    d, V, L = cfg.d_model, cfg.vocab_size, cfg.n_layers
    H, dh, ff = cfg.n_heads, cfg.d_head, cfg.d_ff
    n_out = max(cfg.n_classes, 1)
    ones = lambda *s: torch.ones(s, dtype=dtype, device=gen.device)
    zeros = lambda *s: torch.zeros(s, dtype=dtype, device=gen.device)
    groups = {
        "ln1_s": ones(L, d),
        "ln1_b": zeros(L, d),
        "ln2_s": ones(L, d),
        "ln2_b": zeros(L, d),
        "attn": {
            "wq": stacked_dense_init(gen, L, d, H * dh, dtype),
            "wk": stacked_dense_init(gen, L, d, H * dh, dtype),
            "wv": stacked_dense_init(gen, L, d, H * dh, dtype),
            "wo": stacked_dense_init(gen, L, H * dh, d, dtype),
        },
        "mlp": {
            "w_up": stacked_dense_init(gen, L, d, ff, dtype),
            "w_down": stacked_dense_init(gen, L, ff, d, dtype),
        },
    }
    return {
        "embed": normal(gen, (V, d), 0.02, dtype),
        "pos_embed": normal(gen, (cfg.max_position or 512, d), 0.02, dtype),
        "emb_ln_s": ones(d),
        "emb_ln_b": zeros(d),
        "groups": groups,
        "pooler": stacked_dense_init(gen, 1, d, d, dtype)[0],
        "cls_w": normal(gen, (d, n_out), 0.02, torch.float32),
        "cls_b": torch.zeros((n_out,), dtype=torch.float32, device=gen.device),
    }


def _enc_layer(cfg: ModelConfig, p: Dict, x: torch.Tensor, mask: torch.Tensor,
               adapters: Optional[Dict]) -> torch.Tensor:
    """Post-LN transformer encoder layer (BERT/RoBERTa ordering)."""
    H, dh = cfg.n_heads, cfg.d_head
    B, S, _ = x.shape
    attn_adp = (adapters or {}).get("attn", {})

    def proj(name, inp):
        a = attn_adp.get(name)
        a = {k: v for k, v in a.items() if k != "ranks"} if a else None
        return adapted_matmul(inp, p["attn"][name], a)

    q = proj("wq", x).reshape(B, S, H, dh)
    k = proj("wk", x).reshape(B, S, H, dh)
    v = proj("wv", x).reshape(B, S, H, dh)
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * dh**-0.5
    scores = torch.where(mask[:, None, None, :], scores, torch.full_like(scores, -1e30))
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", probs.to(v.dtype), v).reshape(B, S, H * dh)
    x = layer_norm(x + proj("wo", out), p["ln1_s"], p["ln1_b"], cfg.norm_eps)
    h = F.gelu(x @ p["mlp"]["w_up"], approximate="tanh")
    return layer_norm(x + h @ p["mlp"]["w_down"], p["ln2_s"], p["ln2_b"], cfg.norm_eps)


def encoder_apply(params: Dict, cfg: ModelConfig, tokens: torch.Tensor,
                  attn_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """tokens (B, S) → task output in fp32: logits (B, n_classes), or (B, 1)
    for regression.  ``attn_mask`` (B, S) bool marks the keys to attend to
    (default: all)."""
    B, S = tokens.shape
    if attn_mask is None:
        attn_mask = torch.ones((B, S), dtype=torch.bool, device=tokens.device)
    x = params["embed"][tokens.long()] + params["pos_embed"][:S][None]
    x = layer_norm(x, params["emb_ln_s"], params["emb_ln_b"], cfg.norm_eps)
    for p, adp in _layer_slices(params["groups"], cfg.n_layers):
        x = _enc_layer(cfg, p, x, attn_mask, adp)
    cls = torch.tanh(x[:, 0] @ params["pooler"])  # [CLS] pooling
    return cls.float() @ params["cls_w"] + params["cls_b"]
