"""Model and adapter configuration — the port's copy of
``repro/configs/base.py``, cut to the fields the dense, audio, moe and vlm
decoders (serving, training, quantized bases; QKV bias and QK-norm; the
experts; the gated cross-attention layers) and the paper's RoBERTa-style
encoder read.

The dimensions of a published model are plain numbers, so the port keeps its
own copy instead of importing the JAX package (see ``smollm_135m.py``).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Tuple

ADAPTER_MODES = ("none", "ft", "lora", "svd_lora", "qr_lora")

# Frozen-base weight dtypes ("bf16" = the model's native dtype, unquantized;
# int8/fp8 = per-output-channel symmetric quantization of every adapted base
# projection at install time — see core/quantize.py).
BASE_DTYPES = ("bf16", "int8", "fp8")


@dataclass(frozen=True)
class AdapterConfig:
    """The PEFT adapter attached to a model.

    mode:
      none      — no adapters, nothing trainable except what the caller says.
      ft        — full fine-tuning (no adapters, everything trainable).
      lora      — standard LoRA, ΔW = B·A·(α/r); A, B trainable.
      svd_lora  — LoRA with B, A initialized from top-k singular vectors.
      qr_lora   — the paper: pivoted-QR basis, only diagonal λ trainable.
    """

    mode: str = "qr_lora"
    # Projections to adapt, by canonical name ("wq", "wv", ...).
    targets: Tuple[str, ...] = ("wq", "wv")
    # Which layers get adapters: "all", "lastK", or an explicit index tuple.
    layers: str | Tuple[int, ...] = "last4"
    # Rank selection: "energy" (paper eq. 4), "magnitude" (paper §4.1) or
    # "fixed" (``rank``).
    rank_policy: str = "energy"
    tau: float = 0.5
    # Storage rank of the factors; selected ranks are zero-padded up to it.
    rank_cap: int = 160
    # lora / svd_lora (and the "fixed" rank policy):
    rank: int = 2
    alpha: float = 2.0
    svd_k: int = 1
    # svd_lora: subtract the initialized component from W0 so the effective
    # weight is unchanged at init (PiSSA-style), as the reference does.
    svd_subtract_init: bool = True

    def replace(self, **kw) -> "AdapterConfig":
        return dataclasses.replace(self, **kw)


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # "dense", "audio", "moe" or "vlm" (decoders), or "encoder"
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    d_head: int = 0  # 0 → d_model // n_heads
    # Attention flavour: a bias on the q/k/v projections (qwen2), and an RMS
    # norm of each q/k head before RoPE (qwen3)
    qkv_bias: bool = False
    qk_norm: bool = False
    rope_theta: float = 10_000.0
    causal: bool = True
    # MoE: top-``experts_per_token`` of ``n_experts`` per token, each expert
    # a buffer of ``capacity_factor``·T·k/E rows over a call's T rows
    # (models/moe.py); ``moe_every`` > 1 interleaves dense and moe layers,
    # as the hybrid family does (not ported: 1 only)
    n_experts: int = 0
    experts_per_token: int = 0
    moe_every: int = 1
    capacity_factor: float = 1.25
    # VLM: one gated cross-attention layer against the image rows every
    # ``cross_attn_every`` layers (the last of each group); the stub vision
    # frontend feeds ``n_image_tokens`` patch embeddings of width ``d_image``
    cross_attn_every: int = 0
    n_image_tokens: int = 0
    d_image: int = 0
    # Encoder (the paper's RoBERTa-style model)
    is_encoder: bool = False
    n_classes: int = 0
    max_position: int = 0
    dtype: str = "bfloat16"
    logits_dtype: str = "float32"
    norm_eps: float = 1e-5
    adapter: AdapterConfig = field(default_factory=AdapterConfig)
    microbatches: int = 1  # gradient accumulation steps per train step
    # Frozen-base weight dtype: "bf16" keeps W in the model dtype; "int8"/
    # "fp8" replace every adapted base projection with a per-output-channel
    # symmetric {q, scale} pair at install time (core/quantize.py).
    base_dtype: str = "bf16"

    def __post_init__(self):
        if self.d_head == 0:
            object.__setattr__(self, "d_head", self.d_model // self.n_heads)
        if self.n_heads % self.n_kv_heads:
            raise ValueError(
                f"{self.name}: n_heads={self.n_heads} not a multiple of "
                f"n_kv_heads={self.n_kv_heads}"
            )
        if self.adapter.mode not in ADAPTER_MODES:
            raise ValueError(f"adapter mode {self.adapter.mode!r} not in {ADAPTER_MODES}")
        if self.moe_every != 1:
            raise NotImplementedError(
                f"{self.name}: moe_every={self.moe_every} interleaves moe layers as the "
                "hybrid family does, which is not ported yet (ROADMAP Queue 1 item 12b)"
            )
        if self.cross_attn_every and self.n_layers % self.cross_attn_every:
            raise ValueError(
                f"{self.name}: n_layers={self.n_layers} is not a whole number of "
                f"cross_attn_every={self.cross_attn_every} groups"
            )
        if self.base_dtype not in BASE_DTYPES:
            raise ValueError(
                f"{self.name}: base_dtype={self.base_dtype!r} not in {BASE_DTYPES}"
            )

    @property
    def is_moe(self) -> bool:
        return self.n_experts > 0

    @property
    def group_size(self) -> int:
        """Layers per group of the stacked layout: the vlm family's
        ``cross_attn_every`` (P-1 self-attention layers and one cross
        layer), 1 for the other decoders."""
        return self.cross_attn_every or 1

    def param_count(self, active_only: bool = False) -> int:
        """The reference's analytic count (``repro/configs/base.py:197-242``)
        for the families the port has: embedding and unembedding, every
        layer's attention projections (a vlm cross layer's are the same
        shapes as a self layer's, since the image rows are projected to d
        first) and its gated FFN or experts.  Like the reference it leaves
        out the RMS-norm scales, the vlm image projection (d_image × d) and
        gates (one a group), and the routers' float32 leaves are counted
        with the experts (d · E a layer)."""
        d, ff, V = self.d_model, self.d_ff, self.vocab_size
        dh, H, KV = self.d_head, self.n_heads, self.n_kv_heads
        attn = d * H * dh + 2 * d * KV * dh + H * dh * d
        dense_ffn = 3 * d * ff  # gated (gate, up, down)
        total = V * d * 2 + self.n_layers * attn
        if self.is_moe:
            total += self.n_layers * (self.n_experts * dense_ffn + d * self.n_experts)
            if active_only:
                total -= self.n_layers * (self.n_experts - self.experts_per_token) * dense_ffn
        elif ff:
            total += self.n_layers * dense_ffn
        return total

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)
