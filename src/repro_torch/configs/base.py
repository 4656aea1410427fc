"""Model and adapter configuration — the port's copy of
``repro/configs/base.py``, cut to the fields the dense, audio, moe, vlm,
hybrid and ssm decoders (serving, training, quantized bases; QKV bias and
QK-norm; the experts; the gated cross-attention layers; the Mamba and xLSTM
mixers) and the paper's RoBERTa-style encoder read.

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
    family: str  # dense | moe | hybrid | ssm | audio | vlm (decoders), or encoder
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
    # (models/moe.py).  ``moe_every``: the hybrid family's groups put their
    # moe layers at the odd positions (jamba: 2); the moe family routes
    # every layer whatever it says, as the reference does
    n_experts: int = 0
    experts_per_token: int = 0
    moe_every: int = 1
    capacity_factor: float = 1.25
    # Hybrid (jamba): groups of ``hybrid_period`` layers, one attention
    # layer at ``hybrid_attn_index`` and Mamba elsewhere
    hybrid_period: int = 0
    hybrid_attn_index: int = 0
    # Mamba (models/mamba.py)
    mamba_d_state: int = 16
    mamba_d_conv: int = 4
    mamba_expand: int = 2
    # xLSTM: the block kinds of a group, in order ("m" mLSTM, "s" sLSTM)
    xlstm_pattern: str = "ms"
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
    # Train forwards recompute each layer group (and each position of a
    # multi-layer group) in the backward instead of keeping its activations
    # (models/transformer.py); no number changes
    remat: bool = True
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
    def is_hybrid(self) -> bool:
        return self.hybrid_period > 0

    @property
    def group_size(self) -> int:
        """Layers per group of the stacked layout: the hybrid family's
        ``hybrid_period``, the vlm family's ``cross_attn_every`` (P-1
        self-attention layers and one cross layer), the ssm family's
        ``xlstm_pattern`` length, 1 for the other decoders."""
        if self.hybrid_period:
            return self.hybrid_period
        if self.cross_attn_every:
            return self.cross_attn_every
        if self.family == "ssm":
            return len(self.xlstm_pattern)
        return 1

    def param_count(self, active_only: bool = False) -> int:
        """The reference's analytic count (``repro/configs/base.py:197-240``),
        term for term: embedding and unembedding, every attention layer's
        projections (a vlm cross layer's are the same shapes as a self
        layer's, since the image rows are projected to d first), the hybrid
        family's Mamba layers (in and gate projections, conv, the B, C and dt
        projections as ``d_in·(2N + 1)``, out), the ssm family's blocks as
        ``4d² + 8d²`` a layer, and each layer's gated FFN or experts (moe
        layers at ``i % moe_every == moe_every - 1``).  Like the reference
        it leaves out the RMS-norm scales, the vlm image projection and
        gates, and counts the routers' float32 leaves with the experts (d · E
        a layer)."""
        d, ff, V = self.d_model, self.d_ff, self.vocab_size
        dh, H, KV = self.d_head, self.n_heads, self.n_kv_heads
        attn = d * H * dh + 2 * d * KV * dh + H * dh * d
        dense_ffn = 3 * d * ff  # gated (gate, up, down)
        n_attn_layers = self.n_layers
        n_mamba_layers = 0
        if self.is_hybrid:
            n_groups = self.n_layers // self.hybrid_period
            n_attn_layers = n_groups
            n_mamba_layers = self.n_layers - n_groups
        mamba = 0
        if n_mamba_layers:
            d_in = self.mamba_expand * d
            mamba = (2 * d * d_in + d_in * self.mamba_d_conv
                     + d_in * (2 * self.mamba_d_state + 1) + d_in * d)
        if self.family == "ssm":  # xlstm: qkv + out a block, up/down gates
            attn = 4 * d * d + 2 * d * 4 * d
            dense_ffn = 0
        total = V * d * 2
        per_layer_ffn = 0
        if self.is_moe:
            n_moe_layers = len(
                [i for i in range(self.n_layers) if i % self.moe_every == self.moe_every - 1]
            ) if self.moe_every > 1 else self.n_layers
            total += n_moe_layers * (self.n_experts * dense_ffn + d * self.n_experts)
            total += (self.n_layers - n_moe_layers) * dense_ffn
        else:
            per_layer_ffn = dense_ffn if ff else 0
        total += n_attn_layers * attn + n_mamba_layers * mamba
        total += self.n_layers * per_layer_ffn
        if active_only and self.is_moe:
            n_moe_layers = (
                self.n_layers // self.moe_every if self.moe_every > 1 else self.n_layers
            )
            total -= n_moe_layers * (self.n_experts - self.experts_per_token) * dense_ffn
        return total

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)
