"""Model and adapter configuration — the port's copy of
``repro/configs/base.py``, cut to the fields the dense serving, λ-only
training and quantized-base slices read.

The dimensions of a published model are plain numbers, so the port keeps its
own copy instead of importing the JAX package (see ``smollm_135m.py``).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Tuple

# LoRA / SVD-LoRA / full fine-tuning come with later slices of the port.
ADAPTER_MODES = ("none", "qr_lora")

# Frozen-base weight dtypes ("bf16" = the model's native dtype, unquantized;
# int8/fp8 = per-output-channel symmetric quantization of every adapted base
# projection at install time — see core/quantize.py).
BASE_DTYPES = ("bf16", "int8", "fp8")


@dataclass(frozen=True)
class AdapterConfig:
    """QR-LoRA adapter attached to a model.

    mode:
      none    — no adapters.
      qr_lora — the paper: pivoted-QR basis, only diagonal λ trainable.
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
    rank: int = 2

    def replace(self, **kw) -> "AdapterConfig":
        return dataclasses.replace(self, **kw)


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # only "dense" in this slice of the port
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    d_head: int = 0  # 0 → d_model // n_heads
    rope_theta: float = 10_000.0
    dtype: str = "bfloat16"
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
            raise NotImplementedError(
                f"adapter mode {self.adapter.mode!r}: the port has {ADAPTER_MODES}"
            )
        if self.base_dtype not in BASE_DTYPES:
            raise ValueError(
                f"{self.name}: base_dtype={self.base_dtype!r} not in {BASE_DTYPES}"
            )

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)
