"""Typed engine configuration (port of ``repro/serving/config.py``).

The port's engine serves the paged layout; ``layout="auto"`` (the default)
resolves to it for the dense family.  ``EngineConfig.serving()`` is the
reference's production posture: paged KV, copy-on-write prefix sharing, one
watermark block of decode headroom and chunked prefill at two blocks a step.
The reference's other knobs belong to later slices of the port: the fields
exist with their disabled defaults so a config that sets one fails here,
naming the slice, instead of being served without it.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

from repro_torch.configs.base import BASE_DTYPES
from repro_torch.core.quantize import FP8_SUPPORTED

LAYOUTS = ("auto", "paged", "oracle_dense")

#: field → (its disabled default, the slice of the port that brings it)
LATER_SLICES = {
    "quantum": (None, "quantum time-slicing on the dense layout (ROADMAP Queue 1 item 10c)"),
    "speculate_k": (0, "speculative decoding (ROADMAP Queue 1 item 10d)"),
    "draft_lam_rank": (None, "speculative decoding (ROADMAP Queue 1 item 10d)"),
    "cold_slots": (0, "the λ-store cold tier (ROADMAP Queue 1 item 13)"),
    "cold_path": (None, "the λ-store cold tier (ROADMAP Queue 1 item 13)"),
}


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    """Validated multi-tenant engine configuration."""

    layout: str = "auto"
    n_lanes: int = 4
    n_slots: int = 8
    max_len: int = 128
    collect_logits: bool = False
    seed: int = 0
    block_size: int = 16
    n_blocks: Optional[int] = None
    #: Frozen-base weight dtype: "bf16" leaves the model's native weights
    #: alone; "int8"/"fp8" quantize every adapted base projection
    #: per-output-channel at engine construction (``core/quantize.py``) and
    #: dequantize in the kernels' epilogue — λ, B, A stay full precision.
    #: "fp8" needs torch.float8_e4m3fn (validated here, before any device
    #: memory is touched).
    base_dtype: str = "bf16"
    #: Shard every packed λ table's slot axis over the default
    #: torch.distributed process group (each rank holds n_slots / world
    #: slots, n_slots padded up to a multiple of the world); bitwise the
    #: replicated engine.
    shard_lam: bool = False
    #: Shard the shared QR factors B/A over their rank dim across the same
    #: group (when the world divides the rank cap), all-gathered whole before
    #: each contraction; bitwise the replicated engine.
    shard_ba: bool = False
    #: Copy-on-write prefix sharing: requests of one λ family (same λ digest,
    #: same prefill bucket) hold the same physical blocks for their common
    #: full-block prompt prefix.
    share_prefix: bool = False
    #: Blocks admission keeps free as decode-growth headroom.
    watermark: int = 0
    #: Chunked-prefill token budget per engine step: long prompts stream in
    #: ``prefill_chunk``-token chunks between resident lanes' decode steps.
    #: ``None`` disables (monolithic admission prefill).  A multiple of
    #: ``block_size``.
    prefill_chunk: Optional[int] = None
    #: Serving metrics and request-span tracing (``repro_torch.obs``): host
    #: bookkeeping only — no device work, no sync; ``engine.metrics()``.
    telemetry: bool = True
    # -- later slices: must stay at their defaults (see LATER_SLICES) --------
    quantum: Optional[int] = None
    speculate_k: int = 0
    draft_lam_rank: Optional[int] = None
    cold_slots: int = 0
    cold_path: Optional[str] = None

    def __post_init__(self):
        if self.layout not in LAYOUTS:
            raise ValueError(f"layout={self.layout!r} must be one of {LAYOUTS}")
        for name in ("n_lanes", "n_slots", "max_len", "block_size"):
            if getattr(self, name) < 1:
                raise ValueError(f"{name}={getattr(self, name)} must be >= 1")
        if self.watermark < 0:
            raise ValueError(f"watermark={self.watermark} must be >= 0")
        if self.prefill_chunk is not None and (
            self.prefill_chunk < self.block_size or self.prefill_chunk % self.block_size
        ):
            raise ValueError(
                f"prefill_chunk={self.prefill_chunk} must be a positive multiple of "
                f"block_size={self.block_size}"
            )
        if self.speculate_k and self.prefill_chunk is not None:
            raise ValueError(
                "speculate_k is incompatible with prefill_chunk: a lane mid chunked-prefill "
                "is dark and cannot draft or verify a window"
            )
        if self.layout == "oracle_dense":
            raise NotImplementedError(
                "layout='oracle_dense': the dense per-lane layout comes with the "
                "oracle-layout slice (ROADMAP Queue 1 item 10c)"
            )
        for name, (default, slice_name) in LATER_SLICES.items():
            if getattr(self, name) != default:
                raise NotImplementedError(
                    f"EngineConfig.{name}={getattr(self, name)!r}: the port "
                    f"serves it with {slice_name}"
                )
        if self.n_slots < 2:
            raise ValueError("n_slots must hold slot 0 (base) plus one tenant")
        if self.base_dtype not in BASE_DTYPES:
            raise ValueError(f"base_dtype={self.base_dtype!r} must be one of {BASE_DTYPES}")
        if self.base_dtype == "fp8" and not FP8_SUPPORTED:
            raise ValueError(
                "base_dtype='fp8' needs torch.float8_e4m3fn, which this torch build "
                "does not provide — use base_dtype='int8'"
            )

    @classmethod
    def serving(cls, **overrides) -> "EngineConfig":
        """Production posture: paged KV, CoW prefix sharing, one watermark
        block of decode-growth headroom, chunked prefill at two blocks of
        tokens per step."""
        bs = overrides.get("block_size", 16)
        base = dict(layout="paged", share_prefix=True, watermark=1, prefill_chunk=2 * bs)
        base.update(overrides)
        return cls(**base)

    def resolved_layout(self, family: str) -> str:
        """Concrete layout for ``family``: paged, the only layout served."""
        if family != "dense":
            raise NotImplementedError(
                f"family {family!r}: the port serves the dense family so far"
            )
        return "paged"
