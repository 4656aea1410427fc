"""Typed engine configuration (port of ``repro/serving/config.py``).

Layouts, as the reference defines them:

* ``"paged"`` — block-pool KV cache (the serving layout).
* ``"oracle_dense"`` — the dense per-lane ``(lanes, max_len)`` layout: the
  test oracle the paged engine is held against, and the layout of
  time-sliced (``quantum``) serving, whose lane snapshots are dense lane
  state.
* ``"auto"`` (the default) — paged for the families with attention layers
  to page (:data:`~repro_torch.models.transformer.PAGED_FAMILIES`) unless
  ``quantum`` is set, else oracle-dense (the only layout of the ssm family,
  whose lanes hold recurrent state alone).

``EngineConfig.serving()`` is the reference's production posture: paged KV,
copy-on-write prefix sharing, one watermark block of decode headroom and
chunked prefill at two blocks a step; ``EngineConfig.oracle_dense()`` the
reference posture the tests compare against.  ``speculate_k`` turns on
speculative decoding (``draft_lam_rank`` picks the truncated-λ drafter);
engine construction holds it to :data:`SPECULATIVE_FAMILIES`
(:meth:`EngineConfig.validate_speculation`).  ``cold_slots`` adds the
λ-store's host cold tier and ``cold_path`` backs it with an mmap file that
survives a restart.

:meth:`EngineConfig.from_legacy_kwargs` maps the engine keywords of before
the config (:data:`LEGACY_KWARGS`) onto one, as the reference does; the
engine takes them behind a deprecation warning.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

from repro_torch.configs.base import BASE_DTYPES
from repro_torch.core.quantize import FP8_SUPPORTED
from repro_torch.models.transformer import PAGED_FAMILIES

LAYOUTS = ("auto", "paged", "oracle_dense")

#: Families speculative decoding supports.  Accepting a drafted prefix is a
#: pure KV rewind — offsets advance, rejected positions stay masked until
#: overwritten — which only attention state allows.  Hybrid's Mamba scan
#: state advances irreversibly per token and ssm has no KV cache at all, so
#: neither can roll back a rejected draft.
SPECULATIVE_FAMILIES = ("dense", "audio", "moe")

#: Engine keywords accepted before EngineConfig existed, in their historical
#: order.  ``paged`` maps onto ``layout``; everything else is 1:1.
LEGACY_KWARGS = (
    "n_lanes", "n_slots", "max_len", "collect_logits", "seed", "paged",
    "block_size", "n_blocks", "share_prefix", "watermark", "quantum",
    "cold_slots", "shard_lam", "telemetry",
)


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
    #: Time-slice fairness (dense layout only): a lane that has decoded this
    #: many tokens while requests queue is snapshot-preempted to the back of
    #: the queue and later restored without re-prefill.  ``None`` disables.
    quantum: Optional[int] = None
    #: Speculative decoding: draft this many greedy tokens per lane per step
    #: with the drafter view, verify every lane's window in one batched
    #: forward under the full multi-λ view and accept the longest prefix that
    #: matches greedy (token-identical to plain decoding).  0 disables.
    speculate_k: int = 0
    #: Drafter: ``None`` drafts with the base model (slot 0, λ ≡ 0, no
    #: adapter term); ``r`` keeps each slot's top-r |λ| coefficients.  Needs
    #: ``speculate_k >= 1``.
    draft_lam_rank: Optional[int] = None
    #: Host cold-tier capacity (tenants): λ evicted from the hot device
    #: slots spills to host memory and admission promotes it back on demand,
    #: so the tenant count is bounded by host RAM.  0 disables.
    cold_slots: int = 0
    #: Back the cold tier with an mmap record file at this path (its JSON
    #: catalog beside it), so the spilled tenants survive a restart.  Needs
    #: ``cold_slots > 0``.
    cold_path: Optional[str] = None

    def __post_init__(self):
        if self.layout not in LAYOUTS:
            raise ValueError(f"layout={self.layout!r} must be one of {LAYOUTS}")
        for name in ("n_lanes", "n_slots", "max_len", "block_size"):
            if getattr(self, name) < 1:
                raise ValueError(f"{name}={getattr(self, name)} must be >= 1")
        if self.watermark < 0:
            raise ValueError(f"watermark={self.watermark} must be >= 0")
        if self.cold_slots < 0:
            raise ValueError(f"cold_slots={self.cold_slots} must be >= 0")
        if self.cold_path is not None and self.cold_slots <= 0:
            raise ValueError("cold_path requires cold_slots > 0 (a tier to back)")
        if self.quantum is not None:
            if self.quantum < 1:
                raise ValueError(f"quantum={self.quantum} must be >= 1 decode step")
            if self.layout == "paged":
                raise ValueError(
                    "quantum time-slicing snapshots lane state, which a paged lane spreads "
                    "over pool blocks — use the dense layout (layout='oracle_dense') for "
                    "time-sliced serving"
                )
        if self.prefill_chunk is not None:
            if self.layout == "oracle_dense":
                raise ValueError("prefill_chunk requires a paged layout (chunks scatter into "
                                 "pool blocks)")
            if self.prefill_chunk < self.block_size or self.prefill_chunk % self.block_size:
                raise ValueError(
                    f"prefill_chunk={self.prefill_chunk} must be a positive multiple of "
                    f"block_size={self.block_size}"
                )
        if self.speculate_k < 0:
            raise ValueError(f"speculate_k={self.speculate_k} must be >= 0")
        if self.speculate_k and self.prefill_chunk is not None:
            raise ValueError(
                "speculate_k is incompatible with prefill_chunk: a lane mid chunked-prefill "
                "is dark and cannot draft or verify a window"
            )
        if self.draft_lam_rank is not None:
            if self.draft_lam_rank < 1:
                raise ValueError(f"draft_lam_rank={self.draft_lam_rank} must be >= 1")
            if self.speculate_k < 1:
                raise ValueError("draft_lam_rank configures the speculative drafter — it "
                                 "needs speculate_k >= 1")
        if self.layout == "oracle_dense":
            if self.share_prefix:
                raise ValueError("share_prefix requires a paged layout (blocks to share)")
            if self.watermark:
                raise ValueError("watermark requires a paged layout (blocks to reserve)")
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

    @classmethod
    def oracle_dense(cls, **overrides) -> "EngineConfig":
        """The dense reference layout the paged engine is held against (and
        the layout of time-sliced serving)."""
        base = dict(layout="oracle_dense")
        base.update(overrides)
        return cls(**base)

    @classmethod
    def from_legacy_kwargs(cls, **kwargs) -> "EngineConfig":
        """The config of the keywords of before it (:data:`LEGACY_KWARGS`).
        The old default ``paged=False`` maps to the oracle layout, so a
        legacy call site keeps its exact engine."""
        unknown = sorted(set(kwargs) - set(LEGACY_KWARGS))
        if unknown:
            raise TypeError(f"unknown engine kwargs: {unknown}")
        paged = kwargs.pop("paged", False)
        return cls(layout="paged" if paged else "oracle_dense", **kwargs)

    def validate_speculation(self, family: str) -> None:
        """Reject ``speculate_k`` for families whose decode state cannot
        rewind a rejected draft (engine construction calls this once the
        model family is known; the config itself is family-agnostic)."""
        if self.speculate_k and family not in SPECULATIVE_FAMILIES:
            raise ValueError(
                f"speculate_k={self.speculate_k} needs a KV-rollback family "
                f"{SPECULATIVE_FAMILIES}; family {family!r} carries recurrent decode state "
                "that cannot rewind rejected draft positions"
            )

    def resolved_layout(self, family: str) -> str:
        """Concrete layout for ``family``; raises when an explicit
        ``layout="paged"`` names a family with nothing to page.  ``auto``
        pages unless ``quantum`` is set or the family has no attention."""
        if self.layout == "oracle_dense":
            return "oracle_dense"
        if self.layout == "paged":
            if family not in PAGED_FAMILIES:
                raise ValueError(
                    f"layout='paged' needs attention layers to page; family {family!r} has "
                    "none — its per-lane state is already O(1), run layout='oracle_dense'")
            return "paged"
        if self.quantum is not None or family not in PAGED_FAMILIES:
            return "oracle_dense"
        return "paged"
