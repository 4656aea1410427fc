"""Roofline terms of a dry-run cell (port of ``repro/launch/roofline.py``).

Hardware model, one NVIDIA H100 SXM5 80GB (NVIDIA's H100 Tensor Core GPU
datasheet, SXM5 column, dense rates without sparsity, at its 700 W limit):

* ``PEAK_FLOPS`` — 989 TFLOP/s of bf16 on the tensor cores;
* ``HBM_BW`` — 3.35 TB/s of HBM3;
* ``NVLINK_BW`` — 450 GB/s a direction (the datasheet's 900 GB/s of
  NVLink 4 counts both directions).

The reference reads its terms from XLA's compiled program: per-device FLOPs
and bytes from its cost analysis, collective bytes from the optimized HLO.
The port has no compiler between the step and the card, so
:func:`count_costs` counts a step by running it once, on meta tensors
(nothing is computed or stored): FLOPs from
``torch.utils.flop_counter.FlopCounterMode`` (the matmul-class ops it
knows: mm, bmm, addmm, baddbmm, convolutions, attention), and bytes
accessed as the sum of every aten op's operand and result bytes (views
move nothing and are not counted).  That is the unfused program: a fused
kernel keeps its intermediates on chip, so the bytes over-count what a
fused program moves.  There are no collectives to read in a single-program
trace, so the collective term is ``None`` (never 0) and the bottleneck is
chosen between compute and memory.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import FlopCounterMode

PEAK_FLOPS = 989e12  # bf16 dense FLOP/s a card (H100 SXM5 datasheet)
HBM_BW = 3.35e12  # B/s a card (H100 SXM5 datasheet, HBM3)
NVLINK_BW = 450e9  # B/s a direction a card (H100 SXM5 datasheet: 900 GB/s both ways)


@dataclasses.dataclass
class Roofline:
    flops: float  # per-device FLOPs
    hbm_bytes: float  # per-device bytes accessed
    coll_bytes: Optional[float]  # per-device collective bytes (None: not counted)
    coll_by_kind: Optional[Dict[str, int]]
    compute_s: float
    memory_s: float
    collective_s: Optional[float]
    bottleneck: str
    model_flops: float = 0.0  # global useful flops (6·N·D)
    chips: int = 1

    @property
    def useful_ratio(self) -> float:
        """MODEL_FLOPS / (counted FLOPs × chips): the share of the counted
        compute that is useful (remat and redundancy show up here)."""
        total = self.flops * self.chips
        return self.model_flops / total if total else 0.0

    @property
    def roofline_s(self) -> float:
        return max(t for t in (self.compute_s, self.memory_s, self.collective_s)
                   if t is not None)

    @property
    def roofline_fraction(self) -> float:
        """Useful-compute time over the bound step time."""
        t_useful = self.model_flops / (self.chips * PEAK_FLOPS)
        return t_useful / self.roofline_s if self.roofline_s else 0.0


def from_terms(flops: float, hbm: float, coll: Optional[Dict[str, int]], *,
               model_flops: float, chips: int) -> Roofline:
    """Per-device ``flops`` and ``hbm`` bytes, and collective bytes by kind
    (``None`` where none were counted), over the card's rates."""
    cb = None if coll is None else float(sum(coll.values()))
    terms = {"compute": flops / PEAK_FLOPS, "memory": hbm / HBM_BW}
    if cb is not None:
        terms["collective"] = cb / NVLINK_BW
    return Roofline(
        flops=flops,
        hbm_bytes=hbm,
        coll_bytes=cb,
        coll_by_kind=coll,
        compute_s=terms["compute"],
        memory_s=terms["memory"],
        collective_s=terms.get("collective"),
        bottleneck=max(terms, key=terms.get),
        model_flops=model_flops,
        chips=chips,
    )


def _nbytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in tree_flatten(tree)[0]
               if isinstance(t, torch.Tensor))


class _BytesAccessed(TorchDispatchMode):
    """Sums each aten op's operand and result bytes; views are free."""

    def __init__(self):
        super().__init__()
        self.bytes = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if not (func.is_view or func is torch.ops.aten._unsafe_view.default):
            self.bytes += _nbytes((args, kwargs)) + _nbytes(out)
        return out


def count_costs(fn, *args) -> Tuple[int, int]:
    """``(flops, bytes accessed)`` of one call ``fn(*args)`` (see the
    module docstring for what each counts); its result is dropped."""
    flops = FlopCounterMode(display=False)
    with flops, _BytesAccessed() as moved:
        fn(*args)
    return int(flops.get_total_flops()), int(moved.bytes)


def model_flops_for(cfg, shape) -> float:
    """6·N·D (train) / 2·N·D (prefill, decode forward) with N = active
    params, as the reference counts them."""
    n = cfg.param_count(active_only=True)
    if shape.kind == "train":
        return 6.0 * n * shape.global_batch * shape.seq_len
    if shape.kind == "prefill":
        return 2.0 * n * shape.global_batch * shape.seq_len
    return 2.0 * n * shape.global_batch  # decode: one token per sequence
