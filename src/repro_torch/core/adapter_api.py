"""Adapter API (port of ``repro/core/adapter_api.py``, QR-LoRA mode).

One runtime formula::

    y = x · W  +  ((x · B) * λ) · A · scale

B and A are the frozen pivoted-QR factors and λ trains (init 0); ``adp is
None`` is the plain ``x · W``.  Adapters live inside the stacked layer tree
under ``params["groups"]["adapters"][module][proj]``.  One λ goes through
the one-λ matmul kernel (:func:`repro_torch.kernels.ops.qrlora_matmul`),
whose backward gives x and λ their gradients.

Multi-tenant serving: when ``adp`` carries ``"seg"`` (int32 slot ids, per
sequence or per row), its ``"lam"`` leaf is a packed λ table
``(n_slots, r)`` and each row applies its own tenant's λ through the
batched multi-λ kernel (:func:`repro_torch.kernels.ops.qrlora_bgmv`).
Under the serve's sharding rules (:mod:`repro_torch.sharding.rules`) the
shared factors B/A, sharded over their rank dim (``qr_rank``), are first
all-gathered whole; a λ table sharded over its slot axis (``lam_slots``)
goes through the local gather, an all-reduce of the λ rows and the rows
kernel (:func:`repro_torch.kernels.ops.qrlora_bgmv_sharded`).

Quantized base: a W that is the ``{"q", "scale"}`` dict of
:mod:`repro_torch.core.quantize` goes through the quantized twins of the
two kernels (dequantized in their epilogue), or, with no adapter, through
:func:`_quant_base_matmul`.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.configs.base import AdapterConfig, ModelConfig
from repro_torch.core.qr_lora import qr_lora_init_stacked
from repro_torch.core.quantize import dequantize_weight, is_quantized
from repro_torch.kernels import ops
from repro_torch.kernels.qrlora_bgmv import ba_gather_sharded
from repro_torch.sharding.rules import lam_slot_group, qr_rank_group
from repro_torch.tree import Tree, tree_map


def _quant_base_matmul(x: torch.Tensor, W: Dict[str, torch.Tensor]) -> torch.Tensor:
    """``(x·q)·w_scale`` in fp32, in x's dtype: the per-output-channel scale
    multiplies after the contraction, as in the kernels' epilogue.  A plain
    product outside any kernel, as the reference leaves it to XLA."""
    return ((x.float() @ W["q"].float()) * W["scale"].float()).to(x.dtype)


def _plain_matmul(x: torch.Tensor, W: torch.Tensor) -> torch.Tensor:
    """``x @ W`` in the promoted dtype of the two, as the reference's type
    promotion gives it (a merged quantized weight is in the factors' dtype,
    bf16, under a float32 model)."""
    if W.dtype != x.dtype:
        dt = torch.promote_types(x.dtype, W.dtype)
        return x.to(dt) @ W.to(dt)
    return x @ W


def adapter_scale(cfg: AdapterConfig) -> float:
    """``α/r`` for the LoRA modes of later slices; QR-LoRA uses 1."""
    return 1.0


def layer_selection_mask(sel, n: int) -> Tuple[bool, ...]:
    """Which of the n stacked rows get adapters ('all' / 'lastK' / indices)."""
    if sel == "all":
        return tuple(True for _ in range(n))
    if isinstance(sel, str) and sel.startswith("last"):
        k = int(sel[4:])
        return tuple(i >= n - k for i in range(n))
    return tuple(i in sel for i in range(n))


def adapted_matmul(
    x: torch.Tensor,
    W: torch.Tensor,
    adp: Optional[Dict[str, torch.Tensor]],
    scale: float = 1.0,
) -> torch.Tensor:
    """``y = x·W + ((x·B)*λ)·A·scale``.  One λ goes through the one-λ
    kernel (differentiable in x and λ, products in fp32, result in x's
    dtype); with ``adp["seg"]`` the λ leaf is a slot table and every row
    takes its own slot's λ (BGMV kernel; under ``lam_slots`` rules the
    table is this rank's slot shard and the rows kernel applies the
    all-reduced rows; under ``qr_rank`` B and A are rank shards, gathered
    first).  A quantized W takes the quantized kernels (forward only)."""
    quant = is_quantized(W)
    if adp is None:
        return _quant_base_matmul(x, W) if quant else _plain_matmul(x, W)
    seg = adp.get("seg")
    B, A, lam = adp["B"], adp["A"], adp["lam"]
    if seg is not None:
        ba_group = qr_rank_group()
        if ba_group is not None:  # an exact concatenation: bitwise the replicated factors
            B, A = ba_gather_sharded(B, A, ba_group)
        lam_group = lam_slot_group()
        if lam_group is not None:
            return ops.qrlora_bgmv_sharded(
                x, W["q"] if quant else W, B, A, lam, seg, group=lam_group, scale=scale,
                w_scale=W["scale"] if quant else None)
        if quant:
            return ops.qrlora_bgmv_quant(x, W["q"], W["scale"], B, A, lam, seg, scale=scale)
        return ops.qrlora_bgmv(x, W, B, A, lam, seg, scale=scale)
    if quant:
        return ops.qrlora_matmul_quant(x, W["q"], W["scale"], B, A, lam, scale=scale)
    return ops.qrlora_matmul(x, W, B, A, lam, scale=scale)


def merge_adapter(
    W: torch.Tensor, adp: Optional[Dict[str, torch.Tensor]], scale: float = 1.0
) -> torch.Tensor:
    """Fold the adapter into the weight (the single-tenant deployment),
    computed in W's dtype as the reference's type promotion does.  A
    quantized base is dequantized first, to the factors' dtype (float32
    without an adapter), so a merged reference built from a quantized
    engine's params shares its quantization."""
    if is_quantized(W):
        W = dequantize_weight(W, adp["B"].dtype if adp is not None else torch.float32)
    if adp is None:
        return W
    dt = W.dtype
    lam = adp["lam"].to(dt)
    return W + ((adp["B"].to(dt) * lam[..., None, :]) @ adp["A"].to(dt)) * scale


def init_adapters(
    cfg: ModelConfig,
    stacked: Dict[str, torch.Tensor],
    dtype=torch.bfloat16,
) -> Dict[str, Dict[str, torch.Tensor]]:
    """QR-LoRA adapters for every ``(n_layers, d_in, d_out)`` projection in
    ``stacked`` (callers pre-filter targets).  The factors default to
    bfloat16 whatever the model dtype, as in the reference."""
    acfg = cfg.adapter
    if acfg.mode == "none":
        return {}
    return {
        name: qr_lora_init_stacked(
            W, layer_selection_mask(acfg.layers, W.shape[0]), acfg, dtype
        )
        for name, W in sorted(stacked.items())
    }


def count_trainable_params(params, cfg: ModelConfig) -> int:
    """Trainable λ entries of a QR-LoRA parameter tree.

    Counts every stored λ entry, rank padding included — the figure the
    reference's ``count_trainable_params`` returns for decoder trees (its
    ``ranks`` lookup is keyed by module name and never matches a
    projection, see ROADMAP Queue 3)."""
    if cfg.adapter.mode != "qr_lora":
        return 0
    adapters = params["groups"].get("adapters", {})
    return sum(
        leaf["lam"].numel() for projs in adapters.values() for leaf in projs.values()
    )


# ---------------------------------------------------------------------------
# Trainability masks and partitioning
# ---------------------------------------------------------------------------

_QR_TRAINABLE = ("lam",)


def trainable_mask(params: Tree, cfg: ModelConfig) -> Tree:
    """Tree of bools beside ``params``: which leaves train.  In qr_lora mode
    only the λ leaves under ``adapters`` do (the reference's mask with no
    extra trainable paths)."""
    train_lam = cfg.adapter.mode == "qr_lora"

    def decide(tree, in_adapters):
        return {
            k: decide(v, in_adapters or k == "adapters") if isinstance(v, dict)
            else train_lam and in_adapters and k in _QR_TRAINABLE
            for k, v in tree.items()
        }

    return decide(params, False)


def partition(params: Tree, mask: Tree) -> Tuple[Tree, Tree]:
    """Split params into (trainable, frozen); the other side holds None."""
    train = tree_map(lambda p, m: p if m else None, params, mask)
    frozen = tree_map(lambda p, m: None if m else p, params, mask)
    return train, frozen


def merge(trainable: Tree, frozen: Tree) -> Tree:
    """Inverse of :func:`partition`."""
    if isinstance(frozen, dict):
        return {k: merge(trainable[k], frozen[k]) for k in frozen}
    return trainable if frozen is None else frozen
