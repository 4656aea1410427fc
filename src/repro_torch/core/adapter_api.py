"""Adapter API (port of ``repro/core/adapter_api.py``).

One runtime formula serves every mode::

    y = x · W  +  ((x · B) * λ) · A · scale

* qr_lora  — B, A frozen pivoted-QR factors; λ trainable (init 0).
* lora     — B, A trainable; λ frozen at 1; scale = α/r.
* svd_lora — B, A trainable from SVD init; λ frozen at 1; scale = α/r.
* ft/none  — no adapters (``adp is None``): y = x · W.

Adapters live inside the stacked layer tree under
``params["groups"]["adapters"][module][proj]``.  One λ goes through the
one-λ matmul kernel (:func:`repro_torch.kernels.ops.qrlora_matmul`) in
every mode; its backward gives x, λ, B and A the gradients they need.

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

Trainability is a tree of bools beside the params (:func:`trainable_mask`)
that drives the (trainable, frozen) split (:func:`partition` /
:func:`merge`).
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.configs.base import AdapterConfig, ModelConfig
from repro_torch.core.lora import lora_init_stacked, svd_lora_init_stacked
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
    """``α/r`` for lora and svd_lora; 1 for QR-LoRA."""
    if cfg.mode in ("lora", "svd_lora"):
        return cfg.alpha / cfg.rank
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
    kernel (differentiable in x, λ, B and A, products in fp32, result in
    x's dtype); with ``adp["seg"]`` the λ leaf is a slot table and every row
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
    gen: Optional[torch.Generator],
    cfg: ModelConfig,
    stacked: Dict[str, torch.Tensor],
    dtype=torch.bfloat16,
) -> Tuple[Dict[str, Dict[str, torch.Tensor]], Dict[str, torch.Tensor]]:
    """Adapters for every ``(n_layers, d_in, d_out)`` projection in
    ``stacked`` (callers pre-filter targets) → ``(adapters,
    updated_weights)``; the weights change only for svd_lora with
    subtract-init.  LoRA's A is drawn from ``gen`` (the other modes draw
    nothing).  The factors default to bfloat16 whatever the model dtype, as
    in the reference."""
    acfg = cfg.adapter
    adapters: Dict[str, Dict[str, torch.Tensor]] = {}
    new_weights = dict(stacked)
    if acfg.mode in ("none", "ft"):
        return adapters, new_weights
    for name, W in sorted(stacked.items()):
        mask = layer_selection_mask(acfg.layers, W.shape[0])
        if acfg.mode == "qr_lora":
            adapters[name] = qr_lora_init_stacked(W, mask, acfg, dtype)
        elif acfg.mode == "lora":
            adapters[name] = lora_init_stacked(gen, W, mask, acfg, dtype)
        else:  # svd_lora
            adapters[name], new_weights[name] = svd_lora_init_stacked(W, mask, acfg, dtype)
    return adapters, new_weights


def dryrun_adapters(
    cfg: ModelConfig, stacked_shapes: Dict[str, Tuple[int, int, int]], dtype=torch.bfloat16
) -> Dict[str, Dict[str, torch.Tensor]]:
    """Meta-tensor stand-ins of :func:`init_adapters`' factors for
    ``(n_layers, d_in, d_out)`` shapes, as the reference's dry-run gives
    them (no QR, nothing allocated): B (n, d_in, cap) and A (n, cap, d_out)
    in ``dtype``, λ (n, cap) float32, ranks (n,) int32, with ``cap =
    min(rank_cap, d_in, d_out)`` for qr_lora and ``rank`` otherwise."""
    acfg = cfg.adapter
    if acfg.mode in ("none", "ft"):
        return {}
    meta = lambda *s, dt=dtype: torch.empty(s, dtype=dt, device="meta")
    out = {}
    for name, (n_layers, d_in, d_out) in stacked_shapes.items():
        cap = min(acfg.rank_cap, d_in, d_out) if acfg.mode == "qr_lora" else acfg.rank
        out[name] = {
            "B": meta(n_layers, d_in, cap),
            "A": meta(n_layers, cap, d_out),
            "lam": meta(n_layers, cap, dt=torch.float32),
            "ranks": meta(n_layers, dt=torch.int32),
        }
    return out


# ---------------------------------------------------------------------------
# Trainability masks and partitioning
# ---------------------------------------------------------------------------

_QR_TRAINABLE = ("lam",)
_LORA_TRAINABLE = ("A", "B")


def _is_adapter_leaf_trainable(mode: str, leaf_name: str) -> bool:
    if mode == "qr_lora":
        return leaf_name in _QR_TRAINABLE
    if mode in ("lora", "svd_lora"):
        return leaf_name in _LORA_TRAINABLE
    return False


def _paths(tree: Tree, prefix: Tuple[str, ...] = ()):
    """(path, leaf) of every non-``None`` leaf, in JAX's flattening order
    (sorted keys)."""
    if tree is None:
        return
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _paths(tree[k], prefix + (str(k),))
    else:
        yield prefix, tree


def trainable_mask(params: Tree, cfg: ModelConfig, extra_trainable=()) -> Tree:
    """Tree of bools beside ``params`` (``None`` stays ``None``): which
    leaves train, by the reference's rule.  A leaf whose ``/``-joined path
    contains one of ``extra_trainable`` trains (a fresh task head during
    PEFT); in ft every leaf outside ``adapters`` and ``ranks`` trains;
    otherwise the adapter leaves of the mode do (qr_lora: λ; lora and
    svd_lora: A and B)."""
    mode = cfg.adapter.mode

    def decide(keys) -> bool:
        spath = "/".join(keys)
        if any(s in spath for s in extra_trainable):
            return True
        if mode == "ft":
            return "adapters" not in spath and "ranks" not in spath
        if "adapters" in spath:
            return _is_adapter_leaf_trainable(mode, keys[-1])
        return False

    def walk(tree, keys):
        if tree is None:
            return None
        if isinstance(tree, dict):
            return {k: walk(v, keys + (str(k),)) for k, v in tree.items()}
        return decide(keys)

    return walk(params, ())


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


def count_params(tree: Tree) -> int:
    return sum(leaf.numel() for _, leaf in _paths(tree))


def count_trainable_params(params: Tree, cfg: ModelConfig, extra_trainable=()) -> int:
    """The reference's paper-style trainable-parameter count, step for step.

    For qr_lora a λ leaf is meant to count its projection's selected ranks
    (the ``ranks`` metadata) instead of its padded size; but the lookup is
    keyed by the path of the dict that holds ``adapters`` plus the name
    under it, so in a model tree (``groups/adapters/<module>/<proj>``) it
    never matches a projection and the padded λ size is counted, as the
    reference counts it (ROADMAP Queue 3, kept on purpose)."""
    mask = trainable_mask(params, cfg, extra_trainable)
    rank_by_proj = {}

    def visit(node, path=""):
        if isinstance(node, dict):
            for k, v in node.items():
                if k == "adapters" and isinstance(v, dict):
                    for proj, adp in v.items():
                        if isinstance(adp, dict) and "ranks" in adp:
                            rank_by_proj[path + "/" + proj] = int(adp["ranks"].sum())
                else:
                    visit(v, path + "/" + str(k))

    visit(params)
    total = 0
    for (keys, leaf), (_, m) in zip(_paths(params), _paths(mask)):
        if not m:
            continue
        spath = "/".join(keys)
        if cfg.adapter.mode == "qr_lora" and spath.endswith("lam") and "adapters" in spath:
            matches = [v for k, v in rank_by_proj.items() if k.endswith("/" + keys[-2])]
            total += matches[0] if matches else leaf.numel()
        else:
            total += leaf.numel()
    return total
