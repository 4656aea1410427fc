"""Input stand-ins and placements of a dry-run cell (port of
``repro/launch/specs.py``).

Everything here is allocation-free: inputs, params, train state and decode
caches are meta tensors of the reference's shapes and dtypes (params from
:meth:`Model.dryrun_params`, caches from ``init_decode_state`` on the meta
device), and each placement is a tree of specs beside its tree, one entry
per dim as a ``PartitionSpec`` holds them, from
:mod:`repro_torch.sharding.rules`' logical rule table on a mesh description
(:mod:`repro_torch.launch.mesh`).  :func:`per_device_bytes` is what one
device holds of a tree under its specs.
"""
from __future__ import annotations

import math
from typing import Dict, Tuple

import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.core import adapter_api
from repro_torch.models.model_zoo import Model, build_model
from repro_torch.sharding import rules as shrules
from repro_torch.tree import Tree, tree_leaves, tree_map


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


# ---------------------------------------------------------------------------
# batch input specs
# ---------------------------------------------------------------------------


def input_specs(cfg: ModelConfig, shape: ShapeConfig) -> Dict[str, torch.Tensor]:
    B, S = shape.global_batch, shape.seq_len
    if shape.kind in ("train", "prefill"):
        if cfg.family == "audio":
            out = {"embeds": _meta((B, S, cfg.d_model), torch.bfloat16),
                   "targets": _meta((B, S), torch.int32)}
        else:
            out = {"tokens": _meta((B, S), torch.int32)}
    elif cfg.family == "audio":  # decode: one new token against a cache of S
        out = {"embeds": _meta((B, 1, cfg.d_model), torch.bfloat16)}
    else:
        out = {"token": _meta((B, 1), torch.int32)}
    if cfg.family == "vlm":
        out["image_embeds"] = _meta((B, cfg.n_image_tokens, cfg.d_image), torch.bfloat16)
    return out


def _dp_axes(mesh) -> Tuple[str, ...]:
    return tuple(a for a in ("pod", "data") if a in mesh.axis_names)


def _dp_size(mesh) -> int:
    return math.prod(mesh.shape[a] for a in _dp_axes(mesh))


def batch_shardings(cfg: ModelConfig, shape: ShapeConfig, mesh) -> Dict[str, Tuple]:
    """The batch dim on the rule table's "batch" axes (every axis under
    ``dp_only``; none for weight-stationary decode, whose activations
    replicate) where the global batch divides them; other dims replicated."""
    rules = shrules.default_rules(
        mesh, dp_only=cfg.dp_only,
        replicate_batch=shape.kind == "decode" and cfg.decode_weight_stationary)
    axes = rules["batch"]
    if axes is not None and shape.global_batch % math.prod(mesh.shape[a] for a in axes):
        rules["batch"] = None
    return {k: shrules.logical_spec(rules, "batch", *(None,) * (v.ndim - 1))
            for k, v in input_specs(cfg, shape).items()}


# ---------------------------------------------------------------------------
# train state / decode cache shapes + placements
# ---------------------------------------------------------------------------


def train_state_shapes(model: Model) -> Tree:
    """The train state as the reference lays it out: the (trainable,
    frozen) split of the params, AdamW's float32 m and v beside the
    trainable leaves and an int32 step."""
    params = model.dryrun_params()
    trainable, frozen = adapter_api.partition(params, model.trainable_mask(params))
    f32 = lambda x: _meta(x.shape, torch.float32)
    return {
        "trainable": trainable,
        "frozen": frozen,
        "opt": {"step": _meta((), torch.int32), "m": tree_map(f32, trainable),
                "v": tree_map(f32, trainable)},
    }


def _rules(mesh, fsdp: bool, dp_only: bool):
    return shrules.default_rules(mesh, fsdp=fsdp, dp_only=dp_only)


def train_state_shardings(state_shapes: Tree, mesh, *, fsdp: bool, dp_only: bool = False) -> Tree:
    """Params by the rule table; optimizer m/v mirror their parameter's
    placement; the step is replicated."""
    rules = _rules(mesh, fsdp, dp_only)
    place = lambda t: shrules.param_sharding_rules(t, mesh, rules)
    opt = state_shapes["opt"]
    return {
        "trainable": place(state_shapes["trainable"]),
        "frozen": place(state_shapes["frozen"]),
        "opt": {"step": (), "m": place(opt["m"]), "v": place(opt["v"])},
    }


def decode_cache_shapes(model: Model, shape: ShapeConfig) -> Tree:
    """The lock-step decode cache of a cell, bf16, on the meta device."""
    return build_model(model.cfg, "meta").init_decode_state(
        shape.global_batch, shape.seq_len, torch.bfloat16)


def decode_cache_shardings(cache_shapes: Tree, cfg: ModelConfig, shape: ShapeConfig,
                           mesh) -> Tree:
    """KV caches: batch over the data axes when divisible, kv-heads over
    "model" when they divide, else the head dim, never the sequence (a
    write into a sequence-sharded cache gathers the whole cache every
    step).  Recurrent states: batch over the data axes, then their largest
    divisible dim of the last three over "model"."""
    dp = _dp_axes(mesh)
    B = shape.global_batch
    batch_ok = bool(dp) and B % _dp_size(mesh) == 0
    model_ax = "model" if "model" in mesh.axis_names else None
    msize = mesh.shape[model_ax] if model_ax else 1

    def spec_for(name, leaf):
        nd = leaf.ndim
        spec = [None] * nd
        if name in ("k", "v"):
            lead = nd - 4  # (G, [inner,] B, S, KV, dh)
            if batch_ok:
                spec[lead] = dp
            if model_ax and cfg.n_kv_heads % msize == 0:
                spec[lead + 2] = model_ax
            elif model_ax and cfg.d_head % msize == 0:
                spec[lead + 3] = model_ax
        elif name in ("conv", "h", "C", "n", "m", "c"):
            for i, s in enumerate(leaf.shape):
                if batch_ok and s == B and i >= nd - 4:
                    spec[i] = dp
                    break
            if model_ax:
                cands = [i for i in range(max(nd - 3, 0), nd)
                         if spec[i] is None and leaf.shape[i] % msize == 0
                         and leaf.shape[i] >= msize]
                if cands:
                    spec[max(cands, key=lambda i: leaf.shape[i])] = model_ax
        return tuple(spec)

    def walk(node, name):
        if isinstance(node, dict):
            return {k: walk(v, k) for k, v in node.items()}
        return spec_for(name, node)

    return walk(cache_shapes, None)


def params_shardings(params_shapes: Tree, mesh, *, fsdp: bool, dp_only: bool = False) -> Tree:
    return shrules.param_sharding_rules(params_shapes, mesh, _rules(mesh, fsdp, dp_only))


def per_device_bytes(tree: Tree, specs: Tree, mesh) -> int:
    """Bytes one device holds of ``tree`` placed by ``specs`` (a tree of
    the same structure, a spec tuple at each leaf; ``None`` leaves hold
    nothing)."""
    return sum(math.prod(shrules.shard_shape(t.shape, spec, mesh)) * t.element_size()
               for t, spec in zip(tree_leaves(tree), tree_leaves(specs), strict=True))
