"""Quantized frozen-base weights: per-output-channel symmetric int8 / fp8
(port of ``repro/core/quantize.py``).

QR-LoRA's frozen base W dominates memory and bandwidth while the adapter is
a few hundred λ scalars, so W is what gets quantized and the adapter stays
exact: the QR delta ((x·B)·λ)·A rides on top of the dequantized base.

Representation
==============

A quantized weight replaces the ``(…, K, N)`` tensor with a two-leaf dict::

    {"q": int8|float8_e4m3fn (…, K, N),  "scale": float32 (…, N)}

* per-output-channel symmetric: ``scale[…, n] = max_k |W[…, k, n]| / Q``
  with ``Q = 127`` (int8) or ``448`` (fp8-e4m3), so dequantization is one
  per-column multiply after the contraction, ``x·W ≈ (x·q)·scale``: the
  kernels stream q at one byte an element and scale their fp32 accumulator
  once per output column.
* the dict rides through the layer loop (``transformer._tslice``) like the
  tensor it replaces; only ``adapter_api.adapted_matmul`` (the one consumer
  of W) dispatches on it.

The operations are the reference's, in its order (abs-max over axis −2,
``where(amax > 0, amax / Q, 1)``, a true division, round-half-even, a clip
to ±127, a cast to ``float8_e4m3fn``), so ``q`` and ``scale`` come out
bit-identical to the JAX package's.

Round trip: ``|W − dequant(quantize(W))| ≤ scale/2`` per entry for int8;
fp8-e4m3 is bounded by half its ulp at the scaled magnitude.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from repro_torch.configs.base import BASE_DTYPES

FP8_DTYPE = getattr(torch, "float8_e4m3fn", None)
#: whether this torch build has fp8-e4m3; EngineConfig refuses ``"fp8"``
#: without it, before any device memory is touched
FP8_SUPPORTED = FP8_DTYPE is not None

#: Largest magnitude each dtype's symmetric range maps the channel amax
#: onto.  int8 uses 127 (not 128), so q = −q is always representable.
_QMAX = {"int8": 127.0, "fp8": 448.0}

#: Documented end-to-end bound (the reference's): max |Δlogit| of an
#: int8-base float32 engine against the unquantized float32 merged-weight
#: reference at reduced scale, over matched-context decode positions.
INT8_LOGIT_EPS = 0.15

#: Modules whose projection weights may be quantized.  The reference also
#: lists ``mamba``, ``xattn`` and ``moe``; they come with their families.
_QUANTIZABLE_MODULES = ("attn", "mlp")


def is_quantized(W: Any) -> bool:
    """True when ``W`` is the quantized-weight dict ``{"q", "scale"}``."""
    return isinstance(W, dict) and "q" in W and "scale" in W


def quantize_weight(W: torch.Tensor, base_dtype: str) -> Dict[str, torch.Tensor]:
    """Per-output-channel symmetric quantization of a ``(…, K, N)`` weight.

    ``scale`` is taken over the contracting (−2) axis, so dequantization
    commutes with the matmul.  All-zero columns get scale 1 (q is zero
    there anyway)."""
    if base_dtype not in _QMAX:
        raise ValueError(
            f"base_dtype={base_dtype!r} is not quantized; expected one of {tuple(_QMAX)}"
        )
    if base_dtype == "fp8" and not FP8_SUPPORTED:
        raise ValueError("fp8 base_dtype needs torch.float8_e4m3fn")
    qmax = _QMAX[base_dtype]
    W32 = W.float()
    amax = W32.abs().amax(dim=-2)  # (…, N)
    scale = torch.where(amax > 0, amax / qmax, torch.ones_like(amax))
    scaled = W32 / scale[..., None, :]
    if base_dtype == "int8":
        q = torch.clamp(torch.round(scaled), -qmax, qmax).to(torch.int8)
    else:
        q = scaled.to(FP8_DTYPE)
    return {"q": q, "scale": scale}


def dequantize_weight(qW: Dict[str, torch.Tensor], dtype=torch.float32) -> torch.Tensor:
    """The full-precision weight (references and the adapter merge only;
    the serving path never materializes it)."""
    return (qW["q"].float() * qW["scale"][..., None, :]).to(dtype)


def quantization_error_bound(qW: Dict[str, torch.Tensor]) -> torch.Tensor:
    """Per-output-channel bound of int8 round-to-nearest: half a step,
    broadcastable against the source W."""
    return qW["scale"][..., None, :] * 0.5


def quantized_bytes(qW: Dict[str, torch.Tensor]) -> int:
    return qW["q"].numel() * qW["q"].element_size() + qW["scale"].numel() * 4


def quantize_base_params(params, base_dtype: str):
    """Quantize every adapted base projection of a params tree
    (functionally): each ``groups[mod][proj]`` with an adapter under
    ``groups["adapters"][mod][proj]`` becomes its ``{"q", "scale"}`` dict.
    λ, B, A, norms, embeddings and the unembed stay in the native dtype.
    An already-quantized leaf is kept as it is (the same tensors), and
    ``"bf16"`` returns ``params`` itself."""
    if base_dtype == "bf16":
        return params
    if base_dtype not in BASE_DTYPES:
        raise ValueError(f"base_dtype={base_dtype!r} must be one of {BASE_DTYPES}")
    groups = dict(params["groups"])
    for mod, projs in groups.get("adapters", {}).items():
        if mod not in groups or mod not in _QUANTIZABLE_MODULES:
            continue
        mod_params = dict(groups[mod])
        for proj in projs:
            W = mod_params.get(proj)
            if W is None or is_quantized(W):
                continue
            mod_params[proj] = quantize_weight(W, base_dtype)
        groups[mod] = mod_params
    return {**params, "groups": groups}


def resident_base_bytes(params) -> Tuple[int, int]:
    """(quantized bytes, bytes the same leaves would take in bf16) over
    every quantized projection."""
    qb = fb = 0
    for mod, projs in params["groups"].items():
        if mod == "adapters" or not isinstance(projs, dict):
            continue
        for leaf in projs.values():
            if is_quantized(leaf):
                qb += quantized_bytes(leaf)
                fb += leaf["q"].numel() * 2
    return qb, fb
