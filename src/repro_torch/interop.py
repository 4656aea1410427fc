"""Weights crossing from the JAX reference into the port.

:func:`params_from_jax` turns a parameter tree whose leaves are numpy arrays
(``jax.device_get(params)`` of a ``repro`` model: decoder or encoder
params, QR-LoRA, LoRA or SVD-LoRA adapters with ``B``/``A``/``lam``/``ranks``,
or a bare λ tree) into the same tree of
torch tensors, leaf for leaf.  The port keeps the reference's layouts, so
the conversion is a plain copy, quantized ``{"q", "scale"}`` leaves
included, and each leaf keeps its dtype (a moe layer's float32 router
beside its bf16 experts).  This module imports neither ``jax`` nor ``ml_dtypes``: bfloat16
and float8_e4m3fn leaves cross as their raw bit patterns (torch cannot
read an ml_dtypes array itself).

:func:`shard_ba_params` (the engine's own
:func:`repro_torch.sharding.rules.shard_factors`, re-exported) cuts a
converted tree to one rank's ``shard_ba`` share of the QR factors, so a test
can build each rank's tree from the JAX one.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch.core.quantize import FP8_DTYPE
from repro_torch.device import resolve_device
from repro_torch.sharding.rules import shard_factors as shard_ba_params  # noqa: F401


#: ml_dtypes name → (numpy view of the same width, torch dtype of the same bits)
_BIT_PATTERNS = {
    "bfloat16": (np.int16, torch.bfloat16),
    "float8_e4m3fn": (np.uint8, FP8_DTYPE),
}


def _leaf_to_torch(leaf, device) -> torch.Tensor:
    arr = np.asarray(leaf)
    if arr.dtype.name in _BIT_PATTERNS:
        view, dtype = _BIT_PATTERNS[arr.dtype.name]
        bits = np.ascontiguousarray(arr).view(view)
        return torch.from_numpy(bits.copy()).view(dtype).to(device)
    return torch.from_numpy(np.array(arr, copy=True)).to(device)


def params_from_jax(tree: Any, device=None) -> Any:
    """Convert a nested dict of numpy leaves to torch tensors on ``device``
    (default ``cuda``; tests pass ``"cpu"``)."""
    dev = resolve_device(device)

    def conv(node):
        if isinstance(node, dict):
            return {k: conv(v) for k, v in node.items()}
        return _leaf_to_torch(node, dev)

    return conv(tree)
