"""Gradient compression for the data-parallel all-reduce (port of
``repro/optim/compression.py``).

``compressed_grad_sync`` replaces the fp32 gradient all-reduce with an
int8-quantized exchange over a ``torch.distributed`` group:

  1. error-feedback add:  g ← g + e          (residual from last step)
  2. per-leaf symmetric quantization (scale = max|g| / 127), the scale
     shared across ranks by an all-reduce MAX
  3. the exact integer sum of the ranks' codes
  4. dequantize; new residual e ← g − dequant(q)

The reference sums the codes with a psum in int16 (exact for ≤ 256 ranks).
No ``torch.distributed`` backend all-reduces int16 (gloo raises "Invalid
scalar type", NCCL has no such type), so the port all-gathers the int8
codes and sums them on each rank in int32: exact, so the synced gradient
and the residual are bitwise the reference's formula.  Bytes on the wire: each rank
receives the other ranks' codes, (world − 1)·n bytes for an n-element
leaf, against 2·(world − 1)/world·4n for a ring fp32 all-reduce; fewer
bytes below 8 ranks, as many at 8, more above.  Error feedback keeps
convergence (Karimireddy et al., 2019).  For QR-LoRA's few-hundred-parameter
gradients this is moot; like the reference, no train step uses it.

Division goes through tensors on the gradient's device: CUDA divides a
tensor by a Python scalar as a multiplication by its reciprocal, which
would part the card from the CPU by a rounding.
"""
from __future__ import annotations

from typing import Any, Optional, Tuple

import torch

from repro_torch.tree import tree_map

Tree = Any


def _const(x: float, like: torch.Tensor) -> torch.Tensor:
    return torch.tensor(x, dtype=torch.float32, device=like.device)


def _scale(g32: torch.Tensor) -> torch.Tensor:
    return torch.clamp(g32.abs().max(), min=1e-12) / _const(127.0, g32)


def quantize_leaf(g: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    scale = _scale(g)
    q = torch.clamp(torch.round(g / scale), -127, 127).to(torch.int16)
    return q, scale


def dequantize_leaf(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


def _group_world(group) -> Tuple[Any, int]:
    """(group, ranks) to sync over: ``group``, else the default group when
    one is up, else no collective at all (a world of one)."""
    import torch.distributed as dist

    if group is None and dist.is_available() and dist.is_initialized():
        group = dist.group.WORLD
    return group, (1 if group is None else dist.get_world_size(group))


def _sum_codes(q: torch.Tensor, group, n: int) -> torch.Tensor:
    """The ranks' int8 codes summed exactly, in int32."""
    import torch.distributed as dist

    codes = q.to(torch.int8).reshape(-1)
    gathered = torch.empty((n, codes.numel()), dtype=torch.int8, device=q.device)
    dist.all_gather(list(gathered.unbind(0)), codes, group=group)
    return gathered.to(torch.int32).sum(0).reshape(q.shape)


def compressed_grad_sync(grads: Tree, err: Optional[Tree],
                         group=None) -> Tuple[Tree, Tree]:
    """grads: *local* (unreduced) gradient tree; returns (synced, new_err).
    ``group``: the data-parallel process group (module docstring)."""
    import torch.distributed as dist

    group, n = _group_world(group)

    def sync(g, e):
        g32 = g.to(torch.float32) + (0.0 if e is None else e)
        smax = _scale(g32)
        if group is not None:  # shared scale across replicas
            dist.all_reduce(smax, op=dist.ReduceOp.MAX, group=group)
        q2 = torch.clamp(torch.round(g32 / smax), -127, 127).to(torch.int16)
        qsum = _sum_codes(q2, group, n) if group is not None else q2
        synced = qsum.to(torch.float32) * smax / _const(float(n), g32)
        new_e = g32 - q2.to(torch.float32) * smax
        return synced, new_e

    return _sync_tree(sync, grads, err)


def _sync_tree(sync, grads: Tree, err: Optional[Tree]) -> Tuple[Tree, Tree]:
    """``sync`` over the non-None leaves of ``grads`` beside ``err``'s (or
    None) → (synced tree, new error tree), None where ``grads`` has None."""
    errs = err if err is not None else tree_map(lambda g: None, grads)
    out = tree_map(sync, grads, errs)
    return tree_map(lambda o: o[0], out), tree_map(lambda o: o[1], out)


def init_error_state(trainable: Tree) -> Tree:
    return tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32), trainable)


# ---------------------------------------------------------------------------
# Top-k sparsification with error feedback (Deep Gradient Compression,
# Lin et al. 2018): keep the largest-magnitude entries of each leaf,
# accumulate the rest locally.
# ---------------------------------------------------------------------------


def topk_sparsify(g: torch.Tensor, frac: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (g with only its top-k magnitudes kept, residual).  Every
    entry at least the k-th largest magnitude is kept, ties included, so
    more than k may stay."""
    flat = g.reshape(-1)
    k = max(1, int(flat.shape[0] * frac))
    thresh = torch.topk(flat.abs(), k).values[-1]
    mask = flat.abs() >= thresh
    kept = torch.where(mask, flat, torch.zeros((), dtype=flat.dtype, device=flat.device))
    kept = kept.reshape(g.shape)
    return kept, g - kept


def topk_grad_sync(grads: Tree, err: Optional[Tree], group=None,
                   frac: float = 0.01) -> Tuple[Tree, Tree]:
    """Error-feedback top-k gradient exchange.  The sum is a dense fp32
    all-reduce (the collectives have no sparse wire format); this is the
    convergence-preserving substrate, tested for the error-feedback
    contract."""
    import torch.distributed as dist

    group, n = _group_world(group)

    def sync(g, e):
        g32 = g.to(torch.float32) + (0.0 if e is None else e)
        kept, resid = topk_sparsify(g32, frac)
        if group is not None:
            dist.all_reduce(kept, group=group)
        return kept, resid

    return _sync_tree(sync, grads, err)
