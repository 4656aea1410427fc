"""AdamW on partitioned trainable trees — the port's copy of
``repro/optim/adamw.py``.

Not ``torch.optim.AdamW``: the reference clips by ``max(‖g‖, 1e-9)`` (where
``clip_grad_norm_`` adds 1e-6 to the norm) and puts the weight decay inside
the Adam delta.  The trainable tree may hold ``None`` leaves (the frozen
side of ``adapter_api.partition``); optimizer state exists only for real
leaves.  Updates are functional, as in the reference: new tensors, computed
without autograd, and the inputs are left as they were.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Tuple

import torch

from repro_torch.tree import Tree, tree_leaves, tree_map


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 1e-3
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    weight_decay: float = 0.01
    clip_norm: float = 1.0
    schedule: Optional[Callable[[int], float]] = None


def adamw_init(trainable: Tree) -> Tree:
    zeros = lambda p: torch.zeros_like(p, dtype=torch.float32)
    return {"step": 0, "m": tree_map(zeros, trainable), "v": tree_map(zeros, trainable)}


def global_norm(tree: Tree) -> torch.Tensor:
    leaves = tree_leaves(tree)
    if not leaves:
        return torch.zeros(())
    return torch.sqrt(sum(torch.sum(torch.square(x.float())) for x in leaves))


@torch.no_grad()
def adamw_update(grads: Tree, state: Tree, params: Tree, cfg: AdamWConfig,
                 gnorm: Optional[torch.Tensor] = None) -> Tuple[Tree, Tree, dict]:
    """One AdamW step → ``(new_params, new_state, {"grad_norm", "lr"})``;
    ``gnorm`` (default: :func:`global_norm` of ``grads``) is the norm it
    clips by, given where ``grads`` holds one rank's blocks of sharded
    leaves."""
    step = state["step"] + 1
    if gnorm is None:
        gnorm = global_norm(grads)
    if cfg.clip_norm:
        scale = torch.clamp(cfg.clip_norm / torch.clamp(gnorm, min=1e-9), max=1.0)
        # in fp32, as the reference's promotion gives it for a bf16 leaf
        grads = tree_map(lambda g: g.float() * scale, grads)
    lr = cfg.schedule(step) if cfg.schedule is not None else cfg.lr
    step32 = torch.tensor(float(step), dtype=torch.float32)
    b1c = 1.0 - torch.tensor(cfg.b1, dtype=torch.float32) ** step32
    b2c = 1.0 - torch.tensor(cfg.b2, dtype=torch.float32) ** step32

    m = tree_map(lambda mm, g: cfg.b1 * mm + (1 - cfg.b1) * g.float(), state["m"], grads)
    v = tree_map(lambda vv, g: cfg.b2 * vv + (1 - cfg.b2) * torch.square(g.float()),
                 state["v"], grads)

    def upd(p, mm, vv):
        mhat = mm / b1c  # 0-dim CPU tensors combine with tensors on any device
        vhat = vv / b2c
        delta = mhat / (torch.sqrt(vhat) + cfg.eps) + cfg.weight_decay * p.float()
        return (p.float() - lr * delta).to(p.dtype)

    new_params = tree_map(upd, params, m, v)
    return new_params, {"step": step, "m": m, "v": v}, {"grad_norm": gnorm, "lr": lr}
