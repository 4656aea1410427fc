"""The PEFT-aware train step (port of ``repro/training/steps.py`` for the
dense family).

Parameters are partitioned into (trainable, frozen) by the model's mask:
only the trainable leaves require grad (λ for QR-LoRA, a few thousand
scalars; B and A for LoRA and SVD-LoRA; every weight for ft), while the
frozen tree flows through as constants.  Gradient
accumulation (``cfg.microbatches``) is a Python loop over microbatch slices
whose fp32 gradients add up in each leaf's ``.grad``.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from repro_torch.core import adapter_api
from repro_torch.models.model_zoo import Model
from repro_torch.optim.adamw import AdamWConfig, adamw_init, adamw_update
from repro_torch.tree import Tree, tree_leaves, tree_map

MOE_AUX_COEF = 0.01
Z_LOSS_COEF = 1e-4


def lm_loss(logits: torch.Tensor, targets: torch.Tensor, weights: torch.Tensor):
    """Cross-entropy and z-loss (lse²), fp32, means over weighted
    positions → ``(ce, z)``."""
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, targets.long()[..., None])[..., 0]
    w = weights.float()
    denom = torch.clamp(w.sum(), min=1.0)
    return ((lse - gold) * w).sum() / denom, (torch.square(lse) * w).sum() / denom


def _model_inputs(tokens: torch.Tensor):
    """tokens (B, S) → (targets, weights): each position predicts the next
    token; the last position's (wrapped) target has weight 0."""
    tgt = torch.cat([tokens[:, 1:], tokens[:, :1]], dim=1)
    w = torch.ones(tokens.shape, dtype=torch.float32, device=tokens.device)
    w[:, -1] = 0.0
    return tgt, w


def init_train_state(model: Model, gen: Optional[torch.Generator] = None,
                     params: Optional[Tree] = None) -> Tree:
    """``{"trainable", "frozen", "opt"}`` from ``params`` (or a fresh
    ``model.init(gen)``).  The trainable leaves are copies that require
    grad, so training never writes into ``params``; frozen leaves are
    shared with it and stay constants."""
    params = model.init(gen) if params is None else params
    trainable, frozen = adapter_api.partition(params, model.trainable_mask(params))
    trainable = tree_map(lambda p: p.detach().clone().requires_grad_(True), trainable)
    return {"trainable": trainable, "frozen": frozen, "opt": adamw_init(trainable)}


def make_train_step(model: Model, opt_cfg: AdamWConfig):
    cfg = model.cfg

    def loss_fn(trainable, frozen, tokens):
        params = adapter_api.merge(trainable, frozen)
        tgt, w = _model_inputs(tokens)
        logits, aux = model.apply(params, tokens, train=True)
        ce, zl = lm_loss(logits, tgt, w)
        return ce + Z_LOSS_COEF * zl + MOE_AUX_COEF * aux, ce

    def train_step(state: Tree, batch: Dict[str, torch.Tensor]):
        """One optimizer step over ``batch["tokens"]`` (B, S) → ``(new
        state, metrics)``; the values in ``state`` are left as they were."""
        trainable, frozen = state["trainable"], state["frozen"]
        k = cfg.microbatches
        tokens = batch["tokens"]
        for p in tree_leaves(trainable):
            p.grad = None
        loss_sum = ce_sum = 0.0
        for mb in tokens.reshape(k, tokens.shape[0] // k, *tokens.shape[1:]):
            loss, ce = loss_fn(trainable, frozen, mb)
            loss.backward()  # each leaf's .grad sums the microbatches' gradients
            loss_sum, ce_sum = loss_sum + loss.detach(), ce_sum + ce.detach()
        grads = tree_map(lambda p: (torch.zeros_like(p) if p.grad is None else p.grad) / k,
                         trainable)
        new_trainable, new_opt, om = adamw_update(grads, state["opt"], trainable, opt_cfg)
        new_trainable = tree_map(lambda p: p.requires_grad_(True), new_trainable)
        new_state = {"trainable": new_trainable, "frozen": frozen, "opt": new_opt}
        return new_state, {"loss": loss_sum / k, "ce": ce_sum / k, **om}

    return train_step
