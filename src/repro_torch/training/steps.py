"""The PEFT-aware train step and the serving prefill/decode steps (port of
``repro/training/steps.py`` for the dense, audio, moe and vlm families).

Parameters are partitioned into (trainable, frozen) by the model's mask:
only the trainable leaves require grad (λ for QR-LoRA, a few thousand
scalars; B and A for LoRA and SVD-LoRA; every weight for ft), while the
frozen tree flows through as constants.  Gradient
accumulation (``cfg.microbatches``) is a Python loop over microbatch slices
whose fp32 gradients add up in each leaf's ``.grad``; each microbatch is
its own forward, so a moe layer routes that microbatch's rows alone, as the
reference's scan does.  The loss carries ``MOE_AUX_COEF`` times the moe
layers' load-balancing aux (0 for the other families), and the metrics
report ``aux``.

A batch is ``{"tokens"}`` (B, S) for the dense family: each position
predicts the next token.  The audio family trains on frame embeddings:
``{"embeds"}`` (B, S, d) with the code ``{"targets"}`` (B, S) given, every
position weighted one.  The vlm family's batches carry the stub vision
frontend's patch embeddings ``{"image_embeds"}`` (B, n_image_tokens,
d_image) beside the tokens, in the loss and in every prefill and decode
step, and a microbatch takes its rows' images.
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


def _model_inputs(cfg, batch: Dict[str, torch.Tensor]):
    """batch → (apply kwargs, targets, weights).  Audio: the frames in, the
    given targets, every weight one.  Otherwise each position predicts the
    next token; the last position's (wrapped) target has weight 0."""
    if cfg.family == "audio":
        tgt = batch["targets"]
        return ({"embeds": batch["embeds"]}, tgt,
                torch.ones(tgt.shape, dtype=torch.float32, device=tgt.device))
    tokens = batch["tokens"]
    tgt = torch.cat([tokens[:, 1:], tokens[:, :1]], dim=1)
    w = torch.ones(tokens.shape, dtype=torch.float32, device=tokens.device)
    w[:, -1] = 0.0
    kw = {"tokens": tokens}
    if cfg.family == "vlm":
        kw["image_embeds"] = batch["image_embeds"]
    return kw, tgt, w


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

    def loss_fn(trainable, frozen, mb):
        params = adapter_api.merge(trainable, frozen)
        kw, tgt, w = _model_inputs(cfg, mb)
        logits, aux = model.apply(params, train=True, **kw)
        ce, zl = lm_loss(logits, tgt, w)
        return ce + Z_LOSS_COEF * zl + MOE_AUX_COEF * aux, ce, aux

    def train_step(state: Tree, batch: Dict[str, torch.Tensor]):
        """One optimizer step over ``batch`` (module docstring) → ``(new
        state, metrics)``; the values in ``state`` are left as they were."""
        trainable, frozen = state["trainable"], state["frozen"]
        k = cfg.microbatches
        for p in tree_leaves(trainable):
            p.grad = None
        loss_sum = ce_sum = aux_sum = 0.0
        mbs = {name: x.reshape(k, x.shape[0] // k, *x.shape[1:]) for name, x in batch.items()}
        for i in range(k):
            loss, ce, aux = loss_fn(trainable, frozen, {name: x[i] for name, x in mbs.items()})
            loss.backward()  # each leaf's .grad sums the microbatches' gradients
            loss_sum, ce_sum = loss_sum + loss.detach(), ce_sum + ce.detach()
            aux_sum = aux_sum + aux.detach()
        grads = tree_map(lambda p: (torch.zeros_like(p) if p.grad is None else p.grad) / k,
                         trainable)
        new_trainable, new_opt, om = adamw_update(grads, state["opt"], trainable, opt_cfg)
        new_trainable = tree_map(lambda p: p.requires_grad_(True), new_trainable)
        new_state = {"trainable": new_trainable, "frozen": frozen, "opt": new_opt}
        return new_state, {"loss": loss_sum / k, "ce": ce_sum / k, "aux": aux_sum / k, **om}

    return train_step


def _step_inputs(cfg, batch: Dict[str, torch.Tensor], token_key: str) -> Dict:
    kw = {"embeds": batch["embeds"]} if cfg.family == "audio" else {token_key: batch[token_key]}
    if cfg.family == "vlm":
        kw["image_embeds"] = batch["image_embeds"]
    if "seg_ids" in batch:  # multi-tenant λ-slot ids (repro_torch.serving)
        kw["seg_ids"] = batch["seg_ids"]
    return kw


def make_prefill_step(model: Model):
    """``prefill_step(params, cache, batch)`` → (last-position logits,
    cache): ``batch["tokens"]`` (B, S), or ``batch["embeds"]`` (B, S, d) for
    the audio family, ``batch["image_embeds"]`` for vlm, and optionally
    ``batch["seg_ids"]``."""
    cfg = model.cfg

    def prefill_step(params, cache, batch):
        return model.prefill(params, cache, **_step_inputs(cfg, batch, "tokens"))

    return prefill_step


def make_decode_step(model: Model):
    """``decode_step(params, cache, batch)`` → (greedy next token (B, 1)
    int32, logits (B, V), cache): ``batch["token"]`` (B, 1), or
    ``batch["embeds"]`` (B, 1, d) for the audio family, ``batch["image_embeds"]``
    for vlm (every step), and optionally ``batch["seg_ids"]``."""
    cfg = model.cfg

    def decode_step(params, cache, batch):
        logits, cache = model.decode_step(params, cache, **_step_inputs(cfg, batch, "token"))
        # greedy next token, shaped (B, 1) so it feeds the next decode step
        return torch.argmax(logits, dim=-1).to(torch.int32)[:, None], logits, cache

    return decode_step
