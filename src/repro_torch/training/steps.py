"""The PEFT-aware train step and the serving prefill/decode steps (port of
``repro/training/steps.py`` for the dense, audio, moe, vlm, hybrid and ssm
families).

Parameters are partitioned into (trainable, frozen) by the model's mask:
only the trainable leaves require grad (λ for QR-LoRA, a few thousand
scalars; B and A for LoRA and SVD-LoRA; every weight for ft), while the
frozen tree flows through as constants.  Gradient
accumulation (``cfg.microbatches``) is a Python loop over microbatch slices
whose fp32 gradients add up in each leaf's ``.grad``; each microbatch is
its own forward, so a moe layer routes that microbatch's rows alone, as the
reference's scan does.  The loss carries ``MOE_AUX_COEF`` times the moe
layers' load-balancing aux (the moe family's, and the hybrid's moe layers';
0 for the other families), and the metrics report ``aux``.  The recurrent
families' mixers are plain autograd: the gradient reaches λ through their
sequential steps.

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
from repro_torch.sharding import collectives as coll
from repro_torch.sharding import rules as shrules
from repro_torch.tree import Tree, tree_leaves, tree_map

MOE_AUX_COEF = 0.01
Z_LOSS_COEF = 1e-4


def lm_loss(logits: torch.Tensor, targets: torch.Tensor, weights: torch.Tensor,
            denom: Optional[torch.Tensor] = None):
    """Cross-entropy and z-loss (lse²), fp32, weighted sums over ``denom``
    (default: the weight sum, at least 1: means over weighted positions)
    → ``(ce, z)``."""
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, targets.long()[..., None])[..., 0]
    w = weights.float()
    if denom is None:
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
        state, metrics)``; the values in ``state`` are left as they were.
        Under a runtime mesh, the data-parallel step (:func:`_mesh_step`)."""
        if hasattr(shrules.get_mesh(), "group"):
            return _mesh_step(model, opt_cfg, state, batch)
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


def _mesh_step(model: Model, opt_cfg: AdamWConfig, state: Tree, batch: Dict[str, torch.Tensor]):
    """The train step on the installed runtime mesh, the reference's jitted
    step under ``axis_rules`` computed by ranks.

    ``state`` holds this rank's blocks (:func:`~repro_torch.sharding.rules.
    mesh_specs`: the moe expert stacks cut, every other leaf whole) and
    ``batch`` the global batch.  The k microbatches split first, as the
    reference's scan takes them; data rank d then runs its contiguous
    B/(k·n) rows of each (n the data axes' size), or every row when they
    do not divide.  The rank's loss is its share of the microbatch's: its
    weighted sums over the weight sum of the whole microbatch (summed over
    the data axes), the moe aux (already the mean over the mesh) over n;
    with every row on every rank, the whole loss over n.  So every trainable
    leaf's gradient is the sum over the data axes of the ranks' gradients:
    an all-reduce over them for a leaf they do not shard, the fsdp gather's
    reduce-scatter for one they do; never over "model", along which every
    rank computes the same gradient of a leaf it holds whole.  The grad norm
    sums each sharded leaf's blocks over its axes, so every rank clips by
    the same norm and applies the same AdamW update: the replicated leaves
    stay bitwise equal across the mesh.  The metrics are the global ones."""
    cfg = model.cfg
    trainable, frozen = state["trainable"], state["frozen"]
    dp = shrules.dp_axes()
    n = shrules.get_mesh().axis_size(dp)
    k = cfg.microbatches
    specs = shrules.mesh_specs(trainable)
    for p in tree_leaves(trainable):
        p.grad = None
    mbs = {name: x.reshape(k, x.shape[0] // k, *x.shape[1:]) for name, x in batch.items()}
    split = shrules.batch_splits(next(iter(mbs.values())).shape[1])
    parts = []
    for i in range(k):
        mb = {name: shrules.rank_rows(x[i], split) for name, x in mbs.items()}
        params = adapter_api.merge(trainable, frozen)
        kw, tgt, w = _model_inputs(cfg, mb)
        with shrules.data_shard(split):
            logits, aux = model.apply(params, train=True, **kw)
            wsum = w.float().sum()
            denom = torch.clamp(coll.all_reduce(wsum, dp) if split and dp else wsum, min=1.0)
            ce, zl = lm_loss(logits, tgt, w, denom if split or n == 1 else denom * n)
            share = ce + Z_LOSS_COEF * zl + MOE_AUX_COEF * (aux if n == 1 else aux / n)
            share.backward()
        parts.append(torch.stack([ce.detach(), zl.detach(), aux.detach()]))
    # the global ce and z of each microbatch: the shares summed over the data
    # axes, or, with every row on every rank, the whole scaled back (the aux
    # is already the mean over the mesh)
    parts = torch.stack(parts)
    if dp and split:
        parts = torch.cat([coll.all_reduce(parts[:, :2], dp), parts[:, 2:]], 1)
    elif n > 1:
        parts = parts * torch.tensor([n, n, 1.0], dtype=parts.dtype, device=parts.device)
    loss_sum = ce_sum = aux_sum = 0.0
    for ce, zl, aux in parts:
        loss_sum = loss_sum + (ce + Z_LOSS_COEF * zl + MOE_AUX_COEF * aux)
        ce_sum, aux_sum = ce_sum + ce, aux_sum + aux

    def synced(p, spec):
        g = torch.zeros_like(p) if p.grad is None else p.grad
        if dp and not set(dp) & set(shrules.sharded_axes(spec)):
            g = coll.all_reduce(g, dp)
        return g / k

    grads = tree_map(synced, trainable, specs)
    gnorm = torch.sqrt(coll.sum_sq_over(grads, specs))
    new_trainable, new_opt, om = adamw_update(grads, state["opt"], trainable, opt_cfg,
                                              gnorm=gnorm)
    new_trainable = tree_map(lambda p: p.requires_grad_(True), new_trainable)
    new_state = {"trainable": new_trainable, "frozen": frozen, "opt": new_opt}
    return new_state, {"loss": loss_sum / k, "ce": ce_sum / k, "aux": aux_sum / k, **om}


def _step_inputs(cfg, batch: Dict[str, torch.Tensor], token_key: str) -> Dict:
    kw = {"embeds": batch["embeds"]} if cfg.family == "audio" else {token_key: batch[token_key]}
    if cfg.family == "vlm":
        kw["image_embeds"] = batch["image_embeds"]
    if "seg_ids" in batch:  # multi-tenant λ-slot ids (repro_torch.serving)
        kw["seg_ids"] = batch["seg_ids"]
    return kw


def _lanes(fn, batch: Dict[str, torch.Tensor]):
    """``fn(batch)`` → (logits, cache), on a runtime mesh over this data
    rank's lanes: each rank runs its contiguous block of the batch's lanes
    (every lane when they do not divide over the data axes) against the
    cache of those lanes, and the logits of every lane come back
    (all-gathered over the data axes) beside the rank's cache."""
    if not hasattr(shrules.get_mesh(), "group"):
        return fn(batch)
    split = shrules.batch_splits(next(iter(batch.values())).shape[0])
    with shrules.data_shard(split):
        logits, cache = fn({name: shrules.rank_rows(x, split) for name, x in batch.items()})
    if split:
        logits = coll.gather_dim(logits, shrules.dp_axes(), 0)
    return logits, cache


def make_prefill_step(model: Model):
    """``prefill_step(params, cache, batch)`` → (last-position logits,
    cache): ``batch["tokens"]`` (B, S), or ``batch["embeds"]`` (B, S, d) for
    the audio family, ``batch["image_embeds"]`` for vlm, and optionally
    ``batch["seg_ids"]``.  On a runtime mesh ``cache`` holds this data
    rank's lanes (:func:`_lanes`)."""
    cfg = model.cfg

    def prefill_step(params, cache, batch):
        return _lanes(lambda b: model.prefill(params, cache, **_step_inputs(cfg, b, "tokens")),
                      batch)

    return prefill_step


def make_decode_step(model: Model):
    """``decode_step(params, cache, batch)`` → (greedy next token (B, 1)
    int32, logits (B, V), cache): ``batch["token"]`` (B, 1), or
    ``batch["embeds"]`` (B, 1, d) for the audio family, ``batch["image_embeds"]``
    for vlm (every step), and optionally ``batch["seg_ids"]``.  On a runtime
    mesh ``cache`` holds this data rank's lanes (:func:`_lanes`)."""
    cfg = model.cfg

    def decode_step(params, cache, batch):
        logits, cache = _lanes(
            lambda b: model.decode_step(params, cache, **_step_inputs(cfg, b, "token")), batch)
        # greedy next token, shaped (B, 1) so it feeds the next decode step
        return torch.argmax(logits, dim=-1).to(torch.int32)[:, None], logits, cache

    return decode_step
