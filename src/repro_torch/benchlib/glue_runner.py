"""The paper's experimental pipeline, end to end (port of
``repro/benchlib/glue_runner.py``):

  1. warm-up fine-tune a RoBERTa-shaped encoder on the task (paper §4.1:
     "first warm-up fine-tuned for three epochs") — this also gives the
     weights a non-trivial spectrum, which is what pivoted-QR rank
     selection feeds on;
  2. attach the chosen adapter (qr_lora / lora / svd_lora / ft / none) to
     the warmed-up weights;
  3. train ONLY the adapter's trainable set (+ task head);
  4. evaluate with the task's GLUE metric.

The phases, defaults and returned keys are the reference's; the port adds
``device`` (``cuda`` unless the caller names another), ``init_params`` (the
backbone to start from instead of a fresh ``model.init``, so that a test
can start both packages from the same weights) and, in the result, the
per-step losses and step times of both training phases, the eval outputs
and the trained params.  Every step ends
when its loss reaches the host, as in the reference.
"""
from __future__ import annotations

import time
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs import get_config, get_reduced
from repro_torch.configs.base import ModelConfig
from repro_torch.core import adapter_api
from repro_torch.data import GLUE_TASKS, make_task
from repro_torch.data.metrics import compute as compute_metric
from repro_torch.models import build_model
from repro_torch.models.model_zoo import Model
from repro_torch.optim import AdamWConfig, adamw_init, adamw_update, make_schedule
from repro_torch.tree import Tree, tree_leaves, tree_map


def _loss_fn(cfg: ModelConfig, out: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    if cfg.n_classes == 1:  # regression (STS-B)
        return torch.mean((out[:, 0] - labels) ** 2)
    logp = torch.log_softmax(out, dim=-1)
    return -logp[torch.arange(out.shape[0], device=out.device), labels.long()].mean()


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _make_step(model: Model, opt_cfg: AdamWConfig):
    """One AdamW step over the trainable side of ``(trainable, frozen)``;
    returns ``(new trainable, new opt state, loss)``.  The trainable leaves
    require grad; the values passed in are left as they were."""

    def step(trainable: Tree, frozen: Tree, opt: Tree, batch: Dict[str, torch.Tensor]):
        for p in tree_leaves(trainable):
            p.grad = None
        out = model.apply(adapter_api.merge(trainable, frozen), batch["tokens"])
        loss = _loss_fn(model.cfg, out, batch["labels"])
        loss.backward()
        grads = tree_map(lambda p: torch.zeros_like(p) if p.grad is None else p.grad, trainable)
        new_tr, new_opt, _ = adamw_update(grads, opt, trainable, opt_cfg)
        return tree_map(lambda p: p.requires_grad_(True), new_tr), new_opt, loss.detach()

    return step


def _train(step, params: Tree, mask: Tree, batches, steps: int, device):
    """``steps`` steps of ``step`` over the masked side of ``params`` →
    (params, losses, step ms)."""
    trainable, frozen = adapter_api.partition(params, mask)
    trainable = tree_map(lambda p: p.detach().clone().requires_grad_(True), trainable)
    opt = adamw_init(trainable)
    losses, ms = [], []
    for _, b in zip(range(steps), batches):
        batch = {k: torch.from_numpy(v).to(device) for k, v in b.items()}
        t0 = time.perf_counter()
        trainable, opt, loss = step(trainable, frozen, opt, batch)
        losses.append(float(loss))
        ms.append((time.perf_counter() - t0) * 1e3)
    trainable = tree_map(lambda p: p.detach(), trainable)
    return adapter_api.merge(trainable, frozen), losses, ms


def run_glue_method(
    task_name: str,
    mode: str,  # qr_lora | lora | svd_lora | ft | none
    *,
    seed: int = 0,
    reduced: bool = True,
    train_steps: int = 300,
    warmup_steps: int = 150,
    eval_batches: int = 16,
    batch: int = 16,
    seq: int = 48,
    tau: float = 0.5,
    targets: Tuple[str, ...] = ("wq",),
    layers: str = "last4",
    rank: int = 2,
    train_limit: Optional[int] = None,
    lr: float = 2e-3,
    warmup_lr: float = 1e-3,
    device=None,
    init_params: Optional[Dict] = None,
) -> Dict:
    spec = GLUE_TASKS[task_name]
    base_cfg = (get_reduced if reduced else get_config)("roberta_base")
    cfg = base_cfg.replace(
        n_classes=max(spec.n_classes, 1),
        adapter=base_cfg.adapter.replace(
            mode=mode, targets=targets, layers=layers, tau=tau, rank=rank,
        ),
    )
    task = make_task(task_name, vocab=cfg.vocab_size, seq=seq, seed=seed)
    model = build_model(cfg, device)
    dev = model.device
    gen = torch.Generator(device=dev).manual_seed(seed)

    # ---- phase 1: warm-up FT of the raw backbone on the task --------------
    params = model.init(gen, with_adapters=False) if init_params is None else init_params
    ft_mask = tree_map(lambda _: True, params)
    wcfg = AdamWConfig(lr=warmup_lr,
                       schedule=make_schedule("constant", warmup_lr, 5, warmup_steps))
    it = task.batches("train", batch, epochs=1000, limit=train_limit)
    params, warm_losses, warm_ms = _train(_make_step(model, wcfg), params, ft_mask, it,
                                          warmup_steps, dev)

    # ---- phase 2: attach adapter to warmed-up weights ----------------------
    _sync(dev)
    t0 = time.perf_counter()
    if mode not in ("ft", "none"):
        params = model.attach_adapters(gen, params)
    _sync(dev)
    init_s = time.perf_counter() - t0
    mask = model.trainable_mask(params)
    trainable_n = model.count_trainable(params)

    ocfg = AdamWConfig(lr=lr, schedule=make_schedule("cosine", lr, 10, train_steps))
    it = task.batches("train", batch, epochs=1000, limit=train_limit)
    params, losses, step_ms = _train(_make_step(model, ocfg), params, mask, it, train_steps, dev)

    # ---- phase 3: eval ------------------------------------------------------
    outs, preds, labels = [], [], []
    with torch.no_grad():
        for _, b in zip(range(eval_batches), task.batches("eval", batch)):
            out = model.apply(params, torch.from_numpy(b["tokens"]).to(dev)).cpu().numpy()
            outs.append(out)
            preds.append(out[:, 0] if cfg.n_classes == 1 else out.argmax(-1))
            labels.append(b["labels"])
    preds = np.concatenate(preds)
    labels = np.concatenate(labels)
    if spec.n_classes > 1:
        labels = labels.astype(int)
    metric = compute_metric(spec.metric, preds, labels)
    acc = compute_metric("accuracy", preds, labels) if spec.n_classes > 1 else metric
    return {
        "task": task_name,
        "mode": mode,
        "metric": metric,
        "metric_name": spec.metric,
        "accuracy": acc,
        "trainable": trainable_n,
        "final_loss": losses[-1] if losses else float("nan"),
        "adapter_init_s": init_s,
        "losses": losses,
        "step_ms": step_ms,
        "warmup_losses": warm_losses,
        "warmup_step_ms": warm_ms,
        "outputs": np.concatenate(outs) if outs else np.zeros((0, cfg.n_classes), np.float32),
        "params": params,
    }
