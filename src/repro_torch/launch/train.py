"""λ-only training entry point of the port (QR-LoRA: frozen backbone, pivoted-QR
factors, only λ trains) on the synthetic LM stream.

    PYTHONPATH=src python -m repro_torch.launch.train --reduced --device cpu
    PYTHONPATH=src python -m repro_torch.launch.train --steps 30 --batch 8 --seq 256

The second form trains full-width smollm-135m on the card (random weights
from ``--seed``), where every adapted projection's forward runs the one-λ
QR-LoRA kernel.  It prints the trainable count, the loss every
``--log-every`` steps, the median step time and the train tokens/s.  The
reference launcher's LoRA/SVD-LoRA/FT modes and its checkpointing and fault
tolerance (``--ckpt-dir``) come with later slices and raise here.
"""
from __future__ import annotations

import argparse
import statistics
import sys
import time
from typing import Callable, Dict, Iterator, List, Optional

import torch

from repro_torch.configs import get_config, get_reduced
from repro_torch.configs.base import ModelConfig
from repro_torch.data import lm_batches
from repro_torch.models import build_model
from repro_torch.models.model_zoo import Model
from repro_torch.optim import AdamWConfig, make_schedule
from repro_torch.training import init_train_state, make_train_step


def _say(msg: str) -> None:
    sys.stdout.write(f"[train] {msg}\n")
    sys.stdout.flush()


def build(arch: str, reduced: bool, device=None, dtype: Optional[str] = None) -> Model:
    """The model to train (``dtype``: the config's own, bfloat16, unless
    given)."""
    cfg = (get_reduced if reduced else get_config)(arch)
    if dtype is not None:
        cfg = cfg.replace(dtype=dtype)
    return build_model(cfg, device)


def make_step(model: Model, lr: float, steps: int):
    """The train step with the reference launcher's optimizer: AdamW under a
    cosine schedule with ``max(10, steps // 20)`` warmup steps."""
    sched = make_schedule("cosine", lr, warmup_steps=max(10, steps // 20), total_steps=steps)
    return make_train_step(model, AdamWConfig(lr=lr, schedule=sched))


def batches(cfg: ModelConfig, batch: int, seq: int, seed: int,
            device) -> Iterator[Dict[str, torch.Tensor]]:
    for b in lm_batches(cfg.vocab_size, batch, seq, seed=seed):
        yield {"tokens": torch.from_numpy(b["tokens"][:, :seq]).to(device)}


def train(step_fn: Callable, state, data: Iterator, steps: int, log_every: int = 0,
          log: Callable[[str], None] = _say):
    """Run ``steps`` steps; returns (state, history of per-step
    ``{"loss", "ce", "grad_norm", "lr", "ms"}``).  A step's time ends when
    its loss reaches the host, so it covers all of the step's device work."""
    hist: List[Dict[str, float]] = []
    for i in range(steps):
        batch = next(data)
        t0 = time.perf_counter()
        state, m = step_fn(state, batch)
        loss = float(m["loss"])
        ms = (time.perf_counter() - t0) * 1e3
        hist.append({"loss": loss, "ce": float(m["ce"]), "grad_norm": float(m["grad_norm"]),
                     "lr": float(m["lr"]), "ms": ms})
        if log_every and (i % log_every == 0 or i == steps - 1):
            log(f"step {i:4d}  loss {loss:.4f}  |grad| {hist[-1]['grad_norm']:.2e}  "
                f"lr {hist[-1]['lr']:.2e}  {ms:.1f} ms")
    return state, hist


def summary(hist: List[Dict[str, float]], tokens_per_step: int) -> Dict[str, float]:
    """Median step time and train tokens/s over the steps after the first
    (which builds the kernels on the card)."""
    timed = [h["ms"] for h in hist[1:]] or [h["ms"] for h in hist]
    return {"median_step_ms": statistics.median(timed),
            "tokens_per_s": tokens_per_step * len(timed) / (sum(timed) / 1e3)}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-135m")
    ap.add_argument("--reduced", action="store_true", help="CPU-scale config")
    ap.add_argument("--peft", default="qr_lora", choices=["qr_lora", "lora", "svd_lora", "ft"])
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", help="'cuda' (default) or 'cpu'")
    args = ap.parse_args(argv)
    if args.peft != "qr_lora":
        raise NotImplementedError(
            f"--peft {args.peft}: LoRA/SVD-LoRA/FT train B/A or W and need another "
            "backward; they come with ROADMAP Queue 1 item 9"
        )
    if args.ckpt_dir is not None:
        raise NotImplementedError(
            "--ckpt-dir: checkpointing and fault tolerance come with ROADMAP Queue 1 item 15"
        )

    model = build(args.arch, args.reduced, args.device)
    cfg = model.cfg
    _say(f"arch={cfg.name} peft={cfg.adapter.mode} device={model.device} dtype={cfg.dtype}")
    t0 = time.perf_counter()
    state = init_train_state(model, torch.Generator(device=model.device).manual_seed(args.seed))
    n_train = model.count_trainable(state["trainable"])
    _say(f"init {time.perf_counter() - t0:.1f}s; trainable params: {n_train}")

    step_fn = make_step(model, args.lr, args.steps)
    data = batches(cfg, args.batch, args.seq, args.seed, model.device)
    state, hist = train(step_fn, state, data, args.steps, args.log_every)
    s = summary(hist, args.batch * args.seq)
    _say(f"done: {args.steps} steps; final loss {hist[-1]['loss']:.4f}; median step "
         f"{s['median_step_ms']:.1f} ms; {s['tokens_per_s']:.0f} train tokens/s")
    return state, hist


if __name__ == "__main__":
    main()
