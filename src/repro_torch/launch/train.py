"""Training entry point of the port on the synthetic LM stream, in any PEFT
mode: QR-LoRA (the default: frozen backbone, pivoted-QR factors, only λ
trains), LoRA, SVD-LoRA (B and A train) or full fine-tuning (``--peft``).

    PYTHONPATH=src python -m repro_torch.launch.train --reduced --device cpu
    PYTHONPATH=src python -m repro_torch.launch.train --reduced --device cpu --peft lora
    PYTHONPATH=src python -m repro_torch.launch.train --steps 30 --batch 8 --seq 256
    PYTHONPATH=src python -m repro_torch.launch.train --reduced --device cpu --arch musicgen-medium
    PYTHONPATH=src python -m repro_torch.launch.train --reduced --device cpu --arch moonshot-v1-16b-a3b
    PYTHONPATH=src python -m repro_torch.launch.train --reduced --device cpu --arch llama-3.2-vision-11b
    PYTHONPATH=src python -m repro_torch.launch.train --reduced --device cpu --arch xlstm-125m
    PYTHONPATH=src python -m repro_torch.launch.train --reduced --device cpu --arch jamba-1.5-large-398b
    PYTHONPATH=src python -m repro_torch.launch.train --reduced --device cpu --steps 40 --ckpt-dir /tmp/run1 --save-every 10

The third form trains full-width smollm-135m on the card (random weights
from ``--seed``), where every adapted projection's forward runs the one-λ
kernel.  ``--arch musicgen-medium`` trains the audio family on frame
embeddings with code targets; a moe arch (``moonshot-v1-16b-a3b``,
``mixtral-8x22b``) adds its experts' load-balancing aux to the loss;
``--arch llama-3.2-vision-11b`` trains the vlm family on token batches
beside stub patch embeddings; ``--arch xlstm-125m`` trains the ssm family's
λ on ``x_qkv`` (its v third through the strided column slice) and
``--arch jamba-1.5-large-398b`` the hybrid's (full width needs four cards:
ROADMAP item 14c), its moe layers' aux in the loss.  It prints the trainable count, the loss every ``--log-every``
steps, the median step time and the train tokens/s.

Fault tolerance is on by default, as in the reference launcher: the steps
run through :class:`repro_torch.runtime.TrainLoopRunner` over a
:class:`repro_torch.checkpoint.CheckpointManager` (``keep=3``) under
``--ckpt-dir``, so a run restores the newest checkpoint there, saves every
``--save-every`` steps in the background, checkpoints and exits at the
step boundary on SIGTERM, replays from the last checkpoint after a failed
step, and saves at its end.  A run that stopped at step s and is started
again with the same flags goes on from s, and each step's batch is the
one an uninterrupted run takes there (:func:`batches`).  The default
directory is ``repro_torch_ckpt_<arch>`` under the temporary directory
(``/tmp`` unless ``TMPDIR`` says otherwise): the port's own, never the
reference's ``repro_ckpt_<arch>``.  Train forwards remat (``cfg.remat``).
"""
from __future__ import annotations

import argparse
import os
import statistics
import sys
import tempfile
import time
from typing import Callable, Dict, Iterator, List, Optional

import numpy as np
import torch

from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import get_config, get_reduced
from repro_torch.configs.base import ModelConfig
from repro_torch.data import lm_batches
from repro_torch.models import build_model
from repro_torch.models.model_zoo import Model
from repro_torch.optim import AdamWConfig, make_schedule
from repro_torch.runtime import TrainLoopRunner
from repro_torch.training import init_train_state, make_train_step


def _say(msg: str) -> None:
    sys.stdout.write(f"[train] {msg}\n")
    sys.stdout.flush()


def build(arch: str, reduced: bool, device=None, dtype: Optional[str] = None,
          peft: str = "qr_lora") -> Model:
    """The model to train in adapter mode ``peft`` (``dtype``: the config's
    own, bfloat16, unless given)."""
    cfg = (get_reduced if reduced else get_config)(arch)
    cfg = cfg.replace(adapter=cfg.adapter.replace(mode=peft))
    if dtype is not None:
        cfg = cfg.replace(dtype=dtype)
    return build_model(cfg, device)


def make_step(model: Model, lr: float, steps: int):
    """The train step with the reference launcher's optimizer: AdamW under a
    cosine schedule with ``max(10, steps // 20)`` warmup steps."""
    sched = make_schedule("cosine", lr, warmup_steps=max(10, steps // 20), total_steps=steps)
    return make_train_step(model, AdamWConfig(lr=lr, schedule=sched))


def batches(cfg: ModelConfig, batch: int, seq: int, seed: int,
            device, start_step: int = 0) -> Iterator[Dict[str, torch.Tensor]]:
    """The synthetic LM stream's token batches from step ``start_step`` on;
    for the audio family the tokens are the code targets and the frames
    beside them are normal draws (scale 0.1) from ``seed``, the stub EnCodec
    frontend's stand-in; for the vlm family each row gets its own image,
    standard normal patch embeddings (n_image_tokens × d_image) from
    ``seed``, the stub vision frontend's.  The frames and images are one
    stream of draws, so a later start draws and drops the batches before it:
    batch s is the same whatever the start."""
    rng = np.random.default_rng(seed)
    shape = {"vlm": (batch, cfg.n_image_tokens, cfg.d_image),
             "audio": (batch, seq, cfg.d_model)}.get(cfg.family)
    for _ in range(start_step if shape else 0):
        rng.standard_normal(shape, np.float32)
    for b in lm_batches(cfg.vocab_size, batch, seq, seed=seed, start_step=start_step):
        tokens = torch.from_numpy(b["tokens"][:, :seq]).to(device)
        if cfg.family == "vlm":
            img = rng.standard_normal(shape, np.float32)
            yield {"tokens": tokens, "image_embeds": torch.from_numpy(img).to(device)}
            continue
        if cfg.family != "audio":
            yield {"tokens": tokens}
            continue
        frames = rng.standard_normal(shape, np.float32) * 0.1
        yield {"embeds": torch.from_numpy(frames).to(device), "targets": tokens}


def _timed_step(step_fn: Callable, state, batch):
    """One step → (state, metrics, its ``{"loss", "ce", "aux", "grad_norm",
    "lr", "ms"}`` row).  The time ends when the loss reaches the host, so it
    covers all of the step's device work."""
    t0 = time.perf_counter()
    state, m = step_fn(state, batch)
    loss = float(m["loss"])
    ms = (time.perf_counter() - t0) * 1e3
    return state, m, {"loss": loss, "ce": float(m["ce"]), "aux": float(m["aux"]),
                      "grad_norm": float(m["grad_norm"]), "lr": float(m["lr"]), "ms": ms}


def train(step_fn: Callable, state, data: Iterator, steps: int, log_every: int = 0,
          log: Callable[[str], None] = _say):
    """Run ``steps`` steps; returns (state, history of per-step
    ``{"loss", "ce", "aux", "grad_norm", "lr", "ms"}``)."""
    hist: List[Dict[str, float]] = []
    for i in range(steps):
        state, _, row = _timed_step(step_fn, state, next(data))
        hist.append(row)
        if log_every and (i % log_every == 0 or i == steps - 1):
            log(f"step {i:4d}  loss {row['loss']:.4f}  |grad| {row['grad_norm']:.2e}  "
                f"lr {row['lr']:.2e}  {row['ms']:.1f} ms")
    return state, hist


def recorded(step_fn: Callable, hist: Dict[int, Dict[str, float]]) -> Callable:
    """``step_fn`` that files each step's row (:func:`_timed_step`) in
    ``hist`` under the optimizer step it reached, so a replayed step
    overwrites its first run's row."""

    def step(state, batch):
        state, m, row = _timed_step(step_fn, state, batch)
        hist[int(state["opt"]["step"])] = row
        return state, m

    return step


def default_ckpt_dir(cfg: ModelConfig) -> str:
    return os.path.join(tempfile.gettempdir(), f"repro_torch_ckpt_{cfg.name}")


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
    ap.add_argument("--ckpt-dir", default=None,
                    help="checkpoint directory (default: repro_torch_ckpt_<arch> under the "
                         "temporary directory)")
    ap.add_argument("--save-every", type=int, default=50)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", help="'cuda' (default) or 'cpu'")
    args = ap.parse_args(argv)

    model = build(args.arch, args.reduced, args.device, peft=args.peft)
    cfg = model.cfg
    _say(f"arch={cfg.name} peft={cfg.adapter.mode} device={model.device} dtype={cfg.dtype}")
    t0 = time.perf_counter()
    state = init_train_state(model, torch.Generator(device=model.device).manual_seed(args.seed))
    n_train = model.count_trainable({"groups": state["trainable"]["groups"]})
    _say(f"init {time.perf_counter() - t0:.1f}s; trainable params: {n_train}")

    rows: Dict[int, Dict[str, float]] = {}
    step_fn = recorded(make_step(model, args.lr, args.steps), rows)
    ckpt = CheckpointManager(args.ckpt_dir or default_ckpt_dir(cfg), keep=3)
    runner = TrainLoopRunner(
        step_fn, lambda start: batches(cfg, args.batch, args.seq, args.seed, model.device, start),
        ckpt, save_every=args.save_every, log_every=args.log_every or args.steps + 1,
        log_fn=lambda line: print(line, flush=True),
    )
    state, step, _ = runner.run(state, args.steps)
    hist = [rows[s] for s in sorted(rows)]
    if not hist:
        _say(f"done at step {step}: nothing left to run under {ckpt.root}")
        return state, hist
    s = summary(hist, args.batch * args.seq)
    _say(f"done at step {step}: {len(hist)} steps run; final loss {hist[-1]['loss']:.4f}; "
         f"median step {s['median_step_ms']:.1f} ms; {s['tokens_per_s']:.0f} train tokens/s; "
         f"restarts {runner.restarts}; stragglers observed: {len(runner.monitor.events)}")
    return state, hist


if __name__ == "__main__":
    main()
