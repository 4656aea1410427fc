"""Training entry point of the port on the synthetic LM stream, in any PEFT
mode: QR-LoRA (the default: frozen backbone, pivoted-QR factors, only λ
trains), LoRA, SVD-LoRA (B and A train) or full fine-tuning (``--peft``).

    PYTHONPATH=src python -m repro_torch.launch.train --reduced --device cpu
    PYTHONPATH=src python -m repro_torch.launch.train --reduced --device cpu --peft lora
    PYTHONPATH=src python -m repro_torch.launch.train --steps 30 --batch 8 --seq 256
    PYTHONPATH=src python -m repro_torch.launch.train --reduced --device cpu --arch musicgen-medium
    PYTHONPATH=src python -m repro_torch.launch.train --reduced --device cpu --arch moonshot-v1-16b-a3b
    PYTHONPATH=src python -m repro_torch.launch.train --reduced --device cpu --arch llama-3.2-vision-11b

The third form trains full-width smollm-135m on the card (random weights
from ``--seed``), where every adapted projection's forward runs the one-λ
kernel.  ``--arch musicgen-medium`` trains the audio family on frame
embeddings with code targets; a moe arch (``moonshot-v1-16b-a3b``,
``mixtral-8x22b``) adds its experts' load-balancing aux to the loss;
``--arch llama-3.2-vision-11b`` trains the vlm family on token batches
beside stub patch embeddings.  It prints the trainable count, the loss every ``--log-every``
steps, the median step time and the train tokens/s.  The reference
launcher's checkpointing and fault tolerance (``--ckpt-dir``) are not
ported yet and raise here (ROADMAP Queue 1 item 15).
"""
from __future__ import annotations

import argparse
import statistics
import sys
import time
from typing import Callable, Dict, Iterator, List, Optional

import numpy as np
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
            device) -> Iterator[Dict[str, torch.Tensor]]:
    """The synthetic LM stream's token batches; for the audio family the
    tokens are the code targets and the frames beside them are normal draws
    (scale 0.1) from ``seed``, the stub EnCodec frontend's stand-in; for the
    vlm family each row gets its own image, standard normal patch embeddings
    (n_image_tokens × d_image) from ``seed``, the stub vision frontend's."""
    rng = np.random.default_rng(seed)
    for b in lm_batches(cfg.vocab_size, batch, seq, seed=seed):
        tokens = torch.from_numpy(b["tokens"][:, :seq]).to(device)
        if cfg.family == "vlm":
            img = rng.standard_normal((batch, cfg.n_image_tokens, cfg.d_image), np.float32)
            yield {"tokens": tokens, "image_embeds": torch.from_numpy(img).to(device)}
            continue
        if cfg.family != "audio":
            yield {"tokens": tokens}
            continue
        frames = rng.standard_normal((batch, seq, cfg.d_model), np.float32) * 0.1
        yield {"embeds": torch.from_numpy(frames).to(device), "targets": tokens}


def train(step_fn: Callable, state, data: Iterator, steps: int, log_every: int = 0,
          log: Callable[[str], None] = _say):
    """Run ``steps`` steps; returns (state, history of per-step
    ``{"loss", "ce", "aux", "grad_norm", "lr", "ms"}``).  A step's time ends when
    its loss reaches the host, so it covers all of the step's device work."""
    hist: List[Dict[str, float]] = []
    for i in range(steps):
        batch = next(data)
        t0 = time.perf_counter()
        state, m = step_fn(state, batch)
        loss = float(m["loss"])
        ms = (time.perf_counter() - t0) * 1e3
        hist.append({"loss": loss, "ce": float(m["ce"]), "aux": float(m["aux"]),
                     "grad_norm": float(m["grad_norm"]), "lr": float(m["lr"]), "ms": ms})
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
    if args.ckpt_dir is not None:
        raise NotImplementedError(
            "--ckpt-dir: checkpointing and fault tolerance come with ROADMAP Queue 1 item 15"
        )

    model = build(args.arch, args.reduced, args.device, peft=args.peft)
    cfg = model.cfg
    _say(f"arch={cfg.name} peft={cfg.adapter.mode} device={model.device} dtype={cfg.dtype}")
    t0 = time.perf_counter()
    state = init_train_state(model, torch.Generator(device=model.device).manual_seed(args.seed))
    n_train = model.count_trainable({"groups": state["trainable"]["groups"]})
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
