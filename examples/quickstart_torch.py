"""Quickstart on the PyTorch port: QR-LoRA in ~40 lines (the twin of
``examples/quickstart.py``: the same config, steps and printout).

Takes a (reduced) pretrained-style transformer, decomposes the chosen
attention projections with pivoted QR, and fine-tunes ONLY the λ
coefficients — the paper's method end to end.

    PYTHONPATH=src python examples/quickstart_torch.py                # on the card
    PYTHONPATH=src python examples/quickstart_torch.py --device cpu
"""
import argparse

import torch

from repro_torch.configs import get_reduced
from repro_torch.data import lm_batches
from repro_torch.models import build_model
from repro_torch.optim import AdamWConfig
from repro_torch.training import init_train_state, make_train_step


def main(argv=None):
    """Returns the trainable count and the 30 steps' losses."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", help="'cuda' (default) or 'cpu'")
    args = ap.parse_args(argv)

    # 1. A model config with a QR-LoRA adapter spec (paper: Wq/Wv, last 4
    #    layers, τ=0.5 energy rank selection).
    cfg = get_reduced("smollm-135m")
    print(f"arch={cfg.name}  adapter={cfg.adapter.mode} "
          f"targets={cfg.adapter.targets} layers={cfg.adapter.layers} "
          f"tau={cfg.adapter.tau}")

    # 2. init() builds the backbone AND runs the pivoted-QR decomposition of
    #    each adapted projection; only λ (+ nothing else) is trainable.
    model = build_model(cfg, args.device)
    state = init_train_state(model, torch.Generator(device=model.device).manual_seed(0))
    n = model.count_trainable({"groups": state["trainable"]["groups"]})
    total = cfg.param_count()
    print(f"trainable λ parameters: {n}  (backbone ~{total:,} — "
          f"{total / max(n,1):,.0f}× reduction)")

    # 3. Standard training loop — the frozen side never gets gradients.
    step = make_train_step(model, AdamWConfig(lr=3e-3))
    losses = []
    for i, b in zip(range(30), lm_batches(cfg.vocab_size, 8, 32, seed=0)):
        tokens = torch.from_numpy(b["tokens"][:, :32]).to(model.device)
        state, metrics = step(state, {"tokens": tokens})
        losses.append(float(metrics["loss"]))
        if i % 10 == 0:
            print(f"step {i:3d}  loss {losses[-1]:.4f}  "
                  f"|grad| {float(metrics['grad_norm']):.2e}")
    print("done — λ moved, backbone untouched.")
    return n, losses


if __name__ == "__main__":
    main()
