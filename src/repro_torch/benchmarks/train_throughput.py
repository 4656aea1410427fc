"""Training-step throughput: QR-LoRA vs LoRA vs FT on the reduced smollm
config (port of ``benchmarks/train_throughput.py``, same rows) — the
adapter overhead is visible as the step-time delta (the PEFT modes also
skip base-weight optimizer state and updates).  On the card each timed
step is synchronised; the adapted projections run the one-λ kernel."""
from __future__ import annotations

import torch

from repro_torch.benchmarks.common import emit, say, timed
from repro_torch.configs import get_reduced
from repro_torch.core.adapter_api import count_params
from repro_torch.data import lm_batches
from repro_torch.models import build_model
from repro_torch.optim import AdamWConfig
from repro_torch.training import init_train_state, make_train_step


def main(device):
    say(f"# Train-step throughput (reduced smollm, {device})")
    base = get_reduced("smollm_135m")
    tokens = torch.from_numpy(next(lm_batches(base.vocab_size, 8, 64))["tokens"][:, :64])
    batch = {"tokens": tokens.to(device)}
    for mode in ("qr_lora", "lora", "ft"):
        m = build_model(base.replace(adapter=base.adapter.replace(mode=mode)), device)
        state = init_train_state(m, torch.Generator(device=m.device).manual_seed(0))
        step = make_train_step(m, AdamWConfig())
        state, _ = step(state, batch)
        _, us = timed(lambda: step(state, batch), n=5, device=device)
        emit(f"train_throughput:{mode}", us,
             f"tok_per_s={tokens.numel() / (us / 1e6):.0f};"
             f"trainable_leaves={count_params(state['trainable'])}")
