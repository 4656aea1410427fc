"""LR schedules (functions of the int step) — the port's copy of
``repro/optim/schedules.py``, computed in float32 as the reference does."""
from __future__ import annotations

import numpy as np


def make_schedule(
    kind: str = "cosine",
    base_lr: float = 1e-3,
    warmup_steps: int = 100,
    total_steps: int = 10_000,
    min_ratio: float = 0.1,
):
    f32 = np.float32

    def fn(step: int) -> float:
        s = f32(step)
        warm = s / f32(max(1.0, warmup_steps))
        if kind == "constant":
            decay = f32(1.0)
        elif kind == "linear":
            decay = f32(1.0) - f32(1.0 - min_ratio) * np.clip(
                (s - f32(warmup_steps)) / f32(max(1, total_steps - warmup_steps)), f32(0), f32(1)
            )
        else:  # cosine
            t = np.clip((s - f32(warmup_steps)) / f32(max(1, total_steps - warmup_steps)),
                        f32(0), f32(1))
            decay = f32(min_ratio) + f32(1.0 - min_ratio) * f32(0.5) * (f32(1) + np.cos(f32(np.pi) * t))
        return float(f32(base_lr) * np.minimum(f32(1), warm) * decay)

    return fn
