"""Paper Table 3: method comparison across all 8 GLUE-like tasks (port of
``benchmarks/table3_glue.py``, same rows).

QR-LoRA1 = (Wq,Wv, last4, τ=0.5); QR-LoRA2 = (Wq, last4, τ=0.5);
vs SVD-LoRA (r=2,k=1,α=2), LoRA (r=2), FT."""
from __future__ import annotations

from repro_torch.benchmarks.common import glue_rows, say
from repro_torch.data import GLUE_TASKS

METHODS = [
    ("qr_lora1", "qr_lora", dict(tau=0.5, targets=("wq", "wv"), layers="last4")),
    ("qr_lora2", "qr_lora", dict(tau=0.5, targets=("wq",), layers="last4")),
    ("svd_lora", "svd_lora", dict(rank=2)),
    ("lora", "lora", dict(rank=2)),
    ("ft", "ft", dict()),
]


def main(device):
    say("# Table 3 — 8-task GLUE comparison")
    for disp, mode, kw in METHODS:
        for task in GLUE_TASKS:
            glue_rows(f"table3_glue:{disp}:{task}", task, mode, kw, device,
                      lambda r: f"{r['metric_name']}={r['metric']:.4f};trainable={r['trainable']}")
