"""Paper Table 4: training-set-size ablation on MNLI (LoRA / QR-LoRA / FT;
port of ``benchmarks/table4_ablation.py``, same rows).

Reproduces the paper's regime finding: FT wins in the low-data regime;
QR-LoRA catches up / overtakes as data grows."""
from __future__ import annotations

from repro_torch.benchmarks.common import glue_rows, say, scale

METHODS = [
    ("lora", dict(rank=2)),
    ("qr_lora", dict(tau=0.5, targets=("wq", "wv"), layers="last4")),
    ("ft", dict()),
]


def main(device):
    say("# Table 4 — MNLI data-size ablation")
    sizes = [2000, 10000, 50000] if scale() == "paper" else [128, 512, 2048]
    for size in sizes:
        for mode, kw in METHODS:
            glue_rows(f"table4_ablation:{mode}:n={size}", "mnli", mode,
                      dict(kw, train_limit=size), device,
                      lambda r: f"acc={r['metric']:.4f};trainable={r['trainable']}")
