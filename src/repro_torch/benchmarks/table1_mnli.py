"""Paper Table 1: MNLI — FT / LoRA / SVD-LoRA vs QR-LoRA τ- and layer-sweep
(port of ``benchmarks/table1_mnli.py``, same rows)."""
from __future__ import annotations

from repro_torch.benchmarks.common import glue_rows, say

CONFIGS = [
    ("ft", dict()),
    ("lora", dict(rank=2)),
    ("svd_lora", dict(rank=2)),
    ("qr_lora", dict(tau=0.5, targets=("wo",), layers="all")),
    ("qr_lora", dict(tau=0.7, targets=("wo",), layers="all")),
    ("qr_lora", dict(tau=0.8, targets=("wo",), layers="all")),
    ("qr_lora", dict(tau=0.5, targets=("wo",), layers="last4")),
    ("qr_lora", dict(tau=0.5, targets=("wq", "wv"), layers="last4")),
]


def main(device):
    say("# Table 1 — MNLI config sweep (metric: accuracy)")
    for mode, kw in CONFIGS:
        tag = f"tau={kw.get('tau','-')}:{'+'.join(kw.get('targets', ('all',)))}:{kw.get('layers','-')}"
        glue_rows(f"table1_mnli:{mode}:{tag}", "mnli", mode, kw, device,
                  lambda r: f"acc={r['metric']:.4f};trainable={r['trainable']}")
