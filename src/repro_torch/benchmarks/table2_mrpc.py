"""Paper Table 2: MRPC — accuracy + F1 across the same configuration grid
(port of ``benchmarks/table2_mrpc.py``, same rows)."""
from __future__ import annotations

from repro_torch.benchmarks.common import glue_rows, say

CONFIGS = [
    ("ft", dict()),
    ("lora", dict(rank=2)),
    ("svd_lora", dict(rank=2)),
    ("qr_lora", dict(tau=0.5, targets=("wo",), layers="all")),
    ("qr_lora", dict(tau=0.7, targets=("wo",), layers="all")),
    ("qr_lora", dict(tau=0.5, targets=("wo",), layers="last4")),
    ("qr_lora", dict(tau=0.5, targets=("wq", "wv"), layers="last4")),
]


def main(device):
    say("# Table 2 — MRPC config sweep (metric: F1)")
    for mode, kw in CONFIGS:
        tag = f"tau={kw.get('tau','-')}:{'+'.join(kw.get('targets', ('all',)))}:{kw.get('layers','-')}"
        glue_rows(f"table2_mrpc:{mode}:{tag}", "mrpc", mode, kw, device,
                  lambda r: f"f1={r['metric']:.4f};acc={r['accuracy']:.4f};"
                            f"trainable={r['trainable']}")
