"""Paper Figure 1: trainable-parameter count vs downstream performance
(port of ``benchmarks/fig1_tradeoff.py``, same rows).

Emits the (params, metric) points for MNLI and MRPC across all methods —
the paper's 'QR-LoRA occupies the upper-left corner' scatter."""
from __future__ import annotations

from repro_torch.benchmarks.common import glue_rows, say

POINTS = [
    ("ft", dict()),
    ("lora", dict(rank=2)),
    ("svd_lora", dict(rank=2)),
    ("qr_lora", dict(tau=0.5, targets=("wq",), layers="last4")),
    ("qr_lora", dict(tau=0.5, targets=("wq", "wv"), layers="last4")),
    ("qr_lora", dict(tau=0.5, targets=("wo",), layers="all")),
]


def main(device):
    say("# Figure 1 — parameter/performance trade-off")
    for task in ("mnli", "mrpc"):
        for mode, kw in POINTS:
            tag = "+".join(kw.get("targets", ("all",)))
            glue_rows(f"fig1:{task}:{mode}:{tag}", task, mode, kw, device,
                      lambda r: f"params={r['trainable']};{r['metric_name']}={r['metric']:.4f}")
