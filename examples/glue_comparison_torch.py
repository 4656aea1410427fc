"""The paper's Table-3 comparison on the PyTorch port (the twin of
``examples/glue_comparison.py``: the same methods, flags and table):

QR-LoRA (two configs) vs LoRA vs SVD-LoRA vs full fine-tuning on synthetic
GLUE-format tasks, with trainable-parameter counts.

    PYTHONPATH=src python examples/glue_comparison_torch.py [--tasks sst2,mrpc]
    PYTHONPATH=src python examples/glue_comparison_torch.py --device cpu
"""
import argparse

from repro_torch.benchlib import run_glue_method


def main(argv=None):
    """Returns ``(method, task, metric, trainable)`` per row of the table."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--tasks", default="sst2,mrpc")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--device", default="cuda", help="'cuda' (default) or 'cpu'")
    args = ap.parse_args(argv)

    methods = [
        ("QR-LoRA1 (Wq,Wv last4 τ=.5)", "qr_lora", dict(targets=("wq", "wv"), layers="last4", tau=0.5)),
        ("QR-LoRA2 (Wq last4 τ=.5)", "qr_lora", dict(targets=("wq",), layers="last4", tau=0.5)),
        ("LoRA r=2", "lora", dict(rank=2)),
        ("SVD-LoRA r=2 k=1", "svd_lora", dict(rank=2)),
        ("Fine-tune", "ft", dict()),
    ]
    print(f"{'method':32s} {'task':6s} {'metric':>8s} {'params':>9s}")
    rows = []
    for task in args.tasks.split(","):
        for name, mode, kw in methods:
            r = run_glue_method(
                task, mode, seed=0, train_steps=args.steps, warmup_steps=30,
                eval_batches=6, batch=16, seq=32, device=args.device, **kw,
            )
            print(f"{name:32s} {task:6s} {r['metric']:8.4f} {r['trainable']:9d}")
            rows.append((name, task, r["metric"], r["trainable"]))
    return rows


if __name__ == "__main__":
    main()
