"""End-to-end training driver on the PyTorch port (the twin of
``examples/train_lm.py``): trains a causal LM with QR-LoRA through the
port's production stack — data pipeline, partitioned train state, AdamW,
fault-tolerant runner with checkpoint/restart and straggler monitoring.

Default is a reduced config; pass ``--full --arch smollm-135m`` for the
real 135M configuration (same code).  The checkpoint directory defaults to
``repro_torch_train_lm`` under the temporary directory, not the
reference's: the runner restores whatever checkpoint it finds there, and a
run of the port never resumes one of the reference.

    PYTHONPATH=src python examples/train_lm_torch.py --steps 200
    PYTHONPATH=src python examples/train_lm_torch.py --device cpu --steps 20
"""
import argparse
import os
import tempfile

from repro_torch.launch.train import main as train_main

DEFAULT_CKPT_DIR = os.path.join(tempfile.gettempdir(), "repro_torch_train_lm")


def main(argv=None):
    """Returns the launcher's ``(state, history)``."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-135m")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--full", action="store_true")
    ap.add_argument("--peft", default="qr_lora")
    ap.add_argument("--ckpt-dir", default=DEFAULT_CKPT_DIR)
    ap.add_argument("--device", default="cuda", help="'cuda' (default) or 'cpu'")
    args = ap.parse_args(argv)

    argv = [
        "--arch", args.arch,
        "--steps", str(args.steps),
        "--peft", args.peft,
        "--ckpt-dir", args.ckpt_dir,
        "--batch", "8",
        "--seq", "64",
        "--device", args.device,
    ]
    if not args.full:
        argv.append("--reduced")
    return train_main(argv)


if __name__ == "__main__":
    main()
