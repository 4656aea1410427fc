"""Batched serving example on the PyTorch port (the twin of
``examples/serve_lm.py``): prefill + decode loop through the port's
serving launcher, whose step functions the dry-run traces at the
decode_32k / long_500k shapes.

    PYTHONPATH=src python examples/serve_lm_torch.py --arch smollm-135m
    PYTHONPATH=src python examples/serve_lm_torch.py --device cpu
"""
import argparse

from repro_torch.launch.serve import main as serve_main


def main(argv=None):
    """Returns the generated tokens (batch, gen_len)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-135m")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--gen-len", type=int, default=24)
    ap.add_argument("--device", default="cuda", help="'cuda' (default) or 'cpu'")
    args = ap.parse_args(argv)
    return serve_main([
        "--arch", args.arch, "--reduced",
        "--batch", str(args.batch),
        "--prompt-len", "16",
        "--gen-len", str(args.gen_len),
        "--device", args.device,
    ])


if __name__ == "__main__":
    main()
