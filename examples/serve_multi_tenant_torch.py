"""Multi-tenant serving example on the PyTorch port (the twin of
``examples/serve_multi_tenant.py``): N adapters (distinct λ), one decode
batch.

Each tenant is a QR-LoRA λ checkpoint over the shared frozen base; the
engine batches them together with per-lane adapter-slot ids and verifies
every tenant against its merged-weight single-adapter deployment.

    PYTHONPATH=src python examples/serve_multi_tenant_torch.py --tenants 4
    PYTHONPATH=src python examples/serve_multi_tenant_torch.py --device cpu
"""
import argparse

from repro_torch.launch.serve_multi import main as serve_multi_main


def main(argv=None):
    """Returns the launcher's finished requests (it has verified them)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-135m")
    ap.add_argument("--tenants", type=int, default=4)
    ap.add_argument("--gen-len", type=int, default=12)
    ap.add_argument("--device", default="cuda", help="'cuda' (default) or 'cpu'")
    args = ap.parse_args(argv)
    return serve_multi_main([
        "--arch", args.arch, "--reduced",
        "--tenants", str(args.tenants),
        "--lanes", str(args.tenants),
        "--gen-len", str(args.gen_len),
        "--device", args.device,
    ])


if __name__ == "__main__":
    main()
