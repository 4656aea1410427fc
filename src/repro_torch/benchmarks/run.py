"""Benchmark entry point of the port (port of ``benchmarks/run.py``): one
module per paper table/figure plus the kernel and train-throughput benches.
Prints ``name,us_per_call,derived`` CSV rows, as the reference does.

  PYTHONPATH=src python -m repro_torch.benchmarks.run --only kernel
  PYTHONPATH=src python -m repro_torch.benchmarks.run --only table2_mrpc
  PYTHONPATH=src python -m repro_torch.benchmarks.run --only multi_replica --device cpu
  PYTHONPATH=src python -m repro_torch.benchmarks.run --only serve_multitenant --device cpu
  REPRO_BENCH_SCALE=smoke PYTHONPATH=src python -m repro_torch.benchmarks.run \
      --only table3_glue --device cpu

``REPRO_BENCH_SCALE`` (smoke, tiny, paper) sizes the GLUE runs as in the
reference (:func:`common.kw`), the multi-replica bench and the serving
bench.  It runs on the card unless ``--device cpu`` (a missing card
raises).  Naming a sub-bench of the reference's serving bench that the
port does not run yet (:data:`NOT_PORTED`) raises and names the ROADMAP
item that ports it.  Unlike the reference, it exits
non-zero when a row's kernel error is over its stated tolerance, as well as
when a bench fails.  On a card, float32 matrix products stay in full
float32 (TF32 off) so the plain versions are exact references.
"""
from __future__ import annotations

import argparse
import sys
import time
import traceback

import torch

from repro_torch.benchmarks import common
from repro_torch.device import resolve_device

MODULES = [
    ("table1_mnli", "repro_torch.benchmarks.table1_mnli"),
    ("table2_mrpc", "repro_torch.benchmarks.table2_mrpc"),
    ("table3_glue", "repro_torch.benchmarks.table3_glue"),
    ("table4_ablation", "repro_torch.benchmarks.table4_ablation"),
    ("fig1_tradeoff", "repro_torch.benchmarks.fig1_tradeoff"),
    ("kernel", "repro_torch.benchmarks.kernel_bench"),
    ("train_throughput", "repro_torch.benchmarks.train_throughput"),
    ("multi_replica", "repro_torch.benchmarks.multi_replica"),
    ("serve_multitenant", "repro_torch.benchmarks.serve_multitenant"),
]

#: sub-benches of the reference's serving bench that the port does not run
#: yet, and what each needs (none left)
NOT_PORTED: dict = {}


def main(argv=None) -> dict:
    """Run the selected benches; returns name → error record of every row
    that compared a kernel with its plain version (see
    :func:`common.errors`).  Exits 1 when a bench failed or a row is over its
    tolerance."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--only", default=None, help="comma-separated bench names")
    ap.add_argument("--json-out", default=None,
                    help="write {name: us_per_call} JSON on top of the CSV rows; written even "
                    "when a benchmark fails")
    ap.add_argument("--device", default="cuda", help="cuda (default; raises without a card) "
                    "or cpu")
    args = ap.parse_args(argv)
    ported = dict(MODULES)
    sel = args.only.split(",") if args.only else list(ported)
    for name in sel:
        if name in NOT_PORTED:
            raise NotImplementedError(
                f"bench {name!r} is not ported yet: it needs {NOT_PORTED[name]}")
        if name not in ported:
            raise ValueError(f"unknown bench {name!r}; ported: {sorted(ported)}")
    device = resolve_device(args.device)
    if device.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        where = torch.cuda.get_device_name(device)
    else:
        where = "cpu"

    common.reset()
    common.say(f"# device: {where}")
    common.say("name,us_per_call,derived")
    failures = []
    for name, mod in MODULES:
        if name not in sel:
            continue
        t0 = time.time()
        try:
            __import__(mod, fromlist=["main"]).main(device)
            common.say(f"# {name} done in {time.time()-t0:.1f}s")
        except Exception:
            failures.append(name)
            common.say(f"# {name} FAILED:\n{traceback.format_exc()[-1500:]}")
    if args.json_out:
        common.write_json(args.json_out, where)
        common.say(f"# wrote {args.json_out}")
    errors = common.errors()
    over = sorted(n for n, e in errors.items() if not e["ok"])
    if over:
        common.say(f"# OVER TOLERANCE: {over}")
    if failures:
        common.say(f"# FAILURES: {failures}")
    if failures or over:
        sys.exit(1)
    common.say("# all benchmarks complete")
    return errors


if __name__ == "__main__":
    main()
