"""Hillclimb driver (port of ``repro/launch/hillclimb.py``): one (arch ×
shape) cell with config overrides, traced on the meta device, and its
roofline terms — the measure step of the hypothesis → change → measure →
validate loop.

  python -m repro_torch.launch.hillclimb --arch qwen2_0_5b --shape train_4k \\
      --set dp_only=True --set microbatches=2

The record keeps the reference's keys; those that need a compiler (the
peak, temporary bytes, collectives) are None, as in the dry-run's records.
"""
from __future__ import annotations

import argparse
import json

from repro_torch.configs import SHAPES, get_config
from repro_torch.launch.dryrun import argument_bytes, probe_name, roofline_for
from repro_torch.launch.mesh import make_production_mesh


def parse_val(v: str):
    if v in ("True", "False"):
        return v == "True"
    try:
        return int(v)
    except ValueError:
        try:
            return float(v)
        except ValueError:
            return v


def run(arch: str, shape_name: str, overrides: dict, multi_pod: bool = False) -> dict:
    if "scan_layers" in overrides:
        raise ValueError(
            "scan_layers only says how JAX lowers the layer loop; the port's layer loop "
            "is Python, and the dry-run's probe traces 1 and 2 layer groups whatever it says")
    cfg = get_config(arch, **overrides)
    shape = SHAPES[shape_name]
    mesh = make_production_mesh(multi_pod=multi_pod)
    rl = roofline_for(cfg, shape, mesh)
    rec = {
        "arch": arch, "shape": shape_name, "overrides": overrides,
        "peak_gb": None,
        "compute_s": round(rl.compute_s, 4), "memory_s": round(rl.memory_s, 4),
        "collective_s": None,
        "bottleneck": rl.bottleneck, "useful": round(rl.useful_ratio, 4),
        "roofline_frac": round(rl.roofline_fraction, 4),
        "coll_by_kind": None,
        "probe": probe_name(cfg),
        "temp_gb": None,
        "arg_gb": round(argument_bytes(cfg, shape, mesh) / 2**30, 2),
    }
    print(json.dumps(rec, indent=1))
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True, choices=list(SHAPES))
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--set", action="append", default=[], metavar="K=V")
    args = ap.parse_args(argv)
    overrides = {}
    for kv in args.set:
        k, v = kv.split("=", 1)
        overrides[k] = parse_val(v)
    run(args.arch, args.shape, overrides, args.multi_pod)


if __name__ == "__main__":
    main()
