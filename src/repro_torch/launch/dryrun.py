"""Multi-pod dry-run (port of ``repro/launch/dryrun.py``): every (arch ×
shape × mesh) cell traced on the meta device, with no card and nothing
allocated.

For each cell the reference's step is built on the meta device and run
once under :func:`repro_torch.launch.roofline.count_costs`:

  train_*           → make_train_step (PEFT partitioned state, AdamW)
  prefill_*         → make_prefill_step
  decode_* / long_* → make_decode_step

The reference lowers and compiles each cell under its production mesh and
reads XLA's memory and cost analyses.  Here there is no compiler: the
record's bytes are what the rule table places on one device (params, train
state, cache and batch), its roofline terms are the trace's global counts
split evenly over the mesh, and whatever only a compiler knows (temporary
and aliased buffers, the peak, collective bytes) is ``None``.  Each step runs
under the mesh's rule table, as the reference lowers it: a moe layer
counts the work of its sharded branch, each data shard's dispatch with C
over the shard's own rows.  A dense cell's global counts do not depend on
the mesh, so each (arch × shape) is traced once and split per mesh; a cell
with moe layers is traced once per mesh.

Usage:
  python -m repro_torch.launch.dryrun                       # all cells, 16×16
  python -m repro_torch.launch.dryrun --multi-pod           # all cells, 2×16×16
  python -m repro_torch.launch.dryrun --both-meshes --out reports/dryrun.json
  python -m repro_torch.launch.dryrun --arch qwen3-14b --shape train_4k
  python -m repro_torch.launch.dryrun --arch xlstm_125m,jamba_1_5_large_398b --shape decode_32k,long_500k
"""
from __future__ import annotations

import argparse
import functools
import json
import os
import time
import traceback

from repro_torch.configs import SHAPES, all_archs, get_config, shape_applicable
from repro_torch.launch import roofline as RL
from repro_torch.launch import specs as S
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models.model_zoo import build_model
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.sharding import rules as shrules
from repro_torch.training.steps import (
    init_train_state,
    make_decode_step,
    make_prefill_step,
    make_train_step,
)

PROBE = "meta-affine, even split"
# The moe layers trace the sharded branch's work: the dispatch of each data
# shard with C over the shard's rows (a decode shard's few rows hit C's floor
# of 8, so the count is the padded per-device work the mesh does)
PROBE_MOE = PROBE + "; moe: per-data-shard dispatch (C over the shard's rows, floor 8)"


def probe_name(cfg) -> str:
    return PROBE_MOE if cfg.is_moe else PROBE


def _trace_cell(cfg, shape, mesh):
    """``(flops, bytes accessed)`` of the cell's step, run once on meta
    tensors under ``mesh``'s rule table (the reference's ``axis_rules(mesh,
    fsdp=, dp_only=, replicate_batch=)`` of the cell): global counts of one
    program, the moe layers' dispatch split over the data shards."""
    model = build_model(cfg, "meta")
    batch = S.input_specs(cfg, shape)
    ws = cfg.decode_weight_stationary and shape.kind == "decode"
    with shrules.axis_rules(mesh, fsdp=cfg.fsdp, dp_only=cfg.dp_only, replicate_batch=ws):
        if shape.kind == "train":
            state = init_train_state(model, params=model.dryrun_params())
            return RL.count_costs(make_train_step(model, AdamWConfig()), state, batch)
        params = model.dryrun_params()
        cache = S.decode_cache_shapes(model, shape)
        step = make_prefill_step(model) if shape.kind == "prefill" else make_decode_step(model)
        return RL.count_costs(step, params, cache, batch)


def trace_mesh(cfg, mesh):
    """The mesh a cell is traced on: ``mesh`` for a config with moe layers,
    whose counts depend on the data shards, else the single-pod mesh, so a
    dense cell is traced once for every mesh."""
    return mesh if cfg.is_moe else make_production_mesh()


@functools.lru_cache(maxsize=None)
def _probe_costs(cfg, shape, mesh):
    """Counts over 1 and 2 layer groups, one microbatch, then the
    reference's affine extrapolation to G groups, ``c1 + (c2 - c1)·(G - 1)``
    → ``(flops, bytes accessed, seconds)``.  Exact where every group is
    adapted (the port's layer loop repeats one group's ops G times).  The
    shipped configs adapt only their last few layers, but the 1- and 2-group
    probes adapt every group they trace, so the adapters' flops and bytes are
    charged to all G groups, as the reference's probe charges them.
    Cached."""
    t0 = time.time()
    G = cfg.n_layers // cfg.group_size
    (f1, b1), (f2, b2) = (
        _trace_cell(cfg.replace(n_layers=g * cfg.group_size, microbatches=1), shape, mesh)
        for g in (1, 2))
    return f1 + (f2 - f1) * (G - 1), b1 + (b2 - b1) * (G - 1), time.time() - t0


def argument_bytes(cfg, shape, mesh) -> int:
    """What one device holds of the step's inputs under the rule table:
    train state and batch, or params, cache and batch."""
    model = build_model(cfg, "meta")
    batch = S.input_specs(cfg, shape)
    n = S.per_device_bytes(batch, S.batch_shardings(cfg, shape, mesh), mesh)
    if shape.kind == "train":
        state = S.train_state_shapes(model)
        sshard = S.train_state_shardings(state, mesh, fsdp=cfg.fsdp, dp_only=cfg.dp_only)
        return n + S.per_device_bytes(state, sshard, mesh)
    params = model.dryrun_params()
    pshard = S.params_shardings(params, mesh, fsdp=cfg.fsdp, dp_only=cfg.dp_only)
    cache = S.decode_cache_shapes(model, shape)
    cshard = S.decode_cache_shardings(cache, cfg, shape, mesh)
    return n + S.per_device_bytes(params, pshard, mesh) + S.per_device_bytes(cache, cshard, mesh)


def roofline_for(cfg, shape, mesh) -> RL.Roofline:
    flops, hbm, _ = _probe_costs(cfg, shape, trace_mesh(cfg, mesh))
    return RL.from_terms(flops / mesh.size, hbm / mesh.size, None,
                         model_flops=RL.model_flops_for(cfg, shape), chips=mesh.size)


def run_cell(arch: str, shape_name: str, multi_pod: bool, verbose: bool = True) -> dict:
    """The reference's record of one cell; keys whose meaning needs a
    compiler are None."""
    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    rec = {"arch": arch, "shape": shape_name, "mesh": "2x16x16" if multi_pod else "16x16"}
    if not shape_applicable(cfg, shape):
        rec["status"] = "SKIP(full-attn)"
        return rec
    mesh = make_production_mesh(multi_pod=multi_pod)
    try:
        rl = roofline_for(cfg, shape, mesh)
        rec["lower_s"] = round(_probe_costs(cfg, shape, trace_mesh(cfg, mesh))[2], 1)
        rec["compile_s"] = None
        rec["memory"] = {
            "argument_bytes": argument_bytes(cfg, shape, mesh),
            "output_bytes": None,
            "temp_bytes": None,
            "alias_bytes": None,
            "peak_per_device_gb": None,
        }
        rec["probe"] = probe_name(cfg)
        rec["roofline"] = {
            "flops_per_device": rl.flops,
            "hbm_bytes_per_device": rl.hbm_bytes,
            "coll_bytes_per_device": rl.coll_bytes,
            "coll_by_kind": rl.coll_by_kind,
            "compute_s": rl.compute_s,
            "memory_s": rl.memory_s,
            "collective_s": rl.collective_s,
            "bottleneck": rl.bottleneck,
            "model_flops": rl.model_flops,
            "useful_ratio": round(rl.useful_ratio, 4),
            "roofline_fraction": round(rl.roofline_fraction, 4),
        }
        rec["status"] = "OK"
        if verbose:
            print(
                f"  [OK] {arch} × {shape_name} ({rec['mesh']}): "
                f"args {rec['memory']['argument_bytes'] / 2**30:.3f} GiB/dev, "
                f"bottleneck={rl.bottleneck} "
                f"(c={rl.compute_s * 1e3:.2f}ms m={rl.memory_s * 1e3:.2f}ms) "
                f"roofline_frac={rl.roofline_fraction:.3f} [trace {rec['lower_s']}s]",
                flush=True,
            )
    except Exception as e:  # a failure here is a bug in the port
        rec["status"] = "FAIL"
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc()[-2000:]
        if verbose:
            print(f"  [FAIL] {arch} × {shape_name}: {rec['error']}", flush=True)
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None, help="arch ids, comma-separated (default: all)")
    ap.add_argument("--shape", default=None,
                    help=f"shapes of {list(SHAPES)}, comma-separated (default: all)")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--out", default=None, help="write JSON report here")
    args = ap.parse_args(argv)

    archs = args.arch.split(",") if args.arch else all_archs()
    shapes = args.shape.split(",") if args.shape else list(SHAPES)
    unknown = [s for s in shapes if s not in SHAPES]
    if unknown:
        ap.error(f"unknown shapes {unknown}: choose from {list(SHAPES)}")
    meshes = [False, True] if args.both_meshes else [args.multi_pod]

    records = []
    for mp in meshes:
        print(f"=== mesh {'2x16x16 (multi-pod)' if mp else '16x16 (single pod)'} ===",
              flush=True)
        for arch in archs:
            for shape in shapes:
                records.append(run_cell(arch, shape, mp))
    n_ok = sum(r["status"] == "OK" for r in records)
    n_skip = sum(r["status"].startswith("SKIP") for r in records)
    n_fail = sum(r["status"] == "FAIL" for r in records)
    print(f"\n== {n_ok} OK / {n_skip} SKIP / {n_fail} FAIL ==")
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(records, f, indent=1)
        print("report →", args.out)
    return 1 if n_fail else 0


if __name__ == "__main__":
    raise SystemExit(main())
