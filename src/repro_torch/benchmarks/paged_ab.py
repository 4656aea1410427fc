"""Time the paged decode-attention kernel of two source trees in turns, on
one card.

    python src/repro_torch/benchmarks/paged_ab.py --trees OLD/src NEW/src

Each tree's ``repro_torch`` is imported in a process of its own (its
kernels built into that tree), in the order old, new, new, old; each
process times, by CUDA-graph replay (``common.graph_ms``, warm L2), the
paged kernel at the serving shape (lanes of 64/48/33/17 positions through a
4-column slice of 16-position blocks) and at a long one (4 lanes of length
1000 through a 64-column table), the dense decode kernel at the same length
over a (4, 2048) cache, the eager call, and the device µs of one launch
under ``torch.profiler``; bf16, 9 heads over 3, dh 64.  Prints one JSON
line a process and, last, the mean of each tree's two readings with the
card's name and power limit.  Uses only what both trees have:
``paged_decode_attention_cuda``, ``decode_attention_cuda`` and the timers
of ``repro_torch.benchmarks.common``.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

SERVE = (64, 48, 33, 17)
LONG = 1000


def _inputs(gen, lengths, max_blocks, H=9, KV=3, dh=64, bs=16):
    import torch

    B, dev = len(lengths), gen.device
    n_blocks = 1 + B * max_blocks
    q = torch.randn((B, H, dh), generator=gen, device=dev).bfloat16()
    kp, vp = (torch.randn((n_blocks, bs, KV, dh), generator=gen, device=dev).bfloat16()
              for _ in range(2))
    tbl = (torch.randperm(n_blocks - 1, generator=gen, device=dev) + 1).to(torch.int32)
    tbl = tbl.reshape(B, max_blocks)
    lens = torch.tensor(lengths, dtype=torch.int32, device=dev)
    return q, kp, vp, tbl, lens


def measure() -> dict:
    """The readings of the ``repro_torch`` on ``sys.path``."""
    import torch
    from repro_torch.benchmarks.common import eager_ms, graph_ms, launch_us
    from repro_torch.kernels.decode_attention import decode_attention_cuda
    from repro_torch.kernels.paged_attention import paged_decode_attention_cuda

    gen = torch.Generator(device="cuda").manual_seed(0)
    q, kp, vp, tbl, lens = _inputs(gen, SERVE, 8)
    tbl = tbl[:, :4]  # the engine's attend bound: a column slice of the table
    serve = lambda: paged_decode_attention_cuda(q, kp, vp, tbl, lens)
    ql, kl, vl, tl, ll = _inputs(gen, (LONG,) * 4, 64)
    long = lambda: paged_decode_attention_cuda(ql, kl, vl, tl, ll)
    qd = torch.randn((4, 9, 64), generator=gen, device="cuda").bfloat16()
    kc, vc = (torch.randn((4, 2048, 3, 64), generator=gen, device="cuda").bfloat16()
              for _ in range(2))
    length = torch.tensor(LONG, dtype=torch.int32, device="cuda")
    dense = lambda: decode_attention_cuda(qd, kc, vc, length)
    return {"serve_ms": graph_ms(serve), "long_ms": graph_ms(long), "dense_ms": graph_ms(dense),
            "serve_eager_ms": eager_ms(serve), "serve_launch_us": launch_us(serve),
            "long_launch_us": launch_us(long)}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--trees", nargs=2, metavar=("OLD_SRC", "NEW_SRC"))
    ap.add_argument("--src", help=argparse.SUPPRESS)  # one process: the tree to time
    args = ap.parse_args(argv)
    if args.src:
        here = Path(__file__).resolve().parent  # not its siblings: import the tree's package
        sys.path[:] = [args.src] + [p for p in sys.path if Path(p or ".").resolve() != here]
        print(json.dumps(measure()), flush=True)
        return
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    old, new = args.trees
    runs = {old: [], new: []}
    for src in (old, new, new, old):
        out = subprocess.run([sys.executable, __file__, "--src", src], capture_output=True,
                             text=True, check=True).stdout.strip().splitlines()[-1]
        print(f"{src}: {out}", flush=True)
        runs[src].append(json.loads(out))
    mean = {src: {k: sum(r[k] for r in rs) / len(rs) for k in rs[0] if k.endswith("_ms")}
            for src, rs in runs.items()}
    print(json.dumps({"card": smi, "mean": mean}))


if __name__ == "__main__":
    main()
