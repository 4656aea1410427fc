"""Render dry-run JSON reports as markdown roofline tables (port of
``repro/launch/report.py``).  A value the port's dry-run cannot give (the
peak per device, the collective term) is ``None`` and renders as ``—``.

  PYTHONPATH=src python -m repro_torch.launch.report reports/dryrun.json
"""
from __future__ import annotations

import json
import sys


def fmt_bytes(b: float) -> str:
    return f"{b/2**30:.2f}G" if b >= 2**28 else f"{b/2**20:.1f}M"


def _f(x, spec: str = "") -> str:
    return "—" if x is None else format(x, spec)


def render(path: str) -> str:
    with open(path) as f:
        recs = json.load(f)
    out = [
        "| arch | shape | mesh | status | peak GiB/dev | compute_s | memory_s "
        "| collective_s | bottleneck | useful | roofline_frac |",
        "|---|---|---|---|---|---|---|---|---|---|---|",
    ]
    for r in recs:
        if r["status"] != "OK":
            out.append(
                f"| {r['arch']} | {r['shape']} | {r['mesh']} | {r['status']} "
                f"| — | — | — | — | — | — | — |"
            )
            continue
        rl = r["roofline"]
        out.append(
            f"| {r['arch']} | {r['shape']} | {r['mesh']} | OK "
            f"| {_f(r['memory']['peak_per_device_gb'])} "
            f"| {_f(rl['compute_s'], '.3f')} | {_f(rl['memory_s'], '.3f')} "
            f"| {_f(rl['collective_s'], '.3f')} | {rl['bottleneck']} "
            f"| {_f(rl['useful_ratio'], '.3f')} | {_f(rl['roofline_fraction'], '.3f')} |"
        )
    return "\n".join(out)


if __name__ == "__main__":
    for p in sys.argv[1:]:
        print(f"### {p}\n")
        print(render(p))
        print()
