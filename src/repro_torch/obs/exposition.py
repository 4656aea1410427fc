"""Metrics exposition: Prometheus text format + JSON snapshot files.

Everything here renders the plain dict produced by
:meth:`repro_torch.obs.metrics.MetricsRegistry.snapshot` — no live registry
access, so a snapshot can be shipped across a process boundary (CI
artifact, benchmark sidecar) and rendered later.

``to_prometheus`` emits the text exposition format (version 0.0.4):
``# HELP``/``# TYPE`` headers, ``name{label="v"} value`` samples, and for
histograms the conventional cumulative ``_bucket{le=...}`` / ``_sum`` /
``_count`` triplet.  ``write_metrics`` picks the format from the file
extension: ``.prom``/``.txt`` → Prometheus text, anything else → JSON.
"""
from __future__ import annotations

import json
import os
from typing import Any, Dict, List


def _fmt_value(v: float) -> str:
    f = float(v)
    return str(int(f)) if f == int(f) else repr(f)


def _escape(v: str) -> str:
    """Label-value escaping per the text format: backslash, quote, newline."""
    return v.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


def _fmt_labels(labels: Dict[str, str]) -> str:
    if not labels:
        return ""
    inner = ",".join(
        f'{k}="{_escape(str(v))}"' for k, v in sorted(labels.items())
    )
    return "{" + inner + "}"


def to_prometheus(snapshot: Dict[str, Any]) -> str:
    """Render a registry snapshot to the Prometheus text format."""
    lines: List[str] = []
    for name, fam in snapshot.items():
        kind = fam.get("type", "gauge")
        if fam.get("help"):
            lines.append(f"# HELP {name} {fam['help']}")
        lines.append(f"# TYPE {name} {kind}")
        for series in fam.get("series", []):
            labels = dict(series.get("labels", {}))
            if kind == "histogram":
                for le, cum in series["buckets"]:
                    le_s = "+Inf" if le == "+Inf" else _fmt_value(le)
                    lines.append(
                        f"{name}_bucket{_fmt_labels({**labels, 'le': le_s})} {cum}"
                    )
                lines.append(f"{name}_sum{_fmt_labels(labels)} {_fmt_value(series['sum'])}")
                lines.append(f"{name}_count{_fmt_labels(labels)} {series['count']}")
            else:
                lines.append(f"{name}{_fmt_labels(labels)} {_fmt_value(series['value'])}")
    return "\n".join(lines) + ("\n" if lines else "")


def write_metrics(path: str, snapshot: Dict[str, Any]) -> None:
    """Write a snapshot to ``path``: Prometheus text for ``.prom``/``.txt``,
    pretty JSON otherwise (creating parent directories)."""
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    if path.endswith((".prom", ".txt")):
        body = to_prometheus(snapshot)
    else:
        body = json.dumps(snapshot, indent=2, sort_keys=True) + "\n"
    with open(path, "w") as f:
        f.write(body)
