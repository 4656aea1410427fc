"""Serving observability: metrics, request-span tracing, exposition (the
port's own copy of ``repro/obs``: plain Python, the same names, snapshot
schema and Prometheus text).

The multi-tenant engine serves heterogeneous adapter traffic through one
decode loop — scheduling, paging, tiering, and sharing decisions all hide
inside a single ``step()``.  This package makes that loop legible:

* :mod:`repro_torch.obs.metrics` — :class:`MetricsRegistry` with counters,
  gauges, and fixed-bucket histograms.  Pure Python, lock-free (the engine
  loop is single-threaded), no-op stubs when disabled so the decode hot
  path pays ~zero.
* :mod:`repro_torch.obs.tracing` — per-request :class:`RequestTrace` milestone
  logs and a Chrome/Perfetto ``trace_event`` :class:`Tracer`: an engine run
  exports as a lane timeline (prefill/decode/preemption spans per lane,
  queue-wait spans per request).
* :mod:`repro_torch.obs.telemetry` — the :class:`Telemetry` facade the engine
  carries: the serving metric catalog (TTFT/TBT/E2E, step phases,
  preemption/deferral causes, cache hit rates, tier occupancy) plus the
  lifecycle hooks that feed both metrics and traces from one call site.
* :mod:`repro_torch.obs.exposition` — Prometheus-text and JSON renderers over
  plain snapshot dicts (``engine.metrics()``, ``serve_multi
  --metrics-out``, CI artifacts).

The catalog itself is documented in README.md § Observability.  The port's
engine compiles nothing: its ``serve_jit_compiles_*`` callbacks count the
distinct shapes each path was dispatched at, which is what the reference
compiles for the same traffic.
"""
from repro_torch.obs.exposition import to_prometheus, write_metrics
from repro_torch.obs.metrics import (
    DEFAULT_MS_BUCKETS,
    NULL,
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
)
from repro_torch.obs.telemetry import Telemetry
from repro_torch.obs.tracing import PID_ENGINE, PID_QUEUE, RequestTrace, Tracer

__all__ = [
    "Counter",
    "DEFAULT_MS_BUCKETS",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "NULL",
    "PID_ENGINE",
    "PID_QUEUE",
    "RequestTrace",
    "Telemetry",
    "Tracer",
    "to_prometheus",
    "write_metrics",
]
