"""Pure-Python metrics primitives for the serving telemetry layer.

Three instrument kinds, Prometheus-shaped so exposition is mechanical:

* :class:`Counter`   — monotonically increasing total (``inc``).
* :class:`Gauge`     — instantaneous level (``set``/``inc``/``dec``).
* :class:`Histogram` — fixed-bucket latency distribution (``observe``);
  buckets are chosen at construction and never rebalance, so an observe is
  one ``bisect`` + two adds.

Instruments are created through a :class:`MetricsRegistry`.  Declaring a
metric with ``labels=(...)`` returns a *family*: call ``.labels(cause=...)``
to get (and memoize) the child instrument for one label combination.
Unlabeled metrics return the bare instrument directly.

The engine's decode loop is single-threaded and host-driven, so none of
this takes locks — an ``inc`` is a float add on a ``__slots__`` object.
When the registry is constructed with ``enabled=False`` every factory
returns the shared :data:`NULL` instrument whose methods are no-ops and
whose ``labels()`` returns itself, so instrumented code needs no branches
and the disabled hot path pays one no-op call per event.

``registry.callback(name, fn)`` registers a *sampled* metric: ``fn`` is
evaluated only when a snapshot is taken, which is how occupancy gauges
(block-pool fill, λ-tier residency, queue depth) and the jit
compile-counter hooks are exposed without touching the hot path at all.

``registry.snapshot()`` returns a plain JSON-able dict (histogram buckets
cumulative, Prometheus-style); ``repro_torch.obs.exposition`` renders it to
Prometheus text.
"""
from __future__ import annotations

from bisect import bisect_left
from collections import OrderedDict
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

# Latency buckets in milliseconds: sub-100µs host bookkeeping through the
# multi-second decode steps of interpreted smoke runs.
DEFAULT_MS_BUCKETS: Tuple[float, ...] = (
    0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 25.0, 50.0, 100.0,
    250.0, 500.0, 1000.0, 2500.0, 5000.0, 10000.0, 30000.0,
)


class Counter:
    """Monotonic total."""

    kind = "counter"
    __slots__ = ("value",)

    def __init__(self):
        self.value = 0.0

    def inc(self, n: float = 1.0) -> None:
        if n < 0:
            raise ValueError(f"counter increments must be >= 0, got {n}")
        self.value += n


class Gauge:
    """Instantaneous level."""

    kind = "gauge"
    __slots__ = ("value",)

    def __init__(self):
        self.value = 0.0

    def set(self, v: float) -> None:
        self.value = float(v)

    def inc(self, n: float = 1.0) -> None:
        self.value += n

    def dec(self, n: float = 1.0) -> None:
        self.value -= n


class Histogram:
    """Fixed-bucket distribution; bucket edges are upper bounds (``le``),
    with an implicit +Inf tail, Prometheus-style."""

    kind = "histogram"
    __slots__ = ("buckets", "counts", "sum", "count")

    def __init__(self, buckets: Sequence[float] = DEFAULT_MS_BUCKETS):
        edges = tuple(sorted(float(b) for b in buckets))
        if not edges:
            raise ValueError("histogram needs at least one bucket edge")
        self.buckets = edges
        self.counts = [0] * (len(edges) + 1)  # last = +Inf overflow
        self.sum = 0.0
        self.count = 0

    def observe(self, v: float) -> None:
        v = float(v)
        self.counts[bisect_left(self.buckets, v)] += 1
        self.sum += v
        self.count += 1

    @property
    def mean(self) -> float:
        return self.sum / self.count if self.count else 0.0

    def quantile(self, q: float) -> float:
        """Bucket-resolution quantile estimate: the upper edge of the
        bucket holding the q-th observation (inf when it landed in the
        overflow tail, 0.0 on an empty histogram)."""
        if not 0.0 <= q <= 1.0:
            raise ValueError(f"quantile {q} outside [0, 1]")
        if not self.count:
            return 0.0
        rank = q * self.count
        cum = 0
        for edge, n in zip(self.buckets, self.counts):
            cum += n
            if cum >= rank:
                return edge
        return float("inf")


class _Null:
    """Shared no-op instrument: accepts every instrument method, reports
    zeros.  Returned by a disabled registry so instrumented code runs
    unconditionally at ~zero cost."""

    kind = "null"
    value = 0.0
    sum = 0.0
    count = 0
    mean = 0.0

    def labels(self, **kv) -> "_Null":
        return self

    def inc(self, n: float = 1.0) -> None:
        pass

    def dec(self, n: float = 1.0) -> None:
        pass

    def set(self, v: float) -> None:
        pass

    def observe(self, v: float) -> None:
        pass

    def quantile(self, q: float) -> float:
        return 0.0


NULL = _Null()

_KINDS = {"counter": Counter, "gauge": Gauge, "histogram": Histogram}


class _Family:
    """One registered metric name: label schema + memoized children."""

    def __init__(self, kind: str, name: str, help: str,
                 labelnames: Tuple[str, ...], **kw):
        self.kind = kind
        self.name = name
        self.help = help
        self.labelnames = labelnames
        self._kw = kw
        self._children: "OrderedDict[Tuple[str, ...], Any]" = OrderedDict()
        if not labelnames:
            self._children[()] = _KINDS[kind](**kw)

    def labels(self, **kv):
        if set(kv) != set(self.labelnames):
            raise ValueError(
                f"metric {self.name!r} declares labels {self.labelnames}, "
                f"got {tuple(kv)}"
            )
        key = tuple(str(kv[n]) for n in self.labelnames)
        child = self._children.get(key)
        if child is None:
            child = self._children[key] = _KINDS[self.kind](**self._kw)
        return child

    @property
    def default(self):
        return self._children[()]

    def series(self) -> List[Tuple[Dict[str, str], Any]]:
        return [
            (dict(zip(self.labelnames, key)), child)
            for key, child in self._children.items()
        ]


class MetricsRegistry:
    """Factory + catalog for counters/gauges/histograms, with sampled
    callback metrics and JSON-able snapshots.  ``enabled=False`` turns every
    factory into a :data:`NULL` dispenser (and ``snapshot()`` into ``{}``),
    which is how the engine's disabled-telemetry mode costs ~nothing."""

    def __init__(self, enabled: bool = True):
        self.enabled = enabled
        self._families: "OrderedDict[str, _Family]" = OrderedDict()
        # name → (kind, help, fn) sampled at snapshot time only
        self._callbacks: "OrderedDict[str, Tuple[str, str, Callable[[], float]]]" = (
            OrderedDict()
        )

    # -- factories ----------------------------------------------------------

    def _get(self, kind: str, name: str, help: str,
             labels: Sequence[str], **kw):
        if not self.enabled:
            return NULL
        if name in self._callbacks:
            raise ValueError(f"metric {name!r} already registered as a callback")
        fam = self._families.get(name)
        if fam is None:
            fam = self._families[name] = _Family(kind, name, help, tuple(labels), **kw)
        elif fam.kind != kind or fam.labelnames != tuple(labels):
            raise ValueError(
                f"metric {name!r} re-registered as {kind}{tuple(labels)} "
                f"(was {fam.kind}{fam.labelnames})"
            )
        return fam if fam.labelnames else fam.default

    def counter(self, name: str, help: str = "", *, labels: Sequence[str] = ()):
        return self._get("counter", name, help, labels)

    def gauge(self, name: str, help: str = "", *, labels: Sequence[str] = ()):
        return self._get("gauge", name, help, labels)

    def histogram(self, name: str, help: str = "", *,
                  labels: Sequence[str] = (),
                  buckets: Sequence[float] = DEFAULT_MS_BUCKETS):
        return self._get("histogram", name, help, labels, buckets=buckets)

    def callback(self, name: str, fn: Callable[[], float], *,
                 kind: str = "gauge", help: str = "") -> None:
        """Register a metric sampled only when a snapshot is taken (tier
        occupancy, queue depth, jit compile counts — anything already
        tracked elsewhere that the hot path should not mirror)."""
        if not self.enabled:
            return
        if kind not in ("gauge", "counter"):
            raise ValueError(f"callback metrics are gauges or counters, not {kind!r}")
        if name in self._families or name in self._callbacks:
            raise ValueError(f"metric {name!r} is already registered")
        self._callbacks[name] = (kind, help, fn)

    # -- snapshots ----------------------------------------------------------

    @staticmethod
    def _series_value(metric) -> Dict[str, Any]:
        if metric.kind == "histogram":
            cum, buckets = 0, []
            for edge, n in zip(metric.buckets, metric.counts):
                cum += n
                buckets.append([edge, cum])
            buckets.append(["+Inf", metric.count])
            return {"buckets": buckets, "sum": metric.sum, "count": metric.count}
        return {"value": metric.value}

    def snapshot(self) -> Dict[str, Any]:
        """Catalog → plain dict: ``{name: {type, help, series: [{labels,
        ...values}]}}`` with cumulative histogram buckets.  JSON-able as-is;
        ``repro_torch.obs.exposition`` renders the same dict to Prometheus text."""
        if not self.enabled:
            return {}
        out: Dict[str, Any] = {}
        for name, fam in self._families.items():
            out[name] = {
                "type": fam.kind,
                "help": fam.help,
                "series": [
                    {"labels": lbl, **self._series_value(m)}
                    for lbl, m in fam.series()
                ],
            }
        for name, (kind, help, fn) in self._callbacks.items():
            out[name] = {
                "type": kind,
                "help": help,
                "series": [{"labels": {}, "value": float(fn())}],
            }
        return out
