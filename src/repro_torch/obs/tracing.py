"""Request-span tracing: Chrome/Perfetto ``trace_event`` export.

Two cooperating pieces:

* :class:`RequestTrace` — per-request milestone log, attached to
  ``Request.trace`` at submission.  Every lifecycle transition the engine
  drives (submit → defer* → admit → prefill → per-token decode →
  preempt*/retire) appends one ``(event, ts, detail)`` milestone, so tests
  and post-mortems can assert ordering and exactly-once recording without
  parsing the global trace.
* :class:`Tracer` — the flat ``trace_event`` stream.  Lanes are threads of
  one "engine" process (tid = lane), so an engine run renders as a lane
  timeline: an enclosing request span per lane residency, a prefill span at
  admission, one thin decode span per token, and instant markers for
  preemptions, CoW forks, and deferrals.  Queued time renders in a second
  "queue" process with one thread per request (queue spans overlap, so they
  can't share a lane thread).

Timestamps are microseconds from the tracer's construction
(``time.perf_counter`` based — monotonic, not wall clock).  The export is
the JSON object form (``{"traceEvents": [...]}``) that both
``chrome://tracing`` and https://ui.perfetto.dev open directly.

The event list is bounded (``max_events``): a long-running engine drops new
events past the cap and counts them in ``dropped`` instead of growing
without limit — traces are a capture tool, not a flight recorder.
"""
from __future__ import annotations

import json
import os
import time
from typing import Any, Dict, List, Optional, Tuple

PID_ENGINE = 0  # lane timeline: tid = lane index
PID_QUEUE = 1  # queue-wait timeline: tid = request uid


class RequestTrace:
    """Milestone log of one request's trip through the engine."""

    __slots__ = (
        "uid", "tenant", "events",
        "submit_ts", "enqueue_ts", "admit_ts", "lane",
        "first_token_ts", "last_token_ts", "tokens", "retired_ts",
    )

    def __init__(self, uid: int, tenant: str, now: float):
        self.uid = uid
        self.tenant = tenant
        self.events: List[Tuple[str, float, Any]] = []
        self.submit_ts = now
        self.enqueue_ts = now  # reset on preemption (re-queue)
        self.admit_ts: Optional[float] = None
        self.lane = -1
        self.first_token_ts: Optional[float] = None
        self.last_token_ts: Optional[float] = None
        self.tokens = 0  # delivered (exactly-once) tokens
        self.retired_ts: Optional[float] = None
        self.mark("submit", now)

    def mark(self, event: str, ts: float, detail: Any = None) -> None:
        self.events.append((event, ts, detail))

    def names(self) -> List[str]:
        """Milestone names in recording order (test convenience)."""
        return [e for e, _, _ in self.events]

    @property
    def ttft_ms(self) -> Optional[float]:
        if self.first_token_ts is None:
            return None
        return (self.first_token_ts - self.submit_ts) * 1e3

    @property
    def e2e_ms(self) -> Optional[float]:
        if self.retired_ts is None:
            return None
        return (self.retired_ts - self.submit_ts) * 1e3


class Tracer:
    """Bounded ``trace_event`` collector with perf_counter microsecond
    timestamps."""

    def __init__(self, max_events: int = 200_000):
        self._t0 = time.perf_counter()
        self.max_events = max_events
        self.events: List[Dict[str, Any]] = []
        self.dropped = 0
        self._named_tids: set = set()
        self._process_name(PID_ENGINE, "engine")
        self._process_name(PID_QUEUE, "queue")

    # -- timestamps ---------------------------------------------------------

    def now(self) -> float:
        """Seconds since tracer epoch (shared clock for span math)."""
        return time.perf_counter() - self._t0

    @staticmethod
    def us(ts: float) -> float:
        return ts * 1e6

    # -- event emission -----------------------------------------------------

    def _push(self, ev: Dict[str, Any]) -> None:
        if len(self.events) >= self.max_events:
            self.dropped += 1
            return
        self.events.append(ev)

    def _process_name(self, pid: int, name: str) -> None:
        self._push({
            "name": "process_name", "ph": "M", "pid": pid, "tid": 0,
            "args": {"name": name},
        })

    def thread_name(self, pid: int, tid: int, name: str) -> None:
        """Label a timeline row once (lane index → "lane 3", uid → "req 7")."""
        if (pid, tid) in self._named_tids:
            return
        self._named_tids.add((pid, tid))
        self._push({
            "name": "thread_name", "ph": "M", "pid": pid, "tid": tid,
            "args": {"name": name},
        })

    def complete(self, name: str, pid: int, tid: int, ts: float, dur: float,
                 args: Optional[Dict[str, Any]] = None) -> None:
        """A span: ``ts``/``dur`` in epoch seconds (converted to µs here)."""
        ev = {
            "name": name, "ph": "X", "pid": pid, "tid": tid,
            "ts": self.us(ts), "dur": max(self.us(dur), 0.0),
        }
        if args:
            ev["args"] = args
        self._push(ev)

    def instant(self, name: str, pid: int, tid: int,
                args: Optional[Dict[str, Any]] = None,
                ts: Optional[float] = None) -> None:
        ev = {
            "name": name, "ph": "i", "s": "t", "pid": pid, "tid": tid,
            "ts": self.us(self.now() if ts is None else ts),
        }
        if args:
            ev["args"] = args
        self._push(ev)

    # -- export -------------------------------------------------------------

    def to_chrome(self) -> Dict[str, Any]:
        """The ``trace_event`` JSON object form (open in chrome://tracing or
        ui.perfetto.dev)."""
        return {
            "traceEvents": list(self.events),
            "displayTimeUnit": "ms",
            "otherData": {"dropped_events": self.dropped},
        }

    def write(self, path: str) -> None:
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)
        with open(path, "w") as f:
            json.dump(self.to_chrome(), f)
            f.write("\n")
