"""The engine-facing telemetry facade: metric handles + span lifecycle.

One :class:`Telemetry` object rides on every
:class:`~repro_torch.serving.engine.MultiTenantEngine`.  It pre-creates the
serving metric catalog (so the hot path never does a name lookup) and
translates request lifecycle callbacks into both metric observations and
trace events:

========================  ====================================================
engine event              recorded as
========================  ====================================================
``on_submit``             ``serve_requests_total``; a :class:`RequestTrace`
                          attached to ``request.trace``
``on_defer``              ``serve_deferrals_total{cause}`` (once per episode —
                          the engine dedupes), queue-track instant marker
``on_admit``              ``serve_queue_wait_ms``; closes the queue span
``on_prefill``            ``serve_prefill_ms``; a lane-track prefill span
                          (chunked prefills observe admission → final-chunk
                          commit, spanning the interleaved decode steps)
``on_prefill_chunk``      ``serve_prefill_chunk_ms``; a lane-track span per
                          chunk of a chunked prefill
``on_token``              ``serve_ttft_ms`` (first delivered token) /
                          ``serve_tbt_ms`` (later ones), ``serve_tokens_total``
``on_decode_lane``        a thin per-token decode span on the lane track
``on_preempt``            ``serve_preemptions_total{cause}``, closes the lane's
                          request span, instant marker
``on_retire``             ``serve_e2e_ms``, ``serve_retired_total``, closes the
                          request span
``phase``                 ``serve_step_phase_ms{phase}`` — where ``step()``
                          spends host time (admit/prefill_chunk/grow/
                          dispatch/sync/emit)
========================  ====================================================

All times come from one ``perf_counter`` epoch shared with the tracer, so
histogram latencies and trace spans line up.  With ``enabled=False`` every
method returns immediately and every handle is the shared no-op instrument
— the disabled engine pays one predicate per event.
"""
from __future__ import annotations

import time
from typing import Any, Dict, Optional

from repro_torch.obs.metrics import DEFAULT_MS_BUCKETS, MetricsRegistry
from repro_torch.obs.tracing import PID_ENGINE, PID_QUEUE, RequestTrace, Tracer

#: Engine-track thread id for whole-step spans (draft/verify) that belong to
#: no single lane — rendered above the lane rows in the trace viewer.
TID_STEP = -1


class Telemetry:
    def __init__(self, enabled: bool = True, *, trace: Optional[bool] = None,
                 max_trace_events: int = 200_000):
        self.enabled = enabled
        self.registry = MetricsRegistry(enabled=enabled)
        trace = enabled if trace is None else (trace and enabled)
        self.tracer: Optional[Tracer] = (
            Tracer(max_events=max_trace_events) if trace else None
        )
        self._t0 = self.tracer._t0 if self.tracer else time.perf_counter()

        m = self.registry
        self.ttft = m.histogram(
            "serve_ttft_ms", "submit → first delivered token (ms)")
        self.tbt = m.histogram(
            "serve_tbt_ms", "gap between consecutive delivered tokens (ms)")
        self.e2e = m.histogram(
            "serve_e2e_ms", "submit → retirement (ms)")
        self.queue_wait = m.histogram(
            "serve_queue_wait_ms", "enqueue → lane admission (ms)")
        self.prefill_ms = m.histogram(
            "serve_prefill_ms", "admission prefill wall time (ms)")
        self.prefill_chunk_ms = m.histogram(
            "serve_prefill_chunk_ms",
            "wall time of one chunk of a chunked prefill (ms)")
        self.step_phase = m.histogram(
            "serve_step_phase_ms",
            "host time per engine step() phase (ms)", labels=("phase",),
            buckets=DEFAULT_MS_BUCKETS)
        self.requests = m.counter(
            "serve_requests_total", "requests submitted")
        self.retired = m.counter(
            "serve_retired_total", "requests run to completion")
        self.tokens = m.counter(
            "serve_tokens_total",
            "tokens delivered exactly-once (re-derived tokens after a "
            "discard-preemption are not double counted)")
        self.preempts = m.counter(
            "serve_preemptions_total", "lane preemptions", labels=("cause",))
        self.defers = m.counter(
            "serve_deferrals_total",
            "admission deferral episodes (one per wait, not per step)",
            labels=("cause",))
        self.cow_forks = m.counter(
            "serve_cow_forks_total", "copy-on-write block forks")
        self.prefix_hits = m.counter(
            "serve_prefix_hits_total", "prefix-cache blocks adopted at admission")
        self.prefix_misses = m.counter(
            "serve_prefix_misses_total", "full prompt blocks prefilled uncached")
        # speculative decoding: per-step acceptance-rate distribution plus
        # monotonic token-fate counters (drafted = accepted + rolled_back)
        self.spec_acceptance = m.histogram(
            "serve_spec_acceptance",
            "per-step fraction of drafted tokens accepted",
            buckets=(0.0, 0.125, 0.25, 0.375, 0.5, 0.625, 0.75, 0.875, 1.0))
        self.spec_drafted = m.counter(
            "serve_spec_drafted_total", "draft tokens proposed")
        self.spec_accepted = m.counter(
            "serve_spec_accepted_total", "draft tokens the verify pass accepted")
        self.spec_rolled_back = m.counter(
            "serve_spec_rolled_back_total",
            "draft tokens rejected and rolled back")
        if self.tracer:
            self.tracer.thread_name(PID_ENGINE, TID_STEP, "step")

    # -- clock --------------------------------------------------------------

    def now(self) -> float:
        """Seconds since the telemetry epoch (shared with the tracer)."""
        return time.perf_counter() - self._t0

    # -- request lifecycle --------------------------------------------------

    def on_submit(self, req) -> None:
        if not self.enabled:
            return
        req.trace = RequestTrace(req.uid, req.tenant, self.now())
        self.requests.inc()

    def on_defer(self, req, cause: str) -> None:
        """One deferral *episode* (the engine dedupes per-step refusals)."""
        if not self.enabled:
            return
        now = self.now()
        req.trace.mark("defer", now, cause)
        self.defers.labels(cause=cause).inc()
        if self.tracer:
            self.tracer.thread_name(PID_QUEUE, req.uid, f"req {req.uid}")
            self.tracer.instant(
                f"defer:{cause}", PID_QUEUE, req.uid, ts=now,
                args={"uid": req.uid, "tenant": req.tenant})

    def on_admit(self, req, *, restored: bool = False) -> None:
        if not self.enabled:
            return
        now = self.now()
        tr: RequestTrace = req.trace
        tr.mark("admit", now, {"lane": req.lane, "restored": restored})
        tr.admit_ts, tr.lane = now, req.lane
        self.queue_wait.observe((now - tr.enqueue_ts) * 1e3)
        if self.tracer:
            self.tracer.thread_name(PID_QUEUE, req.uid, f"req {req.uid}")
            self.tracer.thread_name(PID_ENGINE, req.lane, f"lane {req.lane}")
            self.tracer.complete(
                "queued", PID_QUEUE, req.uid, tr.enqueue_ts,
                now - tr.enqueue_ts, args={"uid": req.uid, "tenant": req.tenant})

    def on_prefill(self, req, t0: float, t1: float) -> None:
        if not self.enabled:
            return
        tr: RequestTrace = req.trace
        tr.mark("prefill", t1, {"prompt": int(req.prompt.size)})
        self.prefill_ms.observe((t1 - t0) * 1e3)
        if self.tracer:
            self.tracer.complete(
                "prefill", PID_ENGINE, req.lane, t0, t1 - t0,
                args={"uid": req.uid, "tenant": req.tenant,
                      "prompt_tokens": int(req.prompt.size)})

    def on_prefill_chunk(self, req, t0: float, t1: float, start: int,
                         tokens: int) -> None:
        """One chunk of a chunked prefill (absolute prompt position
        ``start``, ``tokens`` positions processed)."""
        if not self.enabled:
            return
        req.trace.mark("prefill_chunk", t1, {"start": int(start)})
        self.prefill_chunk_ms.observe((t1 - t0) * 1e3)
        if self.tracer:
            self.tracer.complete(
                "prefill_chunk", PID_ENGINE, req.lane, t0, t1 - t0,
                args={"uid": req.uid, "tenant": req.tenant,
                      "start": int(start), "tokens": int(tokens)})

    def on_token(self, req) -> None:
        """One *delivered* token (the engine calls this inside its
        exactly-once stream-delivery branch)."""
        if not self.enabled:
            return
        now = self.now()
        tr: RequestTrace = req.trace
        if tr.first_token_ts is None:
            tr.first_token_ts = now
            tr.mark("first_token", now)
            self.ttft.observe((now - tr.submit_ts) * 1e3)
        else:
            self.tbt.observe((now - tr.last_token_ts) * 1e3)
        tr.last_token_ts = now
        tr.tokens += 1
        self.tokens.inc()

    def on_decode_lane(self, req, t0: float, t1: float, token: int) -> None:
        """The lane's slice of one shared decode step (re-derived tokens
        trace too — the lane really did the work).  The engine calls this
        after emit, which may already have retired the request off its lane
        — fall back to the lane the trace recorded at admission."""
        if self.tracer:
            lane = req.lane if req.lane >= 0 else req.trace.lane
            self.tracer.complete(
                "decode", PID_ENGINE, lane, t0, t1 - t0,
                args={"uid": req.uid, "token": int(token),
                      "index": len(req.tokens) - 1})

    def _close_request_span(self, req, now: float, outcome: str) -> None:
        tr: RequestTrace = req.trace
        if self.tracer and tr.admit_ts is not None:
            self.tracer.complete(
                f"req {req.uid} ({req.tenant})", PID_ENGINE, tr.lane,
                tr.admit_ts, now - tr.admit_ts,
                args={"uid": req.uid, "tenant": req.tenant, "outcome": outcome,
                      "tokens": len(req.tokens)})
        tr.admit_ts = None

    def on_preempt(self, req, cause: str) -> None:
        """Called while the victim still owns its lane, exactly once per
        preemption event."""
        if not self.enabled:
            return
        now = self.now()
        tr: RequestTrace = req.trace
        tr.mark("preempt", now, cause)
        self.preempts.labels(cause=cause).inc()
        if self.tracer:
            self.tracer.instant(
                f"preempt:{cause}", PID_ENGINE, req.lane, ts=now,
                args={"uid": req.uid, "tenant": req.tenant})
        self._close_request_span(req, now, f"preempt:{cause}")
        tr.enqueue_ts = now  # queue-wait clock restarts

    def on_retire(self, req) -> None:
        if not self.enabled:
            return
        now = self.now()
        tr: RequestTrace = req.trace
        tr.mark("retire", now)
        tr.retired_ts = now
        self.e2e.observe((now - tr.submit_ts) * 1e3)
        self.retired.inc()
        self._close_request_span(req, now, "retired")

    def on_cow_fork(self, req, src: int, dst: int) -> None:
        if not self.enabled:
            return
        self.cow_forks.inc()
        if self.tracer:
            self.tracer.instant(
                "cow_fork", PID_ENGINE, req.lane,
                args={"uid": req.uid, "src_block": src, "dst_block": dst})

    # -- speculative decoding -----------------------------------------------

    def on_speculate(self, drafted: int, accepted: int,
                     rolled_back: int) -> None:
        """One speculative step's token fates across all lanes; the engine
        calls this exactly once per speculative ``step()``."""
        if not self.enabled:
            return
        self.spec_drafted.inc(drafted)
        self.spec_accepted.inc(accepted)
        self.spec_rolled_back.inc(rolled_back)
        if drafted:
            self.spec_acceptance.observe(accepted / drafted)

    def on_spec_phase(self, name: str, t0: float, t1: float) -> None:
        """A whole-step draft/verify span: a ``step_phase`` observation plus
        a step-track trace span (no single lane owns it)."""
        self.phase(name, t1 - t0)
        if self.tracer:
            self.tracer.complete(name, PID_ENGINE, TID_STEP, t0, t1 - t0)

    # -- step phases --------------------------------------------------------

    def phase(self, name: str, seconds: float) -> None:
        self.step_phase.labels(phase=name).observe(seconds * 1e3)

    # -- export -------------------------------------------------------------

    def snapshot(self) -> Dict[str, Any]:
        return self.registry.snapshot()

    def write_trace(self, path: str) -> None:
        if self.tracer is None:
            raise RuntimeError("tracing is disabled on this engine")
        self.tracer.write(path)
