"""Continuous-batching scheduler: request queue + decode-lane management
(port of ``repro/serving/scheduler.py``).

The decode batch has a fixed number of *lanes*.  Requests queue FIFO;
whenever a lane frees up the next request is admitted and prefilled into it
while the other lanes keep decoding.  Requests from different tenants share
one decode batch: the per-lane adapter-slot ids are the ``seg_ids`` fed to
the batched multi-λ kernel.
"""
from __future__ import annotations

import dataclasses
from collections import deque
from typing import Any, Deque, List, Optional

import numpy as np


@dataclasses.dataclass
class Request:
    """One generation request from one tenant."""

    uid: int
    tenant: str
    prompt: np.ndarray  # (S,) int32 token ids
    max_new_tokens: int
    # filled by the engine:
    lane: int = -1
    slot: int = -1  # adapter slot id (0 = base model)
    admit_seq: int = -1  # admission ordinal (preemption picks the youngest)
    preemptions: int = 0
    # decode steps since (re-)admission: the time-slicing quantum counts these
    slice_steps: int = 0
    # next prompt position a chunked prefill computes (-1: none in flight)
    prefill_pos: int = -1
    prefill_chunks: int = 0  # prompt chunks dispatched (0: one monolithic pass)
    # tokens already surfaced as stream events: monotonic, it survives the
    # preemption that clears ``tokens``, so a re-derived token is not
    # delivered twice
    delivered: int = 0
    # LaneState snapshot taken at a time-slice preemption (host memory):
    # when set, re-admission restores the lane instead of re-prefilling
    snapshot: Any = None
    # telemetry span (``repro_torch.obs.tracing.RequestTrace``): the
    # request's milestone log, attached at submission when the engine's
    # telemetry is on
    trace: Any = None
    tokens: List[int] = dataclasses.field(default_factory=list)
    logits: List[np.ndarray] = dataclasses.field(default_factory=list)

    @property
    def done(self) -> bool:
        return len(self.tokens) >= self.max_new_tokens


class ContinuousBatchScheduler:
    """FIFO admission over a fixed set of decode lanes."""

    def __init__(self, n_lanes: int):
        if n_lanes < 1:
            raise ValueError("need at least one lane")
        self.n_lanes = n_lanes
        self.queue: Deque[Request] = deque()
        self.lanes: List[Optional[Request]] = [None] * n_lanes
        self._next_uid = 0

    def submit(self, tenant: str, prompt: np.ndarray, max_new_tokens: int) -> Request:
        req = Request(
            uid=self._next_uid,
            tenant=tenant,
            prompt=np.asarray(prompt, np.int32).reshape(-1),
            max_new_tokens=int(max_new_tokens),
        )
        self._next_uid += 1
        self.queue.append(req)
        return req

    def free_lanes(self) -> List[int]:
        return [i for i, r in enumerate(self.lanes) if r is None]

    def admit(self, can_admit=None) -> List[Request]:
        """Move queued requests into free lanes (FIFO); returns the newly
        admitted requests with their ``lane`` assigned.  ``can_admit(req)``
        is an optional resource gate; admission stops at the first refused
        request (strict FIFO, no overtaking)."""
        admitted = []
        for lane in self.free_lanes():
            if not self.queue:
                break
            if can_admit is not None and not can_admit(self.queue[0]):
                break
            req = self.queue.popleft()
            req.lane = lane
            self.lanes[lane] = req
            admitted.append(req)
        return admitted

    def active(self) -> List[Request]:
        return [r for r in self.lanes if r is not None]

    def finish(self, req: Request) -> None:
        if self.lanes[req.lane] is not req:
            raise ValueError(f"request {req.uid} does not hold lane {req.lane}")
        self.lanes[req.lane] = None
        req.lane = -1

    def preempt(self, req: Request, *, to_back: bool = False,
                keep_progress: bool = False) -> None:
        """Kick an active request off its lane, back onto the queue.

        Default (block-pressure reclaim): to the *front*, its generated
        tokens discarded; greedy decode re-derives them on re-admission
        (``delivered`` stays, so they stream only once).
        ``keep_progress=True`` (time-slice preemption): tokens and logits
        survive, the engine having stashed a lane snapshot on
        ``req.snapshot`` to restore instead of re-prefilling.
        ``to_back=True`` re-queues at the tail (round-robin fairness)."""
        self.finish(req)
        req.admit_seq = -1
        req.preemptions += 1
        req.slice_steps = 0
        req.prefill_pos = -1  # an interrupted chunked prefill restarts
        if not keep_progress:
            req.tokens.clear()
            req.logits.clear()
            req.snapshot = None
        if to_back:
            self.queue.append(req)
        else:
            self.queue.appendleft(req)

    @property
    def has_work(self) -> bool:
        return bool(self.queue) or any(r is not None for r in self.lanes)

    def batch_composition(self) -> np.ndarray:
        """Per-lane adapter-slot ids (idle lanes → slot 0, the zero-λ base
        tenant)."""
        seg = np.zeros((self.n_lanes,), np.int32)
        for r in self.lanes:
            if r is not None:
                seg[r.lane] = r.slot
        return seg
