"""Fault-tolerant training runtime (port of
``repro/runtime/fault_tolerance.py``).

* **Checkpoint/restart**: auto-restore the newest checkpoint at startup;
  periodic async saves overlap serialization with compute; a final blocking
  save on exit or signal.
* **Preemption handling**: SIGTERM flips a flag; the loop checkpoints and
  exits cleanly at the next step boundary.  The previous SIGTERM handler
  is put back when :meth:`TrainLoopRunner.run` returns.
* **Crash recovery**: a step that raises (device OOM, data corruption, a
  simulated node failure through ``failure_injector``) triggers
  restore-from-last-checkpoint and replay; the data pipeline is a pure
  function of the step index, so replayed batches are identical.  The
  restore first waits for an async save still in flight.  The
  restore requires grad on every leaf whose counterpart in the running
  state does (the trainable leaves), so the next step differentiates them.
* **Straggler mitigation**: per-step wall-time EWMA and deviation; a step
  slower than ``mean + straggler_k·dev`` is logged and counted.
* **Elastic scaling**: checkpoints hold whole logical arrays; ``on_restore``
  is where :func:`repro_torch.checkpoint.reshard_to_mesh` lays them onto
  the run's placement.

A step's time ends when its loss reaches the host, so it covers all of the
step's device work (the reference blocks on its metrics with
``jax.block_until_ready``).
"""
from __future__ import annotations

import signal
import time
from typing import Any, Callable, Dict, Iterator, Optional

from repro_torch.checkpoint import CheckpointManager

Tree = Any


class StragglerMonitor:
    def __init__(self, k: float = 4.0, warmup: int = 5):
        self.k, self.warmup = k, warmup
        self.mean = 0.0
        self.dev = 0.0
        self.n = 0
        self.events = []

    def observe(self, step: int, dt: float) -> bool:
        self.n += 1
        if self.n <= self.warmup:
            # initialize on early steps (the first steps build the kernels)
            self.mean = dt if self.n == 1 else 0.5 * (self.mean + dt)
            self.dev = max(self.dev, 0.25 * self.mean)
            return False
        slow = dt > self.mean + self.k * max(self.dev, 1e-6)
        if slow:
            self.events.append({"step": step, "dt": dt, "mean": self.mean})
        a = 0.1
        self.mean = (1 - a) * self.mean + a * dt
        self.dev = (1 - a) * self.dev + a * abs(dt - self.mean)
        return slow


class TrainLoopRunner:
    def __init__(
        self,
        step_fn: Callable[[Tree, Dict], tuple],
        make_batches: Callable[[int], Iterator[Dict]],  # start_step → iterator
        ckpt: CheckpointManager,
        *,
        save_every: int = 50,
        log_every: int = 10,
        straggler_k: float = 4.0,
        failure_injector: Optional[Callable[[int], None]] = None,
        on_restore: Optional[Callable[[Tree], Tree]] = None,
        log_fn: Callable[[str], None] = print,
    ):
        self.step_fn = step_fn
        self.make_batches = make_batches
        self.ckpt = ckpt
        self.save_every = save_every
        self.log_every = log_every
        self.monitor = StragglerMonitor(k=straggler_k)
        self.failure_injector = failure_injector
        self.on_restore = on_restore
        self.log = log_fn
        self._preempted = False
        self.restarts = 0

    def _install_signal_handler(self):
        """The previous SIGTERM handler, or None off the main thread."""
        try:
            return signal.signal(signal.SIGTERM, lambda *_: setattr(self, "_preempted", True))
        except ValueError:
            return None  # not on main thread (tests)

    def _restore(self, state: Tree) -> tuple:
        # an async save still writing is the newest checkpoint: let it land
        # (the reference looks before it has, and then replays from an older
        # one, or from step 0 with the current state)
        self.ckpt.wait()
        step = self.ckpt.latest_step()
        if step is None:
            return state, 0
        restored, meta = self.ckpt.restore(state)
        if self.on_restore is not None:  # elastic re-shard hook
            restored = self.on_restore(restored)
        self.log(f"[ft] restored checkpoint at step {meta['step']}")
        return restored, int(meta["step"])

    def run(self, state: Tree, total_steps: int) -> tuple:
        prev_handler = self._install_signal_handler()
        try:
            return self._run(state, total_steps)
        finally:
            if prev_handler is not None:
                signal.signal(signal.SIGTERM, prev_handler)

    def _run(self, state: Tree, total_steps: int) -> tuple:
        state, start = self._restore(state)
        step = start
        metrics_hist = []
        while step < total_steps:
            batches = self.make_batches(step)
            try:
                for batch in batches:
                    if step >= total_steps or self._preempted:
                        break
                    if self.failure_injector is not None:
                        self.failure_injector(step)  # may raise (simulated fault)
                    if self._preempted:  # preemption: stop at the boundary
                        break
                    t0 = time.time()
                    state, metrics = self.step_fn(state, batch)
                    # read the loss back for honest step timing
                    float(metrics["loss"])
                    dt = time.time() - t0
                    step += 1
                    slow = self.monitor.observe(step, dt)
                    if slow:
                        self.log(f"[ft] straggler at step {step}: {dt:.3f}s "
                                 f"(mean {self.monitor.mean:.3f}s) — mitigation hook fired")
                    if step % self.log_every == 0:
                        m = {k: float(v) for k, v in metrics.items()}
                        metrics_hist.append({"step": step, **m})
                        self.log(f"[train] step {step}: " +
                                 " ".join(f"{k}={v:.4g}" for k, v in m.items()))
                    if step % self.save_every == 0:
                        self.ckpt.save(step, state, blocking=False)
                if self._preempted:
                    self.log(f"[ft] preemption — checkpointing at step {step} and exiting")
                    break
                if step >= total_steps:
                    break
            except KeyboardInterrupt:
                raise
            except Exception as e:
                self.restarts += 1
                self.log(f"[ft] step {step} failed ({type(e).__name__}: {e}) — "
                         f"restoring last checkpoint (restart #{self.restarts})")
                state, step = self._restore(state)
                continue
        self.ckpt.save(step, state, blocking=True)
        return state, step, metrics_hist
