"""CSV/JSON emit helpers and timers of the port's benchmarks (the port's copy
of ``benchmarks/common.py``'s ``emit``, ``timed`` and ``write_json``; the
row format is the same, ``name,us_per_call,derived``).

On a card the timers synchronise: :func:`timed` brackets its loop with
``torch.cuda.synchronize()`` (host clock, launches included) and
:func:`device_us` reads CUDA events around a run of calls, so neither times
only the launches.  Rows that compare a kernel with its plain version also
record the error against a stated tolerance (:func:`record_error`), which
``run.py`` turns into its exit code.
"""
from __future__ import annotations

import json
import sys
import time

import torch

_rows = []
_timings = {}
_errors = {}


def reset() -> None:
    """Forget every emitted row (one run of ``run.main`` starts empty)."""
    _rows.clear()
    _timings.clear()
    _errors.clear()


def emit(name: str, us_per_call: float, derived: str):
    row = f"{name},{us_per_call:.1f},{derived}"
    _rows.append(row)
    _timings[name] = round(float(us_per_call), 1)
    sys.stdout.write(row + "\n")
    sys.stdout.flush()


def err_over_bound(got: torch.Tensor, want: torch.Tensor, tol, scale=None) -> float:
    """Largest ``|got − want| / (atol + rtol·|want| + ptol·scale)`` over the
    elements, ``tol = (atol, rtol, ptol)``: at most 1 within tolerance (an
    exact element reads 0 even where its bound is 0).  ``scale`` is needed
    only when ``ptol`` is not 0."""
    atol, rtol, ptol = tol
    g, w = got.float(), want.float()
    if not g.numel():
        return 0.0
    bound = atol + rtol * w.abs()
    if ptol:
        bound = bound + ptol * scale.float()
    d = (g - w).abs()
    return float(torch.where(d == 0, torch.zeros_like(d), d / bound).max())


def record_error(name: str, got: torch.Tensor, want: torch.Tensor, tol, scale=None) -> str:
    """Hold ``got`` against ``want`` elementwise, ``|got − want| ≤ atol +
    rtol·|want| + ptol·scale`` (see :func:`err_over_bound`); keep the verdict
    under ``name`` and return the ``maxerr=…;tol=…`` text for the row's
    derived column."""
    atol, rtol, ptol = tol
    g, w = got.float(), want.float()
    err = float((g - w).abs().max()) if g.numel() else 0.0
    over = err_over_bound(got, want, tol, scale)
    ok = over <= 1.0 and bool(torch.isfinite(g).all())
    _errors[name] = {"max_abs_err": err, "atol": atol, "rtol": rtol, "ptol": ptol,
                     "err_over_bound": over, "ok": ok}
    text = f"{atol:g}+{rtol:g}*|ref|" + (f"+{ptol:g}*P|v|" if ptol else "")
    return f"maxerr={err:.2e};tol={text};over_bound={over:.3f};ok={int(ok)}"


def errors() -> dict:
    """name → ``{max_abs_err, atol, rtol, ptol, err_over_bound, ok}`` of
    every row that compared."""
    return dict(_errors)


def rows() -> list:
    return list(_rows)


def write_json(path: str, device: str) -> None:
    """Dump every emitted benchmark as ``{name: us_per_call}``, with the
    device it ran on."""
    with open(path, "w") as f:
        json.dump({"device": device, "us_per_call": _timings}, f, indent=2, sort_keys=True)
        f.write("\n")


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def timed(fn, *args, n: int = 3, device="cpu"):
    """Mean wall time of one call in µs over ``n`` calls after a warm-up
    call, synchronised on a card; returns (last output, µs)."""
    fn(*args)  # warm
    _sync(device)
    t0 = time.perf_counter()
    for _ in range(n):
        out = fn(*args)
    _sync(device)
    return out, (time.perf_counter() - t0) / n * 1e6


def device_us(fn, n: int = 20) -> float:
    """Device time of one call in µs on the card: CUDA events around ``n``
    calls after a warm-up call."""
    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) * 1e3 / n


def graph_ms(fn, iters: int = 50, reps: int = 5) -> float:
    """Device time of one call in ms on the card: ``iters`` back-to-back
    calls captured in a CUDA graph, replayed ``reps`` times between CUDA
    events.  Replaying a graph takes the host's launch overhead out, so this
    is the card's time (with warm L2: the operands are the same every call).
    A call that cannot be captured raises."""
    torch.cuda.synchronize()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm-up off the default stream, as capture needs
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (iters * reps)


def eager_ms(fn, iters: int = 100) -> float:
    """Wall time of one eager call in ms on the card, host launch overhead
    included."""
    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / iters


def launch_us(fn, calls: int = 20) -> dict:
    """Mean device µs of each kernel that one call of ``fn`` launches, by
    kernel name (template arguments kept, parameters cut), over ``calls``
    eager calls under torch.profiler."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        if e.device_time_total > 0:
            name = e.key.replace("void ", "").replace("(anonymous namespace)::", "")
            out[name.split("(")[0]] = e.device_time_total / e.count
    return out
