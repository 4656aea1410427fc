"""Where a host-bound Python program spends its wall time: run a script
under a stack sampler and file the seconds by function.

    python -m repro_torch.benchmarks.stack_sample chip_smoke.py \\
        --out chiprun_out/stack_sample.json [-- script arguments]

A daemon thread reads the main thread's stack every ``--interval`` seconds
(``sys._current_frames``: no tracing hook, so the program runs at its own
speed but for a few µs a sample) and keeps the frames whose file matches one
of ``--match`` (by default the script's own file and ``repro_torch``).  The
JSON holds, in seconds of wall time:

* ``inclusive``: each kept function, counted once a sample if it is anywhere
  on the stack;
* ``innermost``: the innermost kept function of each sample: its own time
  and that of the library calls it makes (torch operators, CUDA launches);
* ``chains``: the innermost four frames of the script itself, innermost
  first.

Each sample weighs the wall time since the one before it (the sampler
waits for the GIL too, up to the interpreter's switch interval), so the
seconds add up to the run's wall time.  The script's exit code is the
sampler's; the JSON is written either way.
"""
from __future__ import annotations

import argparse
import collections
import json
import os
import runpy
import sys
import threading
import time


def _key(code) -> str:
    return f"{os.path.basename(code.co_filename)}:{code.co_name}"


def sample(script: str, args, match, interval: float = 0.02) -> tuple:
    """Run ``script`` (a path) as ``__main__`` with ``args`` under the
    sampler; returns (exit code, readings)."""
    main_id = threading.get_ident()
    inclusive, innermost, chains = (collections.Counter() for _ in range(3))
    count, stop = [0], threading.Event()
    last = [time.perf_counter()]
    script_file = os.path.abspath(script)

    def kept(filename: str) -> bool:
        return any(m in filename for m in match)

    def loop():
        while not stop.wait(interval):
            frame = sys._current_frames().get(main_id)
            now = time.perf_counter()
            dt, last[0] = now - last[0], now
            seen, chain, inner = set(), [], None
            while frame is not None:
                code = frame.f_code
                if kept(code.co_filename):
                    key = _key(code)
                    if key not in seen:
                        seen.add(key)
                        inclusive[key] += dt
                    inner = inner or key
                    if os.path.abspath(code.co_filename) == script_file:
                        chain.append(code.co_name)
                frame = frame.f_back
            if inner:
                innermost[inner] += dt
            chains[" < ".join(chain[:4])] += dt
            count[0] += 1

    thread = threading.Thread(target=loop, daemon=True)
    argv = sys.argv
    sys.argv = [script, *args]
    rc = 0
    t0 = last[0] = time.perf_counter()
    thread.start()
    try:
        runpy.run_path(script, run_name="__main__")
    except SystemExit as e:
        rc = e.code if isinstance(e.code, int) else (0 if e.code is None else 1)
    finally:
        stop.set()
        thread.join()
        sys.argv = argv

    def top(counter, n):
        return [[k, round(t, 3)] for k, t in counter.most_common(n)]

    return rc, {"interval_s": interval, "samples": count[0],
                "wall_s": time.perf_counter() - t0,
                "inclusive": top(inclusive, 300), "innermost": top(innermost, 150),
                "chains": top(chains, 300)}


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    args = argv[argv.index("--") + 1:] if "--" in argv else []
    argv = argv[:argv.index("--")] if "--" in argv else argv
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("script")
    ap.add_argument("--out", required=True)
    ap.add_argument("--interval", type=float, default=0.02)
    ap.add_argument("--match", default=None,
                    help="comma-separated substrings of the file names to keep "
                         "(default: the script's own file and repro_torch)")
    a = ap.parse_args(argv)
    match = a.match.split(",") if a.match else [os.path.basename(a.script), "repro_torch"]
    rc, out = sample(a.script, args, match, a.interval)
    os.makedirs(os.path.dirname(os.path.abspath(a.out)), exist_ok=True)
    with open(a.out, "w") as f:
        json.dump(out, f, indent=0)
    return rc


if __name__ == "__main__":
    sys.exit(main())
