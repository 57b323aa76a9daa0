#!/usr/bin/env python3
"""``chip_smoke.py`` run whole, with a wall-clock timer around each of its
module-level functions, on one CUDA card.

    python3 scripts/chip_smoke_phase_times.py [--out build/phase_times.txt]

The smoke run must end within its time limit; this says where its time
goes. Every function defined in ``chip_smoke.py`` (not ``main``, ``log``,
``require`` or the context managers) is wrapped before ``main`` runs, so
calls between them go through the timers too. At exit it writes, to
``--out``, the 80 functions with the most inclusive seconds: seconds,
calls, name (a function's time includes that of the functions it calls).
The smoke run's own output goes to stdout as usual.
"""
from __future__ import annotations

import argparse
import atexit
import collections
import functools
import inspect
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke as cs  # noqa: E402


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="build/phase_times.txt")
    args = ap.parse_args()
    sys.argv = sys.argv[:1]
    seconds, calls = collections.Counter(), collections.Counter()

    def timed(name, fn):
        @functools.wraps(fn)
        def run(*a, **k):
            t0 = time.perf_counter()
            try:
                return fn(*a, **k)
            finally:
                seconds[name] += time.perf_counter() - t0
                calls[name] += 1
        return run

    for name, fn in list(vars(cs).items()):
        if (inspect.isfunction(fn) and fn.__module__ == cs.__name__
                and name not in ("main", "log", "require")
                and not hasattr(fn, "__wrapped__")):
            setattr(cs, name, timed(name, fn))

    def dump():
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        with open(args.out, "w") as fh:
            for name, s in seconds.most_common(80):
                fh.write(f"{s:9.1f} s {calls[name]:6d} {name}\n")

    atexit.register(dump)
    cs.main()


if __name__ == "__main__":
    main()
