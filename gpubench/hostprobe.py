"""A fixed measure of the host's speed, taken at the start of every run and
again once its window has closed, so that a run that reads slow can be told
apart from a host that ran slow: the same work from a fixed seed each time,
timed by the wall clock and by the process's CPU clock (`*_cpu_s`).

  unique_s  np.union1d of two fixed arrays of 2^19 uint32: the operation
            the report's HLL merges spend their time in
  sort_s    np.sort of a fixed array of 2^22 uint64
  touch_s   a fresh 256 MiB array written once: the host's page faults
  python_s  a fixed loop of the interpreter
"""

from __future__ import annotations

import time

import numpy as np


def _timed(fn) -> tuple[float, float]:
    w, c = time.perf_counter(), time.process_time()
    fn()
    return time.perf_counter() - w, time.process_time() - c


def measure() -> dict:
    rng = np.random.default_rng(20180101)
    a = rng.integers(0, 1 << 32, 1 << 19, dtype=np.uint32)
    b = rng.integers(0, 1 << 32, 1 << 19, dtype=np.uint32)
    s = rng.integers(0, 1 << 63, 1 << 22, dtype=np.uint64)

    def touch():
        x = np.empty(256 << 20, dtype=np.uint8)
        x.fill(1)
        del x

    def python():
        t = 0
        for i in range(1_000_000):
            t += i & 7
        return t

    out = {}
    for name, fn in (("unique_s", lambda: np.union1d(a, b)), ("sort_s", lambda: np.sort(s)), ("touch_s", touch),
                     ("python_s", python)):
        wall, cpu = _timed(fn)
        out[name] = wall
        out[name[:-2] + "_cpu_s"] = cpu
    return out
