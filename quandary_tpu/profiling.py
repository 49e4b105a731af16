"""Profiling utilities — the observability layer (the reference's surface is
MPI_Wtime + getrusage + timing.dat, main.cpp:453-487; SURVEY section 5).

* `timer()` context: wall time + peak RSS, optionally appended to timing.dat;
* `trace(dir)` context: a full `jax.profiler` device trace (TensorBoard /
  xprof format) around any block — per-kernel timing on the device;
* `sweep_timer`: synchronous throughput measurement (value fetched per rep,
  so every rep includes its device-to-host round trip).
"""

from __future__ import annotations

import contextlib
import os
import resource
import time
from typing import Callable, Optional


@contextlib.contextmanager
def timer(label: str = "", timing_file: Optional[str] = None):
    t0 = time.perf_counter()
    yield
    dt = time.perf_counter() - t0
    rss_mb = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1024.0
    msg = f"{label + ': ' if label else ''}{dt:.3f} s, peak RSS {rss_mb:.1f} MB"
    print(msg)
    if timing_file:
        with open(timing_file, "a") as f:
            f.write("%d  %1.8e\n" % (1, dt))


@contextlib.contextmanager
def trace(logdir: str = "/tmp/qtpu_trace"):
    """jax.profiler device trace around a block; view with TensorBoard."""
    import jax

    os.makedirs(logdir, exist_ok=True)
    jax.profiler.start_trace(logdir)
    try:
        yield logdir
    finally:
        jax.profiler.stop_trace()


def sweep_timer(fn: Callable, make_args: Callable, reps: int = 10) -> float:
    """Synchronous reps/s of fn(*make_args(i)), forcing a value fetch."""
    import jax

    out = fn(*make_args(0))
    jax.block_until_ready(out)
    _force(out)
    t0 = time.perf_counter()
    for i in range(reps):
        out = fn(*make_args(i))
        _force(out)
    return reps / (time.perf_counter() - t0)


def _force(out):
    import jax
    import numpy as np

    leaf = jax.tree.leaves(out)[0]
    np.asarray(leaf.ravel()[0])
