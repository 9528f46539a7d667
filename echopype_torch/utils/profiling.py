"""Per-stage wall-clock timing and profiler traces.

Counterpart of ``echopype_tpu/utils/profiling.py``.  :class:`StageTimer`'s
stages are host wall time: CUDA launches return at once, so a stage
includes device time only where it waits for a result (a synchronous copy,
a readback), or where CUDA tensors appended to the yielded list make it end
with ``torch.cuda.synchronize()``.  :func:`trace` records a window with
``torch.profiler``: host ops, the port's kernel launches (each wrapper
marks its launch with :func:`launch_span`, named by the kernel's C entry
point), and, once CUDA is initialised, the card's kernels and copies.
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict
from pathlib import Path

import torch

from .log import _init_logger

logger = _init_logger(__name__)

__all__ = ["StageTimer", "launch_span", "trace"]


class StageTimer:
    """Accumulates wall-clock per named pipeline stage.

    >>> timer = StageTimer()
    >>> with timer.stage("calibrate"):
    ...     ...
    >>> timer.report()
    """

    def __init__(self):
        self.totals = defaultdict(float)
        self.counts = defaultdict(int)

    @contextlib.contextmanager
    def stage(self, name: str):
        """Add the wall time of the ``with`` body to stage ``name``; CUDA
        tensors appended to the yielded list are waited for first."""
        holder = []
        t0 = time.perf_counter()
        try:
            yield holder
        finally:
            if any(isinstance(t, torch.Tensor) and t.is_cuda for t in holder):
                torch.cuda.synchronize()
            self.totals[name] += time.perf_counter() - t0
            self.counts[name] += 1

    def report(self, log=True) -> dict:
        out = {
            name: {"total_s": round(t, 4), "count": self.counts[name]}
            for name, t in sorted(self.totals.items(), key=lambda kv: -kv[1])
        }
        if log:
            for name, row in out.items():
                logger.info("stage %-20s %8.3f s  (%d calls)", name, row["total_s"], row["count"])
        return out


def launch_span(name: str):
    """A ``record_function`` span named ``name`` while a profiler records,
    else a no-op.  Opening the span costs host time even with no profiler
    on, enough to widen the gap between K1 launches (~0.11 ms kernels) on
    the card, so the kernel wrappers pay it only inside a profiler
    window."""
    if torch.autograd._profiler_enabled():
        return torch.profiler.record_function(name)
    return contextlib.nullcontext()


@contextlib.contextmanager
def trace(log_dir: str):
    """Trace the ``with`` body with ``torch.profiler`` and write it into
    ``log_dir`` as a Chrome trace (``<pid>.<ns>.pt.trace.json``; Perfetto,
    chrome://tracing or TensorBoard's profiler plugin read it).

    Host activity always; the card's activity (kernels, copies) too when
    CUDA is initialised when the window opens.  Yields the profiler, whose
    ``key_averages()`` and ``events()`` stay readable after the window.
    The trace is written also when the body raises; profiler errors
    propagate.
    """
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_initialized():
        activities.append(ProfilerActivity.CUDA)
    out = Path(log_dir)
    out.mkdir(parents=True, exist_ok=True)
    prof, started = profile(activities=activities), False
    try:
        with prof:
            started = True
            yield prof
    finally:
        if started:  # the window closed, also when the body raised
            path = out / f"{os.getpid()}.{time.time_ns()}.pt.trace.json"
            prof.export_chrome_trace(str(path))
            logger.info("profiler trace written to %s", path)
