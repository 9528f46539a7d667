"""Per-stage wall-clock timing, counters and profiler traces.

Counterpart of ``echopype_tpu/utils/profiling.py``.  A stage
(:func:`stage`, :meth:`StageTimer.stage`) is host wall time: CUDA launches
return at once, so a stage includes device time only where it waits for a
result (a synchronous copy, a readback), or where CUDA tensors appended to
the yielded list make it end with ``torch.cuda.synchronize()``.  While a
profiler records on the calling thread, a stage is also a
``record_function`` span named ``stage:<name>`` over the same interval, and
it and every counter (:func:`count`) add to :data:`TRACED`, so a stage's
total and its spans in the trace are one measurement.  With no profiler
and no timer, a stage or a counter costs one check.

:func:`trace` records a window with ``torch.profiler``: host ops, the
stages, the port's kernel launches (each wrapper marks its launch with
:func:`launch_span`, named by the kernel's C entry point), and, once CUDA
is initialised, the card's kernels and copies.
"""

from __future__ import annotations

import contextlib
import os
import threading
import time
from collections import defaultdict
from pathlib import Path

import torch

from .log import _init_logger

logger = _init_logger(__name__)

__all__ = ["StageTimer", "TRACED", "count", "launch_span", "stage", "trace"]


class StageTimer:
    """Accumulates wall-clock per named pipeline stage, and counters.

    >>> timer = StageTimer()
    >>> with timer.stage("calibrate"):
    ...     ...
    >>> timer.count("staged_pings", 5000)
    >>> timer.report(), timer.counters

    Threads may share a timer: every addition takes its lock.
    """

    def __init__(self):
        self.totals = defaultdict(float)
        self.counts = defaultdict(int)
        self.counters = defaultdict(int)
        self._lock = threading.Lock()

    def stage(self, name: str):
        """Add the wall time of the ``with`` body to stage ``name``; CUDA
        tensors appended to the yielded list are waited for first."""
        return stage(name, self)

    def count(self, name: str, n):
        """Add ``n`` to counter ``name``."""
        count(name, n, self)

    def clear(self):
        with self._lock:
            self.totals.clear()
            self.counts.clear()
            self.counters.clear()

    def _add(self, name, seconds):
        with self._lock:
            self.totals[name] += seconds
            self.counts[name] += 1

    def _count(self, name, n):
        with self._lock:
            self.counters[name] += n

    def report(self, log=True) -> dict:
        """{stage: {"total_s", "count"}}, largest total first.  Counters are
        not in it: read :attr:`counters`."""
        with self._lock:
            stages = {
                name: {"total_s": round(t, 4), "count": self.counts[name]}
                for name, t in sorted(self.totals.items(), key=lambda kv: -kv[1])
            }
            counters = dict(sorted(self.counters.items()))
        if log:
            for name, row in stages.items():
                logger.info("stage %-20s %8.3f s  (%d calls)", name, row["total_s"], row["count"])
            for name, n in counters.items():
                logger.info("counter %-18s %s", name, n)
        return stages


#: The stages and counters of the profiler windows: every stage or counter
#: opened while a profiler records on the calling thread adds here (a
#: worker thread records nothing, so adds nothing).  :func:`trace` clears
#: it on entry; read ``TRACED.report()`` after the window.
TRACED = StageTimer()


_NO_STAGE = contextlib.nullcontext()


class _Stage:
    """One timed stage: adds to ``timer`` and, while traced, to
    :data:`TRACED`, inside a ``stage:<name>`` span over the same interval."""

    __slots__ = ("name", "timer", "span", "holder", "t0")

    def __init__(self, name, timer, traced):
        self.name, self.timer = name, timer
        self.span = torch.profiler.record_function(f"stage:{name}") if traced else None

    def __enter__(self):
        if self.span is not None:
            self.span.__enter__()
        self.holder = []
        self.t0 = time.perf_counter()
        return self.holder

    def __exit__(self, *exc):
        try:
            if any(isinstance(t, torch.Tensor) and t.is_cuda for t in self.holder):
                torch.cuda.synchronize()
            dt = time.perf_counter() - self.t0
            if self.timer is not None:
                self.timer._add(self.name, dt)
            if self.span is not None and self.timer is not TRACED:
                TRACED._add(self.name, dt)
        finally:
            if self.span is not None:
                self.span.__exit__(*exc)
        return False


def stage(name: str, timer: StageTimer | None = None):
    """Time stage ``name`` into ``timer`` and, while a profiler records on
    this thread, into :data:`TRACED` under a ``stage:<name>`` span; the
    ``with`` target is then a list for CUDA tensors to wait for.  With
    neither, a no-op after one check, whose target is None: code that waits
    on tensors passes a timer."""
    traced = torch.autograd._profiler_enabled()
    if timer is None and not traced:
        return _NO_STAGE
    return _Stage(name, timer, traced)


def count(name: str, n, timer: StageTimer | None = None):
    """Add ``n`` to counter ``name`` of ``timer`` and, while a profiler
    records on this thread, of :data:`TRACED`."""
    if timer is not None:
        timer._count(name, n)
    if timer is not TRACED and torch.autograd._profiler_enabled():
        TRACED._count(name, n)


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
    CUDA is initialised when the window opens.  Stages are ``stage:<name>``
    spans; :data:`TRACED`, cleared on entry, holds the window's stages and
    counters after it.  Yields the profiler, whose ``key_averages()`` and
    ``events()`` stay readable after the window.  The trace is written also
    when the body raises; profiler errors propagate.
    """
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_initialized():
        activities.append(ProfilerActivity.CUDA)
    out = Path(log_dir)
    out.mkdir(parents=True, exist_ok=True)
    TRACED.clear()
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
