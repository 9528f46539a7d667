"""Per-stage wall-clock timing.

Counterpart of ``echopype_tpu/utils/profiling.py::StageTimer``.  The stages
are host wall time: CUDA launches return at once, so a stage includes
device time only where it waits for a result (a synchronous copy, a
readback), or where CUDA tensors appended to the yielded list make it end
with ``torch.cuda.synchronize()``.
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict

import torch

from .log import _init_logger

logger = _init_logger(__name__)

__all__ = ["StageTimer"]


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
