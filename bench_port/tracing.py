"""The benchmark's spans and the reading of its profiler window.

:func:`span` opens a ``record_function`` named ``bench:<name>`` while a
profiler records (a no-op otherwise).  :class:`Profiler` records the
measured window with ``torch.profiler`` (host and, on a card, CUPTI device
activity), writes the Chrome trace into the run's scratch directory and
reduces it to what the metrics read:

* ``busy_s``: the union of the device's kernels, copies and sets within the
  window; ``window_s``: the window's length (its ``bench:window`` span);
* ``kernels``: device seconds by kernel name;
* ``breakdown``: the ten device operations that took most time, and the
  device's idle time summed by what the host was doing then (the innermost
  ``bench:`` span or ``stage:`` of the measured package's stage timer over
  each stretch of the gap), the ten largest.
"""

from __future__ import annotations

import contextlib
import json
from collections import defaultdict
from pathlib import Path

import torch

__all__ = ["Profiler", "span"]

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def span(name):
    if torch.autograd._profiler_enabled():
        return torch.profiler.record_function(f"bench:{name}")
    return contextlib.nullcontext()


def _union(intervals):
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def _segments(spans, w0, w1):
    """The window cut at every span boundary, each piece labelled by the
    innermost (shortest) span covering it, or "outside any span"."""
    cuts = sorted({w0, w1, *(t for s, e, _ in spans for t in (s, e) if w0 < t < w1)})
    out = []
    for a, b in zip(cuts, cuts[1:]):
        mid, best = (a + b) / 2, None
        for s, e, name in spans:
            if s <= mid <= e and (best is None or e - s < best[0]):
                best = (e - s, name)
        out.append((a, b, "outside any span" if best is None else best[1]))
    return out


def reduce_trace(events):
    """Chrome-trace events -> busy_s, window_s, kernels, breakdown (seconds)."""
    window = [(e["ts"], e["ts"] + e["dur"]) for e in events
              if e.get("ph") == "X" and e.get("name") == "bench:window"]
    if not window:
        raise RuntimeError("the trace holds no bench:window span")
    w0, w1 = window[0]
    dev = [e for e in events if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS]
    kernels, ops = defaultdict(float), defaultdict(float)
    ivals = []
    for e in dev:
        s, t = max(e["ts"], w0), min(e["ts"] + e["dur"], w1)
        if t <= s:
            continue
        ivals.append((s, t))
        ops[e["name"]] += (t - s) * 1e-6
        if e["cat"] == "kernel":
            kernels[e["name"]] += (t - s) * 1e-6
    busy = _union(ivals)
    busy_s = sum(t - s for s, t in busy) * 1e-6
    host = [(e["ts"], e["ts"] + e["dur"], e["name"]) for e in events
            if e.get("ph") == "X" and e.get("cat") == "user_annotation"
            and (e["name"].startswith("stage:") or e["name"].startswith("bench:"))
            and e["name"] != "bench:window"]
    idle, prev = [], w0
    for s, t in busy + [[w1, w1]]:
        if s > prev:
            idle.append((prev, s))
        prev = max(prev, t)
    gaps = defaultdict(float)
    for a, b, name in _segments(host, w0, w1):
        for s, t in idle:  # idle time of each host piece
            if s < b and t > a:
                gaps[name] += (min(b, t) - max(a, s)) * 1e-6
    top = sorted(ops.items(), key=lambda kv: -kv[1])[:10]
    by_host = sorted(gaps.items(), key=lambda kv: -kv[1])[:10]
    return {"busy_s": busy_s, "window_s": (w1 - w0) * 1e-6, "kernels": dict(kernels),
            "breakdown": {"device_ops": [[n, v] for n, v in top],
                          "idle_gaps": [[n, v] for n, v in by_host]}}


class Profiler:
    """``torch.profiler`` over the measured window; :meth:`summary` after."""

    def __init__(self, out_dir, device):
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        if device == "cuda":
            acts.append(ProfilerActivity.CUDA)
        self.out = Path(out_dir)
        self.prof = profile(activities=acts)

    def __enter__(self):
        self.prof.__enter__()
        return self

    def __exit__(self, *exc):
        return self.prof.__exit__(*exc)

    def summary(self):
        self.out.mkdir(parents=True, exist_ok=True)
        path = self.out / "window.pt.trace.json"
        self.prof.export_chrome_trace(str(path))
        events = json.loads(path.read_text())["traceEvents"]
        path.unlink()
        return reduce_trace(events)
