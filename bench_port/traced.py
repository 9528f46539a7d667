"""What the measured package's own stages and counters recorded in a traced window.

``echopype_torch.utils.profiling.TRACED`` collects every stage and counter
the package opens while a profiler records on the calling thread; the
warm-up call runs before the window, so it holds the window's calls only.
Each function returns None for an untraced run, a package without
``TRACED``, or a name it never recorded.
"""

from __future__ import annotations


def _traced(rec):
    if rec["trace"] is None:
        return None
    try:
        from echopype_torch.utils import profiling
    except ImportError:
        return None
    return getattr(profiling, "TRACED", None)


def counter(rec, name):
    """Counter ``name`` summed over the window."""
    traced = _traced(rec)
    if traced is None or name not in traced.counters:
        return None
    return traced.counters[name]


def stage_ms_per_kping(rec, name):
    """Stage ``name``'s milliseconds per 1,000 pings of the window's calls."""
    traced = _traced(rec)
    if traced is None or name not in traced.totals or not rec["pings"]:
        return None
    return traced.totals[name] * 1e3 / (rec["pings"] / 1e3)
