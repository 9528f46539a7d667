"""Comparisons of the measured package's outputs with the plain reference."""

from __future__ import annotations

import numpy as np

__all__ = ["grid_mismatch", "max_db_gap", "nan_mismatch"]


def grid_mismatch(got, ref):
    """How many of shape, channels, ping-time and range coordinates differ."""
    bad = int(np.shape(got["Sv"]) != np.shape(ref["Sv"]))
    bad += int(list(got["channel"]) != list(ref["channel"]))
    for key in ("ping_time", "echo_range"):
        a, b = np.asarray(got[key]), np.asarray(ref[key])
        bad += int(a.shape != b.shape or not np.array_equal(a, b))
    return bad


def nan_mismatch(a, b):
    """Cells NaN on one side only (every cell when the shapes differ)."""
    a, b = np.asarray(a), np.asarray(b)
    if a.shape != b.shape:
        return max(a.size, b.size, 1)
    return int(np.count_nonzero(np.isnan(a) != np.isnan(b)))


def max_db_gap(a, b):
    """Widest |a - b| in dB over the cells finite on both sides; inf when
    the shapes differ or no cell is."""
    a, b = np.asarray(a, dtype="f8"), np.asarray(b, dtype="f8")
    if a.shape != b.shape:
        return float("inf")
    both = np.isfinite(a) & np.isfinite(b)
    if not both.any():
        return float("inf")
    return float(np.max(np.abs(a[both] - b[both])))
