"""Host-side bin helpers for the survey path, in numpy without pandas.

Counterparts of ``echopype_tpu/commongrid/utils.py::_parse_x_bin`` and
``::ping_time_bin_edges``.  The GPU machine has no pandas, so the ping-time
edges reproduce pandas' ``resample`` (default ``origin="start_day"``,
``closed="left"``) in integer nanoseconds for fixed-length bins.
"""

from __future__ import annotations

import re
from fractions import Fraction

import numpy as np

__all__ = ["_parse_x_bin", "ping_time_bin_edges"]

_RANGE_BIN_PATTERN = r"([\d+]*[.,]{0,1}[\d+]*)(\s+)?(m)"

# fixed-length pandas offset aliases -> nanoseconds
_TIME_UNIT_NS = {
    "ns": 1,
    "us": 1_000,
    "ms": 1_000_000,
    "s": 1_000_000_000,
    "min": 60_000_000_000,
    "h": 3_600_000_000_000,
}
_DAY_NS = 86_400_000_000_000


def _parse_x_bin(x_bin: str) -> float:
    """Parse '10m' range-bin strings (reference commongrid/utils.py:305)."""
    if not isinstance(x_bin, str):
        raise TypeError("'x_bin' must be a string")
    m = re.match(_RANGE_BIN_PATTERN, x_bin.strip().lower())
    if m is None:
        raise ValueError("Range bin must be in meters (e.g., '10m').")
    return float(m.group(1))


def _time_bin_ns(ping_time_bin: str) -> int:
    """'20s' / '0.5min' / '2h' -> bin length in integer nanoseconds."""
    m = re.fullmatch(r"\s*(\d*\.?\d*)\s*(ns|us|ms|s|min|h)\s*", ping_time_bin)
    if m is None:
        raise ValueError(
            f"ping_time_bin {ping_time_bin!r}: only fixed-length bins "
            f"({', '.join(_TIME_UNIT_NS)}) are supported"
        )
    value = Fraction(m.group(1)) if m.group(1) not in ("", ".") else Fraction(1)
    ns = value * _TIME_UNIT_NS[m.group(2)]
    if ns.denominator != 1 or ns <= 0:
        raise ValueError(f"ping_time_bin {ping_time_bin!r} is not a whole number of ns")
    return int(ns)


def ping_time_bin_edges(ping_time: np.ndarray, ping_time_bin: str) -> np.ndarray:
    """Bin edges matching pandas resample semantics (commongrid/api.py:117-124).

    Bins are ``[origin + k*freq, origin + (k+1)*freq)`` with the origin at
    midnight of the first timestamp's day; the edges run from the bin that
    holds the first ping through the bin that holds the last, plus the final
    right edge.
    """
    freq = _time_bin_ns(ping_time_bin)
    t = np.asarray(ping_time, dtype="datetime64[ns]").astype("i8")
    first, last = int(t.min()), int(t.max())
    origin = first - first % _DAY_NS
    start = first - (first - origin) % freq
    n_bins = (last - start) // freq + 1
    edges = start + freq * np.arange(n_bins + 1, dtype="i8")
    return edges.astype("datetime64[ns]")
