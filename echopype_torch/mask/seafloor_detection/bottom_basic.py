"""Threshold-based seafloor detection.

Capability parity: echopype/mask/seafloor_detection/bottom_basic.py:10 —
per ping, first range sample (below a surface skip) whose Sv falls inside
the threshold interval; depth minus offset is the bottom line.
"""

from __future__ import annotations

import numpy as np

from ...xrlite import DataArray

__all__ = ["bottom_basic"]


def _validate_threshold(threshold):
    if isinstance(threshold, (tuple, list)):
        tmin, tmax = float(threshold[0]), float(threshold[1])
    else:
        tmin = float(threshold)
        tmax = tmin + 10.0
    if tmin >= tmax:
        raise ValueError("threshold_min must be < threshold_max")
    return tmin, tmax


def _select_channel(ds, var_name, channel):
    sv = ds[var_name]
    depth_name = "depth" if "depth" in ds else "echo_range"
    depth = ds[depth_name]
    if "channel" in sv.dims:
        sv = sv.sel(channel=channel)
        if "channel" in depth.dims:
            depth = depth.sel(channel=channel)
    return sv, depth


def bottom_basic(
    ds,
    var_name: str = "Sv",
    channel: str = None,
    threshold=-50.0,
    offset_m: float = 0.5,
    bin_skip_from_surface: int = 200,
) -> DataArray:
    """1-D bottom depth per ping from a simple Sv threshold crossing."""
    sv_sel, depth_sel = _select_channel(ds, var_name, channel)
    tmin, tmax = _validate_threshold(threshold)

    sv = np.asarray(sv_sel.values, dtype="f8")  # [P, R]
    depth_ref = np.asarray(depth_sel.values, dtype="f8")
    if depth_ref.ndim == 2:
        depth_ref = depth_ref[0]

    sliced = sv[:, bin_skip_from_surface:]
    cond = (sliced > tmin) & (sliced < tmax)
    idx = cond.argmax(axis=1) + bin_skip_from_surface
    bottom_depth = depth_ref[np.clip(idx, 0, len(depth_ref) - 1)] - float(offset_m)

    out = DataArray(
        bottom_depth,
        ("ping_time",),
        coords={"ping_time": ds.coords["ping_time"]},
        attrs={
            "detector": "basic",
            "threshold_min": float(tmin),
            "threshold_max": float(tmax),
            "offset_m": float(offset_m),
            "bin_skip_from_surface": int(bin_skip_from_surface),
            "channel": str(channel),
        },
        name="bottom_depth",
    )
    return out
