"""Blackwell (2019) seafloor detection from Sv + split-beam angles.

Capability parity: echopype/mask/seafloor_detection/bottom_blackwell.py:10 —
smooth angles with square mean kernels, build an angle-activity mask, derive
an adaptive Sv threshold from the angle-masked Sv median, keep connected
Sv components intersecting the angle mask, bottom = first masked sample.
"""

from __future__ import annotations

import numpy as np
from scipy.ndimage import generate_binary_structure, label
from scipy.signal import convolve2d

from ...utils.compute import _lin2log, _log2lin
from ...xrlite import DataArray

__all__ = ["bottom_blackwell"]


def _parse_blackwell_thresholds(threshold):
    if isinstance(threshold, (tuple, list)):
        if len(threshold) != 3:
            raise ValueError("threshold must be a float or (tSv, ttheta, tphi)")
        return float(threshold[0]), float(threshold[1]), float(threshold[2])
    return float(threshold), 702.0, 282.0  # echopy defaults


def bottom_blackwell(
    ds,
    var_name: str = "Sv",
    channel: str = None,
    threshold=-75.0,
    r0: float = 10.0,
    r1: float = 1000.0,
    offset: float = 0.0,
    wtheta: int = 28,
    wphi: int = 52,
) -> DataArray:
    for v in ("angle_alongship", "angle_athwartship"):
        if v not in ds:
            raise ValueError(f"blackwell detection requires {v} in the dataset")
    tSv, ttheta, tphi = _parse_blackwell_thresholds(threshold)

    sv_da = ds[var_name]
    depth_name = "depth" if "depth" in ds else "echo_range"
    depth = ds[depth_name]
    theta = ds["angle_alongship"]
    phi = ds["angle_athwartship"]
    if "channel" in sv_da.dims:
        sv_da = sv_da.sel(channel=channel)
        theta = theta.sel(channel=channel)
        phi = phi.sel(channel=channel)
        if "channel" in depth.dims:
            depth = depth.sel(channel=channel)

    # (range, ping) layout like echopy
    sv = np.asarray(sv_da.values, dtype="f8").T
    th = np.asarray(theta.values, dtype="f8").T
    ph = np.asarray(phi.values, dtype="f8").T
    r = np.asarray(depth.values, dtype="f8")
    if r.ndim == 2:
        r = r[0]

    r0_idx = int(np.nanargmin(np.abs(r - r0)))
    r1_idx = int(np.nanargmin(np.abs(r - r1))) + 1

    sv_chunk = sv[r0_idx:r1_idx]
    th_chunk = th[r0_idx:r1_idx]
    ph_chunk = ph[r0_idx:r1_idx]

    ktheta = np.ones((wtheta, wtheta)) / wtheta**2
    kphi = np.ones((wphi, wphi)) / wphi**2
    th_mask = convolve2d(th_chunk, ktheta, "same", boundary="symm") ** 2 > ttheta
    ph_mask = convolve2d(ph_chunk, kphi, "same", boundary="symm") ** 2 > tphi
    angle_mask = th_mask | ph_mask

    if angle_mask.any():
        sv_median = float(_lin2log(np.nanmedian(_log2lin(sv_chunk[angle_mask]))))
        if np.isnan(sv_median):
            sv_median = np.inf
        sv_median = max(sv_median, tSv)
        sv_mask = sv_chunk > sv_median
        items = label(sv_mask, generate_binary_structure(2, 2))[0]
        intercepted = set(items[angle_mask].tolist()) - {0}
        mask_chunk = np.isin(items, list(intercepted))
        above = np.zeros((r0_idx, mask_chunk.shape[1]), dtype=bool)
        below = np.zeros((len(r) - r1_idx, mask_chunk.shape[1]), dtype=bool)
        mask = np.concatenate([above, mask_chunk, below], axis=0)
    else:
        mask = np.zeros_like(sv, dtype=bool)

    bottom_idx = mask.argmax(axis=0)
    bottom_depth = r[bottom_idx] - offset

    return DataArray(
        bottom_depth,
        ("ping_time",),
        coords={"ping_time": ds.coords["ping_time"]},
        attrs={
            "detector": "blackwell",
            "threshold_Sv": float(tSv),
            "threshold_angle_major": float(ttheta),
            "threshold_angle_minor": float(tphi),
            "offset_m": float(offset),
            "channel": str(channel),
        },
        name="bottom_depth",
    )
