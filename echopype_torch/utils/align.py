"""Align a time-indexed parameter onto ping_time.

Capability parity: echopype/utils/align.py:5-61 — rename if equal, broadcast
single values, NaN if empty, otherwise interpolate with extrapolation.
"""

import numpy as np

from ..xrlite import DataArray

__all__ = ["align_to_ping_time"]


def align_to_ping_time(da: DataArray, time_name: str, ping_time: DataArray, method="linear"):
    """Interpolate ``da`` (indexed by ``time_name``) onto ``ping_time``."""
    pt = ping_time.values if isinstance(ping_time, DataArray) else np.asarray(ping_time)
    src_time = da.coords[time_name].values

    if len(src_time) == len(pt) and np.array_equal(src_time, pt):
        out = da.rename({time_name: "ping_time"})
        return out
    if len(src_time) == 1:
        vals = np.broadcast_to(
            np.take(da.values, 0, axis=da.dims.index(time_name)), _target_shape(da, time_name, pt)
        ).copy()
        return _rewrap(da, time_name, pt, vals)
    if len(src_time) == 0:
        vals = np.full(_target_shape(da, time_name, pt), np.nan)
        return _rewrap(da, time_name, pt, vals)
    if method == "nearest":
        src = src_time.astype("datetime64[ns]").astype("f8")
        tgt = np.asarray(pt).astype("datetime64[ns]").astype("f8")
        idx = np.argmin(np.abs(src[None, :] - tgt[:, None]), axis=1)
        ax = da.dims.index(time_name)
        vals = np.take(da.values, idx, axis=ax)
        return _rewrap(da, time_name, pt, vals)
    return da.interp(
        {time_name: pt}, method=method, kwargs={"fill_value": "extrapolate"}
    ).rename({time_name: "ping_time"})


def _target_shape(da, time_name, pt):
    return tuple(len(pt) if d == time_name else n for d, n in zip(da.dims, da.shape))


def _rewrap(da, time_name, pt, vals):
    dims = tuple("ping_time" if d == time_name else d for d in da.dims)
    out = DataArray(vals, dims, attrs=da.attrs, name=da.name)
    for k, v in da.coords.items():
        if time_name not in v.dims and k != time_name:
            out.coords[k] = v
    out.coords["ping_time"] = DataArray(np.asarray(pt), ("ping_time",), name="ping_time")
    return out
