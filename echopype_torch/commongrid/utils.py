"""Host-side commongrid helpers, in numpy without pandas.

Counterpart of ``echopype_tpu/commongrid/utils.py`` (which imports pandas,
so its helpers are copied here, not imported): bin-string parsing, the
ping-time bin edges, along-track distance, position reduction, the
flox fill semantics of the dB conversion, and the raw MVBS / NASC entry
points on caller-provided bins.  The GPU machine has no pandas,
so the ping-time edges reproduce pandas' ``resample`` (default
``origin="start_day"``, ``closed="left"``) in integer nanoseconds, and
:func:`parse_time_bin_to_value_unit` reproduces ``pd.Timedelta``'s
resolution, both for fixed-length bins.
"""

from __future__ import annotations

import re
from fractions import Fraction

import numpy as np

from ..device import device_name, resolve_device
from ..ops import binning
from ..utils.compute import _lin2log
from ..utils.geodesy import pairwise_distance_nmi
from ..xrlite import Dataset

__all__ = [
    "POSITION_VARIABLES",
    "X_BIN_MAP",
    "_binned_mean_to_db",
    "_interval_edges",
    "_parse_x_bin",
    "_setup_and_validate",
    "assign_actual_range",
    "compute_raw_MVBS",
    "compute_raw_NASC",
    "get_distance_from_latlon",
    "get_reduced_positions",
    "parse_time_bin_to_value_unit",
    "ping_time_bin_edges",
]

POSITION_VARIABLES = ("latitude", "longitude")

X_BIN_MAP = {
    "range_bin": {
        "name": "Range bin",
        "unit": "m",
        "ex": "10m",
        "unit_label": "meters",
        "pattern": r"([\d+]*[.,]{0,1}[\d+]*)(\s+)?(m)",
    },
    "dist_bin": {
        "name": "Distance bin",
        "unit": "nmi",
        "ex": "0.5nmi",
        "unit_label": "nautical miles",
        "pattern": r"([\d+]*[.,]{0,1}[\d+]*)(\s+)?(nmi)",
    },
}

# fixed-length pandas offset aliases -> nanoseconds
_TIME_UNIT_NS = {
    "ns": 1,
    "us": 1_000,
    "ms": 1_000_000,
    "s": 1_000_000_000,
    "min": 60_000_000_000,
    "h": 3_600_000_000_000,
    "D": 86_400_000_000_000,  # a fixed 24 h, as pandas' Day tick
}
_DAY_NS = _TIME_UNIT_NS["D"]


def _parse_x_bin(x_bin: str, x_label="range_bin") -> float:
    """Parse '10m' / '0.5nmi' strings (reference commongrid/utils.py:305)."""
    info = X_BIN_MAP.get(x_label)
    if info is None:
        raise KeyError(f"x_label must be one of {list(X_BIN_MAP)}")
    if not isinstance(x_bin, str):
        raise TypeError("'x_bin' must be a string")
    m = re.match(info["pattern"], x_bin.strip().lower())
    if m is None:
        raise ValueError(
            f"{info['name']} must be in {info['unit_label']} (e.g., '{info['ex']}')."
        )
    return float(m.group(1))


def _setup_and_validate(ds_Sv: Dataset, range_var: str, range_bin: str, closed: str):
    if range_var not in ("echo_range", "depth"):
        raise ValueError("range_var must be one of 'echo_range' or 'depth'.")
    if range_var not in ds_Sv:
        raise ValueError(f"range_var '{range_var}' does not exist in the input dataset.")
    if closed not in ("left", "right"):
        raise ValueError(f"{closed} is not a valid option. Options are 'left' or 'right'.")
    return ds_Sv, _parse_x_bin(range_bin, "range_bin")


def _time_bin_ns(ping_time_bin: str) -> int:
    """'20s' / '0.5min' / '2h' / '1D' -> bin length in integer nanoseconds."""
    m = re.fullmatch(r"\s*(\d*\.?\d*)\s*(ns|us|ms|s|min|h|D)\s*", ping_time_bin)
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


# pandas Timedelta.resolution_string is the finest unit with a non-zero
# component: (that component's period, the unit counted, its label), finest
# first.  The us and ns resolutions deliberately count whole milliseconds,
# as the reference's timedelta_units map does (commongrid/utils.py:654-698).
_RESOLUTIONS = (
    (1_000, 1_000_000, "millisecond"),  # "ns"
    (1_000_000, 1_000_000, "millisecond"),  # "us"
    (1_000_000_000, 1_000_000, "millisecond"),  # "ms"
    (60_000_000_000, 1_000_000_000, "second"),  # "s"
    (3_600_000_000_000, 60_000_000_000, "minute"),  # "min"
    (_DAY_NS, 3_600_000_000_000, "hour"),  # "h"
)


def parse_time_bin_to_value_unit(ping_time_bin: str):
    """'20s' -> (20, 'second'), for cell_methods attrs, without pandas.

    The reference counts whole units of ``pd.Timedelta(bin)``'s resolution:
    ``'0.5min'`` -> (30, 'second'), ``'90min'`` -> (90, 'minute'),
    ``'24h'`` -> (1, 'day'), and a bin with a sub-millisecond part in whole
    milliseconds (``'1500us'`` -> (1, 'millisecond')).
    """
    ns = _time_bin_ns(ping_time_bin)
    for period, unit, label in _RESOLUTIONS:
        if ns % period:
            return ns // unit, label
    return ns // _DAY_NS, "day"


def get_distance_from_latlon(ds_Sv: Dataset) -> np.ndarray:
    """Cumulative along-track distance [nmi] per ping (utils.py:210-231).

    Consecutive-segment geodesic distances -> cumulative sum -> ffill/bfill,
    replicating the reference's pandas shift(-1)/cumsum/ffill/bfill.
    """
    lat = np.asarray(ds_Sv["latitude"].values, dtype="f8")
    lon = np.asarray(ds_Sv["longitude"].values, dtype="f8")
    if not (~(np.isnan(lat) | np.isnan(lon))).any():
        raise ValueError("All lat/lon entries are NaN!")
    seg = pairwise_distance_nmi(lat, lon)  # seg[i] = dist(p_i, p_{i+1}); NaN-poisoned
    valid_seg = ~np.isnan(seg)
    dist = np.full(len(lat), np.nan)
    dist[valid_seg] = np.cumsum(seg[valid_seg])
    return _ffill_bfill(dist)


def _ffill_bfill(x: np.ndarray) -> np.ndarray:
    x = x.copy()
    mask = np.isnan(x)
    idx = np.where(~mask, np.arange(len(x)), 0)
    np.maximum.accumulate(idx, out=idx)
    x = x[idx]
    mask = np.isnan(x)
    if mask.any() and (~mask).any():
        first_valid = np.argmax(~mask)
        x[:first_valid] = x[first_valid]
    return x


def get_reduced_positions(ds_Sv, ds_X, x_dim, x_idx, n_x):
    """Mean lat/lon per x bin attached to the output (utils.py:453-501).

    Host float64 bincount: positions need ~1e-6 deg (the geospatial attrs
    round to 1e-5), which a float32 device reduction cannot hold.
    """
    if all(v in ds_Sv for v in POSITION_VARIABLES):
        x_idx = np.asarray(x_idx)
        for var in POSITION_VARIABLES:
            v = np.asarray(ds_Sv[var].values, dtype="f8")
            ok = (x_idx >= 0) & np.isfinite(v)
            sums = np.bincount(x_idx[ok], weights=v[ok], minlength=n_x)
            cnts = np.bincount(x_idx[ok], minlength=n_x)
            with np.errstate(invalid="ignore", divide="ignore"):
                vals = sums / np.where(cnts > 0, cnts, np.nan)
            ds_X[var] = ((x_dim,), vals, dict(ds_Sv[var].attrs))
    return ds_X


def ping_time_bin_parsing_and_conversion(ping_time_bin: str):
    """Reference-named alias of parse_time_bin_to_value_unit
    (reference: commongrid/utils.py:654-698)."""
    return parse_time_bin_to_value_unit(ping_time_bin)


def assign_actual_range(ds_MVBS: Dataset) -> Dataset:
    """Attach the Sv 'actual_range' attribute (reference commongrid/utils.py:631-651)."""
    sv = np.asarray(ds_MVBS["Sv"].values, dtype="f8")
    actual_range = [round(float(np.nanmin(sv)), 2), round(float(np.nanmax(sv)), 2)]
    return ds_MVBS.assign_attrs({"actual_range": actual_range})


def _binned_mean_to_db(sums, counts, nan_counts, fill_value):
    """Linear bin sums/counts -> dB, with flox's fill semantics.

    flox fills bins with nothing aggregated, in the linear domain, before
    the dB conversion (reference commongrid/utils.py:76-92): a non-positive
    fill comes out NaN in dB, ``fill_value=None`` means NaN, and a bin whose
    members are all NaN (``skipna=False``) was aggregated and stays NaN.
    Only bins with counts == 0 and nan_counts == 0 take the fill.
    """
    with np.errstate(invalid="ignore", divide="ignore"):
        good = (counts > 0) & (nan_counts == 0)
        linear = np.where(good, sums / np.where(counts > 0, counts, 1), np.nan)
        if fill_value is not None and not np.isnan(fill_value):
            linear = np.where((counts == 0) & (nan_counts == 0), fill_value, linear)
        return _lin2log(linear)


def _interval_edges(interval):
    """(edges, closed) from an interval index or a 1-D edge array.

    An interval index (anything with ``.left``, ``.right`` and ``.closed``,
    such as pandas' ``IntervalIndex``; read by duck typing, so pandas is not
    needed) carries its own closed side; plain edge arrays default to the
    reference's 'left'.
    """
    if all(hasattr(interval, a) for a in ("left", "right", "closed")):
        closed = interval.closed if interval.closed in ("left", "right") else "left"
        return np.append(np.asarray(interval.left), np.asarray(interval.right)[-1]), closed
    return np.asarray(interval), "left"


def compute_raw_MVBS(
    ds_Sv: Dataset,
    range_interval,
    ping_interval,
    range_var: str = "echo_range",
    method="map-reduce",
    reindex=False,
    skipna=True,
    fill_value=np.nan,
    device="cuda",
    **kwargs,
):
    """Raw (unformatted) MVBS on caller-provided bins, in dB.

    Reference commongrid/utils.py:17-94: output dims are ``(dim0,
    ping_time_bins, {range_var}_bins)`` with the bins' left edges as coords.
    Takes interval indexes or 1-D edge arrays; the bin sums run on
    ``device`` ("cuda" by default, "cpu" for the plain PyTorch path), which
    ``attrs["device"]`` names.
    """
    dev = resolve_device(device)
    range_edges, closed_r = _interval_edges(range_interval)
    range_edges = range_edges.astype("f8")
    ping_edges_raw, closed_p = _interval_edges(ping_interval)
    ping_edges = np.asarray(ping_edges_raw, dtype="datetime64[ns]")
    ping_time = np.asarray(ds_Sv.coords["ping_time"].values, dtype="datetime64[ns]")
    sv = np.asarray(ds_Sv["Sv"].values, dtype="f4")
    er = np.asarray(ds_Sv[range_var].values, dtype="f8")
    if er.shape != sv.shape:
        er = np.broadcast_to(er, sv.shape)
    x_bounds = binning.x_bounds_np(ping_time.astype("i8"), ping_edges.astype("i8"), closed_p)
    sums, counts, nan_w = binning.windowed_partials_np(
        sv, er, range_edges, x_bounds, skipna=bool(skipna), closed=closed_r, device=dev,
    )
    mvbs = _binned_mean_to_db(sums, counts, nan_w, fill_value)
    dim0 = ds_Sv["Sv"].dims[0]
    out = Dataset(
        coords={
            dim0: ds_Sv.coords[dim0],
            "ping_time_bins": ping_edges[:-1],
            f"{range_var}_bins": range_edges[:-1],
        }
    )
    out["Sv"] = ((dim0, "ping_time_bins", f"{range_var}_bins"), mvbs)
    out.attrs["device"] = device_name(dev)
    return out


def compute_raw_NASC(
    ds_Sv: Dataset,
    range_interval,
    dist_interval,
    method="map-reduce",
    skipna=True,
    device="cuda",
    **kwargs,
):
    """Raw (unformatted) NASC on caller-provided bins.

    Reference commongrid/utils.py:97-207.  ``ds_Sv`` carries ``depth`` and
    a ``distance_nmi`` variable along the ping dim (compute_NASC derives it
    from lat/lon); the output holds ``sv`` (= NASC) and the mean
    ``ping_time`` of each distance bin.  The bin sums run on ``device``,
    which ``attrs["device"]`` names.
    """
    dev = resolve_device(device)
    depth_edges, closed_r = _interval_edges(range_interval)
    depth_edges = depth_edges.astype("f8")
    dist_edges, closed_x = _interval_edges(dist_interval)
    dist_edges = dist_edges.astype("f8")
    dist = np.asarray(ds_Sv["distance_nmi"].values, dtype="f8")
    sv = np.asarray(ds_Sv["Sv"].values, dtype="f4")
    depth = np.asarray(ds_Sv["depth"].values, dtype="f8")
    if depth.shape != sv.shape:
        depth = np.broadcast_to(depth, sv.shape)
    n_x = len(dist_edges) - 1
    x_bounds = binning.x_bounds_np(dist, dist_edges, closed_x)
    x_idx = binning.bin_index_np(dist, dist_edges, closed_x)
    sums, counts, nan_w = binning.windowed_partials_np(
        sv, depth, depth_edges, x_bounds, skipna=bool(skipna), closed=closed_r, device=dev,
    )
    with np.errstate(invalid="ignore", divide="ignore"):
        good = (counts > 0) & (nan_w == 0)
        sv_mean = np.where(good, sums / np.where(counts > 0, counts, 1), np.nan)
    ddepth = np.diff(depth, axis=2).astype("f4")
    h_num = binning.windowed_sum_raw_np(
        ddepth, depth[:, :, :-1], depth_edges, x_bounds, closed=closed_r, device=dev,
    )
    denom = np.bincount(x_idx[x_idx >= 0], minlength=n_x).astype("f8")
    with np.errstate(invalid="ignore", divide="ignore"):
        h_mean = h_num / np.where(denom > 0, denom, np.nan)[None, :, None]
    nasc = sv_mean * h_mean * 4 * np.pi * 1852**2
    pt_ns = np.asarray(ds_Sv.coords["ping_time"].values, dtype="datetime64[ns]").astype("i8")
    in_bin = x_idx >= 0
    pt_rel = (pt_ns - pt_ns[0]).astype("f8")
    pt_sums = np.bincount(x_idx[in_bin], weights=pt_rel[in_bin], minlength=n_x)
    pt_cnts = np.bincount(x_idx[in_bin], minlength=n_x)
    with np.errstate(invalid="ignore", divide="ignore"):
        pt_mean = pt_ns[0] + pt_sums / np.where(pt_cnts > 0, pt_cnts, np.nan)
    pt_out = np.where(
        pt_cnts > 0, pt_mean, float(np.datetime64("NaT", "ns").astype("i8"))
    ).astype("i8").astype("datetime64[ns]")
    dim0 = ds_Sv["Sv"].dims[0]
    out = Dataset(
        coords={
            dim0: ds_Sv.coords[dim0],
            "distance_nmi_bins": dist_edges[:-1],
            "depth_bins": depth_edges[:-1],
        }
    )
    out["sv"] = ((dim0, "distance_nmi_bins", "depth_bins"), nasc)
    out["ping_time"] = (("distance_nmi_bins",), pt_out)
    out.attrs["device"] = device_name(dev)
    return out
