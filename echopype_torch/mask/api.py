"""mask: apply masks, frequency differencing, regridding, seafloor & shoal detection.

Capability parity: echopype/mask/api.py:307-996.
"""

from __future__ import annotations

import operator as op
from datetime import datetime, timezone

import numpy as np

from ..commongrid.utils import _parse_x_bin, parse_time_bin_to_value_unit, ping_time_bin_edges
from ..utils.prov import add_processing_level, echopype_prov_attrs, insert_input_processing_level
from ..xrlite import DataArray, Dataset, broadcast_arrays
from .freq_diff import _parse_freq_diff_eq

STR2OPS = {">": op.gt, "<": op.lt, "<=": op.le, ">=": op.ge, "==": op.eq}

__all__ = [
    "apply_mask",
    "frequency_differencing",
    "regrid_mask",
    "detect_seafloor",
    "detect_shoal",
]


def _validate_and_collect_mask_input(mask, storage_options=None):
    masks = mask if isinstance(mask, list) else [mask]
    out = []
    for m in masks:
        if isinstance(m, (str,)):
            from .. import storage

            ds = storage.read_group(m, storage_options=storage_options)
            if len(ds.data_vars) != 1:
                raise ValueError(f"mask store {m} must contain exactly one variable")
            m = next(iter(ds.data_vars.values()))
        if not isinstance(m, DataArray):
            raise TypeError("each mask must be an xrlite DataArray or a store path")
        vals = m.values
        if vals.dtype != bool:
            uniq = np.unique(vals[~np.isnan(vals.astype("f8"))]) if vals.dtype.kind == "f" else np.unique(vals)
            if not np.all(np.isin(uniq, [0, 1])):
                raise ValueError("mask must contain only boolean or 0/1 values")
        out.append(m)
    return out if isinstance(mask, list) else out[0]


@add_processing_level("L3*")
def apply_mask(
    source_ds: Dataset,
    mask,
    var_name: str = "Sv",
    fill_value=np.nan,
    storage_options_ds: dict = {},
    storage_options_mask=None,
) -> Dataset:
    """Apply boolean mask(s) to ``source_ds[var_name]`` (mask/api.py:307-465).

    A list of masks is AND-combined; masks without a channel dim broadcast
    across channels; NaNs in the mask are treated as False.
    """
    from ..utils.io import open_source

    source_ds = open_source(source_ds, "dataset", storage_options=storage_options_ds)
    mask = _validate_and_collect_mask_input(mask, storage_options_mask)
    if var_name not in source_ds.data_vars:
        raise ValueError(f"{var_name} is not a variable in source_ds")
    source_da = source_ds[var_name]

    if isinstance(mask, list):
        combined = mask[0]
        for m in mask[1:]:
            a, b = broadcast_arrays(combined, m)
            combined = DataArray(
                np.logical_and(
                    np.nan_to_num(a.values.astype("f8"), nan=0.0),
                    np.nan_to_num(b.values.astype("f8"), nan=0.0),
                ).astype(bool),
                a.dims,
            )
            combined.coords = a.coords
        final_mask = combined
    else:
        final_mask = mask

    # shape checks (channel rules, mask/api.py:404-432)
    src_chan_shape = (
        source_da.isel(channel=0).shape if "channel" in source_da.dims else source_da.shape
    )
    mask_chan_shape = (
        final_mask.isel(channel=0).shape if "channel" in final_mask.dims else final_mask.shape
    )
    if mask_chan_shape != src_chan_shape:
        raise ValueError(
            f"The final constructed mask is not of the same shape as source_ds[{var_name}] "
            "along the ping_time, and range_sample dimensions!"
        )
    if "channel" in final_mask.dims and "channel" not in source_da.dims:
        raise ValueError(
            "The final constructed mask has the channel dimension, "
            f"so source_ds[{var_name}] must also have the channel dimension."
        )
    if "channel" in final_mask.dims and "channel" in source_da.dims:
        if final_mask.sizes["channel"] != source_da.sizes["channel"]:
            raise ValueError(
                f"If both the final constructed mask and source_ds[{var_name}] "
                "have the channel dimension, that dimension should match between the two."
            )

    mvals = final_mask.values
    if mvals.dtype.kind == "f":
        mvals = np.nan_to_num(mvals, nan=0.0)
    mask_da = DataArray(mvals.astype(bool), final_mask.dims)
    mask_da.coords = dict(final_mask.coords)

    if isinstance(fill_value, DataArray):
        masked = source_da.where(mask_da, fill_value)
    else:
        masked = source_da.where(mask_da, other=fill_value)

    output_ds = source_ds.copy()
    masked = masked.transpose(*source_da.dims)
    output_ds[var_name] = (source_da.dims, masked.values, dict(source_da.attrs))
    output_ds.data_vars[var_name].attrs.update(
        {
            "mask_applied": True,
            "history": f"{datetime.now(timezone.utc).isoformat()} mask applied by mask.apply_mask",
        }
    )
    prov = echopype_prov_attrs("mask")
    prov["mask_function"] = "mask.apply_mask"
    output_ds.attrs.update(prov)
    return insert_input_processing_level(output_ds, input_ds=source_ds)


def frequency_differencing(
    source_Sv: Dataset,
    storage_options=None,
    freqABEq: str = None,
    chanABEq: str = None,
) -> DataArray:
    """dB-differencing mask: Sv(chanA) - Sv(chanB) <op> diff (mask/api.py:467-675)."""
    freqAB, chanAB, operator, diff = _parse_freq_diff_eq(freqABEq, chanABEq)

    from ..utils.io import open_source

    source_Sv = open_source(source_Sv, "dataset", storage_options=storage_options)
    if "channel" not in source_Sv.coords or "frequency_nominal" not in source_Sv:
        raise ValueError(
            "source_Sv must have the channel coordinate and frequency_nominal variable"
        )
    channels = [str(c) for c in source_Sv.coords["channel"].values]
    freqs = np.asarray(source_Sv["frequency_nominal"].values)

    if freqAB is not None:
        for f in freqAB:
            if f not in freqs:
                raise ValueError("freqAB contains values not in frequency_nominal!")
        chanA = channels[int(np.argwhere(freqs == freqAB[0]).ravel()[0])]
        chanB = channels[int(np.argwhere(freqs == freqAB[1]).ravel()[0])]
    else:
        chanA, chanB = chanAB
        for c in (chanA, chanB):
            if c not in channels:
                raise ValueError("chanAB contains values not in the channel coordinate!")

    sv = source_Sv["Sv"]
    ci_a, ci_b = channels.index(chanA), channels.index(chanB)
    ax = sv.dims.index("channel")
    lhs = np.take(sv.values, ci_a, axis=ax) - np.take(sv.values, ci_b, axis=ax)
    mask_vals = STR2OPS[operator](lhs, diff)

    dims = tuple(d for d in sv.dims if d != "channel")
    da = DataArray(mask_vals, dims, name="mask")
    da.coords = {k: v for k, v in sv.coords.items() if "channel" not in v.dims}
    da.attrs = {
        "mask_type": "frequency differencing",
        "history": (
            f"{datetime.now(timezone.utc).isoformat()}. "
            "Mask created by mask.frequency_differencing. "
            f"Operation: Sv['{chanA}'] - Sv['{chanB}'] {operator} {diff}"
        ),
    }
    return da


def regrid_mask(
    mask_da: DataArray,
    range_da: DataArray,
    range_bin: str = "20m",
    ping_time_bin: str = "20s",
    third_dim=None,
    func: str = "logical-AND",
    method: str = "map-reduce",
    reindex: bool = False,
    closed: str = "left",
    range_var_max=None,
    **kwargs,
) -> DataArray:
    """Downsample a boolean mask onto a (ping_time, range) grid
    (mask/api.py:678-866): bin-mean then AND (==1) or OR (!=0).

    The binning core is host-exact f64 elementwise digitize + bincount —
    the reference's flox path digitizes each sample independently in f64,
    so samples whose range value is NaN fall into NO bin and empty bins
    fill 0.  (A searchsorted over range rows would assume monotone rows —
    interior NaN holes break the binary search — and membership in f32
    flips samples within one ulp of a bin edge.)
    """
    if method != "map-reduce" and reindex is not None:
        raise ValueError(
            f"Passing in reindex={reindex} is only allowed when method='map_reduce'."
        )
    if not isinstance(ping_time_bin, str):
        raise TypeError("ping_time_bin must be a string")
    if third_dim is None and len(mask_da.dims) != 2:
        raise ValueError("Mask must have only 2 dimensions unless 'third_dim' is specified.")
    if third_dim is not None and third_dim not in mask_da.dims:
        raise ValueError(f"Mask must contain the specified '{third_dim}' as a dimension.")
    if third_dim is not None and len(mask_da.dims) != 3:
        raise ValueError("Mask must have 3 dimensions when 'third_dim' is specified.")
    if not np.isin(np.asarray(mask_da.values), [1, 0]).all():
        raise ValueError("Mask must be binary True/False or 1/0.")
    if func not in ("logical-AND", "logical-OR"):
        raise ValueError("'func' must be 'logical-AND' or 'logical-OR'.")
    range_bin_m = _parse_x_bin(range_bin)
    rvals = np.asarray(range_da.values, dtype="f8")
    if range_var_max is None:
        range_var_max_v = np.nanmax(rvals)
    else:
        range_var_max_v = _parse_x_bin(str(range_var_max))
    range_var_max_v += 1e-8
    range_edges = np.arange(0, range_var_max_v + range_bin_m, range_bin_m)

    pt = np.asarray(mask_da.coords["ping_time"].values, dtype="datetime64[ns]")
    ping_edges = ping_time_bin_edges(pt, ping_time_bin)

    # normalize to [C?, P, R]
    if third_dim is not None:
        m3 = mask_da.transpose(third_dim, "ping_time", mask_da.dims[-1]).values.astype("f8")
    else:
        m3 = mask_da.values.astype("f8")[None, ...]
    n_x, n_r = len(ping_edges) - 1, len(range_edges) - 1

    # elementwise bin membership, exact in f64 (closed='left': [a, b);
    # closed='right': (a, b]); NaN range values land in no bin
    if rvals.ndim == 1:
        rvals = np.broadcast_to(rvals, (len(pt), rvals.shape[0]))
    elif rvals.ndim == 3:
        # per-channel range grid (e.g. echo_range [channel, ping_time,
        # range_sample]): align its dim order with the transposed mask so
        # rvals[c] pairs with m3[c] (flox broadcasts the by-variable;
        # membership and counts must stay per-channel)
        if third_dim is None:
            raise ValueError(
                "range_da has 3 dimensions but 'third_dim' was not specified."
            )
        rest = [d for d in range_da.dims if d not in (third_dim, "ping_time")]
        rda = range_da.transpose(third_dim, "ping_time", rest[-1])
        rvals = np.asarray(rda.values, dtype="f8")
        # pair by coordinate LABEL, not position (xarray/flox align the
        # by-variable on coords; a channel-sorted mask with unsorted
        # echo_range must not bin against the wrong channel's range grid)
        if third_dim in mask_da.coords and third_dim in rda.coords:
            mc = np.asarray(mask_da.coords[third_dim].values)
            rc = np.asarray(rda.coords[third_dim].values)
            if not np.array_equal(mc, rc):
                order = []
                for v in mc:
                    hit = np.nonzero(rc == v)[0]
                    if hit.size == 0:
                        raise ValueError(
                            f"range_da is missing {third_dim}={v!r} present "
                            "in mask_da; cannot regrid."
                        )
                    order.append(int(hit[0]))
                rvals = rvals[order]
    side = "right" if closed == "left" else "left"
    xi = np.searchsorted(ping_edges.astype("i8"), pt.astype("i8"), side=side) - 1
    in_x = (xi >= 0) & (xi < n_x)

    def _labels_valid(rv2d):
        ri = np.searchsorted(range_edges, rv2d, side=side) - 1  # [P, R]
        in_r = (ri >= 0) & (ri < n_r) & ~np.isnan(rv2d)
        valid = in_r & in_x[:, None]
        return (xi[:, None] * n_r + np.where(in_r, ri, 0))[valid], valid

    C = m3.shape[0]
    sums = np.empty((C, n_x * n_r), dtype="f8")
    if rvals.ndim == 3:
        counts = np.empty((C, n_x * n_r), dtype="f8")
        for c in range(C):
            labels, valid = _labels_valid(rvals[c])
            counts[c] = np.bincount(labels, minlength=n_x * n_r)
            sums[c] = np.bincount(labels, weights=m3[c][valid], minlength=n_x * n_r)
        counts = counts.reshape(C, n_x, n_r)
    else:
        labels, valid = _labels_valid(rvals)
        shared = np.bincount(labels, minlength=n_x * n_r).astype("f8")
        for c in range(C):
            sums[c] = np.bincount(labels, weights=m3[c][valid], minlength=n_x * n_r)
        counts = np.broadcast_to(shared.reshape(1, n_x, n_r), (C, n_x, n_r))
    sums = sums.reshape(C, n_x, n_r)

    # bin-mean then threshold, in exact integer form: mean == 1.0 iff every
    # member is 1 (AND); mean != 0.0 iff any member is 1 (OR); empty bins
    # take the reference's fill_value=0.0 (False on both)
    if func == "logical-AND":
        out_vals = (counts > 0) & (sums == counts)
    else:
        out_vals = sums > 0
    out_vals = out_vals.astype(mask_da.dtype)

    range_name = range_da.name or "depth"
    if third_dim is not None:
        dims = (third_dim, "ping_time", range_name)
        coords = {
            third_dim: mask_da.coords.get(third_dim),
            "ping_time": DataArray(ping_edges[:-1], ("ping_time",)),
            range_name: DataArray(range_edges[:-1], (range_name,)),
        }
        data = out_vals
    else:
        dims = ("ping_time", range_name)
        coords = {
            "ping_time": DataArray(ping_edges[:-1], ("ping_time",)),
            range_name: DataArray(range_edges[:-1], (range_name,)),
        }
        data = out_vals[0]
    out = DataArray(data, dims, name=mask_da.name)
    out.coords = {k: v for k, v in coords.items() if v is not None}
    tval, tlabel = parse_time_bin_to_value_unit(ping_time_bin)
    out.attrs = {
        "cell_methods": (
            f"ping_time: mean (interval: {tval} {tlabel} "
            "comment: ping_time is the interval start) "
            f"{range_name}: mean (interval: {range_bin_m} meter "
            f"comment: {range_name} is the interval start)"
        ),
        "binning_mode": "physical units",
        "range_meter_interval": str(range_bin_m) + "m",
        "ping_time_interval": ping_time_bin,
    }
    return out


def detect_seafloor(ds: Dataset, method: str = "basic", params: dict = None) -> DataArray:
    """Seafloor detection, method in {'basic', 'blackwell'} (mask/api.py:873-966)."""
    from .seafloor_detection import bottom_basic, bottom_blackwell

    methods = {"basic": bottom_basic, "blackwell": bottom_blackwell}
    if method not in methods:
        raise ValueError(f"Unsupported seafloor detection method: {method}")
    return methods[method](ds, **(params or {}))


def detect_shoal(ds: Dataset, method: str = "echoview", params: dict = None) -> DataArray:
    """Shoal detection, method in {'echoview', 'weill'} (mask/api.py:971-996)."""
    from .shoal_detection import shoal_echoview, shoal_weill

    methods = {"echoview": shoal_echoview, "weill": shoal_weill}
    if method not in methods:
        raise ValueError(f"Unsupported shoal detection method: {method}")
    return methods[method](ds, **(params or {}))
