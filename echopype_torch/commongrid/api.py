"""commongrid on Sv datasets: MVBS, index-binned MVBS and NASC.

Counterpart of ``echopype_tpu/commongrid/api.py`` (reference
echopype/commongrid/api.py:31-416): the same arguments, attrs, coords and
provenance, plus ``device=`` ("cuda" by default; "cpu" runs the same torch
ops on the host).  Bin membership resolves on the host in float64
(``ops/binning.py::exact_bin_encode_np``).  ``compute_MVBS`` takes one of
two routes, by what the range variable shows: where every ping shares one
range row (``binning.ping_invariant_row``, exact, NaN holes included; the
instrument norm) it resolves that [C, R] row once and ships only Sv to
``device``, where a per-channel 0/1 matmul against the row bins it; where
the grid varies by ping it resolves every sample of the [C, P, R] range,
as in the JAX package.  Both give the same bits on a ping-invariant grid.
``compute_NASC`` takes the same two routes on its depth grid, for the Sv
sums and for the height sums (on the row, ``binning.windowed_sum_raw_grid_np``:
the row's bin sums times each distance bin's ping count); its counter
``nasc_sample_pings`` counts the pings of the per-sample route, as
``mvbs_pings`` less ``mvbs_grid_pings`` does for ``compute_MVBS``.
The linear-domain bin sums run on ``device`` in float32 for ping-invariant
grids and in float64 for ping-varying ones.
"""

from __future__ import annotations

import warnings

import numpy as np
import torch

from ..device import resolve_device
from ..ops import binning
from ..utils.compute import _lin2log, _log2lin
from ..utils.profiling import count, stage
from ..utils.prov import add_processing_level, echopype_prov_attrs, insert_input_processing_level
from ..xrlite import Dataset
from .utils import (
    _binned_mean_to_db,
    _parse_x_bin,
    _setup_and_validate,
    get_distance_from_latlon,
    get_reduced_positions,
    parse_time_bin_to_value_unit,
    ping_time_bin_edges,
)

__all__ = ["compute_MVBS", "compute_MVBS_index_binning", "compute_NASC", "regrid"]


def _set_MVBS_attrs(ds):
    ds.coords["ping_time"].attrs = {
        "long_name": "Ping time",
        "standard_name": "time",
        "axis": "T",
    }
    ds.data_vars["Sv"].attrs.update(
        {"long_name": "Mean volume backscattering strength (MVBS, mean Sv re 1 m-1)", "units": "dB"}
    )


@add_processing_level("L3*")
def compute_MVBS(
    ds_Sv: Dataset,
    range_var: str = "echo_range",
    range_bin: str = "20m",
    ping_time_bin: str = "20s",
    method: str = "map-reduce",
    reindex: bool = False,
    skipna: bool = True,
    fill_value: float = np.nan,
    closed: str = "left",
    range_var_max=None,
    device="cuda",
    **kwargs,
) -> Dataset:
    """Mean volume backscattering strength on a (ping_time, range) grid.

    Linear-domain mean per bin; output coords are bin left edges
    (reference commongrid/api.py:31-191).  ``method`` and ``reindex`` are
    accepted for the reference's signature and change nothing.  A range
    grid that every ping shares is resolved as one [C, R] row, a grid that
    varies by ping sample by sample (module docstring); the counters
    ``mvbs_pings`` and ``mvbs_grid_pings`` (``utils.profiling.count``) say
    how many pings were binned and how many took the row.
    """
    with stage("mvbs_prepare"):
        dev = resolve_device(device)
        ds_Sv, range_bin_m = _setup_and_validate(ds_Sv, range_var, range_bin, closed)
        if not isinstance(ping_time_bin, str):
            raise TypeError("ping_time_bin must be a string")

        sv = np.asarray(ds_Sv["Sv"].values, dtype="f4")
        # the route, decided exactly on the range variable's own dtype
        row, grid = binning.ping_invariant_row(np.broadcast_to(
            _conform_range(np.asarray(ds_Sv[range_var].values), ds_Sv, range_var, sv.shape),
            sv.shape))
        if grid:  # every range step on the [C, R] row, held as [C, 1, R]
            er = er_b = np.asarray(row, dtype="f8")[:, None, :]
        else:
            er = np.asarray(ds_Sv[range_var].values, dtype="f8")
            er_b = np.broadcast_to(_conform_range(er, ds_Sv, range_var, sv.shape), sv.shape)
        count("mvbs_pings", sv.shape[1])
        count("mvbs_grid_pings", sv.shape[1] if grid else 0)

        if range_var_max is None:
            range_var_max_val = np.nanmax(er)
        else:
            range_var_max_val = _parse_x_bin(str(range_var_max), "range_bin") + 1e-8
        range_edges = np.arange(0, range_var_max_val + range_bin_m, range_bin_m)

        ping_time = np.asarray(ds_Sv.coords["ping_time"].values, dtype="datetime64[ns]")
        ping_edges = ping_time_bin_edges(ping_time, ping_time_bin)
        n_x = len(ping_edges) - 1

        # sorted-contiguous reduction: the ping axis sorted (argsort if not; the
        # row moves with no ping), the range axis increasing (flipped for an
        # upward-looking instrument)
        sv, er_b, order = _sort_ping_axis(sv, er_b, ping_time)
        sv, er_b = _orient_range_axis(sv, er_b)

        pt_sorted = ping_time[order] if order is not None else ping_time
        x_bounds = binning.x_bounds_np(pt_sorted.astype("i8"), ping_edges.astype("i8"), closed)
        # bin membership in the original ping order (for the lat/lon reduction)
        x_idx = binning.bin_index_np(ping_time.astype("i8"), ping_edges.astype("i8"), closed)

    sums_w, counts_w, nan_w = binning.windowed_partials_np(
        sv, er_b, np.asarray(range_edges, dtype="f8"), x_bounds,
        skipna=bool(skipna), closed=closed, device=dev,
    )
    with stage("mvbs_assemble"):
        mvbs = _binned_mean_to_db(sums_w, counts_w, nan_w, fill_value)

        dim_0 = ds_Sv["Sv"].dims[0]
        ds_MVBS = Dataset(
            coords={
                dim_0: ds_Sv.coords[dim_0],
                "ping_time": ping_edges[:-1],
                range_var: range_edges[:-1],
            }
        )
        ds_MVBS["Sv"] = ((dim_0, "ping_time", range_var), mvbs)
        ds_MVBS = get_reduced_positions(ds_Sv, ds_MVBS, "ping_time", x_idx, n_x)

        if range_var == "echo_range" and "water_level" in ds_Sv.data_vars:
            ds_MVBS["water_level"] = ds_Sv["water_level"]

        _set_MVBS_attrs(ds_MVBS)
        ds_MVBS.coords[range_var].attrs = {"long_name": "Range distance", "units": "m"}
        tval, tlabel = parse_time_bin_to_value_unit(ping_time_bin)
        ds_MVBS.data_vars["Sv"].attrs.update(
            {
                "cell_methods": (
                    f"ping_time: mean (interval: {tval} {tlabel} "
                    "comment: ping_time is the interval start) "
                    f"{range_var}: mean (interval: {range_bin_m} meter "
                    f"comment: {range_var} is the interval start)"
                ),
                "binning_mode": "physical units",
                "range_meter_interval": str(range_bin_m) + "m",
                "ping_time_interval": ping_time_bin,
            }
        )
        prov = echopype_prov_attrs("processing")
        prov["processing_function"] = "commongrid.compute_MVBS"
        ds_MVBS.attrs.update(prov)
        if "frequency_nominal" in ds_Sv:
            ds_MVBS["frequency_nominal"] = ds_Sv["frequency_nominal"]
        return insert_input_processing_level(ds_MVBS, input_ds=ds_Sv)


def _sort_ping_axis(sv, er_b, ping_time):
    """Sort along the ping axis if needed; returns (sv, er, order or None).
    A range row ``er_b`` [C, 1, R] is every ping's and stays as it is."""
    pt = ping_time.astype("i8")
    if np.all(np.diff(pt) >= 0):
        return sv, er_b, None
    order = np.argsort(pt, kind="stable")
    return sv[:, order], (er_b if er_b.shape[1] == 1 else er_b[:, order]), order


def _orient_range_axis(sv, er_b):
    """Flip the range axis if the range variable decreases (upward-looking)."""
    d = np.diff(er_b, axis=2)
    if np.nanmean(d) < 0:
        return sv[:, :, ::-1].copy(), er_b[:, :, ::-1].copy()
    return sv, er_b


def _conform_range(er, ds_Sv, range_var, sv_shape):
    """The range variable's values with axes in Sv's dim order (size-1 axes
    where it lacks a dim), ready to broadcast against Sv's [C, P, R]."""
    rv = ds_Sv[range_var]
    sv_dims = ds_Sv["Sv"].dims
    if rv.dims == sv_dims:
        return er
    out = rv.transpose(*[d for d in sv_dims if d in rv.dims]).values
    for i, d in enumerate(sv_dims):
        if d not in rv.dims:
            out = np.expand_dims(out, i)
    return out


@add_processing_level("L3*")
def compute_MVBS_index_binning(ds_Sv: Dataset, range_sample_num: int = 100,
                               ping_num: int = 100, device="cuda"):
    """MVBS by fixed index blocks (coarsen-mean in the linear domain).

    Reference commongrid/api.py:195-266: pad to the block boundary, float64
    linear nanmean per block on ``device``, echo_range as the block minimum.
    """
    dev = resolve_device(device)
    dims = ds_Sv["Sv"].dims
    sv = torch.from_numpy(np.asarray(ds_Sv["Sv"].values, dtype="f8")).to(dev)
    er = torch.from_numpy(np.asarray(ds_Sv["echo_range"].values, dtype="f8")).to(dev)
    C, P, R = sv.shape
    n_pb = -(-P // ping_num)
    n_rb = -(-R // range_sample_num)
    pad = (0, n_rb * range_sample_num - R, 0, n_pb * ping_num - P)
    blocks = (C, n_pb, ping_num, n_rb, range_sample_num)
    lin = _log2lin(torch.nn.functional.pad(sv, pad, value=torch.nan)).reshape(blocks)
    mvbs = _lin2log(torch.nanmean(lin, dim=(2, 4))).cpu().numpy()
    er_pad = torch.nn.functional.pad(er, pad, value=torch.nan).reshape(blocks)
    er_min = torch.where(torch.isnan(er_pad), torch.inf, er_pad).amin(dim=(2, 4))
    er_bin = torch.where(torch.isinf(er_min), torch.nan, er_min).cpu().numpy()

    pt = np.asarray(ds_Sv.coords["ping_time"].values)[::ping_num]
    ds = Dataset(
        coords={
            dims[0]: ds_Sv.coords[dims[0]],
            "ping_time": pt,
            "range_sample": (
                ("range_sample",),
                np.arange(n_rb),
                {"long_name": "Along-range sample number, base 0"},
            ),
        }
    )
    ds["Sv"] = ((dims[0], "ping_time", "range_sample"), mvbs)
    ds["echo_range"] = ((dims[0], "ping_time", "range_sample"), er_bin)
    _set_MVBS_attrs(ds)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", category=RuntimeWarning)
        actual_range = [round(float(np.nanmin(mvbs)), 2), round(float(np.nanmax(mvbs)), 2)]
    ds.data_vars["Sv"].attrs.update(
        {
            "cell_methods": (
                f"ping_time: mean (interval: {ping_num} pings "
                "comment: ping_time is the interval start) "
                f"range_sample: mean (interval: {range_sample_num} samples along range "
                "comment: range_sample is the interval start)"
            ),
            "comment": "MVBS binned on the basis of range_sample and ping number specified as index numbers",  # noqa: E501
            "binning_mode": "sample number",
            "range_sample_interval": f"{range_sample_num} samples along range",
            "ping_interval": f"{ping_num} pings",
            "actual_range": actual_range,
        }
    )
    prov = echopype_prov_attrs("processing")
    prov["processing_function"] = "commongrid.compute_MVBS_index_binning"
    ds.attrs.update(prov)
    if "frequency_nominal" in ds_Sv:
        ds["frequency_nominal"] = ds_Sv["frequency_nominal"]
    return insert_input_processing_level(ds, input_ds=ds_Sv)


@add_processing_level("L4")
def compute_NASC(
    ds_Sv: Dataset,
    range_bin: str = "10m",
    dist_bin: str = "0.5nmi",
    method: str = "map-reduce",
    skipna: bool = True,
    closed: str = "left",
    device="cuda",
    **kwargs,
) -> Dataset:
    """Nautical areal scattering coefficient on a (distance, depth) grid.

    NASC = mean_sv * mean_height * 4 pi 1852^2 per Echoview PRC_NASC
    (reference commongrid/api.py:270-416, utils.py:97-207).  The depth
    grid takes ``compute_MVBS``'s two routes (module docstring): a depth
    row every ping shares resolves on the host in float64 once, as [C, R],
    for the Sv sums and for the height sums, and only Sv goes to
    ``device``; a grid that varies by ping resolves every sample's depth,
    for the Sv sums and again for the height sums.  The bins run on
    ``device``.  Stages (``utils.profiling.stage``): ``nasc_prepare``
    (checks, distance, depth, the route test, edges, orientation, ping
    bins, depth differences) and ``nasc_assemble`` (the product, mean ping
    times and positions, the Dataset), siblings of the binning's own
    ``bin_membership`` and ``bin_device``.  Counters ``nasc_pings`` (pings
    binned) and ``nasc_sample_pings`` (pings whose samples resolve one by
    one: those of a grid that varies by ping).
    """
    with stage("nasc_prepare"):
        dev = resolve_device(device)
        if "depth" not in ds_Sv:
            raise ValueError("Input Sv dataset must contain 'depth' (use consolidate.add_depth)")
        range_bin_m = _parse_x_bin(range_bin, "range_bin")
        if not isinstance(dist_bin, str):
            raise TypeError("dist_bin must be a string")
        dist_bin_nmi = _parse_x_bin(dist_bin, "dist_bin")

        dist_nmi = get_distance_from_latlon(ds_Sv)

        depth = np.asarray(ds_Sv["depth"].values, dtype="f8")
        sv = np.asarray(ds_Sv["Sv"].values, dtype="f4")
        depth_b = np.broadcast_to(_conform_range(depth, ds_Sv, "depth", sv.shape), sv.shape)
        row, grid = binning.ping_invariant_row(depth_b)
        if grid:  # every depth step on the [C, R] row, held as [C, 1, R]
            depth_b = row[:, None, :]
        count("nasc_pings", sv.shape[1])
        count("nasc_sample_pings", 0 if grid else sv.shape[1])

        dist_edges = np.arange(0, np.nanmax(dist_nmi) + dist_bin_nmi, dist_bin_nmi)
        depth_edges = np.arange(0, np.nanmax(depth_b) + range_bin_m, range_bin_m)
        n_x = len(dist_edges) - 1

        # cumulative distance is non-decreasing: a sorted-contiguous reduction
        sv, depth_b = _orient_range_axis(sv, depth_b)
        x_bounds = binning.x_bounds_np(dist_nmi, dist_edges, closed)
        x_idx = binning.bin_index_np(dist_nmi, dist_edges, closed)
        edges_f8 = np.asarray(depth_edges, dtype="f8")
        # mean height per (channel, dist, depth) bin: the depth first-differences
        # summed over the bin / the pings in the distance bin (utils.py:160-201)
        ddepth = np.diff(depth_b, axis=2).astype("f4")  # label=lower -> leading bins

    # a [C, 1, R] depth row goes on to the row twins (ops/binning.py, *_grid_np)
    sums, counts, nan_counts = binning.windowed_partials_np(
        sv, depth_b, edges_f8, x_bounds, skipna=bool(skipna), closed=closed, device=dev
    )
    h_num = binning.windowed_sum_raw_np(
        ddepth, depth_b[:, :, :-1], edges_f8, x_bounds, closed=closed, device=dev
    )
    with stage("nasc_assemble"):
        with np.errstate(invalid="ignore", divide="ignore"):
            good = (counts > 0) & (nan_counts == 0)
            sv_mean = np.where(good, sums / np.where(counts > 0, counts, 1), np.nan)
        denom = np.bincount(x_idx[x_idx >= 0], minlength=n_x).astype("f8")
        with np.errstate(invalid="ignore", divide="ignore"):
            h_mean = h_num / np.where(denom > 0, denom, np.nan)[None, :, None]

        nasc = sv_mean * h_mean * 4 * np.pi * 1852**2

        # mean ping_time per distance bin, host float64 on t0-relative ns
        pt_ns = np.asarray(ds_Sv.coords["ping_time"].values, dtype="datetime64[ns]").astype("i8")
        in_bin = x_idx >= 0
        pt_rel = (pt_ns - pt_ns[0]).astype("f8")
        pt_sums = np.bincount(x_idx[in_bin], weights=pt_rel[in_bin], minlength=n_x)
        pt_cnts = np.bincount(x_idx[in_bin], minlength=n_x)
        with np.errstate(invalid="ignore", divide="ignore"):
            pt_mean = pt_ns[0] + pt_sums / np.where(pt_cnts > 0, pt_cnts, np.nan)
        ping_time_out = np.where(pt_cnts > 0, pt_mean, np.datetime64("NaT", "ns").astype("i8"))

        dim_0 = ds_Sv["Sv"].dims[0]
        ds_NASC = Dataset(
            coords={
                dim_0: ds_Sv.coords[dim_0],
                "distance": dist_edges[:-1],
                "depth": depth_edges[:-1],
            }
        )
        ds_NASC["NASC"] = (
            (dim_0, "distance", "depth"),
            nasc,
            {"long_name": "Nautical Areal Scattering Coefficient (NASC, m2 nmi-2)",
             "units": "m2 nmi-2"},
        )
        ds_NASC["ping_time"] = (
            ("distance",),
            ping_time_out.astype("i8").astype("datetime64[ns]"),
            {"long_name": "Mean ping time in distance bin"},
        )
        ds_NASC = get_reduced_positions(ds_Sv, ds_NASC, "distance", x_idx, n_x)
        if "frequency_nominal" in ds_Sv:
            ds_NASC["frequency_nominal"] = ds_Sv["frequency_nominal"]

        ds_NASC.coords["distance"].attrs = {"long_name": "Cumulative distance", "units": "nmi"}
        ds_NASC.coords["depth"].attrs = {"long_name": "Cell depth", "units": "m"}
        # ACDD bounding box from the input per-ping positions, not the bin-reduced
        # ones (reference api.py:404-414 reads ds_Sv lat/lon)
        ds_NASC.attrs["Conventions"] = "CF-1.7,ACDD-1.3"
        pt_in = np.asarray(ds_Sv.coords["ping_time"].values, dtype="datetime64[ns]")
        pt_ok = pt_in[~np.isnat(pt_in)]
        if pt_ok.size:
            ds_NASC.attrs["time_coverage_start"] = np.datetime_as_string(pt_ok.min(),
                                                                         timezone="UTC")
            ds_NASC.attrs["time_coverage_end"] = np.datetime_as_string(pt_ok.max(),
                                                                       timezone="UTC")
        if "latitude" in ds_Sv and "longitude" in ds_Sv:
            lat = np.asarray(ds_Sv["latitude"].values, dtype="f8")
            lon = np.asarray(ds_Sv["longitude"].values, dtype="f8")
            if np.isfinite(lat).any():
                ds_NASC.attrs.update(
                    {
                        "geospatial_lat_min": round(float(np.nanmin(lat)), 5),
                        "geospatial_lat_max": round(float(np.nanmax(lat)), 5),
                        "geospatial_lon_min": round(float(np.nanmin(lon)), 5),
                        "geospatial_lon_max": round(float(np.nanmax(lon)), 5),
                    }
                )
        prov = echopype_prov_attrs("processing")
        prov["processing_function"] = "commongrid.compute_NASC"
        ds_NASC.attrs.update(prov)
        return insert_input_processing_level(ds_NASC, input_ds=ds_Sv)


def regrid():
    """Placeholder mirroring the reference's stub (commongrid/api.py:419)."""
    return 1
