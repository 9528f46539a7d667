"""Time-coordinate QC: detect and repair reversed timestamps.

Capability parity: echopype/qc/api.py:12-110 — reversed ping times are
replaced using the median pinging interval of a local window, preserving
subsequent intervals while enforcing monotonicity.
"""

from __future__ import annotations

import numpy as np

from ..utils.log import _init_logger
from ..xrlite import DataArray, Dataset

logger = _init_logger(__name__)

__all__ = ["coerce_increasing_time", "exist_reversed_time", "_clean_reversed"]


def _clean_reversed(time_old: np.ndarray, win_len: int) -> np.ndarray:
    time_old = np.asarray(time_old, dtype="datetime64[ns]")
    diffs = np.diff(time_old)
    neg_idx = np.argwhere(diffs < np.timedelta64(0, "ns")).flatten()
    if len(neg_idx) == 0:
        return time_old
    # A reversal at the VERY FIRST interval has no prior window — the
    # reference's _clean_reversed (qc/api.py:23) raises IndexError there, so
    # that whole regime's semantics are ours to define.  In it we use a
    # ROBUST repair: each reversed interval takes the median of the
    # NONNEGATIVE diffs around it (prior window, then forward window, then
    # whole array, else 0) — every replacement is nonnegative, so the
    # repaired axis is guaranteed monotone (the plain prior-window median
    # can itself be negative when reversals dominate the window, silently
    # re-corrupting the axis — review finding).  Outside the crash regime
    # the reference's exact algorithm runs, quirks included, for parity.
    robust = neg_idx[0] == 0
    zero = np.timedelta64(0, "ns")
    new_diff = []
    for ni in neg_idx:
        local = ni + np.arange(-win_len, 0)
        local = local[local >= 0]
        if not robust:
            new_diff.append(
                np.median(diffs[local].astype("i8")).astype("timedelta64[ns]")
            )
            continue
        ok = diffs[local]
        ok = ok[ok >= zero]
        if ok.size == 0:
            fwd = diffs[ni + 1 : ni + 1 + win_len]
            ok = fwd[fwd >= zero]
        if ok.size == 0:
            ok = diffs[diffs >= zero]
        med = np.median(ok.astype("i8")) if ok.size else 0.0
        new_diff.append(np.timedelta64(int(med), "ns"))
    diffs[neg_idx] = new_diff
    c_diff = np.cumsum(diffs[neg_idx[0] :])
    new_time = time_old.copy()
    new_time[neg_idx[0] + 1 :] = new_time[neg_idx[0]] + c_diff
    return new_time


def coerce_increasing_time(ds: Dataset, time_name: str = "ping_time", win_len: int = 100):
    """Coerce a time coordinate to flow forward (modifies ``ds`` in place)."""
    da = ds.coords[time_name] if time_name in ds.coords else ds[time_name]
    fixed = _clean_reversed(da.values, win_len)
    if time_name in ds.coords:
        ds.coords[time_name] = DataArray(fixed, da.dims, attrs=da.attrs, name=time_name)
    else:
        ds[time_name] = (da.dims, fixed, da.attrs)
    return ds


def exist_reversed_time(ds, time_name: str) -> bool:
    """True if the named time coordinate goes backward anywhere."""
    da = ds.coords[time_name] if time_name in getattr(ds, "coords", {}) else ds[time_name]
    return bool((np.diff(np.asarray(da.values, dtype="datetime64[ns]")) < np.timedelta64(0, "ns")).any())


def orchestrate_reverse_time_check(
    ed_comb,
    zarr_store=None,
    possible_time_dims=None,
    storage_options=None,
    consolidated: bool = True,
):
    """Check every group's time dims; repair reversals, record the originals
    in the Provenance group, and mirror the updates into ``zarr_store``
    (reference qc/api.py:174-267).

    Sets the Provenance attribute ``reversed_ping_times`` to 1 when any
    reversal was corrected (0 otherwise); the uncorrected times are stored
    as ``<group>_old_<time>`` arrays.  ``Platform/NMEA`` is skipped like the
    reference (non-GPS NMEA timestamps are routinely unordered).  Unlike the
    reference's literal code — whose store write re-reads the tree and so
    persists the *uncorrected* time — the corrected time is written.

    Modifies ``ed_comb`` in place and returns it.
    """
    if possible_time_dims is None:
        from ..echodata.combine import POSSIBLE_TIME_DIMS as possible_time_dims

    if zarr_store is not None:
        from ..xrlite.datatree import dataset_to_zarr

    prov = ed_comb["Provenance"]
    prov.attrs["reversed_ping_times"] = 0
    if zarr_store is not None:
        only_attrs_ds = Dataset(attrs=prov.attrs)
        dataset_to_zarr(
            only_attrs_ds, zarr_store, group="Provenance", mode="a",
            storage_options=storage_options, consolidated=consolidated,
        )

    for group in ed_comb.group_paths:
        if group == "Platform/NMEA":
            continue
        group_ds = ed_comb[group]
        time_dims = set(group_ds.dims).intersection(possible_time_dims)
        for time in sorted(time_dims):
            old_time = check_and_correct_reversed_time(
                combined_group=group_ds, time_str=time, ed_group=group
            )
            if old_time is None:
                continue
            old_time_array = create_old_time_array(group, old_time)
            prov[old_time_array.name] = old_time_array
            prov.attrs["reversed_ping_times"] = 1
            if zarr_store is not None:
                old_time_ds = old_time_array.to_dataset()
                old_time_ds.attrs = prov.attrs
                dataset_to_zarr(
                    old_time_ds, zarr_store, group="Provenance", mode="a",
                    storage_options=storage_options, consolidated=consolidated,
                )
                dataset_to_zarr(
                    group_ds[[time]] if time in group_ds.data_vars
                    else Dataset(coords={time: group_ds.coords[time]}),
                    zarr_store, group=group, mode="r+",
                    storage_options=storage_options, consolidated=consolidated,
                )
    return ed_comb


def check_and_correct_reversed_time(combined_group, time_str: str, ed_group: str):
    """Check a combined group's time coordinate; coerce in place if reversed.

    Returns the pre-correction time as a DataArray when coercion happened,
    else None (reference: qc/api.py:88-129).
    """
    if time_str in combined_group and exist_reversed_time(combined_group, time_str):
        logger.warning(
            f"{ed_group} {time_str} reversal detected; {time_str} will be corrected"
        )
        old_time = combined_group[time_str].copy()
        coerce_increasing_time(combined_group, time_name=time_str)
    else:
        old_time = None
    return old_time


def create_old_time_array(group: str, old_time_in: DataArray) -> DataArray:
    """Build the Provenance-group record of an uncorrected time coordinate
    (reference: qc/api.py:132-171)."""
    old_time = old_time_in.copy()
    ed_name = group.replace("-", "_").replace("/", "_").lower()
    old_time_name = ed_name + "_old_" + old_time.name
    old_time_name_dim = old_time_name + "_dim"
    attributes = dict(old_time.attrs)
    attributes["comment"] = f"Uncorrected {old_time.name} from the combined group {group}."
    return DataArray(
        old_time.values, (old_time_name_dim,), attrs=attributes, name=old_time_name
    )
