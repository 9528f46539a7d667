"""numpy-backed ``flox.xarray.xarray_reduce`` for the xarray facade.

The reference implementation's commongrid and clean subsystems reduce onto
common grids through flox (reference: echopype/commongrid/utils.py:614-627,
echopype/clean/utils.py:198-208).  To execute those reference modules as
differential oracles against xrlite datasets, this module provides the subset
of flox they use:

- ``xarray_reduce(obj, *by, func, expected_groups, isbin, ...)`` with any mix
  of categorical (``isbin=False``) and binned (``isbin=True`` over an array
  of edges, or an ``IntervalIndex``-like object) group-bys,
- reductions ``nanmean`` / ``mean`` / ``nansum`` / ``sum`` with flox's
  ``skipna`` semantics (``mean`` + ``skipna=True`` behaves as ``nanmean``),
- binned output dims named ``{by.name}_bins`` holding interval labels with
  ``left``, ``right`` and ``closed``, matching what the reference reads back
  (``raw_MVBS.ping_time_bins``),
- datetime64 inputs reduced through int64 nanoseconds (flox's datetime mean).

Counterpart of ``echopype_tpu/xrlite/flox_compat.py`` without pandas: an
array of edges bins as ``pd.IntervalIndex.from_breaks`` does (right-closed
intervals; NaN, NaT and values outside the edges join no group), with the
port's own :class:`_Interval` labels, and an ``IntervalIndex``-like object
the caller passes is used through its own ``get_indexer`` and iteration.

This is host-side oracle plumbing, not a compute path: the port bins
through ``ops/binning.py`` and the survey steps of ``parallel/``.
"""

from __future__ import annotations

import math
import types

import numpy as np

from .dataarray import DataArray
from .dataset import Dataset

__all__ = ["xarray_reduce", "make_flox_module", "make_dask_image_module"]

_REDUCERS = ("nanmean", "mean", "nansum", "sum", "nanmax", "max", "nanmin", "min", "count")


class _Interval:
    """A bin label: ``left``, ``right`` and ``closed``, equal by the three
    (as ``pd.Interval`` labels compare)."""

    __slots__ = ("left", "right", "closed")

    def __init__(self, left, right, closed="right"):
        self.left, self.right, self.closed = left, right, closed

    def __eq__(self, other):
        try:
            return bool(self.left == other.left and self.right == other.right
                        and self.closed == other.closed)
        except AttributeError:
            return NotImplemented

    def __hash__(self):
        return hash((self.left, self.right, self.closed))

    def __repr__(self):
        return f"_Interval({self.left!r}, {self.right!r}, closed={self.closed!r})"


def _break_codes(flat, breaks):
    """Right-closed interval codes of ``flat`` over the sorted ``breaks``:
    ``i`` for ``breaks[i] < v <= breaks[i + 1]``, -1 for NaN, NaT and values
    outside (``pd.IntervalIndex.from_breaks(breaks).get_indexer``)."""
    if breaks.dtype.kind == "M":
        breaks, flat = breaks.astype("datetime64[ns]"), flat.astype("datetime64[ns]")
        missing = np.isnat(flat)
    else:
        missing = np.isnan(flat) if flat.dtype.kind in "fc" else np.zeros(flat.shape, bool)
    idx = np.searchsorted(breaks, flat, side="left") - 1
    return np.where(missing | (idx < 0) | (idx >= len(breaks) - 1), -1, idx)


def _group_codes(b, bin_flag, expected):
    """Return (codes aligned to ``b``'s shape, group labels, output dim name)."""
    vals = np.asarray(b.values)
    if bin_flag:
        flat = vals.ravel()
        if hasattr(expected, "get_indexer"):
            codes = np.asarray(expected.get_indexer(flat))
            labels = np.array(list(expected), dtype=object)
        else:
            e = np.asarray(expected)
            codes = _break_codes(flat, e)
            labels = np.empty(len(e) - 1, dtype=object)
            labels[:] = [_Interval(e[i], e[i + 1]) for i in range(len(e) - 1)]
        return codes.reshape(vals.shape), labels, f"{b.name}_bins"
    if expected is not None:
        labels = np.asarray(expected)
        order = np.argsort(labels)
        pos = np.searchsorted(labels[order], vals.ravel())
        pos = np.clip(pos, 0, len(labels) - 1)
        codes = np.where(labels[order][pos] == vals.ravel(), order[pos], -1)
        codes = codes.reshape(vals.shape)
        return codes, labels, str(b.name)
    labels, inv = np.unique(vals.ravel(), return_inverse=True)
    codes = inv.reshape(vals.shape)
    if labels.dtype.kind == "f":
        nanmask = np.isnan(vals)
        if nanmask.any():
            keep = ~np.isnan(labels)
            remap = np.cumsum(keep) - 1
            codes = np.where(nanmask, -1, remap[codes])
            labels = labels[keep]
    return codes, labels, str(b.name)


def _reduce_rows(work, flat_codes, flat_valid, G, func, skipna, fill_value):
    """Reduce (K, R) float64 ``work`` into (K, G) per-group aggregates."""
    K = work.shape[0]
    out = np.empty((K, G), dtype=np.float64)
    drop_nan = skipna or func.startswith("nan")
    for k in range(K):
        row = work[k]
        if drop_nan:
            sel = flat_valid & ~np.isnan(row)
        else:
            sel = flat_valid
        codes = flat_codes[sel]
        vals = row[sel]
        counts = np.bincount(codes, minlength=G).astype(np.float64)
        base = func[3:] if func.startswith("nan") else func
        if base in ("mean", "sum"):
            sums = np.bincount(codes, weights=vals, minlength=G)
            if base == "mean":
                with np.errstate(invalid="ignore", divide="ignore"):
                    res = sums / counts
                empty_fill = np.nan if fill_value is None else fill_value
            else:
                res = sums
                empty_fill = 0.0 if fill_value is None else fill_value
        elif base == "count":
            res = counts
            empty_fill = 0.0 if fill_value is None else fill_value
        else:  # min / max via sort-free segment extremes
            res = np.full(G, -np.inf if base == "max" else np.inf)
            np.maximum.at(res, codes, vals) if base == "max" else np.minimum.at(
                res, codes, vals
            )
            res = np.where(counts > 0, res, np.nan)
            empty_fill = np.nan if fill_value is None else fill_value
        res = np.where(counts > 0, res, empty_fill)
        out[k] = res
    return out


def _reduce_dataarray(obj, by, func, expected, isbin, skipna, fill_value):
    nby = len(by)
    codes_list, labels_list, gdims = [], [], []
    for b, flag, exp in zip(by, isbin, expected):
        codes, labels, gdim = _group_codes(b, flag, exp)
        codes_list.append(codes)
        labels_list.append(labels)
        gdims.append(gdim)

    # ordered union of grouped dims; all must exist on obj
    by_dims = []
    for b in by:
        for d in b.dims:
            if d not in by_dims:
                by_dims.append(d)
    missing = [d for d in by_dims if d not in obj.dims]
    if missing:
        raise ValueError(f"group-by dims {missing} not found on {obj.dims}")
    kept = [d for d in obj.dims if d not in by_dims]

    arr = obj.transpose(*(kept + by_dims)).values
    kept_shape = arr.shape[: len(kept)]
    red_shape = arr.shape[len(kept) :]
    K = int(math.prod(kept_shape)) if kept_shape else 1
    R = int(math.prod(red_shape)) if red_shape else 1

    # broadcast each by's codes to the reduced-dims shape and combine
    comb = np.zeros(red_shape, dtype=np.int64)
    valid = np.ones(red_shape, dtype=bool)
    G = 1
    for i, (b, codes) in enumerate(zip(by, codes_list)):
        shape = tuple(
            b.sizes[d] if d in b.dims else 1 for d in by_dims
        )
        # move b's axes into by_dims order before the singleton reshape
        order = [d for d in by_dims if d in b.dims]
        perm = [b.dims.index(d) for d in order]
        c = np.transpose(codes, perm).reshape(shape)
        c = np.broadcast_to(c, red_shape)
        n = len(labels_list[i])
        valid &= c >= 0
        comb = comb * n + np.where(c >= 0, c, 0)
        G *= n

    is_dt = np.issubdtype(arr.dtype, np.datetime64)
    if is_dt:
        work = arr.astype("datetime64[ns]").astype(np.int64).astype(np.float64)
        work[np.isnat(arr)] = np.nan
    else:
        work = arr.astype(np.float64)
    work = work.reshape(K, R)

    out = _reduce_rows(
        work, comb.ravel(), valid.ravel(), G, func, skipna, fill_value
    )
    group_sizes = tuple(len(labels) for labels in labels_list)
    out = out.reshape(kept_shape + group_sizes)
    if is_dt:
        nat = np.isnan(out)
        out = np.where(nat, 0.0, out)
        out = np.round(out).astype(np.int64).astype("datetime64[ns]")
        out[nat] = np.datetime64("NaT")

    res = DataArray(out, tuple(kept) + tuple(gdims), name=obj.name, attrs=dict(obj.attrs))
    for k, v in obj.coords.items():
        if set(v.dims) <= set(kept):
            res.coords[k] = v
    for gdim, labels in zip(gdims, labels_list):
        res.coords[gdim] = DataArray(labels, (gdim,), name=gdim)
    return res


def xarray_reduce(
    obj,
    *by,
    func="nanmean",
    expected_groups=None,
    isbin=False,
    method="map-reduce",
    reindex=None,
    skipna=True,
    fill_value=None,
    **kwargs,
):
    """flox-compatible groupby-bin reduction over xrlite objects."""
    if func not in _REDUCERS:
        raise NotImplementedError(f"xrlite flox shim: func={func!r}")
    nby = len(by)
    if not isinstance(isbin, (list, tuple)):
        isbin = [isbin] * nby
    if expected_groups is None:
        expected = [None] * nby
    elif isinstance(expected_groups, tuple) and len(expected_groups) == nby:
        expected = list(expected_groups)
    else:
        if nby != 1:
            raise ValueError("expected_groups must be a tuple matching `by`")
        expected = [expected_groups]

    if isinstance(obj, Dataset):
        out = Dataset(attrs=dict(obj.attrs))
        for name in obj.data_vars:
            red = _reduce_dataarray(
                obj[name], by, func, expected, isbin, skipna, fill_value
            )
            out[name] = red
        return out
    return _reduce_dataarray(obj, by, func, expected, isbin, skipna, fill_value)


class _Computed:
    """Minimal dask-array-alike wrapping an eager numpy result."""

    def __init__(self, arr):
        self._arr = arr

    def compute(self):
        return self._arr


def make_flox_module():
    """Build ``flox`` + ``flox.xarray`` module objects exposing the shim."""
    flox = types.ModuleType("flox")
    flox_xarray = types.ModuleType("flox.xarray")
    flox_xarray.xarray_reduce = xarray_reduce
    flox.xarray = flox_xarray
    return flox, flox_xarray


def make_dask_image_module():
    """Build ``dask_image.ndfilters`` over scipy.ndimage (eager, host-side).

    The reference's index-binned transient-noise pooling runs
    ``dask_image.ndfilters.generic_filter(...).compute()``
    (reference: echopype/clean/utils.py:162-169); eager scipy matches its
    numerics exactly on in-memory arrays.
    """
    import scipy.ndimage as ndi

    dask_image = types.ModuleType("dask_image")
    ndfilters = types.ModuleType("dask_image.ndfilters")

    def generic_filter(image, function, size=None, footprint=None, mode="reflect", **kw):
        res = ndi.generic_filter(
            np.asarray(image), function, size=size, footprint=footprint, mode=mode
        )
        return _Computed(res)

    ndfilters.generic_filter = generic_filter
    dask_image.ndfilters = ndfilters
    return dask_image, ndfilters
