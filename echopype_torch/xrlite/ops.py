"""Module-level operations for xrlite: broadcast, concat, merge, where."""

from __future__ import annotations

import numpy as np

from .dataarray import DataArray

__all__ = [
    "align_dims",
    "broadcast_arrays",
    "concat",
    "merge",
    "where",
    "zeros_like",
    "full_like",
]


def align_dims(a_dims, b_dims):
    """Union of dims: a's dims in order, then b-only dims appended in b's order."""
    return tuple(a_dims) + tuple(d for d in b_dims if d not in a_dims)


def _expand_to(da: DataArray, out_dims, out_sizes):
    """Return ndarray of ``da`` transposed/reshaped to broadcast against out_dims."""
    # move existing axes into out order, then insert singleton axes
    present = [d for d in out_dims if d in da.dims]
    order = [da.dims.index(d) for d in present]
    vals = np.transpose(da.values, order)
    shape = tuple(da.sizes[d] if d in da.dims else 1 for d in out_dims)
    vals = vals.reshape(shape)
    return np.broadcast_to(vals, tuple(out_sizes[d] for d in out_dims))


def _align_inner(a: DataArray, b: DataArray):
    """xarray-style automatic alignment: inner-join shared dims on their
    index coords when the labels differ (e.g. Sv[40] * dz[39] after .diff
    aligns to the 39 common range samples, metrics/summary_statistics.py)."""
    for d in tuple(a.dims):
        if d not in b.dims:
            continue
        ca, cb = a.coords.get(d), b.coords.get(d)
        if ca is None or cb is None or ca.dims != (d,) or cb.dims != (d,):
            continue
        if ca.shape == cb.shape and _array_equal_any(ca.values, cb.values):
            continue
        keep = np.isin(ca.values, cb.values)
        ia = np.nonzero(keep)[0]
        pos_b = {v: i for i, v in enumerate(cb.values)}
        ib = np.array([pos_b[v] for v in ca.values[ia]], dtype=np.intp)
        a = a.isel({d: ia})
        b = b.isel({d: ib})
    return a, b


def broadcast_arrays(a: DataArray, b: DataArray):
    """Broadcast two DataArrays against each other by dim name.

    Shared dims whose index-coord labels differ first align with an inner
    join (xarray semantics); positional broadcast applies after."""
    a, b = _align_inner(a, b)
    out_dims = align_dims(a.dims, b.dims)
    sizes = {}
    for d in out_dims:
        na, nb = a.sizes.get(d), b.sizes.get(d)
        if na is not None and nb is not None and na != nb:
            if na == 1:
                na = nb
            elif nb == 1:
                nb = na
            else:
                raise ValueError(f"conflicting sizes for dim {d!r}: {na} vs {nb}")
        sizes[d] = na if na is not None else nb
    av = _expand_to(a, out_dims, sizes)
    bv = _expand_to(b, out_dims, sizes)
    coords = {}
    for src in (a, b):
        for k, v in src.coords.items():
            if k not in coords and all(d in sizes and sizes[d] == v.sizes[d] for d in v.dims):
                coords[k] = v
    oa = DataArray(av, out_dims, name=a.name)
    ob = DataArray(bv, out_dims, name=b.name)
    oa.coords = dict(coords)
    ob.coords = dict(coords)
    return oa, ob


def where(cond, x, y):
    """Element-wise where over DataArrays/scalars (xr.where equivalent)."""
    operands = [v for v in (cond, x, y) if isinstance(v, DataArray)]
    if not operands:
        return np.where(cond, x, y)
    base = operands[0]
    for other in operands[1:]:
        base, _ = broadcast_arrays(base, other)

    def as_vals(v):
        if isinstance(v, DataArray):
            _, vb = broadcast_arrays(base, v)
            return vb.values
        return v

    out = DataArray(np.where(as_vals(cond), as_vals(x), as_vals(y)), base.dims)
    out.coords = base.coords
    if isinstance(x, DataArray):
        out.name = x.name
        out.attrs = dict(x.attrs)
    return out


def zeros_like(da: DataArray, dtype=None):
    out = DataArray(np.zeros(da.shape, dtype=dtype or da.dtype), da.dims, name=da.name)
    out.coords = dict(da.coords)
    return out


def full_like(da: DataArray, fill_value, dtype=None):
    out = DataArray(np.full(da.shape, fill_value, dtype=dtype or da.dtype), da.dims, name=da.name)
    out.coords = dict(da.coords)
    return out


def concat(objs, dim, coords="minimal", data_vars="minimal"):
    """Concatenate DataArrays or Datasets along ``dim``.

    Mirrors the subset of xr.concat behavior used by the reference's
    combine_echodata (echopype/echodata/combine.py:804-817): objects are
    concatenated along an existing or new dimension; variables without that
    dim are taken from the first object.
    """
    from .dataset import Dataset

    objs = list(objs)
    if not objs:
        raise ValueError("need at least one object")
    objs = _align_outer(objs, dim)
    if isinstance(objs[0], Dataset):
        return _concat_datasets(objs, dim, data_vars=data_vars)
    return _concat_dataarrays(objs, dim)


def _align_outer(objs, concat_dim):
    """xarray ``join="outer"`` alignment for the non-concat dims: when an
    indexed dim's labels differ across objects (e.g. range_sample on ragged
    multi-file combines), every object reindexes onto the sorted label
    union with NaN fill — matching xr.concat's default join semantics
    (the reference's combine concatenates files of differing range_sample
    lengths this way, combine.py:804-817)."""
    first = objs[0]
    shared_dims = set(first.dims)
    for o in objs[1:]:
        shared_dims |= set(o.dims)
    shared_dims.discard(concat_dim)
    indexers = {}
    for d in shared_dims:
        cands = [o for o in objs if d in o.dims]
        if not all(d in o.coords for o in cands):
            continue  # no index coordinate: xarray requires equal sizes
        labels = [np.asarray(o.coords[d].values) for o in cands]
        if all(
            len(lab) == len(labels[0]) and np.array_equal(lab, labels[0])
            for lab in labels[1:]
        ):
            continue
        union = labels[0]
        for lab in labels[1:]:
            union = np.union1d(union, lab)
        indexers[d] = union
    if not indexers:
        return objs
    out = []
    for o in objs:
        sub = {d: u for d, u in indexers.items() if d in o.dims}
        out.append(o.reindex(sub) if sub else o)
    return out


def _nan_like(template, ds, dim):
    """A fill DataArray standing in for ``template`` on a dataset missing it
    (xarray concat fills absent variables with fill_value).  Dim sizes come
    from ``ds`` where it has them (notably the concat dim); float dtypes fill
    NaN, datetimes NaT, and ints promote to float64 like xarray."""
    shape = tuple(
        ds.sizes.get(d, template.sizes[d]) for d in template.dims
    )
    dt = template.values.dtype
    if dt.kind in "mM":
        vals = np.full(shape, np.array("NaT", dtype=dt), dtype=dt)
    elif dt.kind in "fc":
        vals = np.full(shape, np.nan, dtype=dt)
    elif dt.kind in "iub":
        vals = np.full(shape, np.nan, dtype="f8")
    else:
        vals = np.full(shape, np.nan, dtype=object)
    out = DataArray(vals, template.dims, attrs=dict(template.attrs), name=template.name)
    for k, v in template.coords.items():
        if dim in v.dims:
            if k in ds.coords:
                out.coords[k] = ds.coords[k]
        else:
            out.coords[k] = v
    return out


def _concat_dataarrays(objs, dim):
    first = objs[0]
    if dim in first.dims:
        ax = first.dims.index(dim)
        vals = np.concatenate([o.values for o in objs], axis=ax)
        dims = first.dims
    else:
        vals = np.stack([o.values for o in objs], axis=0)
        dims = (dim,) + first.dims
    out = DataArray(vals, dims, attrs=dict(first.attrs), name=first.name)
    for k, v in first.coords.items():
        if dim in v.dims:
            cax = v.dims.index(dim)
            out.coords[k] = DataArray(
                np.concatenate([o.coords[k].values for o in objs], axis=cax),
                v.dims,
                attrs=v.attrs,
                name=k,
            )
        else:
            out.coords[k] = v
    return out


def _concat_datasets(objs, dim, data_vars="minimal"):
    from .dataset import Dataset

    first = objs[0]
    out = Dataset(attrs=dict(first.attrs))
    # union of data_vars in first-seen order (xarray keeps vars present in
    # only some datasets, filling the others with fill_value)
    names = list(first.data_vars)
    for o in objs[1:]:
        for name in o.data_vars:
            if name not in names:
                names.append(name)
    for name in names:
        havers = [o for o in objs if name in o.data_vars]
        template = havers[0][name]
        if dim in template.dims:
            out[name] = _concat_dataarrays(
                [
                    o[name] if name in o.data_vars else _nan_like(template, o, dim)
                    for o in objs
                ],
                dim,
            )
        elif data_vars == "all":
            # xarray data_vars="all": variables lacking the concat dim are
            # expanded along it (one slot per object, or the object's size of
            # that dim) and concatenated — the reference's merge_save relies
            # on this for the per-ping transmit_frequency_start/stop vars
            # added AFTER the channel dim (set_groups_ek80.py:1071-1084)
            parts = []
            for o in objs:
                v = o[name] if name in o.data_vars else _nan_like(template, o, dim)
                n = int(o.sizes.get(dim, 1))
                vals = np.broadcast_to(
                    np.asarray(v.values), (n,) + np.asarray(v.values).shape
                ).copy()
                parts.append(DataArray(vals, (dim,) + v.dims,
                                       attrs=dict(template.attrs), name=name))
            out[name] = _concat_dataarrays(parts, dim)
        else:
            out[name] = template
    for k, v in first.coords.items():
        if dim in v.dims:
            cax = v.dims.index(dim)
            out.coords[k] = DataArray(
                np.concatenate([o.coords[k].values for o in objs], axis=cax),
                v.dims,
                attrs=v.attrs,
                name=k,
            )
        else:
            out.coords[k] = v
    return out


def _array_equal_any(x, y):
    try:
        return bool(np.array_equal(x, y))
    except Exception:
        return False


def _reindex_values(da: DataArray, targets: dict):
    """NaN-fill-expand ``da``'s values onto union coords per indexed dim.

    ``targets`` maps dim -> sorted union coord values (or None = leave as-is).
    """
    rel = {d: t for d, t in targets.items() if d in da.dims and t is not None}
    if not rel:
        return da.values
    # skip dims whose coord already equals the target
    rel = {
        d: t
        for d, t in rel.items()
        if d not in da.coords
        or da.coords[d].shape != t.shape
        or not _array_equal_any(da.coords[d].values, t)
    }
    if not rel:
        return da.values
    shape = tuple(len(rel[d]) if d in rel else da.sizes[d] for d in da.dims)
    dtype = da.dtype
    if not (np.issubdtype(dtype, np.floating) or np.issubdtype(dtype, np.complexfloating)):
        dtype = object if dtype.kind in ("U", "S", "O", "m", "M") else np.float64
    vals = np.full(shape, np.nan, dtype=dtype)
    idx = []
    for d in da.dims:
        if d in rel:
            if d not in da.coords:
                raise ValueError(f"cannot outer-join dim {d!r} without a coordinate")
            idx.append(np.searchsorted(rel[d], da.coords[d].values))
        else:
            idx.append(np.arange(da.sizes[d]))
    vals[np.ix_(*idx)] = da.values
    return vals


def merge(objs, compat="no_conflicts", join="outer"):
    """Merge Datasets/DataArrays into one Dataset (xr.merge semantics).

    When objects carry differing coord values along an indexed dim, all
    variables are outer-joined onto the sorted union of coords with NaN fill
    (the access pattern of the reference's _collapse_vend,
    calibrate_ek.py:37-52).  Same-name collisions: first non-NaN value wins
    (compat="no_conflicts" on non-overlapping inputs).
    """
    from .dataset import Dataset

    objs = [o.to_dataset() if isinstance(o, DataArray) else o for o in objs]
    # pass 1: union coords per indexed dim across all objects
    targets: dict = {}
    for obj in objs:
        for d, c in obj.coords.items():
            if c.dims != (d,):
                continue
            if d not in targets:
                targets[d] = c.values
            elif not (
                targets[d].shape == c.values.shape
                and _array_equal_any(targets[d], c.values)
            ):
                targets[d] = np.unique(np.concatenate([targets[d], c.values]))
    # pass 2: place variables reindexed onto the union
    out = Dataset()
    for obj in objs:
        for name, _ in obj.data_vars.items():
            var = obj[name]
            vals = _reindex_values(var, targets)
            if name not in out.data_vars:
                da = DataArray(vals, var.dims, attrs=dict(var.attrs), name=name)
                out.data_vars[name] = da
            else:
                cur = out.data_vars[name].values
                if cur.shape != vals.shape:
                    raise ValueError(f"conflicting shapes for merged variable {name!r}")
                if np.issubdtype(cur.dtype, np.floating) or cur.dtype == object:
                    hole = (
                        np.array([x is np.nan or (isinstance(x, float) and np.isnan(x)) for x in cur.ravel()]).reshape(cur.shape)
                        if cur.dtype == object
                        else np.isnan(cur)
                    )
                    cur[hole] = np.asarray(vals)[hole]
        for k, v in obj.coords.items():
            if k in out.coords:
                continue
            if v.dims == (k,) and k in targets:
                out.coords[k] = DataArray(targets[k], (k,), attrs=dict(v.attrs), name=k)
            else:
                out.coords[k] = v
        for k, v in obj.attrs.items():
            out.attrs.setdefault(k, v)
    return out
