"""DataArray: ndarray + named dims + coordinates + attributes.

Host-side values are numpy arrays; device compute paths unwrap ``.values`` and
run jit kernels, then re-wrap.  Binary ops broadcast by dimension name.
"""

from __future__ import annotations

import numpy as np

__all__ = ["DataArray"]


def _as_array(values):
    if isinstance(values, DataArray):
        return values.values
    arr = np.asarray(values)
    return arr


def _nanfunc(name, skipna):
    plain = getattr(np, name)
    nanver = getattr(np, "nan" + name, plain)
    return nanver if skipna else plain


def _as_coord(name, val):
    """Coerce a coords-mapping value into a DataArray (xarray semantics)."""
    if isinstance(val, DataArray):
        return val
    if (
        isinstance(val, tuple)
        and len(val) in (2, 3)
        and isinstance(val[0], (str, tuple, list))
    ):
        dims, data = val[0], val[1]
        attrs = val[2] if len(val) == 3 else None
        dims = (dims,) if isinstance(dims, str) else tuple(dims)
        return DataArray(np.asarray(data), dims, attrs=attrs, name=name)
    arr = np.asarray(val)
    if arr.ndim == 0:
        return DataArray(arr, (), name=name)
    if arr.ndim == 1:
        return DataArray(arr, (name,), name=name)
    raise ValueError(f"coord {name!r}: pass (dims, values) for multi-d coords")


class CoordsDict(dict):
    """Coordinate mapping that normalizes values on assignment.

    xarray allows ``obj.coords[name] = (dims, values, attrs)`` (the reference
    does this, e.g. commongrid/api.py:227-231); plain-dict storage would leak
    raw tuples into the coords and break every consumer that expects
    ``.sizes``/``.values`` on them.
    """

    def __init__(self, other=(), **kw):
        super().__init__()
        self.update(other, **kw)

    def __setitem__(self, key, val):
        super().__setitem__(key, _as_coord(key, val))

    def __ior__(self, other):
        self.update(other)
        return self

    def __or__(self, other):
        out = CoordsDict(self)
        out.update(other)
        return out

    def update(self, other=(), **kw):
        # dict.update bypasses __setitem__; route through it for coercion
        items = other.items() if hasattr(other, "items") else other
        for k, v in items:
            self[k] = v
        for k, v in kw.items():
            self[k] = v

    def setdefault(self, key, default=None):
        if key not in self:
            self[key] = default
        return dict.__getitem__(self, key)


def _array_equal_nan(a, b):
    """np.array_equal with NaN==NaN for float/datetime arrays."""
    a, b = np.asarray(a), np.asarray(b)
    if a.shape != b.shape:
        return False
    if np.issubdtype(a.dtype, np.floating) or np.issubdtype(a.dtype, np.complexfloating):
        return bool(np.array_equal(a, b, equal_nan=True))
    return bool(np.array_equal(a, b))


class _LocIndexer:
    """Label-based indexing: ``da.loc[dict(channel=...)]`` get and set.

    Mirrors the subset of xarray's ``.loc`` used by the reference
    (e.g. GPT range override, calibrate/range.py:199).
    """

    __slots__ = ("_da",)

    def __init__(self, da):
        self._da = da

    def _to_iidx(self, key):
        if not isinstance(key, dict):
            raise TypeError("xrlite .loc supports dict keys only")
        return {d: self._da._label_to_index(d, lab) for d, lab in key.items()}

    def __getitem__(self, key):
        return self._da.isel(self._to_iidx(key))

    def __setitem__(self, key, value):
        iidx = self._to_iidx(key)
        sl = tuple(iidx.get(d, slice(None)) for d in self._da.dims)
        if isinstance(value, DataArray):
            # align value dims to the target slice's dims
            tgt = self._da.isel(iidx)
            value = value.broadcast_like(tgt).transpose(*tgt.dims)
            value = value.values
        self._da.values[sl] = np.asarray(value)


class DataArray:
    """A labeled N-D array.

    Parameters
    ----------
    values : array-like
    dims : sequence of str
    coords : dict of {name: DataArray | (dims, values) | array}
        1-D arrays keyed by their own dim name, or DataArrays with dims that
        are a subset of ``dims``.
    attrs : dict
    name : str, optional
    """

    __slots__ = ("values", "dims", "_coords", "_attrs", "name", "_encoding", "_writethrough")

    @property
    def attrs(self):
        return self._attrs

    @attrs.setter
    def attrs(self, value):
        # xarray Variable-sharing parity: Dataset.__getitem__ hands out
        # wrappers that SHARE the stored variable's attrs dict, so
        # ``ds["x"].attrs = {...}`` must reach the stored variable (xarray
        # routes it to self.variable.attrs).  Replace the contents of the
        # already-bound dict in place; first bind makes a private copy.
        try:
            cur = object.__getattribute__(self, "_attrs")
        except AttributeError:
            cur = None
        if cur is None:
            object.__setattr__(self, "_attrs", dict(value) if value else {})
        else:
            # snapshot BEFORE clearing: value may alias cur (e.g.
            # ``da.attrs = da.attrs`` or attrs copied between two wrappers
            # sharing one stored dict) — clear-then-update from the alias
            # would silently erase everything
            value = dict(value or {})
            cur.clear()
            cur.update(value)

    @property
    def coords(self):
        return self._coords

    @coords.setter
    def coords(self, value):
        cd = CoordsDict()
        cd.update(value)
        self._coords = cd

    def __init__(self, values, dims=None, coords=None, attrs=None, name=None):
        if isinstance(values, DataArray):
            dims = dims if dims is not None else values.dims
            coords = coords if coords is not None else values.coords
            attrs = attrs if attrs is not None else values.attrs
            name = name if name is not None else values.name
            values = values.values
        values = np.asarray(values)
        if dims is None and coords is not None and len(coords) == values.ndim:
            # xarray-style dim inference from an ordered coords dict
            dims = tuple(coords.keys())
        if dims is None:
            dims = tuple(f"dim_{i}" for i in range(values.ndim))
        if isinstance(dims, str):
            dims = (dims,)
        dims = tuple(dims)
        if len(dims) != values.ndim:
            raise ValueError(f"dims {dims} do not match array of ndim {values.ndim}")
        self.values = values
        self.dims = dims
        self.attrs = dict(attrs) if attrs else {}
        self.name = name
        self.coords = {}
        if coords:
            for cname, cval in coords.items():
                self._set_coord(cname, cval)

    # ------------------------------------------------------------------ basics
    def _set_coord(self, cname, cval):
        if isinstance(cval, DataArray):
            c = DataArray(cval.values, cval.dims, attrs=cval.attrs, name=cname)
        elif isinstance(cval, tuple) and len(cval) == 2 and not np.isscalar(cval[0]):
            cdims, cdata = cval
            c = DataArray(np.asarray(cdata), cdims, name=cname)
        else:
            arr = np.asarray(cval)
            if arr.ndim == 0:
                c = DataArray(arr, (), name=cname)
            elif arr.ndim == 1:
                c = DataArray(arr, (cname,), name=cname)
            else:
                raise ValueError(f"coord {cname!r}: pass (dims, values) for multi-d coords")
        for d, n in zip(c.dims, c.shape):
            if d in self.dims and self.sizes[d] != n:
                raise ValueError(
                    f"coord {cname!r} dim {d!r} has size {n} != array size {self.sizes[d]}"
                )
        self.coords[cname] = c

    @property
    def shape(self):
        return self.values.shape

    @property
    def ndim(self):
        return self.values.ndim

    @property
    def size(self):
        return self.values.size

    @property
    def dtype(self):
        return self.values.dtype

    @property
    def sizes(self):
        return dict(zip(self.dims, self.values.shape))

    @property
    def nbytes(self):
        return self.values.nbytes

    def item(self):
        return self.values.item()

    @property
    def encoding(self):
        """Serialization encoding hints (xarray parity; storage reads its
        own defaults, so this is carried but not consumed)."""
        try:
            enc = object.__getattribute__(self, "_encoding")
        except AttributeError:
            enc = {}
            object.__setattr__(self, "_encoding", enc)
        return enc

    @encoding.setter
    def encoding(self, value):
        # update the existing dict in place: Dataset.__getitem__ hands out
        # wrappers whose _encoding is the SAME dict object as the stored
        # variable's, so `ds[var].encoding = {...}` sticks (xarray shares the
        # underlying Variable; the reference relies on this in
        # utils/coding.py:158)
        enc = self.encoding
        # snapshot first: value may alias enc (self-assignment through a
        # sharing wrapper) — clear-then-update would wipe it
        value = dict(value or {})
        enc.clear()
        enc.update(value)

    # ---------------------------------------------------- xarray-parity sugar
    @property
    def data(self):
        """Alias of ``.values`` (xarray API parity)."""
        return self.values

    @data.setter
    def data(self, v):
        v = np.asarray(v)
        if (
            getattr(self, "_writethrough", False)
            and v.shape == self.values.shape
            and v.dtype == self.values.dtype
            and self.values.flags.writeable
        ):
            # write through the existing buffer: Dataset.__getitem__ hands
            # out wrappers sharing the stored variable's ndarray, and xarray
            # semantics make `ds[var].data = x` visible in the dataset
            # (the reference's scalar update_platform branch relies on it,
            # echodata.py:494-505).  Restricted to exact dtype matches so a
            # dtype-changing assignment REBINDS like xarray instead of
            # silently truncating through an unsafe in-place cast.
            try:
                self.values[...] = v
                return
            except (TypeError, ValueError):
                pass
        self.values = v

    @property
    def chunks(self):
        """Always None: xrlite arrays are dense in memory (no dask)."""
        return None

    @property
    def variable(self):
        """xarray API parity: the underlying Variable (duck-typed by self —
        same .values/.dims/.attrs surface, no index coordinates)."""
        return DataArray(self.values, self.dims, attrs=self.attrs, name=self.name)

    @property
    def _data(self):
        """Variable._data parity: the wrapped array (ndarray; never dask)."""
        return self.values

    @property
    def loc(self):
        return _LocIndexer(self)

    def __contains__(self, label):
        """Label membership over values (``"GPT" in vend["transceiver_type"]``)."""
        return bool(np.isin(np.asarray(label), self.values).all())

    def __getattr__(self, name):
        # Attribute access for coordinates, xarray-style (da.channel).
        # Only called when normal lookup fails; __slots__ covers real attrs.
        if name.startswith("_"):
            raise AttributeError(name)
        try:
            coords = object.__getattribute__(self, "coords")
        except AttributeError:
            raise AttributeError(name) from None
        if name in coords:
            return coords[name]
        raise AttributeError(f"DataArray has no attribute or coordinate {name!r}")

    def equals(self, other):
        """NaN-aware equality of values + dims + coords (xarray semantics)."""
        if not isinstance(other, DataArray):
            return False
        if self.dims != other.dims or self.shape != other.shape:
            return False
        if not _array_equal_nan(self.values, other.values):
            return False
        if set(self.coords) != set(other.coords):
            return False
        return all(
            self.coords[k].dims == other.coords[k].dims
            and _array_equal_nan(self.coords[k].values, other.coords[k].values)
            for k in self.coords
        )

    def identical(self, other):
        return self.equals(other) and self.name == other.name and self.attrs == other.attrs

    def compute(self):
        return self

    def load(self):
        return self

    def chunk(self, *args, **kwargs):
        return self

    def groupby(self, name):
        """Minimal xarray groupby: (key, subset) pairs grouped by a 1-D
        coordinate, keys sorted (reference: calibrate/api.py:143)."""
        return _groupby(self, name)

    def drop_duplicates(self, dim, keep="first"):
        """xarray semantics: drop entries whose ``dim`` coordinate value
        repeats, keeping the first (or last) occurrence, order preserved."""
        import pandas as pd

        if dim not in self.coords:
            raise ValueError(f"dimension {dim!r} has no coordinate to dedup on")
        mask = ~pd.Index(np.asarray(self.coords[dim].values)).duplicated(keep=keep)
        return self.isel({dim: np.nonzero(mask)[0]})

    def sortby(self, key, ascending=True):
        """Sort along the dim of a 1-D coord/key DataArray (or coord name)."""
        if isinstance(key, str):
            key = self.coords[key]
        (dim,) = key.dims
        order = np.argsort(key.values, kind="stable")
        if not ascending:
            order = order[::-1]
        return self.isel({dim: order})

    def __array__(self, dtype=None, copy=None):
        return np.asarray(self.values, dtype=dtype)

    @property
    def real(self):
        """Real part, labels kept (xarray parity; np.real dispatches here)."""
        out = DataArray(self.values.real, self.dims, name=self.name)
        out.coords = dict(self.coords)
        return out

    @property
    def imag(self):
        """Imaginary part, labels kept (np.imag dispatches here)."""
        out = DataArray(self.values.imag, self.dims, name=self.name)
        out.coords = dict(self.coords)
        return out

    def __array_ufunc__(self, ufunc, method, *inputs, **kwargs):
        """Numpy ufuncs (np.log10, np.exp, ...) map over values, keep labels."""
        if method != "__call__" or kwargs.get("out") is not None:
            return NotImplemented
        from .ops import broadcast_arrays

        das = [x for x in inputs if isinstance(x, DataArray)]
        base = das[0]
        for o in das[1:]:
            base, _ = broadcast_arrays(base, o)
        vals = []
        for x in inputs:
            if isinstance(x, DataArray):
                xb = broadcast_arrays(base, x)[1] if x is not base else base
                vals.append(xb.values)
            else:
                vals.append(x)
        out = DataArray(ufunc(*vals, **kwargs), base.dims, name=self.name)
        out.coords = dict(base.coords)
        return out

    def __len__(self):
        return len(self.values)

    def __bool__(self):
        return bool(self.values)

    def __float__(self):
        return float(self.values)

    def __int__(self):
        return int(self.values)

    def __repr__(self):
        coord_str = ", ".join(
            f"{k}({','.join(v.dims)})" for k, v in self.coords.items()
        )
        return (
            f"<xrlite.DataArray {self.name or ''}{self.dims} shape={self.shape} "
            f"dtype={self.dtype} coords=[{coord_str}]>"
        )

    def copy(self, deep=False, data=None):
        if data is not None:
            vals = np.asarray(data).reshape(self.values.shape)
        else:
            vals = self.values.copy() if deep else self.values
        out = DataArray(vals, self.dims, attrs=dict(self.attrs), name=self.name)
        out.coords = {
            k: DataArray(v.values.copy() if deep else v.values, v.dims, attrs=dict(v.attrs), name=k)
            for k, v in self.coords.items()
        }
        if self.encoding:
            out.encoding = self.encoding
        return out

    # --------------------------------------------------------------- reshaping
    def rename(self, new_name_or_map=None, **dim_map):
        if isinstance(new_name_or_map, str):
            out = self.copy()
            out.name = new_name_or_map
            return out
        if isinstance(new_name_or_map, dict):
            dim_map = {**new_name_or_map, **dim_map}
        new_dims = tuple(dim_map.get(d, d) for d in self.dims)
        out = DataArray(self.values, new_dims, attrs=self.attrs, name=self.name)
        for k, v in self.coords.items():
            nk = dim_map.get(k, k)
            out.coords[nk] = DataArray(
                v.values, tuple(dim_map.get(d, d) for d in v.dims), attrs=v.attrs, name=nk
            )
        return out

    def transpose(self, *dims, missing_dims="raise"):
        if not dims:
            dims = self.dims[::-1]
        # xarray semantics: requested dims must exist unless
        # missing_dims="ignore" (the reference opts into "ignore" only at
        # set_groups_base.py:466; everywhere else runs under the strict
        # default, so a misspelled dim surfaces instead of silently
        # producing a wrong-ordered array).
        if missing_dims == "raise":
            missing = [d for d in dims if d is not ... and d not in self.dims]
            if missing:
                raise ValueError(
                    f"dimensions {missing} do not exist on this array; "
                    f"existing dims: {self.dims} (pass missing_dims='ignore' to drop)"
                )
        dims = tuple(d for d in dims if d is ... or d in self.dims)
        rest = [d for d in self.dims if d not in dims]
        if ... in dims:
            i = dims.index(...)
            dims = tuple(dims[:i]) + tuple(rest) + tuple(dims[i + 1 :])
        order = [self.dims.index(d) for d in dims]
        out = DataArray(np.transpose(self.values, order), dims, attrs=self.attrs, name=self.name)
        out.coords = dict(self.coords)
        return out

    def expand_dims(self, dim=None, axis=0, **dim_kwargs):
        """Insert a new dim of size 1 (or the size of a provided coord).

        Accepts a dim name, a dict {dim: size|coord}, or keyword form
        (xarray parity: ``da.expand_dims(ping_time=coord)``).
        """
        if dim_kwargs:
            dim = {**(dim if isinstance(dim, dict) else {}), **dim_kwargs}
        if isinstance(dim, (list, tuple)):
            # xarray: a sequence of names adds size-1 dims in order
            out = self
            for d in dim:
                out = out.expand_dims(d, axis)
            return out
        if isinstance(dim, dict):
            out = self
            for d, v in dim.items():
                n = v if isinstance(v, int) else len(np.asarray(v))
                ax = axis if axis >= 0 else out.ndim + axis + 1
                shape = list(out.shape)
                shape.insert(ax, n)
                vals = np.broadcast_to(np.expand_dims(out.values, ax), shape).copy()
                new_dims = list(out.dims)
                new_dims.insert(ax, d)
                new = DataArray(vals, tuple(new_dims), attrs=out.attrs, name=out.name)
                new.coords = dict(out.coords)
                if not isinstance(v, int):
                    new.coords[d] = DataArray(np.asarray(v), (d,), name=d)
                out = new
            return out
        vals = np.expand_dims(self.values, axis)
        dims = list(self.dims)
        dims.insert(axis if axis >= 0 else len(dims) + axis + 1, dim)
        out = DataArray(vals, tuple(dims), attrs=self.attrs, name=self.name)
        out.coords = dict(self.coords)
        return out

    def squeeze(self, dim=None, drop=False):
        if dim is None:
            sq = [d for d, n in self.sizes.items() if n == 1]
        else:
            sq = [dim] if isinstance(dim, str) else list(dim)
            for d in sq:
                if self.sizes[d] != 1:
                    raise ValueError(f"cannot squeeze dim {d!r} of size {self.sizes[d]}")
        idx = tuple(0 if d in sq else slice(None) for d in self.dims)
        new_dims = tuple(d for d in self.dims if d not in sq)
        out = DataArray(self.values[idx], new_dims, attrs=self.attrs, name=self.name)
        for k, v in self.coords.items():
            if any(d in sq for d in v.dims):
                if not drop:
                    cidx = tuple(0 if d in sq else slice(None) for d in v.dims)
                    cdims = tuple(d for d in v.dims if d not in sq)
                    out.coords[k] = DataArray(v.values[cidx], cdims, attrs=v.attrs, name=k)
            else:
                out.coords[k] = v
        return out

    def broadcast_like(self, other):
        from .ops import broadcast_arrays

        a, _ = broadcast_arrays(self, other)
        return a

    def astype(self, dtype):
        out = DataArray(self.values.astype(dtype), self.dims, attrs=self.attrs, name=self.name)
        out.coords = dict(self.coords)
        return out

    # --------------------------------------------------------------- selection
    def _dim_index(self, dim):
        try:
            return self.dims.index(dim)
        except ValueError:
            raise KeyError(f"dim {dim!r} not in {self.dims}") from None

    def isel(self, indexers=None, drop=False, **kw):
        indexers = {**(indexers or {}), **kw}
        # split out pointwise (vectorized) DataArray indexers: those whose dims
        # are NOT simply (d,) select elementwise over dims shared with self
        plain, pointwise = {}, {}
        for d, idx in indexers.items():
            if isinstance(idx, DataArray) and idx.dtype == bool and idx.ndim == 1:
                idx = np.nonzero(idx.values)[0]
            if isinstance(idx, DataArray) and idx.ndim >= 1 and idx.dims != (d,):
                pointwise[d] = idx
            else:
                plain[d] = idx
        out_vals = self.values
        # apply one dim at a time (supports int/slice/array indexers)
        dims = list(self.dims)
        for d, idx in plain.items():
            if d not in dims:
                continue
            ax = dims.index(d)
            if isinstance(idx, DataArray):
                idx = idx.values
            sl = [slice(None)] * out_vals.ndim
            sl[ax] = idx
            out_vals = out_vals[tuple(sl)]
            if np.ndim(idx) == 0 and not isinstance(idx, slice):
                dims.pop(ax)
        out = DataArray(out_vals, tuple(dims), attrs=self.attrs, name=self.name)
        for k, v in self.coords.items():
            rel = {d: i for d, i in plain.items() if d in v.dims}
            cv = v.isel(rel) if rel else v
            if cv.ndim == 0 and drop:
                continue
            out.coords[k] = cv
        for d, idx in pointwise.items():
            out = out._isel_pointwise(d, idx, drop=drop)
        return out

    def _isel_pointwise(self, d, indexer, drop=False):
        """Vectorized (pointwise) selection along ``d`` with a DataArray of
        integer positions whose dims are shared with this array.

        xarray semantics: the indexed dim is removed; selection is elementwise
        over the indexer's dims (which must be a subset of the remaining
        dims).  This is the access pattern of the reference's pulse-length
        table matching (calibrate/cal_params.py:311).
        """
        from .ops import _expand_to

        if d not in self.dims:
            return self
        res_dims = tuple(dd for dd in self.dims if dd != d)
        missing = [dd for dd in indexer.dims if dd not in res_dims]
        if missing:
            if not (set(indexer.dims) & set(res_dims)):
                # general vectorized indexing: the indexed dim is REPLACED by
                # the indexer's (new) dims (xarray semantics; the reference's
                # time1 -> ping_time alignment, set_groups_ad2cp.py:421)
                ax = self._dim_index(d)
                vals = np.take(self.values, np.asarray(indexer.values), axis=ax)
                new_dims = self.dims[:ax] + tuple(indexer.dims) + self.dims[ax + 1 :]
                out = DataArray(vals, new_dims, attrs=self.attrs, name=self.name)
                out.coords = {
                    k: v
                    for k, v in self.coords.items()
                    if set(v.dims) <= set(new_dims) and d not in v.dims
                }
                for k, v in indexer.coords.items():
                    if set(v.dims) <= set(new_dims):
                        out.coords.setdefault(k, v)
                if not drop and d in self.coords:
                    out.coords[d] = DataArray(
                        self.coords[d].values[np.asarray(indexer.values)],
                        indexer.dims,
                        name=d,
                    )
                return out
            raise ValueError(
                f"pointwise indexer dims {missing} not among array dims {res_dims}"
            )
        sizes = {dd: self.sizes[dd] for dd in res_dims}
        idx_b = _expand_to(indexer, res_dims, sizes)
        index_arrays = []
        for dd in self.dims:
            if dd == d:
                index_arrays.append(idx_b)
            else:
                pos = res_dims.index(dd)
                shape = [1] * len(res_dims)
                shape[pos] = sizes[dd]
                index_arrays.append(np.arange(sizes[dd]).reshape(shape))
        vals = self.values[tuple(index_arrays)]
        out = DataArray(vals, res_dims, attrs=self.attrs, name=self.name)
        out.coords = {
            k: v for k, v in self.coords.items() if set(v.dims) <= set(res_dims)
        }
        if not drop and d in self.coords:
            out.coords[d] = DataArray(
                self.coords[d].values[indexer.values], indexer.dims, name=d
            )
        return out

    def _label_to_index(self, dim, label, method=None):
        coord = self.coords.get(dim)
        if coord is None:
            raise KeyError(f"no coordinate for dim {dim!r}")
        cv = coord.values
        # boolean masks select positions directly (xarray-style)
        if isinstance(label, DataArray) and label.dtype == bool:
            return np.nonzero(label.values)[0]
        if isinstance(label, np.ndarray) and label.dtype == bool:
            return np.nonzero(label)[0]
        if isinstance(label, DataArray) and label.ndim >= 1:
            # vectorized label lookup; preserves the indexer's dims so isel
            # can dispatch to the pointwise path when they differ from (dim,)
            first_pos = {}
            for i, v in enumerate(cv):
                first_pos.setdefault(v if np.ndim(v) == 0 else tuple(v), i)
            flat = label.values.ravel()
            try:
                pos = np.array([first_pos[v] for v in flat], dtype=np.intp)
            except KeyError as e:
                raise KeyError(f"label {e.args[0]!r} not found in coord {dim!r}") from None
            pos = pos.reshape(label.shape)
            if label.dims == (dim,):
                return pos
            return DataArray(pos, label.dims)
        if isinstance(label, slice):
            lo, hi = label.start, label.stop
            mask = np.ones(len(cv), dtype=bool)
            if lo is not None:
                mask &= cv >= np.asarray(lo).astype(cv.dtype)
            if hi is not None:
                mask &= cv <= np.asarray(hi).astype(cv.dtype)
            idx = np.nonzero(mask)[0]
            if len(idx) and np.all(np.diff(idx) == 1):
                return slice(idx[0], idx[-1] + 1)
            return idx
        labels = np.asarray(label)
        scalar = labels.ndim == 0
        labels = np.atleast_1d(labels)
        if method == "nearest":
            if np.issubdtype(cv.dtype, np.datetime64):
                dist = np.abs(cv[None, :].astype("i8") - labels[:, None].astype(cv.dtype).astype("i8"))
            else:
                dist = np.abs(cv[None, :] - labels[:, None])
            idx = np.argmin(dist, axis=1)
        else:
            sorter = np.argsort(cv) if cv.ndim == 1 else None
            idx = []
            for lab in labels:
                matches = np.nonzero(cv == np.asarray(lab).astype(cv.dtype))[0]
                if len(matches) == 0:
                    raise KeyError(f"label {lab!r} not found in coord {dim!r}")
                idx.append(matches[0])
            idx = np.asarray(idx)
            del sorter
        return int(idx[0]) if scalar else idx

    def sel(self, indexers=None, method=None, drop=False, **kw):
        indexers = {**(indexers or {}), **kw}
        iidx = {d: self._label_to_index(d, lab, method) for d, lab in indexers.items()}
        return self.isel(iidx, drop=drop)

    def __getitem__(self, key):
        if isinstance(key, str):
            if key not in self.coords and key in self.dims:
                # xarray virtual dimension coordinate: arange(size).  The
                # reference iterates da["channel"] on coord-less arrays
                # (clean/utils.py:211-222), so this fallback is required to
                # execute it.
                return DataArray(np.arange(self.sizes[key]), (key,), name=key)
            c = self.coords[key]
            out = DataArray(c.values, c.dims, attrs=c.attrs, name=key)
            # a selected coordinate carries the coords over its own dims,
            # including itself (xarray semantics; regrid_mask resamples
            # mask_da["ping_time"] along its own coordinate)
            out.coords = {
                k: v for k, v in self.coords.items() if set(v.dims) <= set(c.dims)
            }
            return out
        if isinstance(key, dict):
            return self.isel(key)
        if isinstance(key, DataArray):
            if key.dtype == bool and key.ndim == 1 and key.dims[0] in self.dims:
                # dim-aware boolean mask (xarray: da[ch_GPT])
                return self.isel({key.dims[0]: np.nonzero(key.values)[0]})
            key = key.values
        vals = np.asarray(self.values[key])
        # plain positional indexing: keep dims where possible
        if isinstance(key, tuple):
            dims = tuple(
                d
                for d, k in zip(self.dims, key + (slice(None),) * (self.ndim - len(key)))
                if not np.ndim(k) == 0 or isinstance(k, slice)
            )
        elif isinstance(key, slice) or np.ndim(key) >= 1:
            dims = self.dims
        else:
            dims = self.dims[1:]
        if len(dims) != vals.ndim:
            dims = tuple(f"dim_{i}" for i in range(vals.ndim))
        out = DataArray(vals, dims, attrs=self.attrs, name=self.name)
        return out

    def __setitem__(self, key, value):
        if isinstance(key, dict):
            idx = tuple(key.get(d, slice(None)) for d in self.dims)
            self.values[idx] = _as_array(value)
            return
        if isinstance(key, DataArray):
            if key.dtype == bool and key.ndim == 1 and key.dims[0] in self.dims:
                # dim-aware boolean assignment (xarray: tau_eff[ch_GPT] = ...)
                d = key.dims[0]
                pos = np.nonzero(key.values)[0]
                sl = tuple(pos if dd == d else slice(None) for dd in self.dims)
                if isinstance(value, DataArray):
                    tgt = self.isel({d: pos})
                    value = value.broadcast_like(tgt).transpose(*tgt.dims).values
                self.values[sl] = np.asarray(value)
                return
            key = key.values
        self.values[key] = _as_array(value)

    # ------------------------------------------------------------- arithmetic
    def _binary_op(self, other, op, reflexive=False):
        from .ops import broadcast_arrays

        if isinstance(other, DataArray):
            a, b = broadcast_arrays(self, other)
            va, vb = (b.values, a.values) if reflexive else (a.values, b.values)
            out = DataArray(op(va, vb), a.dims, name=self.name)
            out.coords = a.coords
            return out
        vb = np.asarray(other)
        va = self.values
        if reflexive:
            va, vb = vb, va
        out = DataArray(op(va, vb), self.dims, name=self.name)
        out.coords = dict(self.coords)
        return out

    def __add__(self, o):
        return self._binary_op(o, np.add)

    def __radd__(self, o):
        return self._binary_op(o, np.add, True)

    def __sub__(self, o):
        return self._binary_op(o, np.subtract)

    def __rsub__(self, o):
        return self._binary_op(o, np.subtract, True)

    def __mul__(self, o):
        return self._binary_op(o, np.multiply)

    def __rmul__(self, o):
        return self._binary_op(o, np.multiply, True)

    def __truediv__(self, o):
        return self._binary_op(o, np.divide)

    def __rtruediv__(self, o):
        return self._binary_op(o, np.divide, True)

    def __pow__(self, o):
        return self._binary_op(o, np.power)

    def __rpow__(self, o):
        return self._binary_op(o, np.power, True)

    def __mod__(self, o):
        return self._binary_op(o, np.mod)

    def __neg__(self):
        out = DataArray(-self.values, self.dims, attrs=self.attrs, name=self.name)
        out.coords = dict(self.coords)
        return out

    def __abs__(self):
        out = DataArray(np.abs(self.values), self.dims, attrs=self.attrs, name=self.name)
        out.coords = dict(self.coords)
        return out

    def __lt__(self, o):
        return self._binary_op(o, np.less)

    def __le__(self, o):
        return self._binary_op(o, np.less_equal)

    def __gt__(self, o):
        return self._binary_op(o, np.greater)

    def __ge__(self, o):
        return self._binary_op(o, np.greater_equal)

    def __eq__(self, o):  # noqa: D105 - elementwise, xarray-style
        return self._binary_op(o, np.equal)

    def __ne__(self, o):
        return self._binary_op(o, np.not_equal)

    def __and__(self, o):
        return self._binary_op(o, np.logical_and)

    def __or__(self, o):
        return self._binary_op(o, np.logical_or)

    def __invert__(self):
        out = DataArray(np.logical_not(self.values), self.dims, name=self.name)
        out.coords = dict(self.coords)
        return out

    __hash__ = None

    # -------------------------------------------------------------- reductions
    def _reduce(self, fname, dim=None, skipna=True, keepdims=False):
        func = _nanfunc(fname, skipna and np.issubdtype(self.dtype, np.floating))
        if dim is None:
            return DataArray(np.asarray(func(self.values)), (), name=self.name)
        dims = (dim,) if isinstance(dim, str) else tuple(dim)
        axes = tuple(self._dim_index(d) for d in dims)
        import warnings

        with warnings.catch_warnings():
            warnings.simplefilter("ignore", category=RuntimeWarning)
            vals = func(self.values, axis=axes, keepdims=keepdims)
        new_dims = self.dims if keepdims else tuple(d for d in self.dims if d not in dims)
        out = DataArray(vals, new_dims, attrs=self.attrs, name=self.name)
        out.coords = {
            k: v for k, v in self.coords.items() if keepdims or not (set(v.dims) & set(dims))
        }
        return out

    def mean(self, dim=None, skipna=True, **kw):
        return self._reduce("mean", dim, skipna)

    def sum(self, dim=None, skipna=True, **kw):
        return self._reduce("sum", dim, skipna)

    def min(self, dim=None, skipna=True, **kw):
        return self._reduce("min", dim, skipna)

    def max(self, dim=None, skipna=True, **kw):
        return self._reduce("max", dim, skipna)

    def std(self, dim=None, skipna=True, **kw):
        return self._reduce("std", dim, skipna)

    def median(self, dim=None, skipna=True, **kw):
        return self._reduce("median", dim, skipna)

    def prod(self, dim=None, skipna=True, **kw):
        return self._reduce("prod", dim, skipna)

    def all(self, dim=None, axis=None, **kw):
        if dim is None and axis is None:
            return DataArray(np.asarray(np.all(self.values)), (), name=self.name)
        return self._reduce("all", dim, skipna=False)

    def any(self, dim=None, axis=None, **kw):
        if dim is None and axis is None:
            return DataArray(np.asarray(np.any(self.values)), (), name=self.name)
        return self._reduce("any", dim, skipna=False)

    def count(self, dim=None):
        notnull = ~np.isnan(self.values) if np.issubdtype(self.dtype, np.floating) else np.ones(
            self.shape, bool
        )
        tmp = DataArray(notnull.astype(np.int64), self.dims)
        return tmp._reduce("sum", dim, skipna=False)

    def _nanarg(self, dim, fn):
        """nanargmin/max that tolerates all-NaN slices (index 0 there, with
        an all-NaN marker returned alongside) — xarray returns NaN for such
        slices instead of raising like numpy (e.g. skipped pings feeding the
        reference's pulse-length idxmin, cal_params.py:291)."""
        ax = self._dim_index(dim)
        vals = self.values
        if np.issubdtype(vals.dtype, np.floating):
            all_nan = np.isnan(vals).all(axis=ax)
            safe = np.where(np.isnan(vals), np.inf if fn is np.nanargmin else -np.inf, vals)
            idx = fn(safe, axis=ax)
        else:
            all_nan = np.zeros(tuple(s for i, s in enumerate(vals.shape) if i != ax), bool)
            idx = fn(vals, axis=ax)
        return idx, all_nan

    def argmin(self, dim=None, axis=None):
        if dim is None and axis is not None:
            dim = self.dims[axis]
        if dim is None:
            # xarray: dim-less argmin flattens (NaN-skipping)
            return DataArray(np.int64(np.nanargmin(np.asarray(self.values))),
                             (), name=self.name)
        idx, _ = self._nanarg(dim, np.nanargmin)
        new_dims = tuple(d for d in self.dims if d != dim)
        out = DataArray(idx, new_dims, name=self.name)
        out.coords = {k: v for k, v in self.coords.items() if dim not in v.dims}
        return out

    def idxmin(self, dim):
        idx, all_nan = self._nanarg(dim, np.nanargmin)
        coord = self.coords[dim]
        picked = coord.values[idx]
        if all_nan.any():
            if picked.dtype.kind in "mM":
                # datetime/timedelta coords: xarray fills NaT, keeps dtype
                picked = np.where(all_nan, np.array("NaT", dtype=picked.dtype), picked)
            else:
                picked = np.where(all_nan, np.nan, picked.astype("f8"))
        return DataArray(
            picked,
            tuple(d for d in self.dims if d != dim),
            name=self.name,
        )

    def argmax(self, dim=None, axis=None):
        if dim is None and axis is not None:
            dim = self.dims[axis]
        if dim is None:
            return DataArray(np.int64(np.nanargmax(np.asarray(self.values))),
                             (), name=self.name)
        idx, _ = self._nanarg(dim, np.nanargmax)
        new_dims = tuple(d for d in self.dims if d != dim)
        out = DataArray(idx, new_dims, name=self.name)
        out.coords = {k: v for k, v in self.coords.items() if dim not in v.dims}
        return out

    def idxmax(self, dim):
        coord = self.coords[dim]
        return DataArray(
            coord.values[self.argmax(dim).values],
            tuple(d for d in self.dims if d != dim),
            name=self.name,
        )

    def pipe(self, func, *args, **kwargs):
        return func(self, *args, **kwargs)

    def round(self, decimals=0):
        out = DataArray(np.round(self.values, decimals), self.dims, attrs=self.attrs, name=self.name)
        out.coords = dict(self.coords)
        return out

    def plot(self, ax=None, **kwargs):
        """Quick echogram/line plot (2-d -> pcolormesh, 1-d -> line)."""
        import matplotlib.pyplot as plt

        if ax is None:
            _, ax = plt.subplots()
        if self.ndim == 2:
            y, x = self.dims
            xs = self.coords[x].values if x in self.coords else np.arange(self.shape[1])
            ys = self.coords[y].values if y in self.coords else np.arange(self.shape[0])
            m = ax.pcolormesh(xs, ys, self.values, **kwargs)
            ax.set_xlabel(x)
            ax.set_ylabel(y)
            plt.colorbar(m, ax=ax, label=self.name or "")
            return m
        xs = (
            self.coords[self.dims[0]].values
            if self.dims and self.dims[0] in self.coords
            else np.arange(self.size)
        )
        (line,) = ax.plot(xs, self.values, **kwargs)
        if self.dims:
            ax.set_xlabel(self.dims[0])
        ax.set_ylabel(self.name or "")
        return line

    def cumsum(self, dim, skipna=True):
        ax = self._dim_index(dim)
        func = np.nancumsum if skipna else np.cumsum
        out = DataArray(func(self.values, axis=ax), self.dims, attrs=self.attrs, name=self.name)
        out.coords = dict(self.coords)
        return out

    def diff(self, dim, n=1, label="upper"):
        ax = self._dim_index(dim)
        vals = np.diff(self.values, n=n, axis=ax)
        out = DataArray(vals, self.dims, name=self.name)
        sl = slice(n, None) if label == "upper" else slice(None, -n)
        for k, v in self.coords.items():
            if dim not in v.dims:
                out.coords[k] = v
            elif k == dim:
                out.coords[k] = DataArray(v.values[sl], v.dims, attrs=v.attrs, name=k)
        return out

    # ------------------------------------------------------------- nan / where
    def isnull(self):
        if np.issubdtype(self.dtype, np.floating) or np.issubdtype(self.dtype, np.complexfloating):
            vals = np.isnan(self.values)
        elif np.issubdtype(self.dtype, np.datetime64):
            vals = np.isnat(self.values)
        else:
            vals = np.zeros(self.shape, dtype=bool)
        out = DataArray(vals, self.dims, name=self.name)
        out.coords = dict(self.coords)
        return out

    def notnull(self):
        return ~self.isnull()

    def fillna(self, value):
        mask = self.isnull().values
        vals = np.where(mask, value, self.values)
        out = DataArray(vals, self.dims, attrs=self.attrs, name=self.name)
        out.coords = dict(self.coords)
        return out

    def where(self, cond, other=np.nan):
        from .ops import broadcast_arrays

        if not isinstance(cond, DataArray):
            cond = DataArray(np.asarray(cond), self.dims if np.ndim(cond) else ())
        a, c = broadcast_arrays(self, cond)
        o = other
        if isinstance(other, DataArray):
            a2, o_b = broadcast_arrays(a, other)
            o = np.broadcast_to(o_b.values, a2.shape)
            a = a2
            _, c = broadcast_arrays(a, cond)
        av = a.values
        if (
            av.dtype.kind in ("U", "S")
            and not isinstance(o, np.ndarray)
            and isinstance(o, float)
            and np.isnan(o)
        ):
            # xarray: NaN-masking a string array promotes it to object
            av = av.astype(object)
        vals = np.where(c.values, av, o)
        out = DataArray(vals, a.dims, attrs=self.attrs, name=self.name)
        out.coords = a.coords
        return out

    def clip(self, min=None, max=None):
        out = DataArray(np.clip(self.values, min, max), self.dims, attrs=self.attrs, name=self.name)
        out.coords = dict(self.coords)
        return out

    def dropna(self, dim, how="any"):
        ax = self._dim_index(dim)
        other_axes = tuple(i for i in range(self.ndim) if i != ax)
        nulls = self.isnull().values
        bad = nulls.all(axis=other_axes) if how == "all" else nulls.any(axis=other_axes)
        return self.isel({dim: np.nonzero(~bad)[0]})

    # ----------------------------------------------------------------- interp
    def interp(self, coords=None, method="linear", kwargs=None, **kw):
        """Interpolate along one dim onto new coordinate labels.

        xarray parity: scalar targets drop the dim; a DataArray target with a
        different dim renames the interpolated dim to the indexer's dim (the
        access pattern of align_to_ping_time, utils/align.py:5-61).
        Methods: "linear" (optionally fill_value="extrapolate") or "nearest"
        natively; the scipy spline kinds ("zero", "slinear", "quadratic",
        "cubic") delegate to scipy.interpolate.interp1d exactly as xarray
        does (needed to execute the reference's EnvParams._apply,
        calibrate/env_params_old.py:140-154, as an oracle).  The scipy path
        propagates NaNs like xarray (no NaN-dropping).
        """
        coords = {**(coords or {}), **kw}
        if len(coords) != 1:
            # multi-dim: tensor-product interpolation, applied one dim at a
            # time (equivalent to multilinear interpn on an outer-product
            # target grid for the supported linear/nearest methods)
            out = self
            for dim, new_labels in coords.items():
                out = out.interp({dim: new_labels}, method=method, kwargs=kwargs)
            return out
        (dim, new_labels), = coords.items()
        fill = (kwargs or {}).get("fill_value", None)
        old = self.coords[dim].values
        indexer = new_labels if isinstance(new_labels, DataArray) else None
        newc = indexer.values if indexer is not None else np.asarray(new_labels)
        scalar = newc.ndim == 0
        newc_1d = np.atleast_1d(newc)
        time_like = np.issubdtype(old.dtype, np.datetime64)
        x_old = old.astype("datetime64[ns]").astype("f8") if time_like else old.astype("f8")
        x_new = (
            newc_1d.astype("datetime64[ns]").astype("f8")
            if time_like
            else np.asarray(newc_1d, dtype="f8")
        )
        ax = self._dim_index(dim)
        moved = np.moveaxis(self.values.astype("f8"), ax, -1)
        flat = moved.reshape(-1, moved.shape[-1])
        out_flat = np.empty((flat.shape[0], x_new.size), dtype="f8")
        order = np.argsort(x_old)
        xo = x_old[order]
        if method not in ("linear", "nearest"):
            # scipy spline kinds, exactly as xarray's interp delegates
            from scipy.interpolate import interp1d

            f = interp1d(
                xo,
                flat[:, order],
                kind=method,
                axis=-1,
                bounds_error=False,
                fill_value=fill if fill is not None else np.nan,
            )
            out_flat[:] = f(x_new)
            new_shape = moved.shape[:-1] + (x_new.size,)
            vals = np.moveaxis(out_flat.reshape(new_shape), -1, ax)
            out = DataArray(vals, self.dims, attrs=self.attrs, name=self.name)
            out.coords = {k: v for k, v in self.coords.items() if dim not in v.dims}
            if scalar:
                out = out.isel({dim: 0})
                out.coords[dim] = DataArray(np.asarray(newc), (), name=dim)
            else:
                out.coords[dim] = DataArray(newc_1d, (dim,), name=dim)
            return out
        # NaN PROPAGATION (round-5 facade review): real xarray's interp is
        # scipy-backed — a NaN sample poisons every interval it bounds (even
        # an exact hit on the finite endpoint: y0 + slope*0 with slope NaN).
        # The previous per-row NaN-dropping silently interpolated over gaps,
        # diverging from what real echopype produces on partial-NaN inputs
        # (e.g. add_location on NaN-holed NMEA positions, where the
        # reference only WARNS, consolidate/loc_utils.py "some_nan").
        n_xo = len(xo)
        if method == "nearest":
            if n_xo > 1:
                pos = np.clip(np.searchsorted(xo, x_new), 1, n_xo - 1)
                left_closer = (x_new - xo[pos - 1]) <= (xo[pos] - x_new)
                pos = np.where(left_closer, pos - 1, pos)
            else:
                pos = np.zeros(x_new.shape, dtype=int)
            oob = None
            if fill != "extrapolate":
                oob = (x_new < xo[0]) | (x_new > xo[-1])
            for i in range(flat.shape[0]):
                out_flat[i] = flat[i][order][pos]
                if oob is not None:
                    out_flat[i][oob] = np.nan
        else:
            if n_xo == 1:
                for i in range(flat.shape[0]):
                    out_flat[i] = np.where(x_new == xo[0], flat[i][order][0], np.nan)
            else:
                # scipy interp1d(kind="linear") index rule: side='left'
                # searchsorted clipped to [1, n-1], so exact hits evaluate
                # in their LEFT interval and end intervals extrapolate
                idx = np.clip(np.searchsorted(xo, x_new), 1, n_xo - 1)
                x0, x1 = xo[idx - 1], xo[idx]
                oob = None
                if fill != "extrapolate":
                    oob = (x_new < xo[0]) | (x_new > xo[-1])
                with np.errstate(invalid="ignore", divide="ignore"):
                    w = (x_new - x0) / (x1 - x0)
                for i in range(flat.shape[0]):
                    yo = flat[i][order]
                    y0, y1 = yo[idx - 1], yo[idx]
                    with np.errstate(invalid="ignore"):
                        out_flat[i] = y0 + (y1 - y0) * w
                    if oob is not None:
                        out_flat[i][oob] = np.nan
        new_shape = moved.shape[:-1] + (x_new.size,)
        vals = np.moveaxis(out_flat.reshape(new_shape), -1, ax)
        # name of the output dim: a DataArray indexer on a different dim
        # renames (xarray vectorized-interp semantics)
        out_dim = dim
        if indexer is not None and indexer.ndim == 1 and indexer.dims[0] != dim:
            out_dim = indexer.dims[0]
        out_dims = tuple(out_dim if d == dim else d for d in self.dims)
        out = DataArray(vals, out_dims, attrs=self.attrs, name=self.name)
        out.coords = {k: v for k, v in self.coords.items() if dim not in v.dims}
        if scalar:
            out = out.isel({out_dim: 0})
            out.coords[dim] = DataArray(np.asarray(newc), (), name=dim)
            return out
        out.coords[dim] = DataArray(newc_1d, (out_dim,), name=dim)
        if out_dim != dim:
            if indexer is not None and out_dim in indexer.coords:
                out.coords[out_dim] = indexer.coords[out_dim]
            else:
                out.coords[out_dim] = DataArray(newc_1d, (out_dim,), name=out_dim)
        return out

    # ------------------------------------------------------------- metadata
    def assign_coords(self, coords=None, **kw):
        out = self.copy()
        for k, v in {**(coords or {}), **kw}.items():
            out._set_coord(k, v)
        return out

    def assign_attrs(self, *args, **kw):
        out = self.copy()
        for a in args:
            out.attrs.update(a)
        out.attrs.update(kw)
        return out

    def drop_vars(self, names, errors="raise"):
        names = [names] if isinstance(names, str) else list(names)
        out = self.copy()
        for n in names:
            if n in out.coords:
                del out.coords[n]
            elif errors == "raise":
                raise KeyError(n)
        return out

    def to_dataset(self, name=None):
        from .dataset import Dataset

        nm = name or self.name
        if nm is None:
            raise ValueError("cannot convert unnamed DataArray to Dataset")
        return Dataset({nm: self})

    def to_dataframe(self, name=None):
        """1-D DataArray -> pandas DataFrame indexed by the dim coordinate
        (the access pattern of the reference's lat/lon distance walk,
        commongrid/utils.py:210-231)."""
        import pandas as pd

        if self.ndim != 1:
            raise NotImplementedError("xrlite to_dataframe supports 1-D arrays")
        d = self.dims[0]
        if d in self.coords:
            idx = pd.Index(self.coords[d].values, name=d)
        else:
            idx = pd.RangeIndex(len(self.values), name=d)
        return pd.DataFrame({name or self.name: self.values}, index=idx)

    def to_numpy(self):
        return self.values

    def pad(self, pad_width: dict, constant_values=np.nan):
        widths = [pad_width.get(d, (0, 0)) for d in self.dims]
        widths = [(w, w) if isinstance(w, int) else w for w in widths]
        vals = np.pad(self.values, widths, constant_values=constant_values)
        out = DataArray(vals, self.dims, attrs=self.attrs, name=self.name)
        out.coords = {k: v for k, v in self.coords.items() if not set(v.dims) & set(pad_width)}
        return out

    def reindex(self, indexers=None, method=None, fill_value=np.nan, **kw):
        """Conform onto new coordinate labels along existing dims.

        Supports exact matching (``method=None``, unmatched labels filled with
        ``fill_value``) and forward-fill (``method='ffill'``: each new label
        takes the value at the nearest old label <= it), which is what the
        reference's noise-estimate upsampling uses
        (reference: echopype/clean/api.py:424-431, clean/utils.py:246-250).
        """
        indexers = dict(indexers or {})
        indexers.update(kw)
        out = self
        for dim, new_labels in indexers.items():
            if isinstance(new_labels, DataArray):
                new = np.asarray(new_labels.values)
            else:
                new = np.asarray(new_labels)
            old_coord = out.coords.get(dim)
            if old_coord is None:
                raise KeyError(f"reindex: no coordinate for dim {dim!r}")
            old = np.asarray(old_coord.values)
            if len(old) == 0:
                # empty source index: every new label is unmatched
                idx = np.zeros(len(new), dtype=np.intp)
                valid = np.zeros(len(new), dtype=bool)
            elif method == "ffill":
                # xarray requires a monotonic index for fill methods
                if len(old) > 1 and not np.all(old[1:] >= old[:-1]):
                    raise ValueError(
                        f"reindex with method='ffill' requires a monotonically "
                        f"increasing {dim!r} index"
                    )
                idx = np.searchsorted(old, new, side="right") - 1
                valid = idx >= 0
                idx = np.clip(idx, 0, len(old) - 1)
            elif method is None:
                # exact label matching; the old index need not be sorted
                order = np.argsort(old, kind="stable")
                pos = np.searchsorted(old[order], new)
                pos = np.clip(pos, 0, len(old) - 1)
                idx = order[pos]
                valid = old[idx] == new
            else:
                raise NotImplementedError(f"reindex method={method!r}")
            ax = out._dim_index(dim)
            if len(old) == 0:
                # np.take on a zero-length axis is invalid; build the filled
                # shape directly
                shape = list(out.values.shape)
                shape[ax] = len(new)
                vals = np.empty(shape, dtype=out.values.dtype)
            else:
                vals = np.take(out.values, idx, axis=ax)
            if not valid.all():
                sl = [slice(None)] * vals.ndim
                sl[ax] = ~valid
                if np.issubdtype(vals.dtype, np.datetime64):
                    vals = vals.astype("datetime64[ns]")
                    vals[tuple(sl)] = np.datetime64("NaT")
                elif vals.dtype.kind in ("O", "U", "S"):
                    # xarray fills object/string arrays with NaN (object
                    # dtype), e.g. EK80 transmit_type along ping_time
                    vals = vals.astype(object)
                    vals[tuple(sl)] = fill_value
                else:
                    if not np.issubdtype(vals.dtype, np.floating):
                        vals = vals.astype(np.float64)
                    vals[tuple(sl)] = fill_value
            res = DataArray(vals, out.dims, attrs=out.attrs, name=out.name)
            for k, v in out.coords.items():
                if dim not in v.dims:
                    res.coords[k] = v
            res.coords[dim] = DataArray(new, (dim,), name=dim)
            out = res
        return out

    def reindex_like(self, other, method=None, fill_value=np.nan):
        indexers = {
            d: other.coords[d] for d in self.dims if d in other.coords and d in self.coords
        }
        return self.reindex(indexers, method=method, fill_value=fill_value)

    @property
    def indexes(self):
        """pandas Index per 1-D dim coordinate (xarray parity)."""
        import pandas as pd

        return {
            d: pd.Index(self.coords[d].values)
            for d in self.dims
            if d in self.coords and self.coords[d].dims == (d,)
        }

    def resample(self, indexer=None, skipna=True, **kw):
        """Datetime resample along one dim (see _Resample)."""
        spec = {**(indexer or {}), **kw}
        if len(spec) != 1:
            raise ValueError("resample takes exactly one dim=freq pair")
        (dim, freq), = spec.items()
        return _Resample(self, dim, freq, skipna=skipna)

    def coarsen(self, windows=None, boundary="strict", coord_func="mean", **dim_windows):
        """Block aggregation over fixed-size windows (xarray's ``coarsen``).

        Returns a lazy helper exposing ``mean``/``sum``/``min``/``max``.
        ``boundary='pad'`` NaN-pads each coarsened dim up to a window multiple;
        coords along coarsened dims are reduced with ``coord_func`` (datetimes
        through int64 nanoseconds), matching xarray's semantics as used by the
        reference's index-binned MVBS (reference: echopype/commongrid/api.py:
        217-238) and background-noise estimator (clean/api.py:402-408).
        """
        if isinstance(windows, dict):
            dim_windows = {**windows, **dim_windows}
        return _Coarsen(self, dim_windows, boundary, coord_func)


class _Coarsen:
    """Lazy helper returned by ``DataArray.coarsen``."""

    def __init__(self, da, dim_windows, boundary, coord_func):
        self.da = da
        self.dim_windows = dict(dim_windows)
        self.boundary = boundary
        self.coord_func = coord_func
        bad = [d for d in self.dim_windows if d not in da.dims]
        if bad:
            raise ValueError(f"coarsen dims {bad} not in {da.dims}")

    @staticmethod
    def _block_reduce(vals, dims, dim_windows, boundary, fname, skipna):
        """Pad/trim ``vals`` then reduce each window along coarsened dims."""
        is_dt = np.issubdtype(vals.dtype, np.datetime64)
        if is_dt:
            work = vals.astype("datetime64[ns]").astype(np.int64).astype(np.float64)
            work[np.isnat(vals)] = np.nan
        else:
            work = vals
        new_shape = []
        window_axes = []
        pads = []
        trims = []
        needs_pad = False
        for i, d in enumerate(dims):
            n = work.shape[i]
            if d in dim_windows:
                w = int(dim_windows[d])
                if boundary == "pad":
                    nb = -(-n // w)
                    pads.append((0, nb * w - n))
                    needs_pad = needs_pad or nb * w != n
                    trims.append(slice(None))
                elif boundary == "trim":
                    nb = n // w
                    pads.append((0, 0))
                    trims.append(slice(0, nb * w))
                else:
                    if n % w:
                        raise ValueError(
                            f"coarsen: size {n} of dim {d!r} not a multiple of {w}"
                        )
                    nb = n // w
                    pads.append((0, 0))
                    trims.append(slice(None))
                window_axes.append(len(new_shape) + 1)
                new_shape.extend([nb, w])
            else:
                pads.append((0, 0))
                trims.append(slice(None))
                new_shape.append(n)
        work = work[tuple(trims)]
        if needs_pad:
            if not np.issubdtype(work.dtype, np.floating):
                work = work.astype(np.float64)
            work = np.pad(work, pads, constant_values=np.nan)
        work = work.reshape(new_shape)
        fn = {
            ("mean", True): np.nanmean,
            ("mean", False): np.mean,
            ("sum", True): np.nansum,
            ("sum", False): np.sum,
            ("min", True): np.nanmin,
            ("min", False): np.min,
            ("max", True): np.nanmax,
            ("max", False): np.max,
        }[(fname, bool(skipna))]
        import warnings

        with warnings.catch_warnings():
            warnings.simplefilter("ignore", RuntimeWarning)
            out = fn(work, axis=tuple(window_axes))
        if is_dt:
            nat = np.isnan(out)
            out = np.where(nat, 0.0, out)
            out = np.round(out).astype(np.int64).astype("datetime64[ns]")
            if nat.any():
                out[nat] = np.datetime64("NaT")
        return out

    def _reduce(self, fname, skipna=True):
        da = self.da
        vals = self._block_reduce(
            da.values, da.dims, self.dim_windows, self.boundary, fname, skipna
        )
        out = DataArray(vals, da.dims, attrs=da.attrs, name=da.name)
        for k, v in da.coords.items():
            hit = set(v.dims) & set(self.dim_windows)
            if not hit:
                out.coords[k] = v
            else:
                cvals = self._block_reduce(
                    v.values, v.dims, self.dim_windows, self.boundary, self.coord_func, True
                )
                out.coords[k] = DataArray(cvals, v.dims, attrs=v.attrs, name=k)
        return out

    def mean(self, skipna=True, **kw):
        return self._reduce("mean", skipna)

    def sum(self, skipna=True, **kw):
        return self._reduce("sum", skipna)

    def min(self, skipna=True, **kw):
        return self._reduce("min", skipna)

    def max(self, skipna=True, **kw):
        return self._reduce("max", skipna)


class _Resample:
    """Helper returned by ``DataArray.resample`` (datetime group-bins).

    Implements the access pattern the reference uses to build its ping-time
    bin grid: ``da.resample(ping_time="20s").first().indexes["ping_time"]``
    (reference: commongrid/api.py:117-124, mask/api.py regrid_mask) — the
    pandas resample index, including empty interior bins.
    """

    def __init__(self, da, dim, freq, skipna=True):
        self.da = da
        self.dim = dim
        self.freq = freq
        self.skipna = skipna

    def _grouped(self):
        import pandas as pd

        t = np.asarray(self.da.coords[self.dim].values, dtype="datetime64[ns]")
        ax = self.da._dim_index(self.dim)
        moved = np.moveaxis(self.da.values, ax, 0)
        flat = moved.reshape(len(t), -1)
        df = pd.DataFrame(flat, index=pd.DatetimeIndex(t))
        return df, moved.shape, ax

    def _finish(self, res, shape, ax):
        vals = res.to_numpy().reshape((len(res.index),) + shape[1:])
        vals = np.moveaxis(vals, 0, ax)
        dims = self.da.dims
        out = DataArray(vals, dims, attrs=self.da.attrs, name=self.da.name)
        for k, v in self.da.coords.items():
            if self.dim not in v.dims:
                out.coords[k] = v
        out.coords[self.dim] = DataArray(
            np.asarray(res.index.values, dtype="datetime64[ns]"), (self.dim,), name=self.dim
        )
        return out

    def first(self):
        df, shape, ax = self._grouped()
        res = df.resample(self.freq).first()
        return self._finish(res, shape, ax)

    def mean(self):
        df, shape, ax = self._grouped()
        if self.skipna:
            res = df.resample(self.freq).mean()
        else:
            # pandas Resampler.mean has no skipna; NaN must poison its bin
            res = df.resample(self.freq).apply(lambda s: s.mean(skipna=False))
        return self._finish(res, shape, ax)


def _groupby(obj, name):
    """Shared Dataset/DataArray groupby: group along a 1-D coordinate's dim,
    yielding (key, subset) with keys in sorted order (xarray iterates groups
    sorted by unique key — pandas factorize-sort semantics)."""
    coord = obj.coords[name]
    if len(coord.dims) != 1:
        raise ValueError(f"groupby coordinate {name!r} must be 1-D")
    (dim,) = coord.dims
    vals = np.asarray(coord.values)
    uniq, inv = np.unique(vals, return_inverse=True)
    return [(uniq[k], obj.isel({dim: np.nonzero(inv == k)[0]}))
            for k in range(len(uniq))]
