"""Dataset: a mapping of DataArrays sharing named dimensions."""

from __future__ import annotations

import numpy as np

from .dataarray import DataArray, _groupby

__all__ = ["Dataset"]


class Dataset:
    """A dict of named DataArrays + shared coords + attrs.

    Mirrors the subset of xr.Dataset used at the reference's API boundaries
    (see SURVEY.md Appendix B for the group contents this carries).
    """

    __slots__ = ("data_vars", "_coords", "attrs", "_encoding")

    @property
    def coords(self):
        return self._coords

    @coords.setter
    def coords(self, value):
        from .dataarray import CoordsDict

        cd = CoordsDict()
        cd.update(value)
        self._coords = cd

    @property
    def encoding(self):
        try:
            enc = object.__getattribute__(self, "_encoding")
        except AttributeError:
            enc = {}
            object.__setattr__(self, "_encoding", enc)
        return enc

    @encoding.setter
    def encoding(self, value):
        object.__setattr__(self, "_encoding", dict(value))

    def __init__(self, data_vars=None, coords=None, attrs=None):
        self.data_vars = {}
        self.coords = {}
        self.attrs = dict(attrs) if attrs else {}
        if coords:
            for k, v in coords.items():
                self._set_coord(k, v)
        if data_vars:
            for k, v in data_vars.items():
                self[k] = v

    # ------------------------------------------------------------------ dunder
    def _set_coord(self, name, val):
        if isinstance(val, DataArray):
            da = DataArray(val.values, val.dims, attrs=val.attrs, name=name)
            if val.encoding:
                da.encoding = val.encoding
            self.coords[name] = da
        elif isinstance(val, tuple) and len(val) in (2, 3):
            dims, data = val[0], val[1]
            attrs = val[2] if len(val) == 3 else None
            dims = (dims,) if isinstance(dims, str) else tuple(dims)
            self.coords[name] = DataArray(np.asarray(data), dims, attrs=attrs, name=name)
        else:
            arr = np.asarray(val)
            dims = (name,) if arr.ndim == 1 else ()
            self.coords[name] = DataArray(arr, dims, name=name)

    def __setitem__(self, name, val):
        if name in self.coords and name not in self.data_vars:
            # xarray parity: assignment to an existing coordinate name
            # updates the coordinate (e.g. qc's ds["ping_time"] = (dims, vals))
            self._set_coord(name, val)
            return
        # xarray parity: a variable assigned under a name equal to one of its
        # own dims becomes an index coordinate (the reference's combine relies
        # on this when re-assigning concatenated variables, combine.py:820-823)
        val_dims = (
            val.dims
            if isinstance(val, DataArray)
            else (val[0],) if isinstance(val, tuple) and isinstance(val[0], str) else
            tuple(val[0]) if isinstance(val, tuple) and isinstance(val[0], (list, tuple)) else ()
        )
        if name in val_dims and name not in self.data_vars:
            self._set_coord(name, val)
            return
        if isinstance(val, DataArray):
            da = DataArray(val.values, val.dims, attrs=val.attrs, name=name)
            da.coords = dict(val.coords)
            if val.encoding:
                da.encoding = val.encoding
        elif isinstance(val, tuple) and len(val) in (2, 3):
            dims, data = val[0], val[1]
            attrs = val[2] if len(val) == 3 else None
            dims = (dims,) if isinstance(dims, str) else tuple(dims)
            da = DataArray(np.asarray(data), dims, attrs=attrs, name=name)
        else:
            arr = np.asarray(val)
            if arr.ndim != 0:
                raise ValueError(f"cannot infer dims for {name!r}; pass (dims, values)")
            da = DataArray(arr, (), name=name)
        # check dim-size consistency
        for d, n in da.sizes.items():
            cur = self.sizes.get(d)
            if cur is not None and cur != n:
                raise ValueError(f"variable {name!r}: dim {d!r} size {n} != existing {cur}")
        # absorb the variable's own coords into dataset coords
        for ck, cv in da.coords.items():
            if ck not in self.coords:
                self._set_coord(ck, cv)
        da.coords = {}
        self.data_vars[name] = da

    def __getitem__(self, name):
        if isinstance(name, list):
            out = Dataset(attrs=dict(self.attrs))
            for n in name:
                out[n] = self[n]
            for k, v in self.coords.items():
                used = set().union(*(self[n].dims for n in name)) if name else set()
                if set(v.dims) <= used:
                    out.coords.setdefault(k, v)
            return out
        if name in self.data_vars:
            da = self.data_vars[name]
            out = DataArray(da.values, da.dims, name=name)
            out.coords = {
                k: v for k, v in self.coords.items() if set(v.dims) <= set(da.dims)
            }
            # share the stored variable's attrs + encoding dicts so mutation
            # through the returned wrapper sticks (xarray Variable-sharing
            # semantics: ds["x"].attrs["k"] = v reaches the stored variable)
            object.__setattr__(out, "_attrs", da.attrs)
            object.__setattr__(out, "_encoding", da.encoding)
            # the wrapper shares the stored ndarray: let `.data = x` write
            # through (xarray Variable-sharing); plain DataArrays (e.g.
            # .copy() results) rebind instead
            object.__setattr__(out, "_writethrough", True)
            return out
        if name in self.coords:
            c = self.coords[name]
            out = DataArray(c.values, c.dims, name=name)
            out.coords = {
                k: v for k, v in self.coords.items() if set(v.dims) <= set(c.dims)
            }
            object.__setattr__(out, "_attrs", c.attrs)
            object.__setattr__(out, "_encoding", c.encoding)
            object.__setattr__(out, "_writethrough", True)
            return out
        raise KeyError(name)

    def __contains__(self, name):
        return name in self.data_vars or name in self.coords

    def __getattr__(self, name):
        # Attribute access for variables/coords, xarray-style (ds.channel).
        if name.startswith("_"):
            raise AttributeError(name)
        try:
            dv = object.__getattribute__(self, "data_vars")
            co = object.__getattribute__(self, "coords")
        except AttributeError:
            raise AttributeError(name) from None
        if name in dv or name in co:
            return self[name]
        # xarray parity: dataset attributes are reachable as attributes too
        # (the reference reads ds.keywords, echodata/echodata.py:276)
        at = object.__getattribute__(self, "attrs")
        if name in at:
            return at[name]
        raise AttributeError(f"Dataset has no attribute, variable, or coordinate {name!r}")

    def __iter__(self):
        return iter(self.data_vars)

    def __len__(self):
        return len(self.data_vars)

    def __delitem__(self, name):
        if name in self.data_vars:
            del self.data_vars[name]
        elif name in self.coords:
            del self.coords[name]
        else:
            raise KeyError(name)

    def __repr__(self):
        lines = [f"<xrlite.Dataset dims={self.sizes}>"]
        for k, v in self.coords.items():
            lines.append(f"  * {k:30s} {v.dims} {v.dtype}")
        for k, v in self.data_vars.items():
            lines.append(f"    {k:30s} {v.dims} {v.dtype}")
        return "\n".join(lines)

    # -------------------------------------------------------------- properties
    @property
    def sizes(self):
        out = {}
        for da in list(self.data_vars.values()) + list(self.coords.values()):
            for d, n in da.sizes.items():
                out.setdefault(d, n)
        return out

    @property
    def dims(self):
        return self.sizes

    @property
    def variables(self):
        """Mapping of all variables including coordinates (xarray parity)."""
        return {**self.coords, **self.data_vars}

    @property
    def nbytes(self):
        return sum(v.nbytes for v in self.data_vars.values()) + sum(
            v.nbytes for v in self.coords.values()
        )

    def keys(self):
        return self.data_vars.keys()

    def values(self):
        return self.data_vars.values()

    def items(self):
        return self.data_vars.items()

    def get(self, name, default=None):
        try:
            return self[name]
        except KeyError:
            return default

    # -------------------------------------------------------------- selection
    def isel(self, indexers=None, drop=False, **kw):
        indexers = {**(indexers or {}), **kw}
        out = Dataset(attrs=dict(self.attrs))
        for k, v in self.coords.items():
            rel = {d: i for d, i in indexers.items() if d in v.dims}
            nv = v.isel(rel) if rel else v
            if nv.ndim == 0 and drop:
                continue
            out.coords[k] = nv
        for k, v in self.data_vars.items():
            rel = {d: i for d, i in indexers.items() if d in v.dims}
            out.data_vars[k] = v.isel(rel) if rel else v
        return out

    def sel(self, indexers=None, method=None, drop=False, **kw):
        indexers = {**(indexers or {}), **kw}
        iidx = {}
        for d, lab in indexers.items():
            ref = DataArray(
                np.zeros(self.sizes[d]), (d,), coords={d: self.coords[d]}
            )
            iidx[d] = ref._label_to_index(d, lab, method)
        return self.isel(iidx, drop=drop)

    def where(self, cond, other=np.nan, drop=False):
        out = Dataset(attrs=dict(self.attrs))
        out.coords = dict(self.coords)
        for k, v in self.data_vars.items():
            da = self[k]
            out.data_vars[k] = da.where(cond, other) if set(cond.dims) & set(da.dims) else da
        if drop:
            # xarray semantics: along each of cond's dims keep only indices
            # where cond is True somewhere (reference: set_groups_ek80.py's
            # LFM/CW complex split)
            cv = np.asarray(cond.values, dtype=bool)
            for d in cond.dims:
                ax = cond.dims.index(d)
                keep = cv.any(axis=tuple(i for i in range(cv.ndim) if i != ax))
                out = out.isel({d: np.nonzero(keep)[0]})
        return out

    def dropna(self, dim, how="any", subset=None):
        names = subset or list(self.data_vars)
        mask = None
        for n in names:
            v = self[n]
            if dim not in v.dims:
                continue
            axes = tuple(i for i, d in enumerate(v.dims) if d != dim)
            nulls = v.isnull().values
            bad = nulls.all(axis=axes) if how == "all" else nulls.any(axis=axes)
            mask = bad if mask is None else (mask | bad)
        if mask is None:
            return self
        return self.isel({dim: np.nonzero(~mask)[0]})

    # -------------------------------------------------------------- mutation
    def assign(self, variables=None, **kw):
        out = self.copy()
        for k, v in {**(variables or {}), **kw}.items():
            out[k] = v(out) if callable(v) else v
        return out

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

    def reindex(self, indexers=None, method=None, fill_value=np.nan, **kw):
        """Conform every variable onto new labels along existing dims
        (delegates to DataArray.reindex per variable)."""
        indexers = {**(indexers or {}), **kw}
        out = Dataset(attrs=dict(self.attrs))
        for k, v in self.coords.items():
            out.coords[k] = v
        for dim, new_labels in indexers.items():
            new = np.asarray(getattr(new_labels, "values", new_labels))
            out.coords[dim] = DataArray(new, (dim,), name=dim)
        for k, v in self.data_vars.items():
            da = self[k]
            rel = {d: lab for d, lab in indexers.items() if d in da.dims}
            res = da.reindex(rel, method=method, fill_value=fill_value) if rel else da
            res.coords = {}
            out.data_vars[k] = res
        # non-dim coords over reindexed dims must follow too
        for k, v in list(self.coords.items()):
            rel = {d: lab for d, lab in indexers.items() if d in v.dims and k != d}
            if rel:
                tmp = DataArray(v.values, v.dims, attrs=v.attrs, name=k)
                tmp.coords = {
                    c: cv for c, cv in self.coords.items() if set(cv.dims) <= set(v.dims)
                }
                res = tmp.reindex(rel, method=method, fill_value=fill_value)
                res.coords = {}
                out.coords[k] = res
        return out

    def reindex_like(self, other, method=None, fill_value=np.nan):
        indexers = {
            d: other.coords[d]
            for d in self.dims
            if d in other.coords and d in self.coords
        }
        return self.reindex(indexers, method=method, fill_value=fill_value)

    def set_coords(self, names):
        """Promote data variables to coordinates (xarray parity)."""
        if isinstance(names, str):
            names = [names]
        out = self.copy()
        for n in names:
            if n in out.data_vars:
                out.coords[n] = out.data_vars.pop(n)
            elif n not in out.coords:
                raise KeyError(n)
        return out

    def reset_coords(self, names=None, drop=False):
        """Demote non-dim coordinates back to data variables."""
        if names is None:
            names = [k for k, v in self.coords.items() if v.dims != (k,)]
        elif isinstance(names, str):
            names = [names]
        out = self.copy()
        for n in names:
            if n in out.coords:
                c = out.coords.pop(n)
                if not drop:
                    out.data_vars[n] = c
        return out

    def drop_vars(self, names, errors="raise"):
        names = [names] if isinstance(names, str) else list(names)
        out = self.copy()
        for n in names:
            if n in out.data_vars:
                del out.data_vars[n]
            elif n in out.coords:
                del out.coords[n]
            elif errors == "raise":
                raise KeyError(n)
        return out

    def drop_dims(self, dims, errors="raise"):
        """Drop all variables and coords that use any of ``dims``."""
        dims = {dims} if isinstance(dims, str) else set(dims)
        if errors == "raise":
            missing = dims - set(self.sizes)
            if missing:
                raise ValueError(f"dims {sorted(missing)} not found in Dataset")
        out = Dataset(attrs=dict(self.attrs))
        for k, v in self.coords.items():
            if not (set(v.dims) & dims):
                out.coords[k] = v
        for k, v in self.data_vars.items():
            if not (set(v.dims) & dims):
                out.data_vars[k] = v
        return out

    def compute(self):
        return self

    def load(self):
        return self

    def chunk(self, *args, **kwargs):
        return self

    def equals(self, other):
        if not isinstance(other, Dataset):
            return False
        if set(self.data_vars) != set(other.data_vars):
            return False
        return all(self[k].equals(other[k]) for k in self.data_vars)

    def identical(self, other):
        """Like equals plus attribute equality, for vars, coords and the
        dataset itself (xarray parity; the reference's Vendor_specific
        identity check, echodata/combine.py:545)."""
        if not self.equals(other):
            return False
        if set(self.coords) != set(other.coords):
            return False
        if not all(self.coords[k].equals(other.coords[k]) for k in self.coords):
            return False

        def _attrs_eq(a, b):
            if set(a) != set(b):
                return False
            for k in a:
                va, vb = a[k], b[k]
                if isinstance(va, np.ndarray) or isinstance(vb, np.ndarray):
                    if not np.array_equal(np.asarray(va), np.asarray(vb)):
                        return False
                elif va != vb:
                    return False
            return True

        if not _attrs_eq(self.attrs, other.attrs):
            return False
        for k in self.data_vars:
            if not _attrs_eq(self.data_vars[k].attrs, other.data_vars[k].attrs):
                return False
        for k in self.coords:
            if not _attrs_eq(self.coords[k].attrs, other.coords[k].attrs):
                return False
        return True

    def astype(self, dtype):
        out = self.copy()
        for k, da in out.data_vars.items():
            out.data_vars[k] = da.astype(dtype)
        return out

    @classmethod
    def from_dataframe(cls, df) -> "Dataset":
        """pandas DataFrame -> Dataset: index becomes the dim coordinate,
        columns become 1-d variables (what pandas' DataFrame.to_xarray
        delegates to; used by the reference's combine provenance table,
        echodata/combine.py:631-639)."""
        idx = df.index
        if getattr(idx, "nlevels", 1) != 1:
            raise NotImplementedError("MultiIndex from_dataframe is not supported")
        dim = idx.name if idx.name is not None else "index"
        ds = cls()
        ds.coords[dim] = DataArray(np.asarray(idx), (dim,), name=dim)
        for col in df.columns:
            vals = df[col].to_numpy()
            ds.data_vars[str(col)] = DataArray(vals, (dim,), name=str(col))
        return ds

    def rename(self, name_map=None, name_dict=None, **kw):
        # xarray's signature names the mapping ``name_dict``; accept both
        name_map = {**(name_map or {}), **(name_dict or {}), **kw}
        out = Dataset(attrs=dict(self.attrs))
        for k, v in self.coords.items():
            nk = name_map.get(k, k)
            out.coords[nk] = DataArray(
                v.values,
                tuple(name_map.get(d, d) for d in v.dims),
                attrs=v.attrs,
                name=nk,
            )
        for k, v in self.data_vars.items():
            nk = name_map.get(k, k)
            out.data_vars[nk] = DataArray(
                v.values,
                tuple(name_map.get(d, d) for d in v.dims),
                attrs=v.attrs,
                name=nk,
            )
        return out

    def swap_dims(self, dim_map):
        """Swap a dim for a same-length 1-D coordinate (e.g. channel→frequency).

        A data variable named as the NEW dim is promoted to a coordinate
        (xarray semantics; the reference assigns ds["channel"] then swaps,
        calibrate/ecs.py:470-475)."""
        out = Dataset(attrs=dict(self.attrs))
        for k, v in self.coords.items():
            out.coords[k] = DataArray(
                v.values, tuple(dim_map.get(d, d) for d in v.dims), attrs=v.attrs, name=k
            )
        for k, v in self.data_vars.items():
            da = DataArray(
                v.values, tuple(dim_map.get(d, d) for d in v.dims), attrs=v.attrs, name=k
            )
            if k in dim_map.values():
                out.coords[k] = da
            else:
                out.data_vars[k] = da
        return out

    def expand_dims(self, dim, axis=0):
        out = Dataset(attrs=dict(self.attrs))
        out.coords = dict(self.coords)
        if isinstance(dim, dict):
            # xarray: {new_dim: coord_values} adds the dim AND its coordinate
            # (the reference's per-channel group assembly,
            # set_groups_ek60.py:130).  Insert in reverse so the FIRST key
            # ends up outermost, matching xarray's resulting dim order.
            for d, vals in reversed(list(dim.items())):
                vals = np.asarray(vals)
                if vals.ndim == 0:
                    vals = vals[None]
                for k, v in (out.data_vars or self.data_vars).items():
                    src = out.data_vars.get(k, v)
                    expanded = src.expand_dims(d, axis)
                    if len(vals) > 1:
                        expanded = DataArray(
                            np.repeat(expanded.values, len(vals), axis=axis),
                            expanded.dims, attrs=expanded.attrs, name=k,
                        )
                    out.data_vars[k] = expanded
                out.coords[d] = DataArray(vals, (d,), name=d)
            return out
        for k, v in self.data_vars.items():
            out.data_vars[k] = v.expand_dims(dim, axis)
        return out

    def transpose(self, *dims, missing_dims="raise"):
        if missing_dims == "raise":
            missing = [d for d in dims if d is not ... and d not in self.dims]
            if missing:
                raise ValueError(
                    f"dimensions {missing} do not exist on this Dataset; "
                    f"existing dims: {tuple(self.dims)}"
                )
        out = Dataset(attrs=dict(self.attrs))
        out.coords = dict(self.coords)
        for k, v in self.data_vars.items():
            pres = [d for d in dims if d in v.dims]
            rest = [d for d in v.dims if d not in pres]
            out.data_vars[k] = v.transpose(*(pres + rest)) if pres else v
        return out

    def merge(self, other, compat="no_conflicts", join="outer"):
        from .ops import merge as _merge

        return _merge([self, other])

    def update(self, other):
        src = other.data_vars.items() if isinstance(other, Dataset) else other.items()
        for k, v in src:
            self[k] = v
        if isinstance(other, Dataset):
            for k, v in other.coords.items():
                self.coords.setdefault(k, v)
        return self

    def rename_vars(self, name_dict=None, **names):
        """Return a copy with data variables renamed (xarray API parity)."""
        mapping = {**(name_dict or {}), **names}
        missing = [k for k in mapping if k not in self.data_vars]
        if missing:
            raise ValueError(f"cannot rename {missing}: not data variables in this Dataset")
        out = self.copy()
        out.data_vars = {
            mapping.get(k, k): DataArray(v.values, v.dims, attrs=dict(v.attrs), name=mapping.get(k, k))
            for k, v in out.data_vars.items()
        }
        return out

    def copy(self, deep=False):
        def _cp(v, name):
            da = DataArray(
                v.values.copy() if deep else v.values, v.dims, attrs=dict(v.attrs), name=name
            )
            if v.encoding:
                da.encoding = v.encoding
            return da

        out = Dataset(attrs=dict(self.attrs))
        out.coords = {k: _cp(v, k) for k, v in self.coords.items()}
        out.data_vars = {k: _cp(v, k) for k, v in self.data_vars.items()}
        return out

    def interp(self, coords=None, method="linear", kwargs=None, **kw):
        coords = {**(coords or {}), **kw}
        (dim, _), = coords.items()
        out = Dataset(attrs=dict(self.attrs))
        for k, v in self.data_vars.items():
            da = self[k]
            if dim in da.dims:
                out[k] = da.interp(coords, method=method, kwargs=kwargs)
            else:
                out[k] = da
        for k, v in self.coords.items():
            if dim not in v.dims and k not in out.coords:
                out.coords[k] = v
        return out

    def to_zarr(self, store_path=None, compress=True, overwrite=False, mode=None,
                store=None, group=None, encoding=None, consolidated=True,
                storage_options=None, zarr_format=None, shard_spec=None, **kw):
        """Persist this Dataset as zarr.

        Two call styles:
        - plain (ours): ``ds.to_zarr(path)`` writes a one-group store
          (an Sv/MVBS store)
        - xarray-style group write: ``ds.to_zarr(store, group=..., mode=...,
          encoding=..., storage_options=...)`` — what the reference's save
          chain and qc orchestration use (utils/io.py:80, qc/api.py:219)
        """
        target = store_path if store_path is not None else store
        if group is not None or encoding is not None or mode in ("a", "r+"):
            from .datatree import dataset_to_zarr

            return dataset_to_zarr(
                self, target, mode=mode, group=group, encoding=encoding,
                consolidated=consolidated, storage_options=storage_options,
                compress=compress, zarr_format=zarr_format,
                shard_spec=shard_spec,
            )
        from .. import storage

        return storage.write_dataset(
            target, self, compress=compress, overwrite=overwrite or mode in ("w", "a"),
            storage_options=storage_options, zarr_format=zarr_format or 2,
            shard_spec=shard_spec,
        )

    def to_netcdf(self, path=None, mode=None, group=None, encoding=None,
                  engine=None, compress=True, storage_options=None, **kw):
        """Persist as netCDF4 (single group, or group-targeted append like
        xarray's ``to_netcdf(group=...)``)."""
        from ..storage import netcdf4

        key = "Top-level" if not group else str(group).strip("/")
        netcdf4.write_tree(
            str(path), {key: self}, compress=compress,
            overwrite=mode in (None, "w", "a"), storage_options=storage_options,
            append=mode == "a", encoding=encoding,
        )

    def _reduce_all(self, method, dim=None, skipna=True):
        out = Dataset(attrs=dict(self.attrs))
        for k in self.data_vars:
            da = self[k]
            if not np.issubdtype(da.values.dtype, np.number):
                continue  # xarray drops non-numeric vars on reduction
            red = [d for d in ((dim,) if isinstance(dim, str) else dim or da.dims) if d in da.dims]
            out[k] = getattr(da, method)(red, skipna=skipna) if red else da
        return out

    def mean(self, dim=None, skipna=True):
        return self._reduce_all("mean", dim, skipna)

    def sum(self, dim=None, skipna=True):
        return self._reduce_all("sum", dim, skipna)

    def min(self, dim=None, skipna=True):
        return self._reduce_all("min", dim, skipna)

    def max(self, dim=None, skipna=True):
        return self._reduce_all("max", dim, skipna)

    def std(self, dim=None, skipna=True):
        return self._reduce_all("std", dim, skipna)

    def median(self, dim=None, skipna=True):
        return self._reduce_all("median", dim, skipna)

    def count(self, dim=None):
        out = Dataset(attrs=dict(self.attrs))
        for k in self.data_vars:
            da = self[k]
            if not np.issubdtype(da.values.dtype, np.number):
                continue
            red = [d for d in ((dim,) if isinstance(dim, str) else dim or da.dims) if d in da.dims]
            out[k] = da.count(red) if red else da
        return out

    def pipe(self, func, *args, **kwargs):
        return func(self, *args, **kwargs)

    def fillna(self, value):
        out = self.copy()
        for k, da in out.data_vars.items():
            if np.issubdtype(da.values.dtype, np.floating):
                da.values = np.where(np.isnan(da.values), value, da.values)
            elif da.values.dtype == object:
                # object columns (e.g. the combine provenance attr table)
                # carry float NaN for missing entries
                mask = np.frompyfunc(
                    lambda v: isinstance(v, float) and np.isnan(v), 1, 1
                )(da.values).astype(bool)
                if mask.any():
                    vals = da.values.copy()
                    vals[mask] = value
                    da.values = vals
        return out

    def clip(self, min=None, max=None):
        out = self.copy()
        for da in out.data_vars.values():
            if np.issubdtype(da.values.dtype, np.number):
                da.values = np.clip(da.values, min, max)
        return out

    def squeeze(self, dim=None):
        out = Dataset(attrs=dict(self.attrs))
        drop = (
            [dim] if isinstance(dim, str) else [d for d, s in self.sizes.items() if s == 1]
        )
        for k, da in {**self.coords, **self.data_vars}.items():
            keep_axes = tuple(i for i, d in enumerate(da.dims) if d not in drop or da.values.shape[i] != 1)
            vals = da.values.reshape([da.values.shape[i] for i in keep_axes])
            new_dims = tuple(da.dims[i] for i in keep_axes)
            if k in self.data_vars:
                out[k] = (new_dims, vals, dict(da.attrs))
            elif new_dims:
                out.coords[k] = DataArray(vals, new_dims, attrs=dict(da.attrs), name=k)
        return out

    def groupby(self, name):
        """Minimal xarray groupby: iterate (key, subset) pairs grouped by a
        1-D coordinate, keys in sorted order (what the reference's duplicate
        checker iterates, convert/utils/ek_duplicates.py:18)."""
        return _groupby(self, name)

    def drop_duplicates(self, dim, keep="first"):
        """xarray semantics: drop entries whose ``dim`` index value repeats,
        keeping the first (or last) occurrence, original order preserved
        (the reference dedups duplicate ping_time rows this way,
        set_groups_ek80.py:1161)."""
        import pandas as pd

        vals = self.coords[dim].values if dim in self.coords else None
        if vals is None:
            raise ValueError(f"dimension {dim!r} has no coordinate to dedup on")
        mask = ~pd.Index(np.asarray(vals)).duplicated(keep=keep)
        return self.isel({dim: np.nonzero(mask)[0]})

    def sortby(self, name, ascending=True):
        key = self.coords[name] if name in self.coords else self[name]
        (dim,) = key.dims
        order = np.argsort(key.values, kind="stable")
        if not ascending:
            order = order[::-1]
        return self.isel({dim: order})
