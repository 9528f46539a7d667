"""netCDF4-on-HDF5 tree writer/reader via h5py.

Reference parity: the reference serializes EchoData as netCDF4 or Zarr
(echopype/utils/io.py:62 ``save_file``, echodata/echodata.py:27
``XARRAY_ENGINE_MAP``).  netCDF4 is a profile of HDF5: every dimension is an
HDF5 *dimension scale* dataset (a real coordinate variable, or a placeholder
whose NAME says "This is a netCDF dimension but not a netCDF variable."),
variables reference their dims through DIMENSION_LIST, and attributes are
plain HDF5 attributes.  This module writes that profile directly with h5py
(no netCDF-c in this environment) and reads it back — including files
produced by netCDF4-python/xarray with zlib compression, since HDF5 gzip is
the same codec.

Same tree API as zarr_lite: write_tree / open_netcdf_tree with a
{group_path: Dataset} dict and "Top-level" for the root group.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from ..utils import coding
from .zarr_lite import assemble_dataset

try:
    import h5py
except ImportError:  # pragma: no cover - h5py is baked into this image
    h5py = None

# netCDF-c's exact placeholder prefix for dims without coordinate variables
_DIM_WITHOUT_VAR = "This is a netCDF dimension but not a netCDF variable."
# HDF5/netCDF bookkeeping attrs that are not user metadata
_NC_INTERNAL = {
    "CLASS",
    "NAME",
    "DIMENSION_LIST",
    "REFERENCE_LIST",
    "_Netcdf4Dimid",
    "_Netcdf4Coordinates",
    "_NCProperties",
    "_nc3_strict",
}


def _require_h5py():
    if h5py is None:
        raise ImportError("netCDF support requires h5py, which is not importable")


def _attr_value(v):
    """Coerce an attr value into something h5py stores losslessly."""
    if isinstance(v, (str, bytes, int, float, np.generic)):
        return v
    if isinstance(v, bool):
        return np.int8(v)
    if isinstance(v, (list, tuple)):
        if all(isinstance(x, str) for x in v):
            return np.asarray(v, dtype=object)
        return np.asarray(v)
    if isinstance(v, np.ndarray):
        return v
    if isinstance(v, np.datetime64):
        return str(v)
    return str(v)


def _set_attrs(obj, attrs: dict):
    str_dt = h5py.string_dtype("utf-8")
    for k, v in (attrs or {}).items():
        if v is None:
            continue
        v = _attr_value(v)
        if isinstance(v, str):
            obj.attrs.create(k, v, dtype=str_dt)
        elif isinstance(v, np.ndarray) and v.dtype == object:
            obj.attrs.create(k, v, dtype=str_dt)
        else:
            obj.attrs[k] = v


def _create_var(grp, name: str, arr: np.ndarray, attrs: dict, compress: bool):
    """Create one HDF5 dataset holding an (already encoded) array.

    A pre-existing dataset of the same name is replaced (append-mode group
    updates re-write variables)."""
    if name in grp:
        del grp[name]
    if arr.dtype.kind in ("U", "O"):
        str_dt = h5py.string_dtype("utf-8")
        ds = grp.create_dataset(name, shape=arr.shape, dtype=str_dt)
        if arr.size:
            ds[...] = arr.astype(object)
    else:
        kwargs = {}
        if compress and arr.ndim and 0 not in arr.shape:
            chunks = coding.auto_chunks(arr.shape, arr.dtype)
            kwargs = dict(
                compression="gzip",
                compression_opts=4,
                chunks=tuple(max(1, c) for c in chunks),
            )
        ds = grp.create_dataset(name, data=arr, **kwargs)
    _set_attrs(ds, attrs)
    return ds


def _write_group(grp, ds_obj, compress: bool, encoding: dict = None):
    """Write one Dataset into an open h5py group with netCDF4 dimensions.

    ``encoding`` is xarray's per-variable dict (``{var: {units, calendar,
    dtype, ...}}``); it overrides each variable's own ``.encoding`` for CF
    time fields (the zarr writer honors the same keys)."""
    _set_attrs(grp, ds_obj.attrs)
    encoding = encoding or {}

    def _enc_for(name, var):
        return {**(getattr(var, "encoding", None) or {}), **encoding.get(name, {})}

    # encode all arrays up front so dim sizes reflect the stored shapes
    entries = {}  # name -> (encoded array, dims, attrs)
    coord_names = list(ds_obj.coords)
    for name, c in ds_obj.coords.items():
        arr = coding.sanitize_dtypes(np.asarray(c.values))
        arr, extra = coding.encode_array_with(arr, _enc_for(name, c))
        entries[name] = (arr, tuple(c.dims), {**extra, **(c.attrs or {})})
    for name, v in ds_obj.data_vars.items():
        arr = coding.sanitize_dtypes(np.asarray(v.values))
        arr, extra = coding.encode_array_with(arr, _enc_for(name, v))
        attrs = {**extra, **(v.attrs or {})}
        cstr = " ".join(
            cn for cn in coord_names if set(ds_obj.coords[cn].dims) <= set(v.dims)
        )
        if cstr:
            attrs["coordinates"] = cstr
        entries[name] = (arr, tuple(v.dims), attrs)

    # dimension registry for this group, in first-use order
    dim_sizes = {}
    for arr, dims, _ in entries.values():
        for d, s in zip(dims, arr.shape):
            dim_sizes.setdefault(d, s)

    # 1) create every variable dataset
    h5_vars = {}
    for name, (arr, dims, attrs) in entries.items():
        h5_vars[name] = _create_var(grp, name, arr, attrs, compress)

    # 2) dimension scales: a 1-D variable named after its dim doubles as the
    #    scale; other dims get netCDF-c placeholder scale datasets
    for dimid, (d, size) in enumerate(dim_sizes.items()):
        if d in entries and entries[d][1] == (d,):
            scale = h5_vars[d]
            scale.make_scale(d)
        else:
            if d in grp:  # replaced on append-mode group updates
                del grp[d]
            scale = grp.create_dataset(d, shape=(size,), dtype="f4")
            scale.make_scale(f"{_DIM_WITHOUT_VAR}{size:10d}")
        scale.attrs["_Netcdf4Dimid"] = np.int32(dimid)

    # 3) attach scales to variables (skip a scale attaching to itself)
    for name, (arr, dims, _) in entries.items():
        if dims == (name,) and name in dim_sizes:
            continue
        var = h5_vars[name]
        for i, d in enumerate(dims):
            var.dims[i].attach_scale(grp[d])


def write_tree(path, tree: dict, compress=True, overwrite=False, storage_options=None,
               append=False, encoding=None):
    """Write {group_path: Dataset} as one netCDF4 (HDF5) file.

    ``append=True`` opens an existing file and adds/updates the given groups
    (xarray's ``to_netcdf(mode='a', group=...)``).  Remote fsspec URLs are
    written via a local temp file then uploaded (HDF5 needs random access
    while writing).
    """
    from ..utils.io import is_remote_path

    _require_h5py()
    if is_remote_path(path):
        import tempfile

        import fsspec

        fs, _, paths = fsspec.core.get_fs_token_paths(
            str(path), storage_options=storage_options or {}
        )
        exists = fs.exists(paths[0])
        if exists and not (overwrite or append):
            raise FileExistsError(f"{path} exists; pass overwrite=True")
        with tempfile.NamedTemporaryFile(suffix=".nc") as tmp:
            if append and exists:
                fs.get_file(paths[0], tmp.name)
            _write_tree_local(tmp.name, tree, compress, append=append and exists,
                              encoding=encoding)
            if exists:
                fs.rm(paths[0])
            fs.put_file(tmp.name, paths[0])
        return str(path)

    p = Path(path)
    if p.exists() and not append:
        if not overwrite:
            raise FileExistsError(f"{path} exists; pass overwrite=True")
        p.unlink()
    p.parent.mkdir(parents=True, exist_ok=True)
    _write_tree_local(p, tree, compress, append=append and p.exists(), encoding=encoding)
    return str(p)


def _write_tree_local(p, tree: dict, compress: bool, append: bool = False, encoding=None):
    with h5py.File(p, "a" if append else "w") as f:
        f.attrs["_NCProperties"] = np.bytes_("version=2,echopype_tpu=1")
        for gpath, ds_obj in tree.items():
            if gpath in ("Top-level", "/", ""):
                _write_group(f, ds_obj, compress, encoding=encoding)
                continue
            grp = f.require_group(gpath)
            _write_group(grp, ds_obj, compress, encoding=encoding)


# ------------------------------------------------------------------- reading
def _is_dim_placeholder(item) -> bool:
    nm = item.attrs.get("NAME")
    if isinstance(nm, bytes):
        nm = nm.decode("utf-8", "replace")
    return isinstance(nm, str) and nm.startswith(_DIM_WITHOUT_VAR)


def _from_h5_attr(v):
    if isinstance(v, bytes):
        return v.decode("utf-8", "replace")
    if isinstance(v, np.ndarray):
        if v.dtype == object:
            return [x.decode("utf-8", "replace") if isinstance(x, bytes) else x for x in v]
        return v
    if isinstance(v, np.generic):
        return v.item()
    return v


def _dims_of(item, name: str):
    if item.attrs.get("CLASS") == b"DIMENSION_SCALE" and item.ndim == 1:
        return (name,)
    dims = []
    for i in range(item.ndim):
        scales = list(item.dims[i].values()) if item.dims else []
        if scales:
            dims.append(scales[0].name.rsplit("/", 1)[-1])
        else:
            dims.append(f"{name}_dim{i}")
    return tuple(dims)


def _read_values(item):
    if h5py.check_string_dtype(item.dtype):
        vals = item.asstr()[()]
        if isinstance(vals, str):
            return np.str_(vals)
        return np.asarray(vals, dtype=str) if vals.size else vals.astype("U1")
    return item[()]


def _read_group(grp):
    attrs = {k: _from_h5_attr(v) for k, v in grp.attrs.items() if k not in _NC_INTERNAL}
    arrays = {}
    for name, item in grp.items():
        if isinstance(item, h5py.Group):
            continue
        if _is_dim_placeholder(item):
            continue
        a_attrs = {
            k: _from_h5_attr(v) for k, v in item.attrs.items() if k not in _NC_INTERNAL
        }
        vals = _read_values(item)
        vals = coding.decode_array(np.asarray(vals), a_attrs)
        if isinstance(vals, np.ndarray) and np.issubdtype(vals.dtype, np.datetime64):
            a_attrs = {
                k: v for k, v in a_attrs.items() if k not in ("units", "calendar", "dtype")
            }
        arrays[name] = (vals, _dims_of(item, name), a_attrs)
    return assemble_dataset(arrays, attrs)


def open_netcdf_tree(path, storage_options=None) -> dict:
    """Read a netCDF4 file into {group_path: Dataset}; root key 'Top-level'."""
    from contextlib import ExitStack

    from ..utils.io import is_remote_path

    _require_h5py()
    tree = {}
    with ExitStack() as stack:
        if is_remote_path(path):
            import fsspec

            fileobj = stack.enter_context(
                fsspec.open(str(path), "rb", **(storage_options or {})).open()
            )
            f = stack.enter_context(h5py.File(fileobj, "r"))
        else:
            f = stack.enter_context(h5py.File(path, "r"))

        def visit(grp, gpath):
            ds = _read_group(grp)
            key = "Top-level" if gpath == "" else gpath
            if gpath == "" or ds.data_vars or ds.coords or ds.attrs:
                tree[key] = ds
            for name, item in grp.items():
                if isinstance(item, h5py.Group):
                    visit(item, f"{gpath}/{name}" if gpath else name)

        visit(f, "")
    return tree


def write_dataset(path, ds, compress=True, overwrite=False, storage_options=None):
    """Write a single Dataset as a flat netCDF4 file (e.g. an Sv store)."""
    return write_tree(
        path, {"Top-level": ds}, compress=compress, overwrite=overwrite,
        storage_options=storage_options,
    )


def open_dataset(path, storage_options=None):
    """Read a flat netCDF4 file written by :func:`write_dataset`."""
    return open_netcdf_tree(path, storage_options=storage_options)["Top-level"]
