"""Self-contained Zarr v2 directory-store reader/writer.

The reference serializes its SONAR-netCDF4 tree to Zarr via zarr-python +
xarray (echopype/utils/io.py:62, utils/coding.py).  zarr-python is not in this
environment, so this module implements the Zarr v2 on-disk format directly:

- group: ``.zgroup`` + ``.zattrs`` JSON
- array: ``<name>/.zarray`` (shape/chunks/dtype/compressor/fill_value),
  ``<name>/.zattrs`` with the xarray ``_ARRAY_DIMENSIONS`` convention,
  C-order chunk files ``i.j.k``
- compressor: Blosc via the system libblosc (zstd-3 bitshuffle for floats,
  lz4-5 byteshuffle otherwise — the reference's exact defaults,
  echopype/utils/coding.py:17-29), stdlib zlib, or none.  Reading supports
  all three, so reference-produced default stores open here directly.

This keeps byte-level compatibility with xarray/zarr readers for everything
we write.
"""

from __future__ import annotations

import json
import zlib
from pathlib import Path

import numpy as np

from ..utils import coding
from ..xrlite import DataArray, Dataset
from . import blosc
from .fsstore import as_store_path, rmtree_store

ZARR_FORMAT = 2
_FILL = {"f": float("nan"), "c": float("nan")}


def _dtype_to_str(dt: np.dtype) -> str:
    dt = np.dtype(dt)
    if dt.kind == "U":
        return f"<U{dt.itemsize // 4}"
    return dt.str


def _json_default(o):
    if isinstance(o, (np.integer,)):
        return int(o)
    if isinstance(o, (np.floating,)):
        return float(o)
    if isinstance(o, np.ndarray):
        return o.tolist()
    if isinstance(o, bytes):
        return o.decode("utf-8", "replace")
    if isinstance(o, np.datetime64):
        return str(o)
    return str(o)


def _write_json(path: Path, obj):
    path.write_text(json.dumps(obj, indent=2, default=_json_default, allow_nan=True))


def _sanitize_attrs(attrs: dict) -> dict:
    return {k: v for k, v in attrs.items() if v is not None}


def _encode_chunk(raw: bytes, comp, typesize: int) -> bytes:
    if comp is None:
        return raw
    if comp["id"] == "zlib":
        return zlib.compress(raw, comp.get("level", 4))
    return blosc.compress(
        raw, typesize, comp.get("cname", "zstd"), comp.get("clevel", 3),
        comp.get("shuffle", blosc.SHUFFLE),
    )


def _decode_chunk(raw: bytes, comp) -> bytes:
    if comp is None:
        return raw
    cid = comp.get("id")
    if cid in ("zlib", "gzip"):
        return zlib.decompress(raw)
    if cid == "blosc":
        return blosc.decompress(raw)
    raise ValueError(
        f"Unsupported zarr compressor {cid!r}; supported: blosc (via libblosc), "
        "zlib, none"
    )


# --------------------------------------------------------------------- writing
def write_array_encoded(group_dir: Path, name: str, arr: np.ndarray, dims, attrs,
                        comp_meta, chunks=None, clean: bool = False):
    """Write one ALREADY-ENCODED array (times as int64, objects stringified)
    with explicit compressor metadata and chunk shape.

    The single chunk-writing implementation behind both :func:`write_array`
    (our defaults) and the facade's encoding-driven group writes
    (xrlite/datatree.dataset_to_zarr).  ``clean=True`` removes stale chunk
    files from a previous write of this array (append-mode updates).
    """
    arr = np.asarray(arr)
    if arr.dtype == object:
        flat = arr.ravel()
        if all(v is None or (isinstance(v, float) and np.isnan(v)) for v in flat):
            # all-null object arrays -> f8 NaN (xarray ensure_dtype_not_object)
            arr = np.full(arr.shape, np.nan, dtype="f8")
        else:
            arr = arr.astype(str)
    adir = group_dir / name
    adir.mkdir(parents=True, exist_ok=True)
    if chunks is None:
        chunks = coding.auto_chunks(arr.shape, arr.dtype)
    # zarr v2 requires chunk extents >= 1 even for zero-length dims
    chunks = tuple(max(1, int(c)) for c in chunks) if chunks else chunks
    fill = _FILL.get(arr.dtype.kind)
    if arr.dtype.kind == "U":
        fill = ""
    meta = {
        "zarr_format": ZARR_FORMAT,
        "shape": list(arr.shape),
        "chunks": list(chunks) if chunks else [1],
        "dtype": _dtype_to_str(arr.dtype),
        "compressor": comp_meta,
        "fill_value": fill,
        "order": "C",
        "filters": None,
    }
    if arr.ndim == 0:
        # zarr v2 0-d: shape [], chunks [], single chunk keyed "0"
        meta["shape"] = []
        meta["chunks"] = []
    if clean:
        for old in adir.iterdir():
            if old.name not in (".zarray", ".zattrs"):
                old.unlink()
    _write_json(adir / ".zarray", meta)
    _write_json(
        adir / ".zattrs",
        {"_ARRAY_DIMENSIONS": list(dims), **_sanitize_attrs(attrs or {})},
    )

    # write chunks
    cshape = meta["chunks"]
    if 0 in meta["shape"]:
        return  # empty array: metadata only, no chunk files
    if arr.ndim == 0:
        raw = _encode_chunk(np.ascontiguousarray(arr).tobytes(), comp_meta, arr.dtype.itemsize)
        (adir / "0").write_bytes(raw)
        return
    grid = [max(1, -(-s // c)) for s, c in zip(meta["shape"], cshape)] or [1]
    for idx in np.ndindex(*grid):
        slices = tuple(
            slice(i * c, min((i + 1) * c, s)) for i, c, s in zip(idx, cshape, meta["shape"])
        )
        block = arr[slices]
        # pad partial edge chunks to full chunk shape (zarr stores full chunks)
        if list(block.shape) != cshape:
            pad = [(0, c - bs) for bs, c in zip(block.shape, cshape)]
            fillv = fill if fill is not None and fill != "" else 0
            if block.dtype.kind == "U":
                block = np.pad(block, pad, constant_values="")
            else:
                block = np.pad(block, pad, constant_values=fillv)
        raw = _encode_chunk(
            np.ascontiguousarray(block).tobytes(), comp_meta, arr.dtype.itemsize
        )
        (adir / ".".join(map(str, idx))).write_bytes(raw)


def write_array(group_dir: Path, name: str, arr: np.ndarray, dims, attrs, compress=True,
                chunk_spec=None, zarr_format: int = 2, shard_spec=None):
    arr = coding.sanitize_dtypes(np.asarray(arr))
    arr, extra_attrs = coding.encode_array(arr)
    chunks = coding.auto_chunks(arr.shape, arr.dtype)
    if chunk_spec:
        # user-requested per-dim chunking (EchoData.chunk) overrides auto
        chunks = tuple(
            min(int(chunk_spec.get(d, c)), s) if chunk_spec.get(d) else c
            for d, c, s in zip(dims, chunks, arr.shape)
        )
    comp_meta = coding.zarr_compressor_meta(arr.dtype) if compress else None
    all_attrs = {**extra_attrs, **_sanitize_attrs(attrs or {})}
    if zarr_format == 3:
        from . import zarr_v3

        shards = None
        if shard_spec and arr.ndim and any(d in shard_spec for d in dims):
            # per-dim shard sizes (zarr v3 sharding_indexed); dims not named
            # get one inner chunk per shard
            shards = tuple(
                int(shard_spec.get(d) or c) for d, c in zip(dims, chunks)
            )
        zarr_v3.write_array_encoded(group_dir, name, arr, dims, all_attrs, comp_meta,
                                    chunks, shards=shards)
    else:
        if shard_spec:
            raise ValueError("shard_spec requires zarr_format=3 (sharding_indexed)")
        write_array_encoded(group_dir, name, arr, dims, all_attrs, comp_meta, chunks)


def _write_group_marker(gdir: Path, attrs: dict, zarr_format: int):
    if zarr_format == 3:
        from . import zarr_v3

        zarr_v3.write_group_meta(gdir, _sanitize_attrs(attrs or {}))
    else:
        _write_json(gdir / ".zgroup", {"zarr_format": ZARR_FORMAT})
        _write_json(gdir / ".zattrs", _sanitize_attrs(attrs or {}))


def write_group(store_dir, ds: Dataset, group: str = "", compress=True, storage_options=None,
                chunk_spec=None, zarr_format: int = 2, shard_spec=None):
    """Write one Dataset as a zarr group under ``store_dir/group``."""
    root = as_store_path(store_dir, storage_options)
    gdir = root / group if group else root
    gdir.mkdir(parents=True, exist_ok=True)
    _write_group_marker(gdir, ds.attrs, zarr_format)
    coord_names = list(ds.coords)
    for name, c in ds.coords.items():
        write_array(gdir, name, c.values, c.dims, c.attrs, compress, chunk_spec=chunk_spec,
                    zarr_format=zarr_format, shard_spec=shard_spec)
    for name, v in ds.data_vars.items():
        attrs = dict(v.attrs)
        attrs["coordinates"] = " ".join(cn for cn in coord_names if set(ds.coords[cn].dims) <= set(v.dims))
        write_array(gdir, name, v.values, v.dims, attrs, compress, chunk_spec=chunk_spec,
                    zarr_format=zarr_format, shard_spec=shard_spec)


def write_tree(store_dir, tree: dict, compress=True, overwrite=False, storage_options=None,
               chunk_spec=None, zarr_format: int = 2, shard_spec=None):
    """Write {group_path: Dataset} as a nested zarr store (local or fsspec URL).

    ``zarr_format=3`` writes a Zarr v3 tree (one ``zarr.json`` per node,
    ``c/``-keyed chunks — storage/zarr_v3.py), matching what the real
    echopype (zarr>=3) produces; default stays the v2 layout.
    """
    if zarr_format not in (2, 3):
        raise ValueError(f"zarr_format must be 2 or 3, got {zarr_format!r}")
    root = as_store_path(store_dir, storage_options)
    if root.exists():
        if not overwrite and any(root.iterdir()):
            raise FileExistsError(f"{store_dir} exists; pass overwrite=True")
        rmtree_store(root)
    root.mkdir(parents=True, exist_ok=True)
    top = next((tree[k] for k in ("Top-level", "/", "") if k in tree), None)
    _write_group_marker(root, top.attrs if top is not None else {}, zarr_format)
    for path, ds in tree.items():
        if path in ("Top-level", "/", ""):
            # top-level attrs live on the root group (already written above)
            for name, c in ds.coords.items():
                write_array(root, name, c.values, c.dims, c.attrs, compress,
                            chunk_spec=chunk_spec, zarr_format=zarr_format,
                            shard_spec=shard_spec)
            for name, v in ds.data_vars.items():
                write_array(root, name, v.values, v.dims, v.attrs, compress,
                            chunk_spec=chunk_spec, zarr_format=zarr_format,
                            shard_spec=shard_spec)
            continue
        # intermediate groups need group markers
        parts = path.split("/")
        for i in range(1, len(parts)):
            inter = root / "/".join(parts[:i])
            inter.mkdir(parents=True, exist_ok=True)
            marker = inter / ("zarr.json" if zarr_format == 3 else ".zgroup")
            if not marker.exists():
                _write_group_marker(inter, {}, zarr_format)
        write_group(root, ds, path, compress, chunk_spec=chunk_spec, zarr_format=zarr_format,
                    shard_spec=shard_spec)


# --------------------------------------------------------------------- reading
def _read_json(path: Path):
    return json.loads(path.read_text())


def read_array(adir: Path):
    meta = _read_json(adir / ".zarray")
    attrs = _read_json(adir / ".zattrs") if (adir / ".zattrs").exists() else {}
    dims = tuple(attrs.pop("_ARRAY_DIMENSIONS", ()))
    dtype = np.dtype(meta["dtype"])
    shape = tuple(meta["shape"])
    chunks = tuple(meta["chunks"])
    comp = meta.get("compressor")
    fill = meta.get("fill_value")
    if fill is None:
        fill = 0
    if shape == ():
        # 0-d array: single chunk keyed "0"
        out = np.zeros((), dtype=dtype)
        cf = adir / "0"
        if cf.exists():
            raw = _decode_chunk(cf.read_bytes(), comp)
            out = np.frombuffer(raw, dtype=dtype)[0].reshape(())
        vals = coding.decode_array(out, attrs)
        if isinstance(vals, np.ndarray) and vals is not out:
            attrs = {k: v for k, v in attrs.items() if k not in ("units", "calendar", "dtype")}
        return vals, dims, attrs
    out = np.full(shape, fill, dtype=dtype) if shape else np.zeros((), dtype=dtype)
    grid = [max(1, -(-s // c)) for s, c in zip(shape, chunks)] or [()]
    if shape:
        for idx in np.ndindex(*[max(1, -(-s // c)) for s, c in zip(shape, chunks)]):
            cf = adir / ".".join(map(str, idx))
            if not cf.exists():
                continue
            raw = _decode_chunk(cf.read_bytes(), comp)
            block = np.frombuffer(raw, dtype=dtype).reshape(chunks)
            slices = tuple(
                slice(i * c, min((i + 1) * c, s)) for i, c, s in zip(idx, chunks, shape)
            )
            trim = tuple(slice(0, sl.stop - sl.start) for sl in slices)
            out[slices] = block[trim]
    del grid
    vals = coding.decode_array(out, attrs)
    if isinstance(vals, np.ndarray) and vals is not out:
        attrs = {k: v for k, v in attrs.items() if k not in ("units", "calendar", "dtype")}
    return vals, dims, attrs


def assemble_dataset(arrays: dict, attrs: dict) -> Dataset:
    """Build a Dataset from {name: (values, dims, attrs)} + group attrs.

    Coordinate promotion rule shared by all storage backends: 1-d arrays whose
    dim equals their own name, plus anything referenced by a "coordinates"
    attribute.
    """
    ds = Dataset(attrs=attrs)
    coord_names = set()
    for name, (vals, dims, a_attrs) in arrays.items():
        if dims == (name,):
            coord_names.add(name)
    for name, (vals, dims, a_attrs) in arrays.items():
        for cn in str(a_attrs.get("coordinates", "")).split():
            coord_names.add(cn)
    for name in list(arrays):
        if name in coord_names:
            vals, dims, a_attrs = arrays.pop(name)
            a_attrs.pop("coordinates", None)
            ds.coords[name] = DataArray(vals, dims, attrs=a_attrs, name=name)
    for name, (vals, dims, a_attrs) in arrays.items():
        a_attrs.pop("coordinates", None)
        da = DataArray(vals, dims, attrs=a_attrs, name=name)
        ds.data_vars[name] = da
    return ds


def read_group(store_dir, group: str = "", storage_options=None) -> Dataset:
    root = as_store_path(store_dir, storage_options)
    gdir = root / group if group else root
    if (gdir / "zarr.json").exists() and not (gdir / ".zgroup").exists():
        from . import zarr_v3

        return zarr_v3.read_group(store_dir, group, storage_options=storage_options)
    attrs = _read_json(gdir / ".zattrs") if (gdir / ".zattrs").exists() else {}
    arrays = {}
    for child in sorted(gdir.iterdir()):
        if child.is_dir() and (child / ".zarray").exists():
            vals, dims, a_attrs = read_array(child)
            arrays[child.name] = (vals, dims, a_attrs)
    return assemble_dataset(arrays, attrs)


def write_dataset(store_dir, ds: Dataset, compress=True, overwrite=False, storage_options=None,
                  zarr_format: int = 2, shard_spec=None):
    """Write a single Dataset as a one-group zarr store (e.g. an Sv store)."""
    root = as_store_path(store_dir, storage_options)
    if root.exists():
        if not overwrite and any(root.iterdir()):
            raise FileExistsError(f"{store_dir} exists; pass overwrite=True")
        rmtree_store(root)
    root.mkdir(parents=True, exist_ok=True)
    write_group(root, ds, "", compress, zarr_format=zarr_format, shard_spec=shard_spec)
    return str(root)


def open_dataset(store_dir, storage_options=None) -> Dataset:
    """Read a single-group zarr store written by :func:`write_dataset`."""
    return read_group(store_dir, "", storage_options=storage_options)


def list_groups(store_dir, storage_options=None) -> list:
    """All group paths (relative) in a store, root first."""
    root = as_store_path(store_dir, storage_options)
    if (root / "zarr.json").exists() and not (root / ".zgroup").exists():
        from . import zarr_v3

        return zarr_v3.list_groups(store_dir, storage_options=storage_options)
    out = []
    for zg in sorted(root.rglob(".zgroup")):
        rel = zg.parent.relative_to(root)
        out.append("" if str(rel) == "." else str(rel))
    return out


def open_zarr_tree(store_dir, storage_options=None) -> dict:
    """Read a whole store into {group_path: Dataset}; root key is 'Top-level'."""
    store = as_store_path(store_dir, storage_options)
    tree = {}
    for g in list_groups(store):
        ds = read_group(store, g)
        key = "Top-level" if g == "" else g
        if g == "" or ds.data_vars or ds.coords or ds.attrs:
            tree[key] = ds
    return tree
