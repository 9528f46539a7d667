"""Minimal DataTree + tree-aware file IO for the xarray facade.

The reference's echodata layer (echopype/echodata/echodata.py:43,
combine.py:860, qc/api.py:174) operates on ``xr.DataTree`` plus the
module-level openers ``open_dataset``/``open_datatree``/``open_groups`` and
group-targeted ``Dataset.to_zarr``/``to_netcdf`` writes.  This module
implements exactly that surface on xrlite Datasets, backed by the
``storage/`` zarr v2 + netCDF4 writers, so the reference's EchoData,
combine_echodata, and orchestrate_reverse_time_check execute unmodified as
differential oracles — and so user code written against xarray's tree API
runs on this framework.

Semantics mirrored from xarray (relied on by the reference):
- ``node.to_dataset()`` shares the node's attrs dict and variable objects
  (attr mutation through the returned Dataset sticks; adding variables does
  not) — qc/api.py:217 mutates ``ed_comb["Provenance"].attrs`` this way.
- ``DataTree.from_dict`` creates intermediate nodes for nested paths.
- ``tree.groups`` lists "/"-prefixed node paths in pre-order.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from .dataset import Dataset

__all__ = [
    "DataTree",
    "open_dataset",
    "open_datatree",
    "open_groups",
    "dataset_to_zarr",
]

# On-disk zarr format for NEW stores when the caller does not choose one
# (xarray-style writes pass zarr_format=None).  Appends to an existing store
# always follow the store's own format; flip to 3 to default to Zarr v3
# trees like the real echopype's zarr>=3 chain.
DEFAULT_ZARR_FORMAT = 2


def _norm_parts(path) -> list:
    """'/Sonar/Beam_group1' | 'Sonar/Beam_group1' -> ['Sonar', 'Beam_group1']."""
    s = str(path).strip()
    return [p for p in s.split("/") if p not in ("", ".")]


class DataTree:
    """A tree of named nodes, each holding one Dataset."""

    def __init__(self, dataset=None, name=None, children=None):
        self._ds = dataset if dataset is not None else Dataset()
        self.name = name
        self.parent = None
        self.children = {}
        for k, v in (children or {}).items():
            self[k] = v

    # ------------------------------------------------------------- node data
    @property
    def dataset(self):
        return self._ds

    @dataset.setter
    def dataset(self, value):
        self._ds = value if value is not None else Dataset()

    ds = dataset

    def to_dataset(self, inherit=True):
        """Dataset view of this node: shares attrs dict + variable objects
        (xarray Variable-sharing semantics); adding variables to the result
        does not modify the node."""
        out = Dataset()
        out.attrs = self._ds.attrs
        out.coords = dict(self._ds.coords)
        out.data_vars = dict(self._ds.data_vars)
        return out

    @property
    def has_data(self) -> bool:
        return bool(self._ds.data_vars) or bool(self._ds.coords)

    @property
    def has_attrs(self) -> bool:
        return bool(self._ds.attrs)

    @property
    def attrs(self):
        return self._ds.attrs

    @property
    def sizes(self):
        return self._ds.sizes

    @property
    def dims(self):
        return self._ds.dims

    @property
    def nbytes(self):
        return sum(node._ds.nbytes for node in self._walk())

    # ------------------------------------------------------------ tree shape
    @property
    def path(self) -> str:
        parts = []
        node = self
        while node.parent is not None:
            parts.append(node.name)
            node = node.parent
        return "/" + "/".join(reversed(parts))

    def _walk(self):
        yield self
        for child in self.children.values():
            yield from child._walk()

    @property
    def groups(self) -> tuple:
        return tuple(node.path for node in self._walk())

    @property
    def subtree(self):
        return self._walk()

    def __contains__(self, key) -> bool:
        try:
            self[key]
            return True
        except KeyError:
            return False

    def __getitem__(self, key) -> "DataTree":
        node = self
        for part in _norm_parts(key):
            if part == "..":
                if node.parent is None:
                    raise KeyError(key)
                node = node.parent
            else:
                try:
                    node = node.children[part]
                except KeyError:
                    raise KeyError(key) from None
        return node

    def __setitem__(self, key, value):
        parts = _norm_parts(key)
        if not parts:
            # assigning the root: value must be a Dataset
            self.dataset = value if isinstance(value, Dataset) else value.dataset
            return
        node = self
        for part in parts[:-1]:
            if part not in node.children:
                child = DataTree(name=part)
                child.parent = node
                node.children[part] = child
            node = node.children[part]
        leaf = parts[-1]
        if isinstance(value, DataTree):
            # move semantics (datatree-era node re-parenting): detach from any
            # previous parent so the node lives at exactly one path — the
            # reference's v0.5->v0.6 migration relies on this when it maps
            # Beam -> Sonar/Beam_group1 (v05x_to_v06x.py:89-109) and renames
            # Vendor -> Vendor_specific via orphan() (:949-966)
            value.orphan()
            value.name = leaf
            value.parent = node
            node.children[leaf] = value
        else:
            if leaf in node.children:
                node.children[leaf].dataset = value
            else:
                child = DataTree(dataset=value, name=leaf)
                child.parent = node
                node.children[leaf] = child

    def orphan(self):
        """Detach this node from its parent (xarray TreeNode.orphan)."""
        if self.parent is not None:
            self.parent.children.pop(self.name, None)
            self.parent = None

    def get(self, key, default=None):
        try:
            return self[key]
        except KeyError:
            return default

    @classmethod
    def from_dict(cls, d: dict, name=None) -> "DataTree":
        tree = cls(name=name)
        for key, value in d.items():
            parts = _norm_parts(key)
            if not parts:
                tree.dataset = value if isinstance(value, Dataset) else value.dataset
            else:
                tree["/".join(parts)] = value
        return tree

    def to_dict(self) -> dict:
        return {node.path: node.to_dataset() for node in self._walk()}

    def __repr__(self):
        lines = [f"<xrlite.DataTree {self.name or ''!r}>"]
        for node in self._walk():
            nvars = len(node._ds.data_vars)
            lines.append(f"  {node.path}  ({nvars} vars)")
        return "\n".join(lines)

    # ----------------------------------------------------------------- save
    def to_zarr(self, store, mode="w-", consolidated=True, storage_options=None,
                zarr_format=None, **kw):
        from ..storage import zarr_lite

        if mode == "a":
            # xarray append semantics: add/update this tree's groups, leave
            # other groups in the store untouched
            for node in self._walk():
                dataset_to_zarr(
                    node.to_dataset(), store, mode="a",
                    group=None if node.path == "/" else node.path.lstrip("/"),
                    storage_options=storage_options, zarr_format=zarr_format,
                )
            return
        tree = {}
        for node in self._walk():
            key = "Top-level" if node.path == "/" else node.path.lstrip("/")
            tree[key] = node.to_dataset()
        zarr_lite.write_tree(
            store, tree, overwrite=mode == "w", storage_options=storage_options,
            zarr_format=2 if zarr_format is None else zarr_format,
        )

    def identical(self, other) -> bool:
        if sorted(self.groups) != sorted(other.groups):
            return False
        for node in self._walk():
            o = other[node.path] if node.path != "/" else other
            a, b = node.to_dataset(), o.to_dataset()
            if a.attrs != b.attrs or not a.equals(b):
                return False
        return True


# ------------------------------------------------------------------ file IO
def _unwrap_store(path):
    """Accept str/Path or an fsspec FSMap (the reference's sanitize_file_path
    hands FSMaps to xr.open_dataset, echodata/echodata.py:566).  Only a
    mapping-like store is unwrapped — pathlib.Path also HAS a .root ("/").

    Remote FSMaps keep their filesystem: map.root is a bare "bucket/path"
    string, so returning it alone would silently retarget the IO at a local
    path — wrap it as an FsspecPath over the map's own fs instead."""
    if hasattr(path, "fs") and hasattr(path, "root"):
        proto = getattr(path.fs, "protocol", "file")
        if isinstance(proto, (tuple, list)):
            proto = proto[0]
        if proto in ("file", "local", ""):
            return path.root
        from ..storage.fsstore import FsspecPath

        return FsspecPath(path.fs, path.root)
    return path


def _engine_for(path, engine=None) -> str:
    if engine in ("zarr", "netcdf4"):
        return engine
    sfx = Path(str(_unwrap_store(path))).suffix
    return {".nc": "netcdf4", ".zarr": "zarr"}.get(sfx, "zarr")


def open_dataset(path, group=None, engine=None, storage_options=None, **kw) -> Dataset:
    """Open one group of a zarr/netCDF store as a Dataset
    (facade for xr.open_dataset; reference: echodata/echodata.py:598)."""
    eng = _engine_for(path, engine)
    path = _unwrap_store(path)
    if eng == "zarr":
        from ..storage import zarr_lite

        return zarr_lite.read_group(str(path), group or "", storage_options=storage_options)
    from ..storage import netcdf4

    tree = netcdf4.open_netcdf_tree(str(path), storage_options=storage_options)
    key = group or "Top-level"
    if key in tree:
        return tree[key]
    if (group or "") == "" and "Top-level" not in tree:
        return Dataset()
    raise KeyError(f"group {group!r} not found in {path}")


def open_groups(path, engine=None, storage_options=None, **kw) -> dict:
    """{'/': root_ds, '/Sonar': ..., ...} for every group in a store
    (facade for xr.open_groups; reference: echodata/echodata.py:219)."""
    eng = _engine_for(path, engine)
    path = _unwrap_store(path)
    if eng == "zarr":
        from ..storage import zarr_lite

        raw = zarr_lite.open_zarr_tree(str(path), storage_options=storage_options)
    else:
        from ..storage import netcdf4

        raw = netcdf4.open_netcdf_tree(str(path), storage_options=storage_options)
    out = {}
    for key, ds in raw.items():
        out["/" if key in ("Top-level", "", "/") else "/" + key.lstrip("/")] = ds
    return out


def open_datatree(path, engine=None, storage_options=None, **kw) -> DataTree:
    """Open a whole store as a DataTree
    (facade for xr.open_datatree; reference: echodata/echodata.py:249)."""
    return DataTree.from_dict(open_groups(path, engine=engine, storage_options=storage_options))


# ------------------------------------------------- group-targeted zarr write
def _blosc_shuffle_code(shuffle):
    from ..storage import blosc

    name = getattr(shuffle, "shuffle", shuffle)
    return {
        "noshuffle": blosc.NOSHUFFLE,
        "shuffle": blosc.SHUFFLE,
        "bitshuffle": blosc.BITSHUFFLE,
    }.get(str(name), blosc.SHUFFLE)


def _compressor_meta_from_encoding(enc: dict, dtype):
    """Translate an xarray-style encoding entry into zarr_lite compressor
    metadata.  Accepts zarr-v3 style {'compressors': [BloscCodec(...)]} (the
    reference's COMPRESSION_SETTINGS, utils/coding.py:17-29) and numcodecs
    style {'compressor': {...}}."""
    from ..utils import coding as our_coding

    comps = enc.get("compressors", enc.get("compressor"))
    if comps is None:
        return our_coding.zarr_compressor_meta(dtype)
    if isinstance(comps, (list, tuple)):
        comps = comps[0] if comps else None
    if comps is None:
        return None
    if isinstance(comps, dict):
        return dict(comps)
    # duck-typed BloscCodec-like object
    return {
        "id": "blosc",
        "cname": str(getattr(comps, "cname", "zstd")),
        "clevel": int(getattr(comps, "clevel", 3)),
        "shuffle": _blosc_shuffle_code(getattr(comps, "shuffle", "shuffle")),
        "blocksize": 0,
    }


def _encode_with(values: np.ndarray, enc: dict):
    """Apply a CF time encoding (units/calendar/dtype) if present; return
    (encoded array, attrs-to-store)."""
    from ..utils import coding as our_coding

    return our_coding.encode_array_with(values, enc)


def dataset_to_zarr(
    ds: Dataset,
    store,
    mode=None,
    group=None,
    encoding=None,
    consolidated=True,
    storage_options=None,
    compress=True,
    zarr_format=None,
    shard_spec=None,
    **kw,
):
    """Group-targeted Dataset→zarr write (facade for xr.Dataset.to_zarr).

    Modes (xarray semantics, as the reference's save chain uses them —
    utils/io.py:80, qc/api.py:219,253,261):
      - "w": wipe the whole store, write this group fresh
      - "w-"/None: like "w" but refuse to clobber an existing store
      - "a": create/extend the group — add or replace arrays, merge attrs
      - "r+": only overwrite the values of arrays that already exist

    zarr_format: 2 (default for new stores), 3 (Zarr v3 layout, what real
    echopype's zarr>=3 chain produces), or None — None detects the format of
    an EXISTING store so group-by-group append chains stay consistent.
    """
    from ..storage import zarr_lite, zarr_v3
    from ..storage.fsstore import as_store_path, rmtree_store

    encoding = encoding or {}
    mode = mode or "w-"
    # _unwrap_store, NOT getattr(store, "root", ...): pathlib.Path also has a
    # .root attribute — "/" — which would retarget the write (and mode="w"'s
    # rmtree!) at the filesystem root
    root = as_store_path(_unwrap_store(store), storage_options)
    if mode == "w" and root.exists():
        rmtree_store(root)
    if mode == "w-" and root.exists() and any(root.iterdir()):
        raise FileExistsError(f"{store} exists; use mode='w' or 'a'")
    if zarr_format is None:
        if (root / zarr_v3.META).exists():
            zarr_format = 3
        elif (root / ".zgroup").exists():
            zarr_format = 2
        else:
            zarr_format = DEFAULT_ZARR_FORMAT
    v3 = zarr_format == 3

    def _has_group_marker(d):
        m = zarr_v3.node_meta(d) if v3 else None
        return (m is not None and m.get("node_type") == "group") if v3 \
            else (d / ".zgroup").exists()

    def _group_attrs(d):
        if v3:
            m = zarr_v3.node_meta(d) or {}
            return dict(m.get("attributes") or {})
        f = d / ".zattrs"
        return zarr_lite._read_json(f) if f.exists() else {}

    def _put_group(d, attrs):
        if v3:
            zarr_v3.write_group_meta(d, attrs)
        else:
            zarr_lite._write_json(d / ".zgroup", {"zarr_format": zarr_lite.ZARR_FORMAT})
            zarr_lite._write_json(d / ".zattrs", attrs)

    gparts = _norm_parts(group or "")
    # ensure root + intermediate group markers
    root.mkdir(parents=True, exist_ok=True)
    if not _has_group_marker(root):
        _put_group(root, _group_attrs(root) if v3 else {})
    gdir = root
    for part in gparts:
        gdir = gdir / part
        gdir.mkdir(parents=True, exist_ok=True)
        if not _has_group_marker(gdir):
            _put_group(gdir, {})

    # group attrs: "a"/"w" merge (new values win); "r+" leaves attrs alone
    if mode != "r+":
        existing = _group_attrs(gdir)
        existing.update(zarr_lite._sanitize_attrs(ds.attrs))
        _put_group(gdir, existing)

    coord_names = list(ds.coords)
    for name, da in list(ds.coords.items()) + list(ds.data_vars.items()):
        adir = gdir / name
        amarker = (adir / zarr_v3.META) if v3 else (adir / ".zarray")
        if mode == "r+" and not amarker.exists():
            raise KeyError(
                f"mode='r+' cannot create new array {name!r} in group {group!r}"
            )
        enc = {**da.encoding, **encoding.get(name, {})}
        values, extra_attrs = _encode_with(np.asarray(da.values), enc)
        attrs = dict(da.attrs)
        attrs.update(extra_attrs)
        if name in ds.data_vars:
            cs = " ".join(
                cn for cn in coord_names if set(ds.coords[cn].dims) <= set(da.dims)
            )
            if cs:
                attrs["coordinates"] = cs
        comp = _compressor_meta_from_encoding(enc, values.dtype) if compress else None
        chunk_spec = None
        chunks = enc.get("chunks")
        if chunks:
            chunk_spec = dict(zip(da.dims, chunks))
        shards = enc.get("shards")  # zarr-python 3 / xarray encoding key
        if shards is None and shard_spec and any(d in shard_spec for d in da.dims):
            # per-dim shard_spec (our to_zarr convention); None entries mean
            # one inner chunk per shard in that dim (resolved downstream)
            shards = tuple(shard_spec.get(d) for d in da.dims)
        _write_zarr_array(gdir, name, values, da.dims, attrs, comp, chunk_spec,
                          zarr_format=zarr_format, shards=shards)
    return str(root)


def _write_zarr_array(gdir, name, values, dims, attrs, comp_meta, chunk_spec,
                      zarr_format: int = 2, shards=None):
    """Write one encoding-driven array via the shared encoded-level writers
    (one chunk-format implementation per zarr format)."""
    from ..storage import zarr_lite, zarr_v3
    from ..utils import coding as our_coding

    arr = our_coding.sanitize_dtypes(np.asarray(values))
    chunks = our_coding.auto_chunks(arr.shape, arr.dtype)
    if chunk_spec:
        chunks = tuple(
            min(int(chunk_spec.get(d, c) or c), s)
            for d, c, s in zip(dims, chunks, arr.shape)
        )
    if zarr_format == 3:
        zarr_v3.write_array_encoded(gdir, name, arr, dims, attrs, comp_meta,
                                    chunks, clean=True,
                                    shards=tuple(shards) if shards else None)
    else:
        if shards:
            raise ValueError("encoding 'shards' requires zarr_format=3")
        zarr_lite.write_array_encoded(gdir, name, arr, dims, attrs, comp_meta,
                                      chunks, clean=True)
