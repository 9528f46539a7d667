"""Port parity: ``xrlite/datatree.py``, ``xrlite/xarray_compat.py`` and the
group-targeted, encoded and appending zarr writes and CF time encodings
they carry.

Each case builds the same data (numpy, from a seed) with each package's own
xrlite classes and writes it with each package: the two stores hold the same
files, every ``.zarray`` / ``.zattrs`` / ``.zgroup`` / ``zarr.json`` equal as
JSON and every chunk equal byte for byte; ``open_groups`` /
``open_datatree`` / ``open_dataset`` of either package return the same
decoded arrays (bit for bit, NaN where NaN) from either store.
"""

import contextlib
import importlib
import json
import sys
from pathlib import Path

import numpy as np
import pytest

import echopype_torch.xrlite as tx
import echopype_tpu.xrlite as jx
from echopype_torch.utils import coding as t_coding
from echopype_torch.xrlite import datatree as t_dt
from echopype_torch.xrlite import xarray_compat as t_xc
from echopype_tpu.utils import coding as j_coding
from echopype_tpu.xrlite import datatree as j_dt
from echopype_tpu.xrlite import xarray_compat as j_xc

T0 = np.datetime64("2021-06-01T00:00:00", "ns")
META = (".zarray", ".zattrs", ".zgroup", ".zmetadata", "zarr.json")
PKGS = ((tx, t_dt), (jx, j_dt))


def assert_same_store(a, b):
    """Two zarr stores with the same files: metadata equal as JSON, chunks
    equal byte for byte."""
    a, b = Path(a), Path(b)
    fa = sorted(p.relative_to(a).as_posix() for p in a.rglob("*") if p.is_file())
    fb = sorted(p.relative_to(b).as_posix() for p in b.rglob("*") if p.is_file())
    assert fa == fb
    for rel in fa:
        ga, gb = (a / rel).read_bytes(), (b / rel).read_bytes()
        if rel.rsplit("/", 1)[-1] in META:
            assert json.loads(ga) == json.loads(gb), rel
        else:
            assert ga == gb, rel


def _same_values(g, w, where):
    gv, wv = np.asarray(g.values), np.asarray(w.values)
    assert gv.dtype == wv.dtype and gv.shape == wv.shape and g.dims == w.dims, where
    if wv.dtype.kind == "O":
        assert [str(x) for x in gv.ravel()] == [str(x) for x in wv.ravel()], where
    else:
        np.testing.assert_array_equal(gv.view(np.uint8) if gv.size else gv,
                                      wv.view(np.uint8) if wv.size else wv, err_msg=where)


def assert_same_groups(got, want):
    """Two {path: Dataset} maps equal: names, values bit for bit, attrs."""
    assert sorted(got) == sorted(want)
    for path in want:
        g, w = got[path], want[path]
        assert sorted(g.data_vars) == sorted(w.data_vars), path
        assert sorted(g.coords) == sorted(w.coords), path
        for name in [*w.coords, *w.data_vars]:
            _same_values(g[name] if name in g.data_vars else g.coords[name],
                         w[name] if name in w.data_vars else w.coords[name], f"{path}:{name}")
        assert json.dumps(dict(g.attrs), sort_keys=True, default=str) == json.dumps(
            dict(w.attrs), sort_keys=True, default=str), path


def assert_same_reads(store_t, store_j):
    """Each package reads each store to the same groups."""
    reads = [dt.open_groups(str(s)) for _, dt in PKGS for s in (store_t, store_j)]
    for other in reads[1:]:
        assert_same_groups(other, reads[0])


def _sample(xr, seed):
    rng = np.random.default_rng(seed)
    sv = rng.normal(-70.0, 8.0, (2, 6, 9))
    sv[0, 2, 5:] = np.nan
    return xr.Dataset(
        {"Sv": (("channel", "ping_time", "range_sample"), sv, {"units": "dB"}),
         "count": (("ping_time",), rng.integers(0, 9, 6).astype("i4"))},
        coords={"channel": np.array(["ch0", "ch1"], dtype=object),
                "ping_time": T0 + np.arange(6) * np.timedelta64(250, "ms"),
                "range_sample": np.arange(9)},
        attrs={"title": "sample", "seed": seed},
    )


def _both(tmp_path, write):
    """Run ``write(xrlite, datatree, store)`` with each package into its own
    store; returns (port store, JAX store)."""
    stores = []
    for tag, (xr, dt) in zip(("torch", "jax"), PKGS):
        store = tmp_path / f"{tag}.zarr"
        write(xr, dt, store)
        stores.append(store)
    return stores


@pytest.mark.parametrize("zarr_format", [2, 3])
def test_tree_write_then_append(tmp_path, zarr_format):
    def write(xr, dt, store):
        dt.DataTree.from_dict({"/": xr.Dataset(attrs={"k": 1}), "A": _sample(xr, 1)}).to_zarr(
            str(store), mode="w", zarr_format=zarr_format)
        dt.DataTree.from_dict({"B/C": _sample(xr, 2)}).to_zarr(str(store), mode="a")

    st, sj = _both(tmp_path, write)
    assert_same_store(st, sj)
    assert_same_reads(st, sj)
    tree = t_dt.open_datatree(str(st))
    assert {"/A", "/B", "/B/C"} <= set(tree.groups)
    np.testing.assert_array_equal(tree["B/C"].to_dataset()["Sv"].values,
                                  _sample(tx, 2)["Sv"].values)


@pytest.mark.parametrize("zarr_format", [2, 3])
def test_group_write_modes(tmp_path, zarr_format):
    """w, then a (a new array, merged attrs), then r+ (existing values only)."""
    def write(xr, dt, store):
        ds = _sample(xr, 3)
        dt.dataset_to_zarr(ds, store, mode="w", group="Provenance", zarr_format=zarr_format)
        extra = xr.Dataset({"old_time": (("old_time_dim",), ds.coords["ping_time"].values[::-1])},
                           attrs={"reversed_ping_times": 1})
        dt.dataset_to_zarr(extra, store, mode="a", group="Provenance")
        upd = xr.Dataset({"count": (("ping_time",), np.arange(6, dtype="i4"))})
        dt.dataset_to_zarr(upd, store, mode="r+", group="Provenance")
        with pytest.raises(KeyError):
            dt.dataset_to_zarr(xr.Dataset({"new": (("n",), np.zeros(2))}), store, mode="r+",
                               group="Provenance")
        with pytest.raises(FileExistsError):
            dt.dataset_to_zarr(ds, store, group="Other")

    st, sj = _both(tmp_path, write)
    assert_same_store(st, sj)
    assert_same_reads(st, sj)
    back = t_dt.open_dataset(str(st), group="Provenance")
    np.testing.assert_array_equal(back["count"].values, np.arange(6))
    assert back.attrs["reversed_ping_times"] == 1 and back.attrs["seed"] == 3


ENCODINGS = {
    "chunks": {"Sv": {"chunks": (1, 4, 5)}},
    "compressor_dict": {"Sv": {"compressor": {"id": "blosc", "cname": "lz4", "clevel": 5,
                                              "shuffle": 2, "blocksize": 0}}},
    "no_compressor": {"Sv": {"compressors": None}, "count": {"compressor": None}},
    "cf_ms": {"ping_time": {"units": "milliseconds since 2021-06-01T00:00:00"}},
    "cf_ms_calendar": {"ping_time": {"units": "milliseconds since 1970-01-01T00:00:00Z",
                                    "calendar": "gregorian", "dtype": "float64"}},
    "cf_ns_chunks": {"ping_time": {"units": "nanoseconds since 1970-01-01T00:00:00Z",
                                   "chunks": (4,)}, "Sv": {"chunks": (2, 3, 9)}},
}


@pytest.mark.parametrize("name", list(ENCODINGS))
def test_encoded_group_write(tmp_path, name):
    """``Dataset.to_zarr(store, group=..., encoding=...)`` (the call the port
    refused before) equals the JAX package's write."""
    enc = ENCODINGS[name]

    def write(xr, dt, store):
        _sample(xr, 4).to_zarr(str(store), group="Sonar/Beam_group1", mode="w", encoding=enc)

    st, sj = _both(tmp_path, write)
    assert_same_store(st, sj)
    assert_same_reads(st, sj)
    back = t_dt.open_dataset(str(st), group="Sonar/Beam_group1")
    want_pt = _sample(tx, 4).coords["ping_time"].values
    if enc.get("ping_time", {}).get("dtype") == "float64":
        # both packages read a float CF time back as its numbers, undecoded
        want_pt = ((want_pt - np.datetime64("1970-01-01", "ns")).astype("i8") // 10**6).astype("f8")
    np.testing.assert_array_equal(back.coords["ping_time"].values, want_pt)
    if "ping_time" in enc:
        zattrs = json.loads((st / "Sonar/Beam_group1/ping_time/.zattrs").read_text())
        assert zattrs["units"] == enc["ping_time"]["units"]


@pytest.mark.parametrize(
    "units, calendar, dtype",
    [("milliseconds since 2021-06-01T00:00:00", None, None),
     ("seconds since 1970-01-01T00:00:00Z", "standard", "float64"),
     ("hours since 2021-05-31 12:00:00", None, "int32"),
     ("microseconds since 2000-01-01T00:00:00", "proleptic_gregorian", None)],
)
def test_cf_time_encoding_matches_jax(units, calendar, dtype):
    t = T0 + np.arange(5) * np.timedelta64(3600, "s")
    enc = {"units": units, **({"calendar": calendar} if calendar else {}),
           **({"dtype": dtype} if dtype else {})}
    got, got_attrs = t_coding.encode_array_with(t, enc)
    want, want_attrs = j_coding.encode_array_with(t, enc)
    assert got.dtype == want.dtype and got_attrs == want_attrs
    np.testing.assert_array_equal(got, want)
    decode = t_xc._make_coding_module().times.decode_cf_datetime
    np.testing.assert_array_equal(decode(got, got_attrs["units"]),
                                  j_xc._make_coding_module().times.decode_cf_datetime(
                                      want, want_attrs["units"]))


def test_non_time_encoding_falls_through():
    a = np.arange(4.0)
    got, want = t_coding.encode_array_with(a, {"units": "m"}), j_coding.encode_array_with(
        a, {"units": "m"})
    np.testing.assert_array_equal(got[0], want[0])
    assert got[1] == want[1]


def test_netcdf_cf_time_encoding(tmp_path):
    """``to_netcdf(encoding=...)`` with CF units (tests/test_storage.py:220)."""
    import h5py

    from echopype_torch.storage import netcdf4

    paths = []
    for tag, (xr, _) in zip(("torch", "jax"), PKGS):
        ds = xr.Dataset(coords={"ping_time": T0 + np.arange(4) * np.timedelta64(250, "ms")})
        ds["v"] = (("ping_time",), np.arange(4.0))
        path = str(tmp_path / f"{tag}.nc")
        ds.to_netcdf(path, encoding={"ping_time": {"units": "milliseconds since 2021-06-01"}})
        paths.append(path)
    raw = []
    for path in paths:
        with h5py.File(path, "r") as f:
            raw.append((f["ping_time"][()], f["ping_time"].attrs["units"]))
    np.testing.assert_array_equal(raw[0][0], raw[1][0])
    np.testing.assert_array_equal(raw[0][0], np.arange(4) * 250)
    assert raw[0][1] == raw[1][1]
    back = netcdf4.open_netcdf_tree(paths[0])["Top-level"]
    np.testing.assert_array_equal(np.asarray(back.coords["ping_time"].values, "datetime64[ns]"),
                                  T0 + np.arange(4) * np.timedelta64(250, "ms"))


def test_datatree_api_matches_jax():
    trees = [dt.DataTree.from_dict({"/": xr.Dataset(attrs={"a": 1}), "X/Y": _sample(xr, 5),
                                    "Z": _sample(xr, 6)}) for xr, dt in PKGS]
    t, j = trees
    assert t.groups == j.groups
    assert t["X/Y"].path == j["X/Y"].path and "X/Y" in t and "Q" not in t
    assert t.identical(t) and not t.identical(t_dt.DataTree.from_dict({"Z": _sample(tx, 6)}))
    assert_same_groups(t.to_dict(), j.to_dict())


@contextlib.contextmanager
def restoring_xarray_modules():
    """``make_module`` registers ``xarray.coding`` modules in sys.modules
    where none are; put the process back as it was afterwards."""
    names = ("xarray", "xarray.coding", "xarray.coding.times")
    saved = {k: sys.modules[k] for k in names if k in sys.modules}
    try:
        yield
    finally:
        for k in names:
            if k in saved:
                sys.modules[k] = saved[k]
            else:
                sys.modules.pop(k, None)


def test_xarray_facade_matches_jax():
    """``make_module`` exposes the JAX facade's names; importing the module
    registers nothing (``install`` is the only writer of sys.modules)."""
    before = sys.modules.get("xarray")
    importlib.reload(t_xc)
    assert sys.modules.get("xarray") is before
    with restoring_xarray_modules():
        got, want = t_xc.make_module(), j_xc.make_module()
    names = sorted(n for n in vars(want) if not n.startswith("__"))
    assert sorted(n for n in vars(got) if not n.startswith("__")) == names
    assert got.__xrlite__ and got.Dataset is tx.Dataset and got.DataTree is t_dt.DataTree
    da = got.DataArray(np.arange(3.0), coords={"x": np.arange(3)}, dims=("x",), name="v")
    want_da = want.DataArray(np.arange(3.0), coords={"x": np.arange(3)}, dims=("x",), name="v")
    assert da.dims == want_da.dims and da.name == want_da.name
    np.testing.assert_array_equal(got.where(da > 0, da, -1.0).values,
                                  want.where(want_da > 0, want_da, -1.0).values)
