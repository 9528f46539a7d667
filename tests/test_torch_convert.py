"""Port parity: EK60 conversion and converted stores.

``echopype_torch.open_raw`` runs the port's own copy of the host layer
(``convert``, ``echodata``, ``xrlite``, ``native``); it must give what
``echopype_tpu.open_raw`` gives on the synthetic EK60 files of
``tests/synth_ek60.py``: the same groups, and in every group the same
variables and coords, equal bit for bit (NaN where NaN), with the same dims,
dtypes and attrs; only the clock stamps of the conversion may differ.  The
port's native framing scan must equal its pure-Python walk, and a store the
port writes must open with ``echopype_tpu.open_converted`` to the same
groups.
"""

import numpy as np
import pytest

import echopype_torch as et
import echopype_tpu as ep
from echopype_torch import native as t_native
from echopype_torch.convert.simrad import framing as t_framing
from echopype_torch.xrlite import Dataset as TDataset

from synth_ek60 import write_ek60_raw

# attrs that carry the wall clock of the conversion itself
CLOCK_ATTRS = ("date_created", "conversion_time")

FILES = {
    "plain": dict(n_pings=24, n_samples=90, with_angle=False),
    "jitter_raw0": dict(n_pings=30, n_samples=120, with_angle=False, jitter_raw0=True, seed=3),
    "angles": dict(n_pings=20, n_samples=64, with_angle=True, seed=5),
}


@pytest.fixture(scope="module")
def raw_files(tmp_path_factory):
    d = tmp_path_factory.mktemp("convert")
    out = {}
    for name, kw in FILES.items():
        path = d / f"{name}-D20200101-T000000.raw"
        write_ek60_raw(path, **kw)
        out[name] = str(path)
    return out


def _bits(a):
    a = np.ascontiguousarray(a)
    if a.dtype.kind in "fcmMiub":
        return a.view(np.uint8)
    return a


def _same_attrs(got, want, where):
    g = {k: v for k, v in dict(got).items() if k not in CLOCK_ATTRS}
    w = {k: v for k, v in dict(want).items() if k not in CLOCK_ATTRS}
    assert sorted(g) == sorted(w), where
    for k in w:
        if isinstance(w[k], np.ndarray) or isinstance(g[k], np.ndarray):
            np.testing.assert_array_equal(np.asarray(g[k]), np.asarray(w[k]), err_msg=f"{where} {k}")
        else:
            assert g[k] == w[k] or (g[k] != g[k] and w[k] != w[k]), f"{where} {k}"


def _same_variable(g, w, where):
    assert g.dims == w.dims, where
    gv, wv = np.asarray(g.values), np.asarray(w.values)
    assert gv.dtype == wv.dtype and gv.shape == wv.shape, where
    if wv.dtype.kind == "O":
        assert [str(x) for x in gv.ravel()] == [str(x) for x in wv.ravel()], where
    else:
        np.testing.assert_array_equal(_bits(gv), _bits(wv), err_msg=where)
    _same_attrs(g.attrs, w.attrs, where)


def assert_same_tree(got, want):
    """Every group of two EchoData-like trees equal, bitwise and NaN-aware."""
    assert sorted(got.group_paths) == sorted(want.group_paths)
    for path in want.group_paths:
        g, w = got[path], want[path]
        assert sorted(g.data_vars) == sorted(w.data_vars), path
        assert sorted(g.coords) == sorted(w.coords), path
        for name in w.coords:
            _same_variable(g.coords[name], w.coords[name], f"{path}:{name}")
        for name in w.data_vars:
            _same_variable(g[name], w[name], f"{path}:{name}")
        _same_attrs(g.attrs, w.attrs, path)


class TestOpenRaw:
    @pytest.mark.parametrize("name", sorted(FILES))
    def test_matches_jax(self, raw_files, name):
        got = et.open_raw(raw_files[name], sonar_model="EK60")
        want = ep.open_raw(raw_files[name], sonar_model="EK60")
        assert isinstance(got["Sonar/Beam_group1"], TDataset)
        assert_same_tree(got, want)

    def test_es70_routes_to_the_ek60_parser(self, raw_files):
        got = et.open_raw(raw_files["plain"], sonar_model="ES70")
        want = ep.open_raw(raw_files["plain"], sonar_model="ES70")
        assert_same_tree(got, want)

    @pytest.mark.parametrize("model", ["AZFP", "AZFP6", "AD2CP"])
    def test_unported_models_raise(self, raw_files, model):
        with pytest.raises(NotImplementedError, match="ROADMAP Queue 1 item 11"):
            et.open_raw(raw_files["plain"], sonar_model=model)

    def test_unknown_model_raises(self, raw_files):
        with pytest.raises(ValueError, match="Unsupported sonar_model"):
            et.open_raw(raw_files["plain"], sonar_model="EK99")


class TestEK60Dropout:
    """The dropout file of tests/test_ref_setgroups.py::TestEK60DropoutParity:
    channel 1 (1-based: the first) skips pings 2 and 5, so at those pings of
    the union grid ``data_type`` and ``channel_mode`` have no value.  The
    port's copy of set_groups_ek60 gives the JAX package's answer: float64,
    NaN at exactly those two (channel, ping) cells, the recorded values
    elsewhere."""

    def test_data_type_and_channel_mode_match_jax(self, tmp_path):
        raw = tmp_path / "DO-D20200101-T000000.raw"
        write_ek60_raw(raw, n_pings=9, n_samples=30, with_nmea=False, jitter_raw0=True,
                       jitter_config=True, skip_pings={1: {2, 5}})
        got = et.open_raw(str(raw), sonar_model="EK60")["Sonar/Beam_group1"]
        want = ep.open_raw(str(raw), sonar_model="EK60")["Sonar/Beam_group1"]
        for var in ("data_type", "channel_mode"):
            g, w = np.asarray(got[var].values), np.asarray(want[var].values)
            assert g.dtype == w.dtype == np.float64, var
            nan_at = sorted(zip(*np.nonzero(np.isnan(g))))
            assert nan_at == [(0, 2), (0, 5)], var
            np.testing.assert_array_equal(_bits(g), _bits(w), err_msg=var)


class TestNativeScan:
    @pytest.fixture(scope="class")
    def raw_bytes(self, raw_files):
        if t_native.load_native() is None:
            pytest.skip("no C++ toolchain to build the port's native scanner")
        with open(raw_files["jitter_raw0"], "rb") as f:
            return f.read()

    @staticmethod
    def _same_index(a, b):
        np.testing.assert_array_equal(a.body_offset, b.body_offset)
        np.testing.assert_array_equal(a.size, b.size)
        np.testing.assert_array_equal(a.dgram_type, b.dgram_type)
        np.testing.assert_array_equal(a.timestamp, b.timestamp)

    def test_native_equals_python_framing(self, raw_bytes):
        self._same_index(t_framing.scan_datagrams(raw_bytes, use_native=True),
                         t_framing.scan_datagrams(raw_bytes, use_native=False))

    def test_native_equals_python_framing_after_corruption(self, raw_bytes):
        buf = bytearray(raw_bytes)
        buf[700:712] = b"\x00" * 12
        self._same_index(t_framing.scan_datagrams(bytes(buf), use_native=True),
                         t_framing.scan_datagrams(bytes(buf), use_native=False))

    def test_library_lives_in_the_port(self, raw_bytes):
        lib = t_native.load_native()
        assert "echopype_torch" in str(lib._name) and "echopype_tpu" not in str(lib._name)


class TestStores:
    @staticmethod
    def _stores(raw_files, tmp_path, name):
        """(store the port wrote, store the JAX package wrote) of one file."""
        stores = []
        for pkg in (et, ep):
            store = str(tmp_path / f"{name}-{pkg.__name__}.zarr")
            pkg.open_raw(raw_files[name], sonar_model="EK60").to_zarr(store)
            stores.append(store)
        return stores

    @pytest.mark.parametrize("name", ["plain", "angles"])
    def test_port_zarr_opens_in_jax_package(self, raw_files, tmp_path, name):
        port_store, jax_store = self._stores(raw_files, tmp_path, name)
        assert_same_tree(ep.open_converted(port_store), ep.open_converted(jax_store))

    def test_jax_zarr_opens_in_port(self, raw_files, tmp_path):
        port_store, jax_store = self._stores(raw_files, tmp_path, "jitter_raw0")
        back = et.open_converted(jax_store)
        assert isinstance(back["Environment"], TDataset)
        assert_same_tree(back, ep.open_converted(jax_store))
        assert_same_tree(et.open_converted(port_store), back)
