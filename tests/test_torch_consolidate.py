"""Port parity: consolidate (depth, location, split-beam angles), and the
slice from raw files to survey-wide MVBS and NASC.

``echopype_torch.consolidate`` is the port's own copy of the JAX package's
host-only numpy module, so on the same inputs its outputs must be equal bit
for bit, NaN where NaN, with the same dims, dtypes and attrs; only the
clock stamp at the head of each ``history`` attr may differ.  Each package
opens the synthetic EK60 files itself (``open_raw`` is held bit-identical
by tests/test_torch_convert.py) and gets the same Sv arrays in its own
``xrlite.Dataset``.  The cases are those of tests/test_consolidate.py, and
the branches of consolidate/api.py.

The slice as a whole (``open_raw`` -> ``compute_Sv`` -> ``add_depth`` ->
``add_location`` -> stores -> ``run_survey_mvbs`` / ``run_survey_nasc``)
runs through each package on its own: MVBS within 1e-5 dB, NASC within
rtol 1e-5 (the bin means hold the two compute_Sv's float32 differences,
up to 3e-5 dB a sample, well inside both).
"""

import re

import numpy as np
import pytest
import torch

import echopype_torch as et
import echopype_tpu as ep
from echopype_torch.xrlite import DataArray as TDataArray
from echopype_tpu.parallel import survey as js
from echopype_tpu.xrlite import DataArray as JDataArray
from echopype_tpu.xrlite import Dataset as JDataset

from synth_ek60 import write_ek60_raw
from test_torch_commongrid import as_package
from test_torch_convert import _bits

torch.set_num_threads(1)

ANGLE_PARAMS = ("angle_sensitivity_alongship", "angle_sensitivity_athwartship",
                "angle_offset_alongship", "angle_offset_athwartship")
FILES = {
    "plain": dict(n_pings=10, n_samples=50),
    # per-ping transducer depth / motion, per-channel mount and beam direction
    "jitter": dict(n_pings=12, n_samples=40, jitter_raw0=True, jitter_config=True, seed=4),
    "nmea_mix": dict(n_pings=14, n_samples=30, nmea_types=["GGA", "GLL", "RMC"], seed=2),
}


@pytest.fixture(scope="module")
def pipelines(tmp_path_factory):
    """{name: (port EchoData, JAX EchoData, port Sv, JAX Sv on the same arrays)}."""
    d = tmp_path_factory.mktemp("consolidate")
    out = {}
    for name, kw in FILES.items():
        path = d / f"{name}-D20200101-T000000.raw"
        write_ek60_raw(path, **kw)
        ted = et.open_raw(path, sonar_model="EK60")
        jed = ep.open_raw(path, sonar_model="EK60")
        ds = et.calibrate.compute_Sv(ted, device="cpu")
        out[name] = (ted, jed, ds, as_package(ds, JDataset))
    return out


def _history(attrs):
    """attrs with the clock stamp cut from the head of ``history``."""
    out = dict(attrs)
    if "history" in out:
        out["history"] = re.sub(r"^[^ ]+\. ", "", out["history"])
    return out


def _same_variable(g, w, where):
    assert g.dims == w.dims, where
    gv, wv = np.asarray(g.values), np.asarray(w.values)
    assert gv.dtype == wv.dtype and gv.shape == wv.shape, where
    if wv.dtype.kind == "O":
        assert [str(x) for x in gv.ravel()] == [str(x) for x in wv.ravel()], where
    else:
        np.testing.assert_array_equal(_bits(gv), _bits(wv), err_msg=where)
    assert _history(g.attrs) == _history(w.attrs), where


def assert_same_dataset(got, want):
    """Two Datasets equal bit for bit, NaN-aware, attrs included."""
    assert sorted(got.data_vars) == sorted(want.data_vars)
    assert sorted(got.coords) == sorted(want.coords)
    for name in want.coords:
        _same_variable(got.coords[name], want.coords[name], name)
    for name in want.data_vars:
        _same_variable(got[name], want[name], name)
    assert _history(got.attrs) == _history(want.attrs)


class TestSwapDims:
    def test_swap(self, pipelines):
        _, _, ds_t, ds_j = pipelines["plain"]
        got = et.consolidate.swap_dims_channel_frequency(ds_t)
        assert_same_dataset(got, ep.consolidate.swap_dims_channel_frequency(ds_j))
        assert "frequency_nominal" in got["Sv"].dims and "channel" in got.data_vars

    def test_duplicate_freq_raises(self, pipelines):
        _, _, ds_t, _ = pipelines["plain"]
        ds = ds_t.copy()
        ds["frequency_nominal"] = (("channel",), np.array([38000.0, 38000.0]))
        with pytest.raises(ValueError, match="duplicate"):
            et.consolidate.swap_dims_channel_frequency(ds)


def _time_varying(DataArray, ds, name, values):
    pt = np.asarray(ds.coords["ping_time"].values)
    return DataArray(values(len(pt)), ("time_ext",), coords={"time_ext": pt}, name=name)


DEPTH_CASES = {
    "defaults": {},
    "scalar_offset_and_tilt": dict(depth_offset=5.0, tilt=60.0),
    "upward": dict(depth_offset=100.0, downward=False),
    "platform_vertical_offsets": dict(echodata=True, use_platform_vertical_offsets=True),
    "offset_over_platform": dict(echodata=True, depth_offset=2.0,
                                 use_platform_vertical_offsets=True),
    "platform_angles": dict(echodata=True, use_platform_angles=True),
    "beam_angles": dict(echodata=True, use_beam_angles=True),
    "tilt_over_angles": dict(echodata=True, tilt=10.0, use_platform_angles=True),
    "time_varying_offset": dict(depth_offset=lambda n: np.linspace(0, 9, n)),
    "time_varying_tilt": dict(tilt=lambda n: np.linspace(0, 30, n)),
}


class TestAddDepth:
    @pytest.mark.parametrize("file", ["plain", "jitter"])
    @pytest.mark.parametrize("case", sorted(DEPTH_CASES))
    def test_matches_jax(self, pipelines, file, case):
        ted, jed, ds_t, ds_j = pipelines[file]
        kw_t, kw_j = dict(DEPTH_CASES[case]), dict(DEPTH_CASES[case])
        if kw_t.pop("echodata", False):
            kw_t["echodata"], kw_j["echodata"] = ted, jed
        for key in ("depth_offset", "tilt"):
            if callable(kw_t.get(key)):
                kw_t[key] = _time_varying(TDataArray, ds_t, key, kw_t[key])
                kw_j[key] = _time_varying(JDataArray, ds_j, key, kw_j[key])
        got = et.consolidate.add_depth(ds_t, **kw_t)
        assert_same_dataset(got, ep.consolidate.add_depth(ds_j, **kw_j))
        assert got["depth"].dims == ("channel", "ping_time", "range_sample")
        # the plain file carries no beam direction: NaN depth, as in the JAX package
        no_direction = case == "beam_angles" and file == "plain"
        assert np.isfinite(got["depth"].values).any() != no_direction

    def test_platform_offsets_value(self, pipelines):
        """tests/test_consolidate.py: transducer depth = offset_z - (water
        level + heave) = 0 - 9.15 in the synthetic file."""
        ted, _, ds_t, _ = pipelines["plain"]
        got = et.consolidate.add_depth(ds_t, echodata=ted, use_platform_vertical_offsets=True)
        er = ds_t["echo_range"].values
        np.testing.assert_allclose(got["depth"].values[:, 0], (-9.15 + er)[:, 0], rtol=1e-5)

    def test_store_path_and_level(self, pipelines, tmp_path):
        """A store path opens as a Dataset; with location the output is
        stamped Level 2A, as in the JAX package."""
        ted, jed, ds_t, ds_j = pipelines["plain"]
        store = str(tmp_path / "sv.zarr")
        ds_t.to_zarr(store)
        got = et.consolidate.add_depth(store, depth_offset=1.0)
        assert_same_dataset(got, ep.consolidate.add_depth(store, depth_offset=1.0))
        assert "processing_level" not in got.attrs
        loc = et.consolidate.add_location(ds_t, ted)
        assert et.consolidate.add_depth(loc).attrs["processing_level"] == "Level 2A"

    @pytest.mark.parametrize("kw, exc", [
        (dict(use_beam_angles=True), ValueError),
        (dict(echodata=True, use_platform_angles=True, use_beam_angles=True),
         NotImplementedError),
        (dict(depth_offset=np.zeros((2, 2))), None),
    ], ids=["needs_echodata", "both_angles", "offset_array_ignored"])
    def test_errors_as_jax(self, pipelines, kw, exc):
        ted, jed, ds_t, ds_j = pipelines["plain"]
        kw_t, kw_j = dict(kw), dict(kw)
        if kw_t.pop("echodata", False):
            kw_t["echodata"], kw_j["echodata"] = ted, jed
        if exc is None:
            assert_same_dataset(et.consolidate.add_depth(ds_t, **kw_t),
                                ep.consolidate.add_depth(ds_j, **kw_j))
            return
        for fn, ds, k in ((et.consolidate.add_depth, ds_t, kw_t),
                          (ep.consolidate.add_depth, ds_j, kw_j)):
            with pytest.raises(exc):
                fn(ds, **k)

    def test_two_dim_offset_raises(self, pipelines):
        _, _, ds_t, _ = pipelines["plain"]
        off = TDataArray(np.zeros((2, 3)), ("a", "b"))
        with pytest.raises(ValueError, match="single dimension"):
            et.consolidate.add_depth(ds_t, depth_offset=off)


class TestAddLocation:
    @pytest.mark.parametrize("file, kw", [
        ("plain", {}),
        ("plain", dict(nmea_sentence="GGA")),
        ("jitter", {}),
        ("nmea_mix", {}),
        ("nmea_mix", dict(nmea_sentence="GLL")),
        ("nmea_mix", dict(nmea_sentence="RMC")),
    ], ids=["plain", "gga", "jitter", "mix", "mix_gll", "mix_rmc"])
    def test_matches_jax(self, pipelines, file, kw):
        ted, jed, ds_t, ds_j = pipelines[file]
        got = et.consolidate.add_location(ds_t, ted, **kw)
        assert_same_dataset(got, ep.consolidate.add_location(ds_j, jed, **kw))
        lat = got["latitude"].values
        assert lat.shape == (ds_t.sizes["ping_time"],) and np.isfinite(lat).all()

    def test_interpolates_synthetic_track(self, pipelines):
        ted, _, ds_t, _ = pipelines["plain"]
        lat = et.consolidate.add_location(ds_t, ted)["latitude"].values
        assert np.all((lat > 29) & (lat < 31))

    @pytest.mark.parametrize("kw", [dict(datagram_type="MRU1"),
                                    dict(datagram_type="IDX"),
                                    dict(datagram_type=None, nmea_sentence="GGA",
                                         _both=True)])
    def test_errors_as_jax(self, pipelines, kw):
        ted, jed, ds_t, ds_j = pipelines["plain"]
        kw = dict(kw)
        if kw.pop("_both", False):  # valid: no error in either package
            assert_same_dataset(et.consolidate.add_location(ds_t, ted, **kw),
                                ep.consolidate.add_location(ds_j, jed, **kw))
            return
        for fn, ds, ed in ((et.consolidate.add_location, ds_t, ted),
                           (ep.consolidate.add_location, ds_j, jed)):
            with pytest.raises(ValueError):
                fn(ds, ed, **kw)


class TestSplitbeamAngle:
    @staticmethod
    def _with_params(ds, ed):
        ds = ds.copy()
        beam = ed["Sonar/Beam_group1"]
        for p in ANGLE_PARAMS:
            ds[p] = beam[p]
        return ds

    @pytest.mark.parametrize("file", ["plain", "jitter"])
    def test_power_mode_matches_jax(self, pipelines, file):
        ted, jed, ds_t, ds_j = pipelines[file]
        got = et.consolidate.add_splitbeam_angle(self._with_params(ds_t, ted), ted,
                                                 waveform_mode="CW", encode_mode="power")
        want = ep.consolidate.add_splitbeam_angle(self._with_params(ds_j, jed), jed,
                                                  waveform_mode="CW", encode_mode="power")
        assert_same_dataset(got, want)

    def test_power_mode_values(self, pipelines):
        """physical = raw * (180/128) / sensitivity - offset; sensitivity
        21.9, offset 0 in the synthetic file."""
        ted, _, ds_t, _ = pipelines["plain"]
        got = et.consolidate.add_splitbeam_angle(self._with_params(ds_t, ted), ted,
                                                 waveform_mode="CW", encode_mode="power")
        raw = ted["Sonar/Beam_group1"]["angle_alongship"].values
        np.testing.assert_allclose(got["angle_alongship"].values, raw * (180.0 / 128.0) / 21.9,
                                   rtol=1e-5)

    def test_missing_params_raises(self, pipelines):
        ted, _, ds_t, _ = pipelines["plain"]
        ds = ds_t.copy()
        for p in [p for p in ds.data_vars if p.startswith("angle_")]:
            del ds.data_vars[p]
        with pytest.raises(ValueError, match="missing the required parameter"):
            et.consolidate.add_splitbeam_angle(ds, ted, waveform_mode="CW", encode_mode="power")

    def test_mvbs_input_raises(self, pipelines):
        ted, _, ds_t, _ = pipelines["plain"]
        mvbs = et.compute_MVBS(ds_t, range_bin="5m", ping_time_bin="5s", device="cpu")
        with pytest.raises(NotImplementedError, match="full-resolution"):
            et.consolidate.add_splitbeam_angle(mvbs, ted, waveform_mode="CW",
                                               encode_mode="power")

    def test_complex_beam_types_raise_as_jax(self):
        """EC150-3C (beam type 97) is not supported and an unknown beam
        type is an error, in both packages (complex mode leaves such a
        channel's angles NaN)."""
        from echopype_torch.consolidate import split_beam_angle as tsba
        from echopype_tpu.consolidate import split_beam_angle as jsba

        bs = np.ones((2, 5, 4), dtype="c16")
        for mod in (tsba, jsba):
            with pytest.raises(NotImplementedError, match="EC150"):
                mod._angles_from_complex(bs, 97)
            with pytest.raises(ValueError, match="beam_type"):
                mod._angles_from_complex(bs, 5)

    def test_ek80_mode_checks(self):
        from echopype_torch.echodata import simrad as ts
        from echopype_tpu.echodata import simrad as js

        for args in [("FM", "complex"), ("CW", "power"), ("CW", "complex")]:
            assert ts.check_input_args_combination(*args) == js.check_input_args_combination(
                *args)
        for args in [("BB", "power"), (None, "power"), ("XX", "power"), ("CW", "raw"),
                     ("CW", "power", True)]:
            for mod in (ts, js):
                with pytest.raises(ValueError):
                    mod.check_input_args_combination(*args)


class TestSplitbeamComplex:
    """Complex-mode split-beam angles on EK80 files (tests/synth_ek80.py):
    CW complex and BB, BB with and without pulse compression (the replica
    through the port's float64 matched filter), 3-sector and 3+center
    transducers; the port's angles equal the JAX package's bit for bit on
    the same Sv arrays."""

    @pytest.fixture(scope="class")
    def ek80(self, tmp_path_factory):
        from synth_ek80 import write_ek80_multisector, write_ek80_raw

        d = tmp_path_factory.mktemp("splitbeam_ek80")
        out = {"default": d / "E80-D20210201-T000000.raw"}
        write_ek80_raw(out["default"], n_pings=5, n_samples=128)
        for bt in (17, 49):
            out[bt] = d / f"MS{bt}-D20210201-T000000.raw"
            write_ek80_multisector(out[bt], beam_type=bt)
        return {k: (et.open_raw(v, sonar_model="EK80"), ep.open_raw(v, sonar_model="EK80"))
                for k, v in out.items()}

    @pytest.mark.parametrize("file, waveform_mode, pulse_compression", [
        ("default", "BB", False), ("default", "BB", True), ("default", "CW", False),
        (17, "CW", False), (49, "CW", False)])
    def test_matches_jax(self, ek80, file, waveform_mode, pulse_compression):
        ted, jed = ek80[file]
        ds_t = et.calibrate.compute_Sv(ted, waveform_mode=waveform_mode, encode_mode="complex",
                                       precision="float64", device="cpu")
        kw = dict(waveform_mode=waveform_mode, encode_mode="complex",
                  pulse_compression=pulse_compression, to_disk=False)
        got = et.consolidate.add_splitbeam_angle(ds_t, ted, **kw)
        want = ep.consolidate.add_splitbeam_angle(as_package(ds_t, JDataset), jed, **kw)
        assert_same_dataset(got, want)
        assert np.isfinite(got["angle_alongship"].values).any()


# ---------------------------------------------------------- the whole slice
class TestSlice:
    """raw -> open_raw -> compute_Sv -> add_depth -> add_location -> stores ->
    survey MVBS / NASC, through each package on its own."""

    @pytest.fixture(scope="class")
    def chains(self, tmp_path_factory):
        d = tmp_path_factory.mktemp("slice")
        t0 = np.datetime64("2020-01-01T00:00:00", "ns")
        out = {"torch": [], "jax": []}
        for i in range(2):
            raw = d / f"L{i}-D20200101-T000000.raw"
            write_ek60_raw(raw, n_pings=20, n_samples=150, with_angle=False, seed=10 + i,
                           t0=t0 + np.timedelta64(30 * i, "s"))
            for tag, pkg, kw in (("torch", et, dict(device="cpu")), ("jax", ep, {})):
                ed = pkg.open_raw(raw, sonar_model="EK60")
                ds = pkg.calibrate.compute_Sv(ed, **kw)
                ds = pkg.consolidate.add_depth(ds, echodata=ed,
                                               use_platform_vertical_offsets=True)
                ds = pkg.consolidate.add_location(ds, ed)
                store = d / f"L{i}_{tag}.zarr"
                ds.to_zarr(store)
                out[tag].append(str(store))
        return out

    def test_survey_mvbs(self, chains):
        kw = dict(range_bin="5m", ping_time_bin="10s", chunk_pings=7)
        got = et.run_survey_mvbs(chains["torch"], device="cpu", **kw)
        want = js.run_survey_mvbs(chains["jax"], **kw)
        assert got.attrs["routes"] == ["grid", "grid"]
        g, w = np.asarray(got["Sv"].values), np.asarray(want["Sv"].values)
        np.testing.assert_array_equal(got.coords["echo_range"].values,
                                      want.coords["echo_range"].values)
        np.testing.assert_array_equal(np.isnan(g), np.isnan(w))
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-5, equal_nan=True)
        assert np.isfinite(g).mean() > 0.5

    def test_survey_nasc(self, chains):
        kw = dict(range_bin="5m", dist_bin="2nmi", chunk_pings=7)
        got = et.run_survey_nasc(chains["torch"], device="cpu", **kw)
        want = js.run_survey_nasc(chains["jax"], **kw)
        for k in ("distance", "depth"):
            np.testing.assert_array_equal(got.coords[k].values, want.coords[k].values)
        g, w = np.asarray(got["NASC"].values), np.asarray(want["NASC"].values)
        np.testing.assert_array_equal(np.isnan(g), np.isnan(w))
        np.testing.assert_allclose(g, w, rtol=1e-5, equal_nan=True)
        np.testing.assert_array_equal(got["ping_time"].values, want["ping_time"].values)
        assert np.isfinite(g).any()
