"""Port parity: commongrid on Sv datasets (MVBS, index-binned MVBS, NASC).

``echopype_torch.commongrid`` (device="cpu": the same torch ops the card
runs, on the host) against ``echopype_tpu.commongrid`` on the same Sv
datasets: each package gets its own ``xrlite.Dataset``, built from the same
numpy arrays (the port checks ``isinstance`` against its own classes).
Tolerances: MVBS within
1e-5 dB (the accuracy contract; float32 bin sums in another order),
NASC rtol 1e-5, the float64 paths (ping-varying grids, index binning,
positions, distance) within 1e-9; coords, NaN masks and attrs identical
(processing timestamps aside).  The cases are those tests/test_commongrid.py
pins, plus the branches of commongrid/api.py.  The range-row routes of
``compute_MVBS`` and ``compute_NASC`` (and ``ops/binning.py``'s row twins)
equal the per-sample route on the same grid bit for bit.
"""

import numpy as np
import pytest
import torch

import echopype_torch as et
import echopype_tpu as ep
from echopype_torch.commongrid import utils as tu
from echopype_torch.ops import binning as tb
from echopype_torch.utils import profiling
from echopype_tpu.commongrid import utils as ju
from echopype_torch.xrlite import Dataset as TDataset
from echopype_tpu.ops import binning as jb
from echopype_tpu.xrlite import Dataset as JDataset

torch.set_num_threads(1)

MVBS_ATOL_DB = 1e-5
NASC_RTOL = 1e-5
F8_TOL = dict(rtol=1e-9, atol=1e-9)
_CLOCK_ATTRS = ("processing_time",)


def make_sv_dataset(Dataset, n_ch=2, n_ping=60, n_r=100, seed=0, with_latlon=True, dr=0.5):
    """tests/test_commongrid.py::make_sv_dataset, as a ``Dataset`` of the given
    package; the arrays depend on the arguments alone."""
    rng = np.random.default_rng(seed)
    ping_time = np.datetime64("2020-01-01T00:00:03", "ns") + (
        np.arange(n_ping) * np.timedelta64(2_000_000_000, "ns"))
    sv = rng.normal(-70, 10, (n_ch, n_ping, n_r)).astype("f4")
    er = np.broadcast_to(np.arange(n_r) * dr, (n_ch, n_ping, n_r)).copy()
    ds = Dataset(
        {
            "Sv": (("channel", "ping_time", "range_sample"), sv),
            "echo_range": (("channel", "ping_time", "range_sample"), er),
            "frequency_nominal": (("channel",), 1000.0 * (1 + np.arange(n_ch))),
        },
        coords={
            "channel": np.array([f"ch{i}" for i in range(n_ch)], dtype=object),
            "ping_time": ping_time,
            "range_sample": np.arange(n_r),
        },
        attrs={"processing_level": "Level 2A"},
    )
    if with_latlon:
        ds["latitude"] = (("ping_time",), 45.0 + np.arange(n_ping) * 1e-4)
        ds["longitude"] = (("ping_time",), -125.0 + np.arange(n_ping) * 1e-4)
    return ds


def as_package(ds, Dataset):
    """``ds`` rebuilt as a ``Dataset`` of another package, from copies of
    its numpy arrays."""
    def var(da):
        return (da.dims, np.array(da.values), dict(da.attrs))

    return Dataset({k: var(v) for k, v in ds.data_vars.items()},
                   coords={k: var(v) for k, v in ds.coords.items()}, attrs=dict(ds.attrs))


def _mvbs_case(name, Dataset):
    """(dataset, compute_MVBS kwargs) for one branch of compute_MVBS, as a
    ``Dataset`` of the given package."""
    def make_sv_dataset_(**kw):
        return make_sv_dataset(Dataset, **kw)

    kw = {}
    if name == "default":
        ds = make_sv_dataset_()
    elif name == "closed_right":
        ds, kw = make_sv_dataset_(n_ch=1, n_ping=20, n_r=30), dict(range_bin="5m", closed="right")
    elif name == "skipna_false":
        ds, kw = make_sv_dataset_(n_ch=1, n_ping=20, n_r=30), dict(range_bin="5m", skipna=False)
        ds.data_vars["Sv"].values[0, 0, 5] = np.nan
        ds.data_vars["Sv"].values[0, 12, :] = np.nan  # a whole NaN ping
    elif name == "range_var_max":
        ds, kw = make_sv_dataset_(n_r=40), dict(range_bin="10m", range_var_max="30m")
    elif name == "fill_value":  # range_var_max past the data leaves empty bins
        ds, kw = make_sv_dataset_(n_r=40), dict(range_bin="5m", range_var_max="40m",
                                               fill_value=1e-9)
    elif name == "fill_value_skipna_false":
        ds = make_sv_dataset_(n_r=40)
        ds.data_vars["Sv"].values[:, 7, :] = np.nan
        kw = dict(range_bin="5m", range_var_max="40m", fill_value=1e-9, skipna=False)
    elif name == "depth":
        ds = make_sv_dataset_()
        ds["depth"] = (("channel", "ping_time", "range_sample"),
                       np.asarray(ds["echo_range"].values) + 3.2)
        kw = dict(range_var="depth", range_bin="7m")
    elif name == "range_row":  # echo_range carried as one row per channel
        ds = make_sv_dataset_(seed=3)
        ds["echo_range"] = (("channel", "range_sample"),
                            np.asarray(ds["echo_range"].values)[:, 0, :].copy())
    elif name == "unsorted_pings":
        ds = make_sv_dataset_(seed=1)
        order = np.random.default_rng(1).permutation(ds.sizes["ping_time"])
        ds = Dataset(
            {
                "Sv": (("channel", "ping_time", "range_sample"),
                       np.asarray(ds["Sv"].values)[:, order]),
                "echo_range": (("channel", "ping_time", "range_sample"),
                               np.asarray(ds["echo_range"].values)[:, order]),
                "latitude": (("ping_time",), np.asarray(ds["latitude"].values)[order]),
                "longitude": (("ping_time",), np.asarray(ds["longitude"].values)[order]),
            },
            coords={
                "channel": ds.coords["channel"].values,
                "ping_time": np.asarray(ds.coords["ping_time"].values)[order],
                "range_sample": ds.coords["range_sample"].values,
            },
            attrs={"processing_level": "Level 2A"},
        )
    elif name == "upward_looking":
        ds = make_sv_dataset_(seed=2)
        er = np.asarray(ds["echo_range"].values)
        ds["echo_range"] = (("channel", "ping_time", "range_sample"), er[:, :, ::-1].copy())
    elif name == "ping_varying_grid":  # the exact float64 host path
        ds = make_sv_dataset_(seed=4)
        er = np.asarray(ds["echo_range"].values)
        wobble = np.random.default_rng(4).uniform(0.98, 1.02, er.shape[:2])[:, :, None]
        ds["echo_range"] = (("channel", "ping_time", "range_sample"), er * wobble)
    elif name == "ragged_nan_range":  # echo_range NaN where a ping is short
        ds = make_sv_dataset_(seed=5)
        ds.data_vars["Sv"].values[:, 3, 70:] = np.nan
        ds.data_vars["echo_range"].values[:, 3, 70:] = np.nan
    elif name == "upward_looking_holes":  # a decreasing row, the same NaN holes in every ping
        ds = make_sv_dataset_(seed=6)
        er = np.asarray(ds["echo_range"].values)[:, :, ::-1].copy()
        er[:, :, :7] = np.nan
        er[0, :, 40] = np.nan
        ds["echo_range"] = (("channel", "ping_time", "range_sample"), er)
    elif name == "range_sample_row":  # echo_range a float32 row with neither channel nor ping
        ds, kw = make_sv_dataset_(seed=8), dict(range_bin="3m")
        ds["echo_range"] = (("range_sample",), np.arange(100, dtype="f4") * np.float32(0.37))
    elif name == "no_latlon":
        ds = make_sv_dataset_(with_latlon=False)
    elif name == "level_2b":
        ds = make_sv_dataset_()
        ds.attrs["processing_level"] = "Level 2B"
    elif name == "time_bin_30s":
        ds, kw = make_sv_dataset_(n_ping=90), dict(ping_time_bin="0.5min", range_bin="12.5m")
    else:
        raise KeyError(name)
    return ds, kw


MVBS_CASES = ["default", "closed_right", "skipna_false", "range_var_max", "fill_value",
              "fill_value_skipna_false", "depth", "range_row", "unsorted_pings",
              "upward_looking", "ping_varying_grid", "ragged_nan_range", "no_latlon",
              "level_2b", "time_bin_30s", "upward_looking_holes", "range_sample_row"]


def _attrs(a):
    return {k: v for k, v in dict(a).items() if k not in _CLOCK_ATTRS}


def assert_same_dataset(got, want, atol, rtol=0.0):
    assert set(got.data_vars) == set(want.data_vars)
    assert _attrs(got.attrs) == _attrs(want.attrs)
    for name in want.coords:
        np.testing.assert_array_equal(np.asarray(got.coords[name].values),
                                      np.asarray(want.coords[name].values))
        assert dict(got.coords[name].attrs) == dict(want.coords[name].attrs)
    for name in want.data_vars:
        g, w = np.asarray(got[name].values), np.asarray(want[name].values)
        assert got[name].dims == want[name].dims and g.shape == w.shape, name
        assert dict(got[name].attrs) == dict(want[name].attrs), name
        if w.dtype.kind == "f":
            np.testing.assert_array_equal(np.isnan(g), np.isnan(w), err_msg=name)
            np.testing.assert_allclose(g, w, rtol=rtol, atol=atol, err_msg=name)
        else:
            np.testing.assert_array_equal(g, w, err_msg=name)


class TestComputeMVBS:
    @pytest.mark.parametrize("case", MVBS_CASES)
    def test_matches_jax(self, case):
        ds, kw = _mvbs_case(case, TDataset)
        got = et.compute_MVBS(ds, device="cpu", **kw)
        want = ep.commongrid.compute_MVBS(_mvbs_case(case, JDataset)[0], **kw)
        assert_same_dataset(got, want, atol=MVBS_ATOL_DB)
        assert np.isfinite(np.asarray(got["Sv"].values)).any()

    def test_quiet_bin_after_loud_pings(self):
        """tests/test_commongrid.py::TestQuietBinPrecision: a quiet bin after
        loud pings against a float64 oracle (atol 2e-5 dB)."""
        rng = np.random.default_rng(9)
        P, R = 120, 64
        pt = np.datetime64("2021-01-01", "ns") + np.arange(P).astype(
            "timedelta64[s]").astype("timedelta64[ns]")
        sv = np.full((1, P, R), -20.0, dtype="f4")
        sv[:, 80:] = -100.0
        sv += rng.normal(0, 1, sv.shape).astype("f4")
        er = np.broadcast_to(np.arange(R, dtype="f4") * 0.5, (1, P, R)).copy()
        ds = TDataset(coords={"channel": np.asarray(["ch"], dtype=object), "ping_time": pt,
                             "range_sample": np.arange(R)})
        ds["Sv"] = (("channel", "ping_time", "range_sample"), sv)
        ds["echo_range"] = (("channel", "ping_time", "range_sample"), er)
        got = np.asarray(et.compute_MVBS(ds, range_bin="8m", ping_time_bin="20s",
                                         device="cpu")["Sv"].values)
        edges_t, edges_r = np.arange(0, P + 20, 20), np.arange(0, er.max() + 8.0, 8.0)
        want = np.full((1, len(edges_t) - 1, len(edges_r) - 1), np.nan)
        lin = 10.0 ** (sv.astype("f8") / 10.0)
        for i in range(len(edges_t) - 1):
            for j in range(len(edges_r) - 1):
                rsel = (er[0, 0] >= edges_r[j]) & (er[0, 0] < edges_r[j + 1])
                block = lin[0, edges_t[i]:min(edges_t[i + 1], P)][:, rsel]
                if block.size:
                    want[0, i, j] = 10 * np.log10(block.mean())
        n_t, n_r = min(got.shape[1], want.shape[1]), min(got.shape[2], want.shape[2])
        np.testing.assert_allclose(got[:, :n_t, :n_r], want[:, :n_t, :n_r], rtol=0, atol=2e-5,
                                   equal_nan=True)

    @pytest.mark.parametrize("case, grid", [("shared_holes", True), ("ragged_ping", False),
                                            ("sound_speed_ping", False)])
    def test_route_decision(self, monkeypatch, case, grid):
        """The [C, R] row route is taken exactly when every ping shares the
        range row, NaN holes included, and either route gives the output of
        the per-sample route, bit for bit."""
        ds = make_sv_dataset(TDataset, seed=7)
        er, sv = ds.data_vars["echo_range"].values, ds.data_vars["Sv"].values
        if case == "shared_holes":
            er[:, :, 85:] = np.nan
            er[1, :, 30] = np.nan
        elif case == "ragged_ping":  # one short ping
            er[:, 5, 70:] = np.nan
            sv[:, 5, 70:] = np.nan
        else:  # one ping at another sound speed: a scaled row
            er[:, 9] *= 1495.0 / 1480.0
        rows = []
        orig = tb.windowed_partials_grid_np
        monkeypatch.setattr(tb, "windowed_partials_grid_np",
                            lambda sv, row, *a, **kw: rows.append(row) or orig(sv, row, *a, **kw))
        got = np.asarray(et.compute_MVBS(ds, device="cpu")["Sv"].values)
        assert len(rows) == int(grid)
        if grid:
            np.testing.assert_array_equal(rows[0], er[:, 0])
        monkeypatch.setattr(tb, "ping_invariant_row", lambda er: (None, False))
        want = np.asarray(et.compute_MVBS(ds, device="cpu")["Sv"].values)
        assert len(rows) == int(grid)
        np.testing.assert_array_equal(got, want)
        assert np.isfinite(got).any()

    @pytest.mark.parametrize("case, grid", [("default", True), ("ping_varying_grid", False)])
    def test_route_counters(self, tmp_path, case, grid):
        """``mvbs_pings`` counts the pings binned, ``mvbs_grid_pings`` those
        that took the row route, in a profiler window."""
        ds, kw = _mvbs_case(case, TDataset)
        with profiling.trace(str(tmp_path)):
            et.compute_MVBS(ds, device="cpu", **kw)
        n = ds.sizes["ping_time"]
        assert profiling.TRACED.counters["mvbs_pings"] == n
        assert profiling.TRACED.counters["mvbs_grid_pings"] == (n if grid else 0)

    def test_attrs_and_levels(self):
        mvbs = et.compute_MVBS(make_sv_dataset(TDataset), device="cpu")
        assert mvbs.attrs["processing_function"] == "commongrid.compute_MVBS"
        assert mvbs.attrs["processing_level"] == "Level 3A"
        assert "input_processing_level" not in mvbs.attrs
        assert "processing_level" not in et.compute_MVBS(
            make_sv_dataset(TDataset, with_latlon=False), device="cpu").attrs

    @pytest.mark.parametrize("kw, exc", [
        (dict(range_bin="10 parsecs"), ValueError),
        (dict(ping_time_bin=20), TypeError),
        (dict(closed="both"), ValueError),
        (dict(range_var="depth"), ValueError),
        (dict(range_var="range"), ValueError),
        (dict(ping_time_bin="1W"), ValueError),
    ])
    def test_bad_inputs(self, kw, exc):
        ds = make_sv_dataset(TDataset)
        with pytest.raises(exc):
            et.compute_MVBS(ds, device="cpu", **kw)

    def test_cuda_request_without_cuda_raises(self):
        if torch.cuda.is_available():
            pytest.skip("a CUDA device is present; this checks the no-fallback rule")
        with pytest.raises(RuntimeError, match="cuda"):
            et.compute_MVBS(make_sv_dataset(TDataset))


class TestIndexBinning:
    @pytest.mark.parametrize("shape, nums", [((1, 25, 35), (10, 10)), ((2, 60, 100), (7, 13)),
                                             ((2, 30, 40), (100, 100))])
    def test_matches_jax(self, shape, nums):
        ds_t, ds_j = (make_sv_dataset(D, n_ch=shape[0], n_ping=shape[1], n_r=shape[2], seed=6)
                      for D in (TDataset, JDataset))
        for ds in (ds_t, ds_j):
            ds.data_vars["Sv"].values[0, 2, 10:] = np.nan
            ds.data_vars["echo_range"].values[0, 2, 10:] = np.nan
        got = et.compute_MVBS_index_binning(ds_t, range_sample_num=nums[0], ping_num=nums[1],
                                            device="cpu")
        want = ep.commongrid.compute_MVBS_index_binning(ds_j, range_sample_num=nums[0],
                                                        ping_num=nums[1])
        assert_same_dataset(got, want, **F8_TOL)


def _nasc_dataset(Dataset, seed=0, n_ping=40, n_r=50, const_sv=None, nan_positions=False):
    ds = make_sv_dataset(Dataset, n_ch=2, n_ping=n_ping, n_r=n_r, seed=seed)
    if const_sv is not None:
        ds.data_vars["Sv"].values[:] = const_sv
    ds["depth"] = (("channel", "ping_time", "range_sample"),
                   np.asarray(ds["echo_range"].values) + 1.5)
    lat = 45.0 + np.arange(n_ping) * 3e-3
    if nan_positions:
        lat[[0, 5, 6]] = np.nan
    ds["latitude"] = (("ping_time",), lat)
    return ds


class TestComputeNASC:
    @pytest.mark.parametrize("kw, data", [
        ({}, {}),
        (dict(range_bin="5m", dist_bin="0.1nmi"), dict(seed=1)),
        (dict(range_bin="5m", dist_bin="0.1nmi", closed="right"), dict(seed=2)),
        (dict(range_bin="5m", dist_bin="0.05nmi", skipna=False), dict(seed=3)),
        (dict(dist_bin="0.2nmi"), dict(nan_positions=True)),
        (dict(range_bin="10m", dist_bin="0.5nmi"), dict(const_sv=-60.0)),
    ], ids=["default", "fine", "closed_right", "skipna_false", "nan_positions", "constant_sv"])
    def test_matches_jax(self, kw, data):
        ds_t, ds_j = (_nasc_dataset(D, **data) for D in (TDataset, JDataset))
        if kw.get("skipna") is False:
            for ds in (ds_t, ds_j):
                ds.data_vars["Sv"].values[1, 4, 7] = np.nan
        got = et.compute_NASC(ds_t, device="cpu", **kw)
        want = ep.commongrid.compute_NASC(ds_j, **kw)
        assert_same_dataset(got, want, atol=0.0, rtol=NASC_RTOL)
        assert np.isfinite(np.asarray(got["NASC"].values)).any()

    def test_ping_varying_depth_grid(self):
        ds_t, ds_j = (_nasc_dataset(D, seed=4) for D in (TDataset, JDataset))
        dep = np.asarray(ds_t["depth"].values)
        dep = dep * np.random.default_rng(4).uniform(0.98, 1.02, dep.shape[:2])[:, :, None]
        for ds in (ds_t, ds_j):
            ds["depth"] = (("channel", "ping_time", "range_sample"), dep.copy())
        got = et.compute_NASC(ds_t, range_bin="5m", dist_bin="0.1nmi", device="cpu")
        want = ep.commongrid.compute_NASC(ds_j, range_bin="5m", dist_bin="0.1nmi")
        assert_same_dataset(got, want, **F8_TOL)

    def test_constant_sv_analytic(self):
        """tests/test_commongrid.py::TestNASC: NASC = sv_lin * H * 4 pi 1852^2."""
        n_ping, n_r = 40, 50
        ds = make_sv_dataset(TDataset, n_ch=1, n_ping=n_ping, n_r=n_r, dr=0.5)
        ds.data_vars["Sv"].values[:] = -60.0
        ds["depth"] = (("channel", "ping_time", "range_sample"), ds["echo_range"].values)
        v = et.compute_NASC(ds, range_bin="10m", dist_bin="0.5nmi", device="cpu")["NASC"].values
        expected = 10 ** (-60.0 / 10) * 10.0 * 4 * np.pi * 1852**2
        np.testing.assert_allclose(v[0, 0, 1:(n_r // 20) - 1], expected, rtol=0.02)

    @pytest.mark.parametrize("kw, exc", [
        (dict(dist_bin=0.5), TypeError), (dict(dist_bin="0.5km"), ValueError),
        (dict(range_bin="5 fathoms"), ValueError),
    ])
    def test_bad_inputs(self, kw, exc):
        with pytest.raises(exc):
            et.compute_NASC(_nasc_dataset(TDataset), device="cpu", **kw)

    def test_requires_depth(self):
        with pytest.raises(ValueError, match="depth"):
            et.compute_NASC(make_sv_dataset(TDataset), device="cpu")

    @staticmethod
    def _route_case(case):
        ds = _nasc_dataset(TDataset, seed=11)
        dep, sv = ds.data_vars["depth"].values, ds.data_vars["Sv"].values
        if case in ("shared_holes", "upward_holes"):
            dep[:, :, 40:] = np.nan
            dep[1, :, 20] = np.nan
            if case == "upward_holes":  # a decreasing row: oriented before it is binned
                dep[:] = dep[:, :, ::-1].copy()
        elif case == "ragged_ping":  # one short ping
            dep[:, 5, 35:] = np.nan
            sv[:, 5, 35:] = np.nan
        else:  # one ping at another sound speed: a scaled row
            dep[:, 9] *= 1495.0 / 1480.0
        return ds

    @pytest.mark.parametrize("case, grid", [("shared_holes", True), ("upward_holes", True),
                                            ("ragged_ping", False), ("sound_speed_ping", False)])
    def test_route_decision(self, monkeypatch, case, grid):
        """The [C, R] depth row is binned once, for the Sv and the height sums,
        exactly when every ping shares it, NaN holes included; the Sv sums,
        the height sums, NASC, the mean ping times and positions equal the
        per-sample route's bit for bit."""
        ds = self._route_case(case)
        rows, sv_sums, h_sums = [], [], []
        orig = (tb.windowed_sum_raw_grid_np, tb.windowed_partials_np, tb.windowed_sum_raw_np)
        monkeypatch.setattr(tb, "windowed_sum_raw_grid_np",
                            lambda v, row, *a, **kw: rows.append(row) or orig[0](v, row, *a, **kw))
        monkeypatch.setattr(tb, "windowed_partials_np",
                            lambda *a, **kw: sv_sums.append(orig[1](*a, **kw)) or sv_sums[-1])
        monkeypatch.setattr(tb, "windowed_sum_raw_np",
                            lambda *a, **kw: h_sums.append(orig[2](*a, **kw)) or h_sums[-1])
        kw = dict(range_bin="5m", dist_bin="1nmi", device="cpu")  # 5-6 pings a bin
        got = et.compute_NASC(ds, **kw)
        assert len(rows) == int(grid)
        if grid:
            dep = np.asarray(ds["depth"].values)[:, 0]
            want_row = dep[:, ::-1] if case == "upward_holes" else dep
            np.testing.assert_array_equal(rows[0], want_row[:, :-1])
        monkeypatch.setattr(tb, "ping_invariant_row", lambda er: (None, False))
        want = et.compute_NASC(ds, **kw)
        assert len(rows) == int(grid)
        for g, w in zip(sv_sums[0], sv_sums[1]):
            np.testing.assert_array_equal(g, w)
        # exact on the CPU (the card's row matmul may round the row sums
        # otherwise: within 1e-6, tests/test_torch_kernels_gpu.py)
        np.testing.assert_array_equal(h_sums[0], h_sums[1])
        nasc = np.asarray(got["NASC"].values)
        np.testing.assert_array_equal(nasc, want["NASC"].values)
        assert np.isfinite(nasc).any()
        for key in ("ping_time", "latitude", "longitude"):
            np.testing.assert_array_equal(got[key].values, want[key].values)
        np.testing.assert_array_equal(got.coords["depth"].values, want.coords["depth"].values)

    @pytest.mark.parametrize("case, grid", [("shared_holes", True), ("sound_speed_ping", False)])
    def test_route_counters(self, tmp_path, case, grid):
        """``nasc_pings`` counts the pings binned, ``nasc_sample_pings`` those
        whose samples resolve one by one, in a profiler window."""
        ds = self._route_case(case)
        with profiling.trace(str(tmp_path)):
            et.compute_NASC(ds, range_bin="5m", dist_bin="1nmi", device="cpu")
        n = ds.sizes["ping_time"]
        assert profiling.TRACED.counters["nasc_pings"] == n
        assert profiling.TRACED.counters["nasc_sample_pings"] == (0 if grid else n)


class TestUtils:
    @pytest.mark.parametrize("ping_time_bin", [
        "20s", "0.5min", "1min", "90min", "2h", "0.25h", "24h", "48h", "100ms", "1.5s",
        "1500us", "500us", "2000ns", "3ns", "60s", "3600s", "86400s", "1000000us", " 5 s"])
    def test_parse_time_bin_to_value_unit(self, ping_time_bin):
        assert tu.parse_time_bin_to_value_unit(ping_time_bin) == \
            ju.parse_time_bin_to_value_unit(ping_time_bin)

    @pytest.mark.parametrize("x_bin, label", [("10m", "range_bin"), (" 2.5 M", "range_bin"),
                                              ("0.5nmi", "dist_bin"), ("2 NMI", "dist_bin")])
    def test_parse_x_bin(self, x_bin, label):
        assert tu._parse_x_bin(x_bin, label) == ju._parse_x_bin(x_bin, label)

    @pytest.mark.parametrize("x_bin, label, exc", [("0.5nmi", "range_bin", ValueError),
                                                   ("10m", "dist_bin", ValueError),
                                                   (10, "range_bin", TypeError),
                                                   ("10m", "time_bin", KeyError)])
    def test_parse_x_bin_errors(self, x_bin, label, exc):
        for fn in (tu._parse_x_bin, ju._parse_x_bin):
            with pytest.raises(exc):
                fn(x_bin, label)

    def test_binned_mean_to_db_fill_semantics(self):
        rng = np.random.default_rng(8)
        sums = rng.uniform(0, 1e-6, (2, 6, 5))
        counts = rng.integers(0, 3, sums.shape).astype("f8")
        nans = rng.integers(0, 2, sums.shape).astype("f8")
        for fill in (np.nan, None, 1e-9, 0.0, -1.0):
            np.testing.assert_array_equal(tu._binned_mean_to_db(sums, counts, nans, fill),
                                          ju._binned_mean_to_db(sums, counts, nans, fill))

    def test_distance_and_positions(self):
        ds_t, ds_j = (_nasc_dataset(D, nan_positions=True) for D in (TDataset, JDataset))
        d_t, d_j = tu.get_distance_from_latlon(ds_t), ju.get_distance_from_latlon(ds_j)
        np.testing.assert_allclose(d_t, d_j, **F8_TOL)
        assert np.all(np.diff(d_t) >= 0)
        x_idx = np.arange(ds_t.sizes["ping_time"]) // 7 - 1
        got = tu.get_reduced_positions(ds_t, TDataset(coords={"x": np.arange(5)}), "x", x_idx, 5)
        want = ju.get_reduced_positions(ds_j, JDataset(coords={"x": np.arange(5)}), "x", x_idx, 5)
        for var in ("latitude", "longitude"):
            np.testing.assert_allclose(got[var].values, want[var].values, **F8_TOL)
        nan_ds = make_sv_dataset(TDataset)
        nan_ds["latitude"] = (("ping_time",), np.full(nan_ds.sizes["ping_time"], np.nan))
        with pytest.raises(ValueError, match="NaN"):
            tu.get_distance_from_latlon(nan_ds)

    def test_assign_actual_range(self):
        mvbs = et.compute_MVBS(make_sv_dataset(TDataset), device="cpu")
        assert tu.assign_actual_range(mvbs).attrs["actual_range"] == \
            ju.assign_actual_range(as_package(mvbs, JDataset)).attrs["actual_range"]


class TestBinningOps:
    """The device window partials and host helpers of ops/binning.py."""

    def _chunk(self, seed=0, C=2, P=40, R=60, W=5):
        rng = np.random.default_rng(seed)
        sv = rng.normal(-70, 10, (C, P, R)).astype("f4")
        sv[rng.random(sv.shape) < 0.05] = np.nan
        er = np.broadcast_to(np.arange(R, dtype="f4") * 0.5, (C, P, R)).copy()
        er[:, 3, 50:] = np.nan  # a ragged suffix
        x_rel = np.sort(rng.integers(-1, W + 1, P)).astype("i4")
        edges = np.arange(0, 32.0, 4.0, dtype="f4")
        return sv, er, edges, x_rel, W

    @pytest.mark.parametrize("uniform_er", [True, False])
    @pytest.mark.parametrize("skipna", [True, False])
    @pytest.mark.parametrize("closed", ["left", "right"])
    def test_binned_window_partials(self, uniform_er, skipna, closed):
        sv, er, edges, x_rel, W = self._chunk()
        if not uniform_er:
            er = er * np.float32(1.01)
        want = jb.binned_window_partials(sv, er, edges, x_rel, W, skipna=skipna, closed=closed,
                                         uniform_er=uniform_er)
        got = tb.binned_window_partials(*[torch.from_numpy(a) for a in (sv, er, edges, x_rel)],
                                        W, skipna=skipna, closed=closed, uniform_er=uniform_er)
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5, atol=1e-12)

    @pytest.mark.parametrize("uniform_er", [True, False])
    def test_binned_window_sum_raw(self, uniform_er):
        sv, er, edges, x_rel, W = self._chunk(seed=1)
        vals = np.abs(sv)
        want = jb.binned_window_sum_raw(vals, er, edges, x_rel, W, uniform_er=uniform_er)
        got = tb.binned_window_sum_raw(*[torch.from_numpy(a) for a in (vals, er, edges, x_rel)],
                                       W, uniform_er=uniform_er)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5)

    @pytest.mark.parametrize("closed", ["left", "right"])
    def test_host_helpers_identical(self, closed):
        rng = np.random.default_rng(3)
        er = np.sort(rng.uniform(0, 50, (2, 9, 30)), axis=2)
        er[0, 1, 20:] = np.nan
        edges = np.arange(0, 55, 5.0)
        for a, b in zip(tb.exact_bin_encode_np(er, edges, closed),
                        jb.exact_bin_encode_np(er, edges, closed)):
            np.testing.assert_array_equal(a, b)
        assert tb.er_is_uniform(er) == jb.er_is_uniform(er) is False
        assert tb.er_is_uniform(er[:, :1].repeat(9, 1)) is True
        vals = rng.uniform(0, 50, 40)
        np.testing.assert_array_equal(tb.bin_index_np(vals, edges, closed),
                                      jb.bin_index_np(vals, edges, closed))
        np.testing.assert_array_equal(tb.x_bounds_np(np.sort(vals), edges, closed),
                                      jb.x_bounds_np(np.sort(vals), edges, closed))
        # the device's per-sample bin ids count each ping as the host's digitize
        ridx, ok = jb.exact_bin_encode_np(er, edges, closed)[2:]
        want = np.zeros(er.shape[:2] + (len(edges) - 1,))
        for c, p in np.ndindex(*er.shape[:2]):
            want[c, p] = np.bincount(ridx[c, p][ok[c, p]], minlength=len(edges) - 1)
        got = tb._sample_bin_sums(torch.from_numpy(er), torch.from_numpy(edges), closed)(
            torch.ones(er.shape, dtype=torch.float64))
        np.testing.assert_array_equal(got.numpy(), want)

    @pytest.mark.parametrize("case, ok", [
        ("uniform", True), ("broadcast_row", True), ("signed_zero", True),
        ("last_ping_differs", False), ("nan_where_row_finite", False),
        ("finite_where_row_nan", False),
    ])
    def test_ping_invariant_row(self, case, ok):
        """Every ping equal to ping 0's row by value, NaN exactly where the
        row is NaN; a difference in the last of several blocks counts."""
        er = np.broadcast_to(np.arange(30, dtype="f4") * 0.5, (2, 600, 30)).copy()
        er[:, :, 25:] = np.nan
        if case == "broadcast_row":
            er = np.broadcast_to(er[:, :1], er.shape)
        elif case == "signed_zero":
            er[1, 300:, 0] = -0.0
        elif case == "last_ping_differs":
            er[1, 599, 3] = np.nextafter(er[1, 599, 3], np.float32(9))
        elif case == "nan_where_row_finite":
            er[0, 400, 24] = np.nan
        elif case == "finite_where_row_nan":
            er[0, 257, 26] = 13.0
        row, got = tb.ping_invariant_row(er)  # three blocks of 256 pings
        assert got is ok
        np.testing.assert_array_equal(row, er[:, 0])

    @pytest.mark.parametrize("skipna", [True, False])
    @pytest.mark.parametrize("closed", ["left", "right"])
    def test_windowed_partials_grid_np(self, closed, skipna):
        """The row route's partials are the per-sample route's on the row
        broadcast over the pings, bit for bit, over five ping chunks."""
        sv, er, edges, _, _ = self._chunk(seed=6, P=70)
        row = er[:, 0].astype("f8")
        row[:, 50:] = np.nan  # holes shared by every ping
        row[1, 17] = np.nan
        x_bounds = np.array([0, 9, 9, 30, 55, 66])
        kw = dict(skipna=skipna, closed=closed, chunk_pings=16, device="cpu")
        want = tb.windowed_partials_np(sv, np.broadcast_to(row[:, None], sv.shape), edges,
                                       x_bounds, **kw)
        for got in (tb.windowed_partials_grid_np(sv, row, edges, x_bounds, **kw),
                    tb.windowed_partials_np(sv, row[:, None], edges, x_bounds, **kw)):
            for g, w in zip(got, want):
                np.testing.assert_array_equal(g, w)
        assert want[1].sum() > 0

    @pytest.mark.parametrize("closed", ["left", "right"])
    def test_windowed_sum_raw_grid_np(self, monkeypatch, closed):
        """The row twin of the raw sums is the per-sample route on the row
        broadcast over the pings, bit for bit: NaN holes in the range row
        and in the values, pings before the first and after the last
        distance bin, an empty bin, five ping chunks; a [C, 1, R] operand to
        ``windowed_sum_raw_np`` reaches it."""
        sv, er, edges, _, _ = self._chunk(seed=7, P=70)
        vals = np.abs(sv[:, 0])  # the row's values, NaN holes of their own
        row = er[:, 0].astype("f8")
        row[:, 50:] = np.nan
        row[1, 17] = np.nan
        x_bounds = np.array([3, 9, 9, 30, 55, 66])
        kw = dict(closed=closed, device="cpu")
        want = tb.windowed_sum_raw_np(np.broadcast_to(vals[:, None], sv.shape),
                                      np.broadcast_to(row[:, None], sv.shape), edges, x_bounds,
                                      chunk_pings=16, **kw)
        rows = []
        orig = tb.windowed_sum_raw_grid_np
        monkeypatch.setattr(tb, "windowed_sum_raw_grid_np",
                            lambda v, r, *a, **k: rows.append(r) or orig(v, r, *a, **k))
        for got in (tb.windowed_sum_raw_grid_np(vals, row, edges, x_bounds, **kw),
                    tb.windowed_sum_raw_np(vals[:, None], row[:, None], edges, x_bounds, **kw)):
            assert got.dtype == np.float64 and got.shape == want.shape
            np.testing.assert_array_equal(got, want)
        assert len(rows) == 2
        np.testing.assert_array_equal(rows[1], row)
        assert (want[:, 1] == 0).all() and (want[:, 2] > 0).any()

    @pytest.mark.parametrize("uniform", [True, False])
    def test_windowed_partials_np(self, uniform):
        sv, er, edges, _, _ = self._chunk(seed=2, P=70)
        er = er.astype("f8")
        if not uniform:
            er = er * np.random.default_rng(2).uniform(0.99, 1.01, er.shape[:2])[:, :, None]
        x_bounds = np.array([0, 9, 9, 30, 55, 66])
        got = tb.windowed_partials_np(sv, er, edges, x_bounds, skipna=False, chunk_pings=16,
                                      device="cpu")
        want = jb.windowed_partials_np(sv, er, edges, x_bounds, skipna=False, chunk_pings=16)
        for g, w in zip(got, want):
            np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-12)
        got = tb.windowed_sum_raw_np(np.abs(sv), er, edges, x_bounds, chunk_pings=16,
                                     device="cpu")
        want = jb.windowed_sum_raw_np(np.abs(sv), er, edges, x_bounds, chunk_pings=16)
        np.testing.assert_allclose(got, want, rtol=1e-5)
