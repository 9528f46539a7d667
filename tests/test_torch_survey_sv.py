"""Port parity: the Sv-store survey streamers and their grid binning.

``echopype_torch`` (device="cpu": the same torch ops the card runs) against
``echopype_tpu`` on the same inputs, made from numpy seeds: each package
gets its own ``xrlite.Dataset`` built from the same arrays, or both read the
same store the port wrote.  Tolerances: MVBS within 1e-5 dB; NASC and bin
sums rtol 1e-5; counts exact and NaN masks identical; coords, ping times
and positions equal.

Two parts of the JAX survey streamers are not held as truth here.  On a
file whose range (depth) grid varies by ping, their per-ping route sums
each row by float32 prefix sums, which lose a quiet bin after loud samples,
and finds its bins by a search that a NaN before the first bin (a depth
above the surface) puts out of order.  In the port each sample adds into
the bin the host's float64 membership gives it, and these cases are held
to the JAX package's float64 ``compute_MVBS`` / ``compute_NASC`` on the
same pings instead.  And the port decides per file whether a grid is
ping-invariant, where the JAX package decides once for the survey.
"""

import numpy as np
import pytest
import torch

import echopype_torch as et
import echopype_tpu as ep
from echopype_torch.commongrid import utils as tu
from echopype_torch.ops import binning as tb
from echopype_torch.parallel import survey as ts
from echopype_torch.xrlite import Dataset as TDataset
from echopype_tpu.commongrid import utils as ju
from echopype_tpu.ops import binning as jb
from echopype_tpu.parallel import survey as js
from echopype_tpu.xrlite import Dataset as JDataset

from synth_ek60 import write_ek60_raw
from test_torch_commongrid import as_package

torch.set_num_threads(1)

MVBS_ATOL_DB = 1e-5
RTOL = 1e-5
T0 = np.datetime64("2022-06-01T00:00:00", "ns")


# ------------------------------------------------------------------ inputs
def make_sv(n_ch=2, n_ping=60, n_r=48, dr=1.0, seed=0, t0=T0, lat0=45.0, lon0=-125.0,
            depth_offset=0.0):
    """An Sv dataset of the port (tests/test_survey_nasc.py::make_sv_ds, with
    ``echo_range`` and a ``depth`` ``depth_offset`` below it)."""
    rng = np.random.default_rng(seed)
    ping_time = t0 + (np.arange(n_ping) * 1_000_000_000).astype("timedelta64[ns]")
    er = np.broadcast_to(np.arange(n_r) * dr, (n_ch, n_ping, n_r)).copy()
    dims = ("channel", "ping_time", "range_sample")
    ds = TDataset(
        {
            "Sv": (dims, rng.normal(-70, 10, (n_ch, n_ping, n_r)).astype("f4")),
            "echo_range": (dims, er),
            "depth": (dims, er + depth_offset),
            "frequency_nominal": (("channel",), 1000.0 * (1 + np.arange(n_ch))),
        },
        coords={
            "channel": np.array([f"ch{i}" for i in range(n_ch)], dtype=object),
            "ping_time": ping_time,
            "range_sample": np.arange(n_r),
        },
    )
    # ~34 m between pings at 3e-4 deg of latitude: several distance bins
    ds["latitude"] = (("ping_time",), lat0 + np.arange(n_ping) * 3e-4)
    ds["longitude"] = (("ping_time",), np.full(n_ping, lon0))
    return ds


def wobble(ds, var, seed, lo=0.97, hi=1.03):
    """Scale ``var`` by a factor per (channel, ping): a grid that varies by ping."""
    a = np.asarray(ds[var].values)
    f = np.random.default_rng(seed).uniform(lo, hi, a.shape[:2])[:, :, None]
    ds[var] = (ds[var].dims, a * f)
    return ds


def holes(ds, var, pings):
    """NaN the far half of ``var`` on some pings (a ping-invariant grid with
    per-ping holes: the grid route's fall-back)."""
    a = np.asarray(ds[var].values).copy()
    a[:, pings, a.shape[2] // 2:] = np.nan
    ds[var] = (ds[var].dims, a)
    return ds


def concat(dss):
    """One port Dataset holding the pings of ``dss`` (same channels and
    sample counts), for the float64 compute_* oracles."""
    first = dss[0]
    out = TDataset(coords={"channel": first.coords["channel"].values,
                           "ping_time": np.concatenate([d.coords["ping_time"].values for d in dss]),
                           "range_sample": first.coords["range_sample"].values},
                   attrs={"processing_level": "Level 2A"})
    for name in ("Sv", "echo_range", "depth", "latitude", "longitude"):
        if name in first:
            axis = first[name].dims.index("ping_time")
            out[name] = (first[name].dims,
                         np.concatenate([np.asarray(d[name].values) for d in dss], axis=axis))
    return out


def survey_distance(dss):
    """The survey streamers' cumulative distance: each file's own, continued
    from the last file's end across the geodesic gap between fixes (JAX
    package functions)."""
    from echopype_tpu.utils.geodesy import pairwise_distance_nmi

    out, offset, prev = [], 0.0, None
    for ds in dss:
        lat, lon = (np.asarray(ds[v].values, dtype="f8") for v in ("latitude", "longitude"))
        if prev is not None:
            offset += float(pairwise_distance_nmi(np.array([prev[0], lat[0]]),
                                                  np.array([prev[1], lon[0]]))[0])
        out.append(ju.get_distance_from_latlon(as_package(ds, JDataset)) + offset)
        offset, prev = float(out[-1][-1]), (lat[-1], lon[-1])
    return np.concatenate(out)


@pytest.fixture(scope="module")
def ek60_sv(tmp_path_factory):
    """Three synthetic EK60 files 40 s apart through the port's open_raw ->
    compute_Sv -> add_depth (Platform offsets) -> add_location, each also
    written to a store with the port's writer.  File 2's sound speed varies
    by ping, so its range and depth grids do too."""
    d = tmp_path_factory.mktemp("survey_sv")
    out = []
    for i in range(3):
        raw = d / f"S{i}-D20200101-T000000.raw"
        write_ek60_raw(raw, n_pings=25, n_samples=120, with_angle=False, seed=i,
                       t0=np.datetime64("2020-01-01T00:00:00", "ns") + np.timedelta64(40 * i, "s"),
                       jitter_raw0=i == 2)
        ed = et.open_raw(raw, sonar_model="EK60")
        ds = et.calibrate.compute_Sv(ed, device="cpu")
        ds = et.consolidate.add_depth(ds, echodata=ed, use_platform_vertical_offsets=True)
        ds = et.consolidate.add_location(ds, ed)
        store = d / f"S{i}_Sv.zarr"
        ds.to_zarr(store)
        out.append((ds, str(store)))
    return out


def assert_mvbs(got, want, atol=MVBS_ATOL_DB, range_var="echo_range"):
    for k in ("channel", "ping_time", range_var):
        np.testing.assert_array_equal(np.asarray(got.coords[k].values),
                                      np.asarray(want.coords[k].values))
    g, w = np.asarray(got["Sv"].values), np.asarray(want["Sv"].values)
    np.testing.assert_array_equal(np.isnan(g), np.isnan(w))
    np.testing.assert_allclose(g, w, rtol=0, atol=atol, equal_nan=True)
    assert np.isfinite(g).any()


def assert_nasc(got, want, dims=("distance", "depth")):
    for k in ("channel", *dims):
        np.testing.assert_array_equal(np.asarray(got.coords[k].values),
                                      np.asarray(want.coords[k].values))
    g, w = np.asarray(got["NASC"].values), np.asarray(want["NASC"].values)
    np.testing.assert_array_equal(np.isnan(g), np.isnan(w))
    np.testing.assert_allclose(g, w, rtol=RTOL, atol=0, equal_nan=True)
    assert np.isfinite(g).any()
    np.testing.assert_array_equal(np.asarray(got["ping_time"].values),
                                  np.asarray(want["ping_time"].values))


# ------------------------------------------------------------- grid binning
class TestGridBinning:
    def _chunk(self, seed=0, C=2, P=40, R=60, W=5, pad=0):
        rng = np.random.default_rng(seed)
        sv = rng.normal(-70, 10, (C, P, R)).astype("f4")
        sv[rng.random(sv.shape) < 0.05] = np.nan
        row = (np.arange(R, dtype="f4") * 0.5)[None].repeat(C, 0)
        row[1, 50:] = np.nan  # a channel's grid ends early
        x_rel = np.sort(rng.integers(-1, W, P)).astype("i4")
        if pad:  # padded pings: NaN data parked past the window
            sv[:, -pad:] = np.nan
            x_rel[-pad:] = W
        return sv, row, np.arange(0, 32.0, 4.0, dtype="f4"), x_rel, W

    @pytest.mark.parametrize("skipna", [True, False])
    @pytest.mark.parametrize("closed", ["left", "right"])
    @pytest.mark.parametrize("pad", [0, 6])
    def test_partials_grid_matches_jax(self, skipna, closed, pad):
        sv, row, edges, x_rel, W = self._chunk(pad=pad)
        want = jb.binned_window_partials_grid(sv, row, edges, x_rel, W, skipna=skipna,
                                              closed=closed)
        got = tb.binned_window_partials_grid(
            *[torch.from_numpy(a) for a in (sv, row, edges, x_rel)], W, skipna=skipna,
            closed=closed)
        np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), rtol=RTOL, atol=1e-30)
        for g, w in zip(got[1:], want[1:]):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))

    @pytest.mark.parametrize("closed", ["left", "right"])
    @pytest.mark.parametrize("pad", [0, 6])
    def test_row_sum_matches_jax(self, closed, pad):
        _, row, edges, x_rel, W = self._chunk(seed=1, pad=pad)
        vals = np.abs(np.random.default_rng(1).normal(0.5, 0.1, row.shape)).astype("f4")
        vals[0, 7] = np.nan
        want = jb.binned_window_row_sum(vals, row, edges, x_rel, W, closed=closed)
        got = tb.binned_window_row_sum(
            *[torch.from_numpy(a) for a in (vals, row, edges, x_rel)], W, closed=closed)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=0)
        # padded pings parked at id >= W count in no bin
        counts = np.bincount(x_rel[(x_rel >= 0) & (x_rel < W)], minlength=W)
        s_row = got.numpy()[:, np.argmax(counts)] / counts.max()
        np.testing.assert_allclose(got.numpy(), s_row[:, None] * counts[None, :, None],
                                   rtol=RTOL)

    @pytest.mark.parametrize("skipna", [True, False])
    def test_grid_equals_broadcast_row(self, skipna):
        sv, row, edges, x_rel, W = self._chunk(seed=2, pad=3)
        er = np.broadcast_to(row[:, None], sv.shape).copy()
        t = [torch.from_numpy(a) for a in (sv, row, er, edges, x_rel)]
        got = tb.binned_window_partials_grid(t[0], t[1], t[3], t[4], W, skipna=skipna)
        want = tb.binned_window_partials(t[0], t[2], t[3], t[4], W, skipna=skipna,
                                         uniform_er=True)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), w.numpy())


class TestRowsBinning:
    """The per-ping route for grids that vary by ping (``binned_window_partials``
    without ``uniform_er``): each sample adds into the bin the host's float64
    membership gives it."""

    def _chunk(self, seed=3, C=2, P=30, R=80, quiet_after_loud=False, hole=True):
        rng = np.random.default_rng(seed)
        sv = rng.normal(-70, 10, (C, P, R)).astype("f4")
        if quiet_after_loud:
            sv[:, :, :20] = 20.0  # loud samples before the first bins
            sv[:, :, 20:] = -150.0 + rng.normal(0, 1, (C, P, R - 20)).astype("f4")
        sv[rng.random(sv.shape) < 0.03] = np.nan
        er = (np.arange(R) * 0.5)[None, None] * rng.uniform(0.97, 1.03, (C, P, 1)) - 3.0
        er[0, 4, 60:] = np.nan  # a short ping
        if hole:
            er[1, 7, 30:35] = np.nan
        x_rel = np.sort(rng.integers(0, 6, P)).astype("i4")
        x_rel[-3:] = 6  # parked past the window
        return sv, er, np.arange(0, 40.0, 4.0), x_rel, 6

    @staticmethod
    def _f64_oracle(values, er, edges, x_rel, W, skipna=True, lin_domain=True, closed="left"):
        """The JAX package's float64 host accumulation on the same membership."""
        _, _, ridx, ok = jb.exact_bin_encode_np(er, edges, closed)
        x_bounds = np.searchsorted(x_rel, np.arange(W + 1), side="left")
        return jb._host_exact_partials_np(values, ridx, ok, len(edges) - 1, x_bounds, skipna,
                                          lin_domain=lin_domain)

    @staticmethod
    def _rows(sv, er, edges, x_rel, W, closed="left", **kw):
        enc, enc_edges = tb.exact_bin_encode_np(er, edges, closed)[:2]
        return tb.binned_window_partials(
            *[torch.from_numpy(a) for a in (sv, enc, enc_edges, x_rel)], W, **kw)

    @pytest.mark.parametrize("skipna", [True, False])
    @pytest.mark.parametrize("closed", ["left", "right"])
    @pytest.mark.parametrize("quiet_after_loud", [False, True])
    def test_partials_rows_match_f64_oracle(self, skipna, closed, quiet_after_loud):
        sv, er, edges, x_rel, W = self._chunk(quiet_after_loud=quiet_after_loud)
        got = self._rows(sv, er, edges, x_rel, W, closed=closed, skipna=skipna)
        want = self._f64_oracle(sv, er, edges, x_rel, W, skipna=skipna, closed=closed)
        np.testing.assert_allclose(got[0].numpy(), want[0], rtol=RTOL, atol=0)
        for g, w in zip(got[1:], want[1:]):
            np.testing.assert_array_equal(g.numpy(), w)
        assert want[1].sum() > 0

    def test_partials_rows_any_sample_order(self):
        """Rows whose range decreases, or comes in no order, bin as the
        float64 oracle bins them (no run along the row is assumed)."""
        sv, er, edges, x_rel, W = self._chunk(seed=6)
        er[0] = er[0, :, ::-1]
        perm = np.random.default_rng(6).permutation(er.shape[2])
        er[1], sv[1] = er[1][:, perm], sv[1][:, perm]
        got = self._rows(sv, er, edges, x_rel, W, skipna=False)
        want = self._f64_oracle(sv, er, edges, x_rel, W, skipna=False)
        np.testing.assert_allclose(got[0].numpy(), want[0], rtol=RTOL, atol=0)
        for g, w in zip(got[1:], want[1:]):
            np.testing.assert_array_equal(g.numpy(), w)

    def test_partials_rows_match_jax_where_jax_holds(self):
        """On rows with no NaN before the first bin or between bins, and no
        quiet bin after loud samples, the JAX package's per-ping route agrees."""
        sv, er, edges, x_rel, W = self._chunk(seed=4, hole=False)
        er = er + 3.0  # no sample above the first edge
        enc = tb.exact_bin_encode_np(er, edges)[0]
        got = self._rows(sv, er, edges, x_rel, W, skipna=False)
        want = jb.binned_window_partials(sv, enc, np.arange(len(edges), dtype="f4"), x_rel, W,
                                         skipna=False, uniform_er=False)
        np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), rtol=RTOL, atol=0)
        for g, w in zip(got[1:], want[1:]):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))

    def test_sum_raw_rows_match_f64_oracle(self):
        _, er, edges, x_rel, W = self._chunk(seed=5)
        ddep = np.diff(er, axis=2).astype("f4")
        enc, enc_edges = tb.exact_bin_encode_np(er[:, :, :-1], edges)[:2]
        got = tb.binned_window_sum_raw(
            *[torch.from_numpy(a) for a in (ddep, enc, enc_edges, x_rel)], W)
        want = self._f64_oracle(ddep, er[:, :, :-1], edges, x_rel, W, lin_domain=False)[0]
        np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=1e-12)


# ----------------------------------------------------------- run_survey_mvbs
class TestRunSurveyMVBS:
    KW = dict(range_bin="5m", ping_time_bin="10s")

    @pytest.mark.parametrize("kind", ["stores", "datasets", "callables"])
    def test_matches_jax(self, ek60_sv, kind):
        files = ek60_sv[:2]
        if kind == "stores":
            t_src = j_src = [store for _, store in files]
        elif kind == "datasets":
            t_src = [ds for ds, _ in files]
            j_src = [as_package(ds, JDataset) for ds, _ in files]
        else:
            t_src = [lambda ds=ds: ds for ds, _ in files]
            j_src = [lambda ds=ds: as_package(ds, JDataset) for ds, _ in files]
        got = et.run_survey_mvbs(t_src, chunk_pings=10, device="cpu", **self.KW)
        want = js.run_survey_mvbs(j_src, chunk_pings=10, **self.KW)
        assert_mvbs(got, want)
        assert got.attrs["routes"] == ["grid", "grid"] and got.attrs["device"] == "cpu"

    @pytest.mark.parametrize("chunk_pings", [1, 7, 25, 1000])
    def test_chunk_invariance(self, ek60_sv, chunk_pings):
        stores = [store for _, store in ek60_sv[:2]]
        got = et.run_survey_mvbs(stores, chunk_pings=chunk_pings, device="cpu", **self.KW)
        want = js.run_survey_mvbs(stores, chunk_pings=13, **self.KW)
        assert_mvbs(got, want)

    def test_per_ping_holes_fall_back(self):
        """A file whose NaN holes differ by ping takes the per-ping route in
        the same survey as a file on the grid route."""
        a = make_sv(seed=1, dr=0.5)
        b = holes(make_sv(seed=2, dr=0.5, t0=T0 + np.timedelta64(70, "s")), "echo_range",
                  [3, 17, 40])
        kw = dict(range_bin="4m", ping_time_bin="20s", chunk_pings=16)
        got = et.run_survey_mvbs([a, b], device="cpu", **kw)
        want = js.run_survey_mvbs([as_package(d, JDataset) for d in (a, b)], **kw)
        assert got.attrs["routes"] == ["grid", "per_ping"]
        assert_mvbs(got, want)

    def test_ping_varying_grid_against_f64_compute_mvbs(self, ek60_sv):
        """A survey of a file on a ping-invariant grid and one whose grid
        varies by ping equals the JAX package's float64 compute_MVBS on the
        same pings."""
        dss = [ds for ds, _ in ek60_sv]
        got = et.run_survey_mvbs(dss, chunk_pings=9, device="cpu", **self.KW)
        want = ep.commongrid.compute_MVBS(as_package(concat(dss), JDataset), **self.KW)
        assert got.attrs["routes"] == ["grid", "grid", "per_ping"]
        assert_mvbs(got, want)

    def test_ping_varying_grids_against_f64_compute_mvbs(self):
        """Two files whose grids vary by ping: the port holds the float64
        compute_MVBS to 1e-5 dB (the JAX streamers do not here, see
        test_jax_streamer_faults_pinned)."""
        dss = [wobble(make_sv(seed=s, dr=0.5, t0=T0 + np.timedelta64(70 * s, "s")),
                      "echo_range", s) for s in range(2)]
        kw = dict(range_bin="4m", ping_time_bin="20s")
        got = et.run_survey_mvbs(dss, chunk_pings=16, device="cpu", **kw)
        assert got.attrs["routes"] == ["per_ping", "per_ping"]
        assert_mvbs(got, ep.commongrid.compute_MVBS(as_package(concat(dss), JDataset), **kw))

    def test_jax_streamer_faults_pinned(self, ek60_sv):
        """The JAX streamers' per-ping route on ping-varying grids (ROADMAP
        Queue 3), pinned so that a change in either package is seen: its
        float32 prefix sums miss the last, partial range bin by over 1e-3 dB,
        and its bin 0 takes samples from above the surface (NASC more than 10%
        high); the port's route holds the float64 oracles."""
        dss = [wobble(make_sv(seed=s, dr=0.5, t0=T0 + np.timedelta64(70 * s, "s")),
                      "echo_range", s) for s in range(2)]
        kw = dict(range_bin="4m", ping_time_bin="20s")
        want = np.asarray(ep.commongrid.compute_MVBS(as_package(concat(dss), JDataset),
                                                     **kw)["Sv"].values)
        jax = js.run_survey_mvbs([as_package(d, JDataset) for d in dss], chunk_pings=16, **kw)
        port = et.run_survey_mvbs(dss, chunk_pings=16, device="cpu", **kw)
        assert np.nanmax(np.abs(np.asarray(jax["Sv"].values) - want)) > 1e-3
        assert np.nanmax(np.abs(np.asarray(port["Sv"].values) - want)) < MVBS_ATOL_DB

        ds = ek60_sv[2][0]
        kw = dict(range_bin="5m", dist_bin="2nmi")
        want = np.asarray(ep.commongrid.compute_NASC(as_package(ds, JDataset), **kw)["NASC"].values)
        jax = np.asarray(js.run_survey_nasc([as_package(ds, JDataset)], **kw)["NASC"].values)
        port = np.asarray(et.run_survey_nasc([ds], device="cpu", **kw)["NASC"].values)
        assert np.nanmax(jax[:, :, 0] / want[:, :, 0]) > 1.1
        np.testing.assert_allclose(port, want, rtol=RTOL)

    def test_range_var_depth(self, ek60_sv):
        dss = [ds for ds, _ in ek60_sv[:2]]
        kw = dict(range_var="depth", chunk_pings=10, **self.KW)
        got = et.run_survey_mvbs(dss, device="cpu", **kw)
        want = js.run_survey_mvbs([as_package(d, JDataset) for d in dss], **kw)
        assert_mvbs(got, want, range_var="depth")

    @pytest.mark.parametrize("spelling", [dict(range_bin="5m"), dict(range_bin=5.0),
                                          dict(range_bin_m=5.0), dict(range_bin="1m",
                                                                      range_bin_m=5.0)])
    def test_range_bin_spellings(self, ek60_sv, spelling):
        ds = ek60_sv[0][0]
        got = et.run_survey_mvbs([ds], ping_time_bin="10s", device="cpu", **spelling)
        want = js.run_survey_mvbs([as_package(ds, JDataset)], ping_time_bin="10s", **spelling)
        assert_mvbs(got, want)
        np.testing.assert_array_equal(np.diff(got.coords["echo_range"].values[:2]), [5.0])

    def test_channel_mismatch_rejected(self, ek60_sv):
        ds = ek60_sv[0][0]
        with pytest.raises(ValueError, match="same channels"):
            et.run_survey_mvbs([ds, ds.isel(channel=[0])], device="cpu")
        with pytest.raises(ValueError, match="same channels"):
            et.run_survey_nasc([ds, ds.isel(channel=[0])], device="cpu")

    def test_reversed_ping_time_rejected(self, ek60_sv):
        ds = ek60_sv[0][0]
        pt = np.asarray(ds.coords["ping_time"].values).copy()
        pt[2], pt[3] = pt[3], pt[2]
        with pytest.raises(ValueError, match="coerce_increasing_time"):
            et.run_survey_mvbs([ds.assign_coords(ping_time=pt)], ping_time_bin="2s",
                               device="cpu")

    def test_no_sources_rejected(self):
        for fn in (et.run_survey_mvbs, et.run_survey_nasc):
            with pytest.raises(ValueError, match="no Sv sources"):
                fn([], device="cpu")

    def test_reopen_rule(self, ek60_sv):
        """As in the JAX package: paths re-open by default, a callable is
        invoked once unless reopen=True asks for twice."""
        ds = ek60_sv[0][0]
        calls = []

        def provider():
            calls.append(1)
            return ds

        a = et.run_survey_mvbs([provider], device="cpu", **self.KW)
        assert len(calls) == 1
        b = et.run_survey_mvbs([provider], reopen=True, device="cpu", **self.KW)
        assert len(calls) == 3
        np.testing.assert_array_equal(a["Sv"].values, b["Sv"].values)
        assert ts._sv_providers([ek60_sv[0][1]], None)[1] is True
        assert ts._sv_providers([ek60_sv[0][1], ds], None)[1] is False

    @pytest.mark.parametrize("option, item", [("mesh", "item 10"), ("freq_diff", "item 7"),
                                              ("noise_masks", "item 8")])
    def test_unported_options_raise(self, ek60_sv, option, item):
        """``mesh`` (ROADMAP Queue 1 item 10) raises; ``freq_diff`` and
        ``noise_masks`` (items 7 and 8) are ported and refuse a value of
        another type."""
        err, match = (NotImplementedError, item) if option == "mesh" else (TypeError, option)
        with pytest.raises(err, match=match):
            et.run_survey_mvbs([ek60_sv[0][0]], device="cpu", **{option: object()})


# ----------------------------------------------------------- run_survey_nasc
class TestRunSurveyNASC:
    KW = dict(range_bin="10m", dist_bin="0.1nmi")

    def _both(self, dss, **kw):
        got = et.run_survey_nasc(dss, device="cpu", **{**self.KW, **kw})
        want = js.run_survey_nasc([as_package(d, JDataset) for d in dss], **{**self.KW, **kw})
        return got, want

    def test_single_file_matches_jax_and_compute_nasc(self):
        ds = make_sv()
        got, want = self._both([ds], chunk_pings=17)
        assert_nasc(got, want)
        assert got.attrs["routes"] == ["grid"]
        assert got.attrs["processing_function"] == "parallel.run_survey_nasc"
        assert_nasc(got, ep.commongrid.compute_NASC(as_package(ds, JDataset), **self.KW))
        for var in ("latitude", "longitude"):
            np.testing.assert_allclose(got[var].values, want[var].values, rtol=1e-12)

    def test_multi_file_continues_distance(self):
        ds1 = make_sv(seed=1)
        ds2 = make_sv(seed=2, t0=T0 + np.timedelta64(120, "s"), lat0=45.0 + 61 * 3e-4)
        got, want = self._both([ds1, ds2], chunk_pings=23)
        assert_nasc(got, want)
        d1 = et.run_survey_nasc([ds1], device="cpu", **self.KW)
        assert got["NASC"].shape[1] > d1["NASC"].shape[1]
        assert np.isfinite(got["NASC"].values[:, d1["NASC"].shape[1]:]).any()

    @pytest.mark.parametrize("chunk_pings", [1, 7, 53])
    def test_chunk_invariance(self, chunk_pings):
        ds = make_sv(n_ping=53, seed=7)
        got = et.run_survey_nasc([ds], chunk_pings=chunk_pings, device="cpu", **self.KW)
        want = js.run_survey_nasc([as_package(ds, JDataset)], chunk_pings=53, **self.KW)
        assert_nasc(got, want)

    def test_skipna_false(self):
        ds = make_sv(seed=3)
        ds.data_vars["Sv"].values[1, 4, 7] = np.nan
        ds.data_vars["Sv"].values[0, 20, :] = np.nan
        got, want = self._both([ds], skipna=False, chunk_pings=11)
        assert_nasc(got, want)
        assert np.isnan(got["NASC"].values).any()

    def test_closed_right(self):
        got, want = self._both([make_sv(seed=4, dr=2.5)], closed="right", chunk_pings=9)
        assert_nasc(got, want)

    def test_upward_looking(self):
        """depth decreasing along range: the range axis flips, and depths
        above the surface join no bin."""
        dss = []
        for s in range(2):
            ds = make_sv(seed=5 + s, t0=T0 + np.timedelta64(70 * s, "s"),
                         lat0=45.0 + 70 * s * 3e-4)
            ds["depth"] = (ds["depth"].dims, 40.0 - np.asarray(ds["echo_range"].values))
            dss.append(ds)
        got, want = self._both(dss, chunk_pings=16)
        assert_nasc(got, want)
        assert got.attrs["routes"] == ["grid", "grid"]

    def test_nan_positions(self):
        ds = make_sv(seed=8)
        lat = np.asarray(ds["latitude"].values).copy()
        lat[[0, 5, 6, 59]] = np.nan
        ds["latitude"] = (("ping_time",), lat)
        ds2 = make_sv(seed=9, t0=T0 + np.timedelta64(70, "s"), lat0=45.0 + 70 * 3e-4)
        got, want = self._both([ds, ds2], chunk_pings=20)
        assert_nasc(got, want)
        for var in ("latitude", "longitude"):
            np.testing.assert_allclose(got[var].values, want[var].values, rtol=1e-12)

    def test_per_ping_holes_fall_back(self):
        a = make_sv(seed=10)
        b = holes(make_sv(seed=11, t0=T0 + np.timedelta64(70, "s"), lat0=45.0 + 70 * 3e-4),
                  "depth", [2, 30])
        got, want = self._both([a, b], chunk_pings=16)
        assert got.attrs["routes"] == ["grid", "per_ping"]
        assert_nasc(got, want)

    @pytest.mark.parametrize("files", [[2], [0, 2, 1]])
    def test_ping_varying_depth_against_f64_oracle(self, ek60_sv, files):
        """EK60 files with depths above the surface (Platform offsets), file 2
        on a depth grid that varies by ping, equal the JAX package's float64
        binning (compute_NASC on one file; compute_raw_NASC on the pings of
        several, at the survey's gap-linked distances)."""
        dss = [ek60_sv[i][0] for i in files]
        assert all(np.nanmin(ds["depth"].values) < 0 for ds in dss)
        kw = dict(range_bin="5m", dist_bin="2nmi")
        got = et.run_survey_nasc(dss, chunk_pings=8, device="cpu", **kw)
        assert got.attrs["routes"] == ["grid" if i < 2 else "per_ping" for i in files]
        if len(dss) == 1:
            assert_nasc(got, ep.commongrid.compute_NASC(as_package(dss[0], JDataset), **kw))
            return
        ds = as_package(concat(dss), JDataset)
        ds["distance_nmi"] = (("ping_time",), survey_distance(dss))
        want = ju.compute_raw_NASC(ds, np.append(got.coords["depth"].values,
                                                 got.coords["depth"].values[-1] + 5.0),
                                   np.append(got.coords["distance"].values,
                                             got.coords["distance"].values[-1] + 2.0))
        g, w = np.asarray(got["NASC"].values), np.asarray(want["sv"].values)
        np.testing.assert_array_equal(np.isnan(g), np.isnan(w))
        np.testing.assert_allclose(g, w, rtol=RTOL, equal_nan=True)
        np.testing.assert_array_equal(got["ping_time"].values, want["ping_time"].values)

    def test_ping_varying_depth_matches_jax_where_jax_holds(self):
        dss = [wobble(make_sv(seed=12 + s, t0=T0 + np.timedelta64(70 * s, "s"),
                              lat0=45.0 + 70 * s * 3e-4), "depth", s) for s in range(2)]
        got, want = self._both(dss, chunk_pings=16)
        assert got.attrs["routes"] == ["per_ping", "per_ping"]
        assert_nasc(got, want)

    def test_requires_depth(self):
        ds = make_sv()
        del ds.data_vars["depth"]
        with pytest.raises(ValueError, match="depth"):
            et.run_survey_nasc([ds], device="cpu")

    @pytest.mark.parametrize("option, item", [("mesh", "item 10"), ("noise_masks", "item 8")])
    def test_unported_options_raise(self, option, item):
        """``mesh`` (item 10) raises; ``noise_masks`` (item 8) is ported and
        refuses a value of another type."""
        err, match = (NotImplementedError, item) if option == "mesh" else (TypeError, option)
        with pytest.raises(err, match=match):
            et.run_survey_nasc([make_sv()], device="cpu", **{option: object()})


# --------------------------------------------------- compute_raw_MVBS / NASC
class _Intervals:
    """An interval index as pandas builds it: .left, .right, .closed."""

    def __init__(self, edges, closed):
        self.left, self.right, self.closed = edges[:-1], edges[1:], closed


class TestComputeRaw:
    @pytest.mark.parametrize("form", ["edges", "pandas_left", "pandas_right"])
    def test_raw_mvbs_matches_jax(self, form):
        pd = pytest.importorskip("pandas")
        ds = holes(make_sv(seed=13, dr=0.5), "echo_range", [4])
        r_edges = np.arange(0, 30.0, 4.0)
        p_edges = T0 + np.arange(0, 70, 20).astype("timedelta64[s]")
        if form == "edges":
            r_int = p_int = None
            t_args = j_args = (r_edges, p_edges)
        else:
            closed = form.split("_")[1]
            r_int = pd.IntervalIndex.from_breaks(r_edges, closed=closed)
            p_int = pd.IntervalIndex.from_breaks(pd.DatetimeIndex(p_edges), closed=closed)
            t_args = j_args = (r_int, p_int)
        got = tu.compute_raw_MVBS(ds, *t_args, device="cpu")
        want = ju.compute_raw_MVBS(as_package(ds, JDataset), *j_args)
        assert got.attrs["device"] == "cpu"
        for k in ("channel", "ping_time_bins", "echo_range_bins"):
            np.testing.assert_array_equal(got.coords[k].values, want.coords[k].values)
        g, w = np.asarray(got["Sv"].values), np.asarray(want["Sv"].values)
        np.testing.assert_array_equal(np.isnan(g), np.isnan(w))
        np.testing.assert_allclose(g, w, rtol=0, atol=MVBS_ATOL_DB, equal_nan=True)

    @pytest.mark.parametrize("form", ["edges", "pandas_left", "pandas_right"])
    def test_raw_nasc_matches_jax(self, form):
        pd = pytest.importorskip("pandas")
        ds = make_sv(seed=14)
        ds["distance_nmi"] = (("ping_time",), tu.get_distance_from_latlon(ds))
        d_edges, x_edges = np.arange(0, 50.0, 10.0), np.arange(0, 1.2, 0.1)
        if form == "edges":
            args = (d_edges, x_edges)
        else:
            closed = form.split("_")[1]
            args = (pd.IntervalIndex.from_breaks(d_edges, closed=closed),
                    pd.IntervalIndex.from_breaks(x_edges, closed=closed))
        got = tu.compute_raw_NASC(ds, *args, device="cpu")
        want = ju.compute_raw_NASC(as_package(ds, JDataset), *args)
        assert got.attrs["device"] == "cpu"
        for k in ("channel", "distance_nmi_bins", "depth_bins"):
            np.testing.assert_array_equal(got.coords[k].values, want.coords[k].values)
        g, w = np.asarray(got["sv"].values), np.asarray(want["sv"].values)
        np.testing.assert_array_equal(np.isnan(g), np.isnan(w))
        np.testing.assert_allclose(g, w, rtol=RTOL, equal_nan=True)
        np.testing.assert_array_equal(got["ping_time"].values, want["ping_time"].values)

    @pytest.mark.parametrize("upward", [False, True])
    def test_raw_on_ping_varying_grids(self, upward):
        """A grid that varies by ping bins on the device in float64, in any
        sample order: equal to the JAX package's float64 host accumulation."""
        ds = wobble(wobble(make_sv(seed=15, dr=0.5), "echo_range", 15), "depth", 16)
        if upward:
            for var in ("echo_range", "depth"):
                ds[var] = (ds[var].dims, np.asarray(ds[var].values)[:, :, ::-1].copy())
        ds["distance_nmi"] = (("ping_time",), tu.get_distance_from_latlon(ds))
        r_edges = np.arange(0, 30.0, 4.0)
        p_edges = T0 + np.arange(0, 70, 20).astype("timedelta64[s]")
        x_edges = np.arange(0, 1.2, 0.1)
        got = tu.compute_raw_MVBS(ds, r_edges, p_edges, device="cpu")
        want = ju.compute_raw_MVBS(as_package(ds, JDataset), r_edges, p_edges)
        g, w = np.asarray(got["Sv"].values), np.asarray(want["Sv"].values)
        np.testing.assert_array_equal(np.isnan(g), np.isnan(w))
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-9, equal_nan=True)
        assert np.isfinite(g).any()
        got = tu.compute_raw_NASC(ds, r_edges, x_edges, device="cpu")
        want = ju.compute_raw_NASC(as_package(ds, JDataset), r_edges, x_edges)
        g, w = np.asarray(got["sv"].values), np.asarray(want["sv"].values)
        np.testing.assert_array_equal(np.isnan(g), np.isnan(w))
        np.testing.assert_allclose(g, w, rtol=1e-9, equal_nan=True)
        assert np.isfinite(g).any()

    def test_interval_edges_duck_typed(self):
        edges = np.arange(0, 10.0, 2.0)
        got, closed = tu._interval_edges(_Intervals(edges, "right"))
        np.testing.assert_array_equal(got, edges)
        assert closed == "right"
        assert tu._interval_edges(_Intervals(edges, "both"))[1] == "left"
        assert tu._interval_edges(edges)[1] == "left"


# -------------------------------------------------------------- no CUDA here
@pytest.mark.parametrize("entry", ["run_survey_mvbs", "run_survey_nasc", "compute_raw_MVBS",
                                   "compute_raw_NASC"])
def test_cuda_request_without_cuda_raises(entry):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; this checks the no-fallback rule")
    ds = make_sv()
    ds["distance_nmi"] = (("ping_time",), tu.get_distance_from_latlon(ds))
    calls = {
        "run_survey_mvbs": lambda: et.run_survey_mvbs([ds]),
        "run_survey_nasc": lambda: et.run_survey_nasc([ds]),
        "compute_raw_MVBS": lambda: tu.compute_raw_MVBS(
            ds, np.arange(0, 40.0, 5.0), T0 + np.arange(0, 70, 20).astype("timedelta64[s]")),
        "compute_raw_NASC": lambda: tu.compute_raw_NASC(
            ds, np.arange(0, 40.0, 5.0), np.arange(0, 1.0, 0.1)),
    }
    with pytest.raises(RuntimeError, match="(?i)cuda"):
        calls[entry]()
