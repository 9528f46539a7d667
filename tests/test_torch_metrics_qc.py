"""Port parity: ``metrics``, ``qc`` and ``colormap``.

The cases of tests/test_metrics_qc.py through both packages on the same
inputs (numpy, from a seed): the five echo metrics on synthetic Sv
datasets, ``exist_reversed_time`` / ``coerce_increasing_time`` on time axes
with reversals, and ``orchestrate_reverse_time_check`` on converted and
combined EK60 files, in memory and with ``zarr_store=`` (the repaired times
and the Provenance records written into an existing store).  Every result,
tree and store equals the JAX package's bit for bit; the provenance clock is
pinned in both packages.  The EK500 colormap equals the JAX package's.
"""

import numpy as np
import pytest

import echopype_torch as et
import echopype_torch.xrlite as tx
import echopype_tpu as ep
import echopype_tpu.xrlite as jx
from echopype_torch.utils import prov as t_prov
from echopype_tpu.utils import prov as j_prov

from synth_ek60 import write_ek60_raw
from test_torch_convert import assert_same_tree
from test_torch_datatree import assert_same_store

METRICS = ("abundance", "center_of_mass", "dispersion", "evenness", "aggregation")
T0 = np.datetime64("2020-01-01T00:00:00", "ns")


@pytest.fixture(autouse=True)
def fixed_clock(monkeypatch):
    for mod in (t_prov, j_prov):
        monkeypatch.setattr(mod, "_utcnow_str", lambda: "2024-01-01T00:00:00Z")


def make_sv(xr, sv_db, dr=0.5, er=None):
    """tests/test_metrics_qc.py:10-25 with ``xr``'s classes; sv_db [C, P, R]."""
    sv_db = np.asarray(sv_db, dtype="f8")
    n_ch, n_ping, n_r = sv_db.shape
    if er is None:
        er = np.broadcast_to(np.arange(n_r) * dr, sv_db.shape).copy()
    return xr.Dataset(
        {"Sv": (("channel", "ping_time", "range_sample"), sv_db),
         "echo_range": (("channel", "ping_time", "range_sample"), er)},
        coords={"channel": np.array([f"ch{i}" for i in range(n_ch)], dtype=object),
                "ping_time": T0 + np.arange(n_ping) * np.timedelta64(1, "s"),
                "range_sample": np.arange(n_r)},
    )


def _sv_case(kind):
    rng = np.random.default_rng(7)
    if kind == "uniform":
        return np.full((1, 3, 101), -60.0), None
    if kind == "peaked":
        sv = np.full((1, 2, 50), -90.0)
        sv[0, :, 30] = -30.0
        return sv, None
    sv = rng.normal(-70.0, 10.0, (2, 6, 80))  # "noisy": NaN tails, a range that varies by ping
    sv[0, 3, 60:] = np.nan
    sv[1, 0, :5] = np.nan
    er = np.arange(80) * 0.19 + rng.uniform(0, 0.05, (2, 6, 1))
    er[:, 2, 40] = er[:, 2, 39]  # a zero step: dz turns NaN
    return sv, er


def _same(g, w):
    assert g.dims == w.dims and g.name == w.name
    gv, wv = np.asarray(g.values), np.asarray(w.values)
    assert gv.dtype == wv.dtype
    np.testing.assert_array_equal(gv.view(np.uint8), wv.view(np.uint8))


@pytest.mark.parametrize("kind", ["uniform", "peaked", "noisy"])
@pytest.mark.parametrize("metric", METRICS)
def test_metrics_match_jax(metric, kind):
    sv, er = _sv_case(kind)
    got = getattr(et.metrics, metric)(make_sv(tx, sv, er=er))
    want = getattr(ep.metrics, metric)(make_sv(jx, sv, er=er))
    _same(got, want)
    assert np.isfinite(np.asarray(got.values)).any()


def test_metrics_analytic():
    """Uniform sv over H meters (tests/test_metrics_qc.py:30-60)."""
    n_r, dr = 101, 0.5
    ds = make_sv(tx, np.full((1, 2, n_r), -60.0), dr=dr)
    H, z = (n_r - 1) * dr, np.arange(1, n_r) * dr
    np.testing.assert_allclose(et.metrics.abundance(ds).values, -60.0 + 10 * np.log10(H),
                               atol=1e-9)
    np.testing.assert_allclose(et.metrics.center_of_mass(ds).values, z.mean(), atol=1e-9)
    np.testing.assert_allclose(et.metrics.dispersion(ds).values, np.var(z), atol=1e-9)
    np.testing.assert_allclose(et.metrics.evenness(ds).values, H, atol=1e-9)
    np.testing.assert_allclose(et.metrics.aggregation(ds).values, 1 / H, atol=1e-12)


def test_metrics_helpers_and_errors_match_jax():
    sv, er = _sv_case("noisy")
    from echopype_torch.metrics import summary_statistics as ts
    from echopype_tpu.metrics import summary_statistics as js

    _same(ts.delta_z(make_sv(tx, sv, er=er)), js.delta_z(make_sv(jx, sv, er=er)))
    _same(ts.convert_to_linear(make_sv(tx, sv, er=er)),
          js.convert_to_linear(make_sv(jx, sv, er=er)))
    for pkg, xr in ((et, tx), (ep, jx)):
        with pytest.raises(ValueError, match="depth"):
            pkg.metrics.abundance(make_sv(xr, sv, er=er), range_label="depth")


def _times(case):
    t = T0 + np.arange(50) * np.timedelta64(1, "s")
    if case == "one_reversal":
        t[20] = t[19] - np.timedelta64(5, "s")
    elif case == "first_interval":
        t = T0 + np.arange(12) * np.timedelta64(2, "s")
        t[1] = t[0] - np.timedelta64(7, "s")
    elif case == "adjacent_at_start":
        t = T0 + np.arange(10) * np.timedelta64(2, "s")
        t[1] = t[0] - np.timedelta64(7, "s")
        t[2] = t[1] - np.timedelta64(2, "s")
    elif case == "fully_reversed":
        t = T0 - np.arange(6) * np.timedelta64(1, "s")
    elif case == "many":
        rng = np.random.default_rng(3)
        t = T0 + np.cumsum(rng.integers(900, 1100, 200)).astype("timedelta64[ms]")
        for i in (30, 31, 90, 150):
            t[i] = t[i - 1] - np.timedelta64(int(rng.integers(1, 4000)), "ms")
    return t


@pytest.mark.parametrize("win_len", [3, 10, 100])
@pytest.mark.parametrize("case", ["none", "one_reversal", "first_interval",
                                  "adjacent_at_start", "fully_reversed", "many"])
def test_qc_time_repair_matches_jax(case, win_len):
    t = _times(case)
    got_ds, want_ds = tx.Dataset(coords={"ping_time": t.copy()}), jx.Dataset(
        coords={"ping_time": t.copy()})
    assert et.qc.exist_reversed_time(got_ds, "ping_time") == ep.qc.exist_reversed_time(
        want_ds, "ping_time") == (case != "none")
    et.qc.coerce_increasing_time(got_ds, win_len=win_len)
    ep.qc.coerce_increasing_time(want_ds, win_len=win_len)
    fixed = got_ds.coords["ping_time"].values
    np.testing.assert_array_equal(fixed.view("i8"), want_ds.coords["ping_time"].values.view("i8"))
    assert not et.qc.exist_reversed_time(got_ds, "ping_time")


def _reverse_one_ping(pkg, xr, ed, i=4, back_s=3):
    """One backward ping-time step, as tests/test_metrics_qc.py:158-168."""
    beam = ed["Sonar/Beam_group1"]
    pt = beam.coords["ping_time"].values.copy()
    pt[i] = pt[i - 1] - np.timedelta64(back_s, "s")
    beam.coords["ping_time"] = xr.DataArray(pt, ("ping_time",), name="ping_time")
    assert pkg.qc.exist_reversed_time(beam, "ping_time")


def _cruise(tmp_path, n_files):
    paths = []
    for i in range(n_files):
        path = tmp_path / f"Q{i}-D20200101-T00{i}000.raw"
        write_ek60_raw(path, n_pings=8, n_samples=20, seed=i,
                       t0=T0 + np.timedelta64(60 * i, "s"))
        paths.append(path)
    return paths


@pytest.mark.parametrize("n_files", [1, 3], ids=["one_file", "combined"])
@pytest.mark.parametrize("store", [False, True], ids=["in_memory", "zarr_store"])
def test_orchestrate_matches_jax(tmp_path, n_files, store):
    """open_raw (-> combine_echodata) -> a reversed ping -> (to_zarr ->)
    orchestrate_reverse_time_check: the repaired tree, the Provenance
    records and, with ``zarr_store``, the store and its reopened tree equal
    the JAX package's."""
    paths = _cruise(tmp_path, n_files)
    out = []
    for pkg, xr in ((et, tx), (ep, jx)):
        eds = [pkg.open_raw(p, sonar_model="EK60") for p in paths]
        ed = pkg.combine_echodata(eds) if n_files > 1 else eds[0]
        _reverse_one_ping(pkg, xr, ed, i=4 + 8 * (n_files - 1))
        kw = {}
        if store:
            kw["zarr_store"] = str(tmp_path / f"{pkg.__name__}.zarr")
            ed.to_zarr(kw["zarr_store"])
        assert pkg.qc.orchestrate_reverse_time_check(ed, **kw) is ed
        out.append((ed, kw.get("zarr_store")))
    (got, st), (want, sj) = out
    assert_same_tree(got, want)
    assert not et.qc.exist_reversed_time(got["Sonar/Beam_group1"], "ping_time")
    prov = got["Provenance"]
    assert prov.attrs["reversed_ping_times"] == 1
    assert "sonar_beam_group1_old_ping_time" in prov.data_vars
    if store:
        assert_same_store(st, sj)
        back = et.open_converted(st)
        np.testing.assert_array_equal(back["Sonar/Beam_group1"].coords["ping_time"].values,
                                      got["Sonar/Beam_group1"].coords["ping_time"].values)
        assert back["Provenance"].attrs["reversed_ping_times"] == 1
        assert_same_tree(back, ep.open_converted(sj))


def test_orchestrate_without_reversal_records_zero(tmp_path):
    paths = _cruise(tmp_path, 2)
    got = et.qc.orchestrate_reverse_time_check(
        et.combine_echodata([et.open_raw(p, sonar_model="EK60") for p in paths]))
    want = ep.qc.orchestrate_reverse_time_check(
        ep.combine_echodata([ep.open_raw(p, sonar_model="EK60") for p in paths]))
    assert got["Provenance"].attrs["reversed_ping_times"] == 0
    assert_same_tree(got, want)


@pytest.mark.parametrize("reverse", [False, True])
def test_colormap_matches_jax(reverse):
    """``colormap``: the EK500 table, and the matplotlib colormap where
    matplotlib is installed (registration is best effort in both)."""
    np.testing.assert_array_equal(et.colormap.EK500_COLORS, ep.colormap.EK500_COLORS)
    mpl = pytest.importorskip("matplotlib")
    got, want = et.colormap.ek500_cmap(reverse), ep.colormap.ek500_cmap(reverse)
    np.testing.assert_array_equal(got(np.linspace(-0.1, 1.1, 25)), want(np.linspace(-0.1, 1.1, 25)))
    assert ("ep.ek500_r" if reverse else "ep.ek500") in mpl.colormaps
