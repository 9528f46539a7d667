"""Port parity: the host-only modules the reference-oracle tests and migrating
callers use (``calibrate/env_params_old.py``, ``xrlite/flox_compat.py``,
``convert/utils/``) and the reference-named stubs of ``commongrid``.

Each package builds its inputs with its own ``xrlite`` classes from the same
numpy arrays.  Tolerances: ``EnvParams`` within 1e-12 of the JAX package
(scipy on both sides); ``xarray_reduce`` values and ``generic_filter``
bit-identical, interval labels equal by ``left``, ``right`` and ``closed``;
``convert/utils`` and the stubs equal.
"""

import datetime
import logging

import numpy as np
import pandas as pd
import pytest

import echopype_tpu.xrlite as jx
import echopype_torch.xrlite as tx
from echopype_torch.calibrate import env_params_old as tenv
from echopype_torch.commongrid import api as tapi
from echopype_torch.commongrid import utils as tcu
from echopype_torch.convert.utils import ek_date_conversion as tdate
from echopype_torch.convert.utils import ek_duplicates as tdup
from echopype_torch.convert.utils import ek_swap as tswap
from echopype_torch.xrlite import flox_compat as tflox
from echopype_tpu.calibrate import env_params_old as jenv
from echopype_tpu.commongrid import api as japi
from echopype_tpu.commongrid import utils as jcu
from echopype_tpu.convert.utils import ek_date_conversion as jdate
from echopype_tpu.convert.utils import ek_duplicates as jdup
from echopype_tpu.convert.utils import ek_swap as jswap
from echopype_tpu.xrlite import flox_compat as jflox

T0 = np.datetime64("2020-01-01T00:00:00", "ns")


def _t(seconds):
    return T0 + np.asarray(seconds, dtype="i8") * 1_000_000_000


class _Groups:
    """The two things ``EnvParams._apply`` reads of an EchoData."""

    def __init__(self, groups):
        self._groups = groups

    def __getitem__(self, path):
        return self._groups[path]


# --------------------------------------------------------------- EnvParams
def _env(x, kind, rng=None):
    if kind == "stationary":  # tests/test_ref_envparams.py:31-41
        return x.Dataset(
            data_vars={
                "temperature": ("time3", np.array([10.0, 10.5, 11.2, 10.9, 11.8, 12.0])),
                "salinity": ("time3", np.array([33.0, 33.2, 33.1, 33.4, 33.3, 33.5])),
                "pressure": ("time3", np.array([50.0, 51.0, 49.5, 50.5, 51.5, 52.0])),
            },
            coords={"time3": _t([100, 120, 140, 160, 180, 200])})
    rng = np.random.default_rng(7)
    n = 30
    return x.Dataset(
        data_vars={v: ("points", m + s * rng.standard_normal(n))
                   for v, m, s in (("temperature", 10.0, 2.0), ("salinity", 33.0, 0.5),
                                   ("pressure", 50.0, 5.0))},
        coords={"latitude": ("points", 32.0 + rng.uniform(0, 1.0, n)),
                "longitude": ("points", -117.0 + rng.uniform(0, 1.0, n))})


def _echodata(x, kind, out_of_range_ping=True, all_nat=False):
    if kind == "stationary":  # below, inside (grid hits, duplicates) and above
        return _Groups({"Platform": x.Dataset(coords={"time3": _t(
            [60, 90, 110, 120, 133, 133, 171, 199, 220, 260])})})
    t1 = np.full(5, np.datetime64("NaT"), "datetime64[ns]") if all_nat else _t([0, 50, 100, 150,
                                                                               200])
    platform = x.Dataset(
        data_vars={"latitude": ("time1", np.array([32.2, 32.4, 32.5, 32.6, 32.8])),
                   "longitude": ("time1", np.array([-116.8, -116.6, -116.5, -116.4, -116.2]))},
        coords={"time1": t1})
    ping_time = _t([10, 60, 110, 160, 240 if out_of_range_ping else 190])
    return _Groups({"Platform": platform,
                    "Sonar/Beam_group1": x.Dataset(coords={"ping_time": ping_time})})


def _same_env_output(got, want):
    assert set(got) == set(want) == {"temperature", "salinity", "pressure"}
    for var in want:
        assert tuple(got[var].dims) == tuple(want[var].dims) == ("time1",)
        np.testing.assert_allclose(np.asarray(got[var].values, "f8"),
                                   np.asarray(want[var].values, "f8"),
                                   rtol=0, atol=1e-12, equal_nan=True)
        np.testing.assert_array_equal(np.asarray(got[var].coords["time1"].values),
                                      np.asarray(want[var].coords["time1"].values))


@pytest.mark.parametrize("extrap_method", ["linear", "nearest", None])
@pytest.mark.parametrize("interp_method", jenv.VALID_INTERP_METHODS["stationary"])
def test_env_params_stationary(interp_method, extrap_method):
    kw = dict(data_kind="stationary", interp_method=interp_method, extrap_method=extrap_method)
    got = tenv.EnvParams(_env(tx, "stationary"), **kw)._apply(_echodata(tx, "stationary"))
    want = jenv.EnvParams(_env(jx, "stationary"), **kw)._apply(_echodata(jx, "stationary"))
    _same_env_output(got, want)
    assert np.isfinite(np.asarray(got["temperature"].values)).any()


@pytest.mark.parametrize("interp_method", jenv.VALID_INTERP_METHODS["mobile"])
def test_env_params_mobile(interp_method):
    oor = interp_method != "nearest"  # scipy's kd-tree rejects a NaN track point
    kw = dict(data_kind="mobile", interp_method=interp_method)
    got = tenv.EnvParams(_env(tx, "mobile"), **kw)._apply(_echodata(tx, "mobile", oor))
    want = jenv.EnvParams(_env(jx, "mobile"), **kw)._apply(_echodata(jx, "mobile", oor))
    _same_env_output(got, want)


def test_env_params_errors():
    assert tenv.VALID_INTERP_METHODS == jenv.VALID_INTERP_METHODS
    for mod, x in ((tenv, tx), (jenv, jx)):
        with pytest.raises(ValueError, match="invalid interp_method quadratic"):
            mod.EnvParams(_env(x, "stationary"), "mobile", interp_method="quadratic")
        with pytest.raises(ValueError, match="missing dimension time3"):
            mod.EnvParams(_env(x, "stationary"), "stationary")._apply(
                _Groups({"Platform": x.Dataset(coords={"time2": _t([0])})}))
        with pytest.raises(ValueError, match="without time1"):
            mod.EnvParams(_env(x, "mobile"), "mobile")._apply(
                _echodata(x, "mobile", all_nat=True))
        with pytest.raises(ValueError, match="must be finite"):
            mod.EnvParams(_env(x, "mobile"), "mobile", interp_method="nearest")._apply(
                _echodata(x, "mobile"))


# ------------------------------------------------------------ flox_compat
def _sv_dataset(x, seed=0, C=2, P=24, R=15):
    rng = np.random.default_rng(seed)
    sv = rng.normal(-60.0, 5.0, (C, P, R))
    sv[0, 2, 3] = sv[1, 9, :] = np.nan
    ds = x.Dataset(coords={"channel": np.array(["a", "b"], dtype=object),
                           "ping_time": T0 + np.arange(P) * np.timedelta64(1, "s"),
                           "range_sample": np.arange(R)})
    ds["Sv"] = (("channel", "ping_time", "range_sample"), sv)
    ds["echo_range"] = (("range_sample",), np.arange(R) * 0.5)
    ds["depth"] = (("channel", "range_sample"), np.arange(C)[:, None] + np.arange(R) * 0.5)
    ds["frame"] = (("ping_time",), np.arange(P) // 5 * 1.5)
    ds["stamp"] = (("ping_time",), T0 + np.arange(P) * np.timedelta64(250, "ms"))
    return ds


class _LeftClosedIndex:
    """A duck-typed ``IntervalIndex``: left-closed bins of ``edges``, with
    ``get_indexer`` and iteration over its labels, and no pandas."""

    def __init__(self, edges):
        self.edges = np.asarray(edges)

    def get_indexer(self, values):
        idx = np.searchsorted(self.edges, values, side="right") - 1
        bad = np.isnan(values) | (idx < 0) | (idx >= len(self.edges) - 1)
        return np.where(bad, -1, idx)

    def __iter__(self):
        return iter(tflox._Interval(a, b, "left") for a, b in zip(self.edges[:-1], self.edges[1:]))


PT_EDGES = T0 + np.arange(-1, 30, 5) * np.timedelta64(1, "s") - np.timedelta64(1, "ns")
RANGE_EDGES = np.arange(0.0, 8.0, 2.0)

# (by variables, isbin, expected groups): binned, categorical and mixed
GROUPINGS = {
    "time_x_range_bins": (("ping_time", "echo_range"), [True, True], (PT_EDGES, RANGE_EDGES)),
    "range_bins": (("echo_range",), True, RANGE_EDGES),
    "depth_bins_2d": (("depth",), True, RANGE_EDGES),
    "category": (("frame",), False, None),
    "category_expected": (("frame",), False, np.array([3.0, 0.0, 1.5, 9.0])),
    "category_x_bins": (("frame", "echo_range"), [False, True], (None, RANGE_EDGES)),
    "interval_index": (("echo_range",), True, "pandas"),
    "duck_index": (("echo_range",), True, "duck"),
}


def _expected(spec, pkg):
    """The groups ``pkg`` is given: a duck-typed index goes to the port, the
    same bins as a pandas ``IntervalIndex`` to the JAX package (which takes
    only that type)."""
    if not isinstance(spec, str):
        return spec
    if spec == "duck" and pkg == "port":
        return _LeftClosedIndex(RANGE_EDGES)
    return pd.IntervalIndex.from_breaks(RANGE_EDGES, closed="left")


@pytest.mark.parametrize("func", ["nanmean", "mean", "nansum", "sum", "count", "nanmax", "min"])
@pytest.mark.parametrize("grouping", sorted(GROUPINGS))
def test_xarray_reduce(grouping, func):
    for skipna, fill_value in ((True, None), (False, None), (True, -999.0), (False, -999.0)):
        _same_reduction(grouping, func, skipna, fill_value)


def _same_reduction(grouping, func, skipna, fill_value):
    by, isbin, expected = GROUPINGS[grouping]
    out = {}
    for name, x, flox in (("port", tx, tflox), ("jax", jx, jflox)):
        ds = _sv_dataset(x)
        exp = (tuple(_expected(e, name) for e in expected) if isinstance(expected, tuple)
               else _expected(expected, name))
        out[name] = flox.xarray_reduce(ds["Sv"], *[ds[b] for b in by], func=func,
                                       expected_groups=exp, isbin=isbin, skipna=skipna,
                                       fill_value=fill_value)
    got, want = out["port"], out["jax"]
    assert tuple(got.dims) == tuple(want.dims)
    np.testing.assert_array_equal(np.asarray(got.values), np.asarray(want.values))
    for dim in got.dims:
        if dim in want.coords:
            g, w = (list(np.asarray(o.coords[dim].values)) for o in (got, want))
            assert len(g) == len(w) and all(a == b for a, b in zip(g, w)), dim
            if dim.endswith("_bins"):
                assert all((a.left, a.right, a.closed) == (b.left, b.right, b.closed)
                           for a, b in zip(g, w))


@pytest.mark.parametrize("func", ["nanmean", "max", "count"])
def test_xarray_reduce_datetime_and_dataset(func):
    """datetime64 values (int64 ns, NaT kept) and a whole Dataset."""
    out = {}
    for name, x, flox in (("port", tx, tflox), ("jax", jx, jflox)):
        ds = _sv_dataset(x)
        stamp = np.asarray(ds["stamp"].values).copy()
        stamp[[3, 4, 5, 6, 7]] = np.datetime64("NaT")  # one bin all NaT
        ds["stamp"] = (("ping_time",), stamp)
        ds2 = x.Dataset(data_vars={"stamp": ds["stamp"], "frame": ds["frame"]},
                        coords={"ping_time": ds.coords["ping_time"]})
        out[name] = flox.xarray_reduce(ds2, ds["ping_time"], func=func, isbin=True,
                                       expected_groups=PT_EDGES)
    for var in ("stamp", "frame"):
        g, w = (np.asarray(o[var].values) for o in (out["port"], out["jax"]))
        np.testing.assert_array_equal(g, w)
    assert np.isnat(np.asarray(out["port"]["stamp"].values)).any() or func == "count"


def test_break_codes_are_right_closed():
    """``pd.IntervalIndex.from_breaks`` semantics: (e[i], e[i+1]], NaN,
    NaT and values outside the edges -> -1."""
    e = np.array([0.0, 1.0, 2.5, 4.0])
    v = np.array([-1.0, 0.0, 0.5, 1.0, 1.0000001, 2.5, 4.0, 4.5, np.nan])
    want = pd.IntervalIndex.from_breaks(e).get_indexer(v)
    np.testing.assert_array_equal(tflox._break_codes(v, e), want)
    te, tv = _t([0, 10, 20]), np.append(_t([0, 5, 10, 15, 20, 25]), np.datetime64("NaT"))
    np.testing.assert_array_equal(tflox._break_codes(tv, te),
                                  pd.IntervalIndex.from_breaks(te).get_indexer(tv))
    a, b = tflox._Interval(0.0, 1.0), pd.Interval(0.0, 1.0)
    assert a == b and a == tflox._Interval(0.0, 1.0)
    assert a != tflox._Interval(0.0, 1.0, "left") and a != tflox._Interval(0.0, 2.0)
    assert hash(a) == hash(tflox._Interval(0.0, 1.0))


def test_make_flox_module():
    flox, flox_xarray = tflox.make_flox_module()
    assert flox.xarray is flox_xarray and flox_xarray.xarray_reduce is tflox.xarray_reduce
    j = jflox.make_flox_module()
    assert (flox.__name__, flox_xarray.__name__) == (j[0].__name__, j[1].__name__)


@pytest.mark.parametrize("mode", ["reflect", "nearest", "constant"])
def test_generic_filter(mode):
    img = np.random.default_rng(4).normal(size=(2, 31, 17))
    img[0, 3, 4] = np.nan
    got = tflox.make_dask_image_module()[1].generic_filter(img, np.nanmean, size=(1, 3, 5),
                                                           mode=mode).compute()
    want = jflox.make_dask_image_module()[1].generic_filter(img, np.nanmean, size=(1, 3, 5),
                                                            mode=mode).compute()
    np.testing.assert_array_equal(got, want)
    assert tflox.make_dask_image_module()[0].__name__ == "dask_image"


# ------------------------------------------------------------ convert/utils
NT_TIMES = [(19496896, 30196149), (0, 30000000), (4294967295, 31000000), (0, 0)]


@pytest.mark.parametrize("nt", NT_TIMES)
def test_nt_date_conversion(nt):
    assert tdate.nt_to_unix(nt) == jdate.nt_to_unix(nt)
    assert tdate.nt_to_unix(nt, return_datetime=False) == jdate.nt_to_unix(
        nt, return_datetime=False)
    dt = tdate.nt_to_unix(nt)
    assert tdate.unix_to_nt(dt) == jdate.unix_to_nt(dt)


def test_nt_round_trip_is_integer_exact():
    """tests/test_api_surface.py:165-187 on the port: the integer NT-time
    arithmetic round-trips to the microsecond."""
    dt = datetime.datetime(2021, 6, 1, 12, 30, 15, 123456, datetime.timezone.utc)
    assert tdate.unix_to_nt(dt) == jdate.unix_to_nt(dt)
    assert tdate.nt_to_unix(tdate.unix_to_nt(dt)) == dt
    assert tdate.datetime_to_unix(dt) == jdate.datetime_to_unix(dt)
    for ts in (0.0, 1.5, 1622550615.123456):
        assert tdate.unix_to_datetime(ts) == jdate.unix_to_datetime(ts)
        assert tdate.unix_to_nt(ts) == jdate.unix_to_nt(ts)


def test_calc_final_shapes():
    # tests/test_api_surface.py:211-226
    pdd = {
        "power": {"ch1": [np.zeros(100), np.zeros(120)], "ch2": [np.zeros(90)]},
        "angle": {"ch1": [np.zeros((100, 2)), np.zeros((110, 2))], "ch2": []},
        "complex": {},
    }
    kinds = ["power", "angle", "complex"]
    assert tswap.calc_final_shapes(kinds, pdd) == jswap.calc_final_shapes(kinds, pdd)


@pytest.mark.parametrize("differ", [False, True])
def test_check_unique_ping_time_duplicates(differ, caplog):
    pt = _t([0, 1, 1, 2, 2])
    power = np.arange(15.0).reshape(5, 3)
    power[2] = power[1]
    power[4] = power[3] + (1.0 if differ else 0.0)
    warned = {}
    for name, x, mod in (("port", tx, tdup), ("jax", jx, jdup)):
        ds = x.Dataset(data_vars={"power": (("ping_time", "range_sample"), power)},
                       coords={"ping_time": pt, "range_sample": np.arange(3)})
        logger = logging.getLogger(f"test_torch_host_shims.{name}")
        caplog.clear()
        with caplog.at_level(logging.WARNING, logger=logger.name):
            mod.check_unique_ping_time_duplicates(ds, logger)
        warned[name] = [r.getMessage() for r in caplog.records]
    assert warned["port"] == warned["jax"]
    assert len(warned["port"]) == (1 if differ else 0)


# ------------------------------------------------------------ commongrid stubs
def test_regrid_stub():
    assert tapi.regrid() == japi.regrid() == 1
    assert "regrid" in tapi.__all__


@pytest.mark.parametrize("ping_time_bin", ["20s", "0.5min", "90min", "24h", "1500us", "2D", "36h"])
def test_ping_time_bin_parsing_alias(ping_time_bin):
    want = jcu.ping_time_bin_parsing_and_conversion(ping_time_bin)
    got = tcu.ping_time_bin_parsing_and_conversion(ping_time_bin)
    assert got == tcu.parse_time_bin_to_value_unit(ping_time_bin) == want
