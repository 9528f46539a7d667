"""Port parity: mask (apply_mask, frequency_differencing, regrid_mask,
detect_seafloor, detect_shoal).

The cases of tests/test_mask.py, each run through ``echopype_tpu.mask`` and
``echopype_torch.mask`` on the same numpy inputs (each package with its own
``xrlite`` classes).  The mask package is host numpy in both, so results
are bit-identical: values, dims, coords and attrs (clock stamps aside).
"""

import numpy as np
import pytest

import echopype_torch as et
import echopype_tpu as ep
from echopype_torch import xrlite as tx
from echopype_tpu import xrlite as jx

PKGS = ((ep, jx), (et, tx))
_CLOCK = ("history", "processing_time", "date_created")


def make_sv(x, n_ch=2, n_ping=20, n_r=30, seed=0, latlon=False):
    """tests/test_mask.py::make_sv in package ``x`` (its xrlite)."""
    rng = np.random.default_rng(seed)
    sv = rng.normal(-70, 5, (n_ch, n_ping, n_r))
    ds = x.Dataset(
        {
            "Sv": (("channel", "ping_time", "range_sample"), sv),
            "frequency_nominal": (("channel",), np.array([18000.0, 38000.0][:n_ch])),
            "depth": (
                ("channel", "ping_time", "range_sample"),
                np.broadcast_to(np.arange(n_r) * 1.0, (n_ch, n_ping, n_r)).copy(),
            ),
        },
        coords={
            "channel": np.array(["chan1", "chan2"][:n_ch], dtype=object),
            "ping_time": np.datetime64("2020-01-01", "ns")
            + np.arange(n_ping) * np.timedelta64(1, "s"),
            "range_sample": np.arange(n_r),
        },
        attrs={"processing_level": "Level 2A"},
    )
    if latlon:
        ds["latitude"] = (("ping_time",), 45.0 + np.arange(n_ping) * 1e-4)
        ds["longitude"] = (("ping_time",), -125.0 + np.arange(n_ping) * 1e-4)
    return ds


def _same_attrs(a, b):
    strip = lambda d: {k: v for k, v in d.items() if k not in _CLOCK}  # noqa: E731
    assert strip(a) == strip(b)


def _same_da(got, want):
    assert got.dims == want.dims and got.name == want.name
    assert got.values.dtype == want.values.dtype
    np.testing.assert_array_equal(got.values, want.values)
    assert set(got.coords) == set(want.coords)
    for k in want.coords:
        np.testing.assert_array_equal(np.asarray(got.coords[k].values),
                                      np.asarray(want.coords[k].values))
    _same_attrs(got.attrs, want.attrs)


def _same_ds(got, want):
    assert set(got.data_vars) == set(want.data_vars)
    for k in want.data_vars:
        _same_da(got[k], want[k])
    _same_attrs(got.attrs, want.attrs)


def _both(build):
    """build(pkg, xrlite) for each package -> (jax result, port result)."""
    return [build(p, x) for p, x in PKGS]


# ------------------------------------------------------------- apply_mask
def _pt_mask(x, vals, dims=("ping_time", "range_sample")):
    return x.DataArray(np.array(vals), dims)


@pytest.mark.parametrize("case", ["basic", "list_fill", "channel", "nan_false", "latlon"])
def test_apply_mask(case):
    def build(p, x):
        ds = make_sv(x, latlon=case == "latlon")
        m = np.ones((20, 30), dtype=bool)
        if case == "basic" or case == "latlon":
            m[5] = False
            return p.mask.apply_mask(ds, _pt_mask(x, m))
        if case == "list_fill":
            m2 = m.copy()
            m[3], m2[7] = False, False
            return p.mask.apply_mask(ds, [_pt_mask(x, m), _pt_mask(x, m2)], fill_value=-999.0)
        if case == "channel":
            mc = np.ones((2, 20, 30), dtype=bool)
            mc[1] = False
            return p.mask.apply_mask(ds, _pt_mask(x, mc, ("channel", "ping_time", "range_sample")))
        mf = np.ones((20, 30))
        mf[2, 4] = np.nan
        return p.mask.apply_mask(ds, _pt_mask(x, mf))

    want, got = _both(build)
    _same_ds(got, want)
    assert got.attrs["mask_function"] == "mask.apply_mask"


@pytest.mark.parametrize("bad", ["non_boolean", "shape"])
def test_apply_mask_raises(bad):
    ds = make_sv(tx)
    vals = np.full((20, 30), 0.5) if bad == "non_boolean" else np.ones((10, 30), dtype=bool)
    with pytest.raises(ValueError):
        et.mask.apply_mask(ds, _pt_mask(tx, vals))


# ------------------------------------------------- frequency_differencing
@pytest.mark.parametrize("a,b,kw", [
    (-50.0, -70.0, dict(chanABEq='"chan1" - "chan2" > 10.0dB')),
    (-50.0, -70.0, dict(chanABEq='"chan1" - "chan2" > 30.0dB')),
    (-50.0, -58.0, dict(freqABEq="18kHz - 38kHz >= 8.0dB")),
    (-60.0, -65.0, dict(chanABEq='"chan1" - "chan2" == 5.0dB')),
    (None, None, dict(freqABEq="38kHz - 18kHz < 1.5dB")),
])
def test_frequency_differencing(a, b, kw):
    def build(p, x):
        ds = make_sv(x, seed=3)
        if a is not None:
            ds.data_vars["Sv"].values[0] = a
            ds.data_vars["Sv"].values[1] = b
        return p.mask.frequency_differencing(ds, **kw)

    want, got = _both(build)
    _same_da(got, want)
    assert got.dims == ("ping_time", "range_sample")


def test_frequency_differencing_validation():
    ds = make_sv(tx)
    with pytest.raises(ValueError):
        et.mask.frequency_differencing(ds)
    with pytest.raises(ValueError):
        et.mask.frequency_differencing(ds, freqABEq="18kHz - 38kHz > 5dB",
                                       chanABEq='"a" - "b" > 5dB')
    with pytest.raises(TypeError):
        et.mask.frequency_differencing(ds, freqABEq="18 - 38 > 5")
    with pytest.raises(ValueError):
        et.mask.frequency_differencing(ds, freqABEq="99kHz - 38kHz > 5.0dB")


# ------------------------------------------------------------ regrid_mask
@pytest.mark.parametrize("func", ["logical-AND", "logical-OR"])
@pytest.mark.parametrize("layout", ["2d", "3d_channel_range"])
def test_regrid_mask(func, layout):
    def build(p, x):
        pt = make_sv(x, n_ch=1).coords["ping_time"].values
        rng = np.random.default_rng(11)
        if layout == "2d":
            vals = np.zeros((20, 30), dtype=bool)
            vals[:, :10] = True
            vals[0, 15] = True
            mask = x.DataArray(vals, ("ping_time", "depth"), coords={"ping_time": pt})
            rng_da = x.DataArray(np.broadcast_to(np.arange(30) * 1.0, (20, 30)).copy(),
                                 ("ping_time", "depth"), name="depth")
            return p.mask.regrid_mask(mask, rng_da, range_bin="10m", ping_time_bin="5s",
                                      func=func)
        vals = rng.random((2, 20, 30)) > 0.4
        mask = x.DataArray(vals, ("channel", "ping_time", "range_sample"),
                           coords={"ping_time": pt,
                                   "channel": np.array(["a", "b"], dtype=object)})
        er = np.broadcast_to(np.arange(30) * 0.7, (2, 20, 30)).copy()
        er[1] *= 1.3
        er[0, :, 25:] = np.nan
        rng_da = x.DataArray(er, ("channel", "ping_time", "range_sample"), name="echo_range",
                             coords={"channel": np.array(["b", "a"], dtype=object)})
        return p.mask.regrid_mask(mask, rng_da, range_bin="4m", ping_time_bin="3s",
                                  third_dim="channel", func=func)

    want, got = _both(build)
    _same_da(got, want)


def test_regrid_mask_bad_func():
    pt = make_sv(tx, n_ch=1).coords["ping_time"].values
    mask = tx.DataArray(np.zeros((20, 30), dtype=bool), ("ping_time", "depth"),
                        coords={"ping_time": pt})
    with pytest.raises(ValueError):
        et.mask.regrid_mask(mask, tx.DataArray(np.arange(30) * 1.0, ("depth",), name="depth"),
                            func="AND")


# --------------------------------------------------------- detect_seafloor
def test_detect_seafloor_basic():
    def build(p, x):
        ds = make_sv(x, n_ch=1, n_ping=10, n_r=50)
        ds.data_vars["Sv"].values[:, :, 30:33] = -20.0
        ds.data_vars["Sv"].values[:, 4, 30:33] = -90.0  # one ping without a bottom
        return p.mask.detect_seafloor(
            ds, method="basic",
            params={"channel": "chan1", "threshold": (-25.0, -15.0), "offset_m": 0.5,
                    "bin_skip_from_surface": 5})

    want, got = _both(build)
    _same_da(got, want)


def test_detect_seafloor_blackwell():
    def build(p, x):
        ds = make_sv(x, n_ch=1, n_ping=60, n_r=80)
        ds.data_vars["Sv"].values[:] = -90.0
        rng = np.random.default_rng(7)
        ds.data_vars["Sv"].values[:, :, 50:] = rng.normal(-20.0, 5.0, (1, 60, 30))
        ang = np.zeros((1, 60, 80))
        ang[:, :, 50:] = 40.0
        ds["angle_alongship"] = (("channel", "ping_time", "range_sample"), ang)
        ds["angle_athwartship"] = (("channel", "ping_time", "range_sample"), ang)
        return p.mask.detect_seafloor(
            ds, method="blackwell",
            params={"channel": "chan1", "r0": 1.0, "r1": 79.0, "threshold": -40.0})

    want, got = _both(build)
    _same_da(got, want)
    np.testing.assert_allclose(got.values, 50.0, atol=6.0)
    with pytest.raises(ValueError):
        et.mask.detect_seafloor(make_sv(tx), method="magic")


# ------------------------------------------------------------ detect_shoal
@pytest.mark.parametrize("method,params", [
    ("weill", {"channel": "chan1", "thr": -60.0, "maxvgap": 4, "maxhgap": 2}),
    ("echoview", {"channel": "chan1", "thr": -60.0, "mincan": (2, 2), "maxlink": (2, 2),
                  "minsho": (2, 2)}),
])
def test_detect_shoal(method, params):
    def build(p, x):
        ds = make_sv(x, n_ch=1, n_ping=30, n_r=40)
        ds.data_vars["Sv"].values[:] = -90.0
        ds.data_vars["Sv"].values[0, 10:20, 10:20] = -50.0
        ds.data_vars["Sv"].values[0, 14, 13:16] = -90.0
        ds.data_vars["Sv"].values[0, 2, 2] = -50.0
        ds.data_vars["Sv"].values[0, 24:27, 30:33] = -50.0
        return p.mask.detect_shoal(ds, method=method, params=params)

    want, got = _both(build)
    _same_da(got, want)
    assert got.values[15, 15]
    # weill fills the gap and keeps the blip; echoview drops the blip
    assert got.values[14, 14] == got.values[2, 2] == (method == "weill")
    with pytest.raises(ValueError):
        et.mask.detect_shoal(make_sv(tx), method="magic")


# ------------------------------------- the detectors' vectorized internals
@pytest.mark.parametrize("axis", [0, 1])
def test_shoal_gap_fill_and_extent_filter_match_jax(axis):
    """tests/test_detector_scaling.py's kernels: gap filling along either
    axis and the component extent filter, bit-identical."""
    import importlib

    from scipy import ndimage as ndi

    # the package's __init__ binds the name to the function; take the modules
    tw, jw = (importlib.import_module(f"{p}.mask.shoal_detection.shoal_weill")
              for p in ("echopype_torch", "echopype_tpu"))

    rng = np.random.default_rng(5 + axis)
    m = rng.random((60, 80)) > 0.55
    np.testing.assert_array_equal(tw.fill_gaps_along_axis(m, 3, axis),
                                  jw.fill_gaps_along_axis(m, 3, axis))
    labeled = ndi.label(m)[0]
    idim, jdim = np.arange(61) * 0.5, np.arange(81) * 2.0
    for kw in ({}, dict(idim=idim, jdim=jdim)):
        np.testing.assert_array_equal(tw.component_extent_filter(m, labeled, 3, 2, **kw),
                                      jw.component_extent_filter(m, labeled, 3, 2, **kw))
