"""Port parity: clean (noise masks, background noise, transient detectors)
and the window programs of ops/windows.py.

``echopype_torch`` (device="cpu": the same torch ops the card runs) against
``echopype_tpu`` on its CPU backend, on the same numpy inputs (each package
gets its own ``xrlite.Dataset``).  Four depth grids: a round-number
monotone grid whose window members land exactly on ``d +- bin`` (host
float64 membership runs), one with interior NaN holes, a non-monotone grid
(float32 value bands with the 4-ulp margin) and a depth that varies by ping
(host float64 pooling).  Tolerances: pooled / upsampled Sv within 1e-4 dB
with identical NaN masks (float32 sums in another order); masks equal; the
host float64 paths (background noise, fielding, matecho, medians,
index binning) bit-identical.
"""

import numpy as np
import pytest
import torch

import echopype_torch as et
import echopype_tpu as ep
from echopype_torch.clean import utils as tcu
from echopype_torch.ops import windows as tw
from echopype_torch.xrlite import Dataset as TDataset
from echopype_tpu.clean import utils as jcu
from echopype_tpu.ops import windows as jw
from echopype_tpu.xrlite import Dataset as JDataset

torch.set_num_threads(1)

DB_ATOL = 1e-4
DEV = "cpu"


def _grid(kind, C, P, R, seed=0):
    """[C, P, R] depth of one of the four grid kinds."""
    rng = np.random.default_rng(seed)
    if kind == "round":  # 0.5 m steps, bins of whole metres: members on d +- bin
        row = np.arange(R) * 0.5
        return np.broadcast_to(row, (C, P, R)).copy()
    if kind == "holes":
        rows = np.stack([np.arange(R) * 0.5, np.arange(R) * 0.75])[:C]
        rows[:, 7:10] = np.nan
        rows[-1, R - 5:] = np.nan
        return np.broadcast_to(rows[:, None, :], (C, P, R)).copy()
    if kind == "nonmono":
        row = np.arange(R) * 0.5
        row[20:24] = row[20:24][::-1]
        return np.broadcast_to(row, (C, P, R)).copy()
    # ping-varying: heave shifts each ping's grid
    heave = rng.uniform(-0.3, 0.3, size=(1, P, 1))
    return np.arange(R)[None, None, :] * 0.5 + heave + np.zeros((C, 1, 1))


def _sv(C, P, R, seed=0, base=-80.0):
    rng = np.random.default_rng(seed)
    return rng.normal(base, 4.0, (C, P, R))


def _datasets(sv, depth):
    """The same Sv dataset in each package."""
    C, P, R = sv.shape
    out = []
    for Dataset in (JDataset, TDataset):
        out.append(Dataset(
            {
                "Sv": (("channel", "ping_time", "range_sample"), sv.copy()),
                "echo_range": (("channel", "ping_time", "range_sample"), depth.copy()),
                "depth": (("channel", "ping_time", "range_sample"), depth.copy()),
                "sound_absorption": (("channel",), np.full(C, 0.001)),
                "frequency_nominal": (("channel",), 38000.0 * (1 + np.arange(C))),
            },
            coords={
                "channel": np.array([f"ch{i}" for i in range(C)], dtype=object),
                "ping_time": np.datetime64("2020-01-01", "ns")
                + np.arange(P) * np.timedelta64(1, "s"),
                "range_sample": np.arange(R),
            },
        ))
    return out


def _np(t):
    return t.cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _close_db(got, want):
    got, want = np.asarray(got, dtype="f8"), np.asarray(want, dtype="f8")
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_allclose(got, want, rtol=0, atol=DB_ATOL, equal_nan=True)


# ------------------------------------------------------------ device programs
@pytest.mark.parametrize("kind", ["round", "holes"])
def test_pool_grid_idx_matches_jax(kind):
    C, P, R = 2, 40, 120
    sv = _sv(C, P, R, seed=1).astype("f4")
    grid = _grid(kind, C, P, R)[:, 0]
    lo, hi, v_r, halo = jw.grid_window_members(grid, 2.0, 3.0)
    assert halo > 0
    gmask = np.isfinite(grid).astype("f4")
    for h in (halo, 0):  # blocked band and dense band
        want = np.asarray(jw.pool_sv_nanmean_grid_idx_device(sv, gmask, lo, hi, v_r, 3,
                                                             range_halo=h))
        got = _np(tw.pool_sv_nanmean_grid_idx_device(sv, gmask, lo, hi, v_r, 3, range_halo=h,
                                                     device=DEV))
        _close_db(got, want)
        mj = np.asarray(jw.transient_mask_grid_idx_packed(sv, gmask, lo, hi, v_r, 3, 8.0,
                                                          range_halo=h))
        mt = _np(tw.transient_mask_grid_idx_packed(sv, gmask, lo, hi, v_r, 3, 8.0,
                                                   range_halo=h, device=DEV))
        np.testing.assert_array_equal(mt, mj)


def test_host_membership_functions_are_the_jax_packages():
    for kind in ("round", "holes", "nonmono"):
        grid = _grid(kind, 2, 1, 80)[:, 0]
        a, b = jw.grid_window_members(grid, 2.0, 1.0), tw.grid_window_members(grid, 2.0, 1.0)
        if a is None:
            assert b is None and kind == "nonmono"
        else:
            for x, y in zip(a, b):
                np.testing.assert_array_equal(x, y)
        assert jw.grid_window_halo(grid, 2.0) == tw.grid_window_halo(grid, 2.0)


@pytest.mark.parametrize("kind", ["nonmono", "round"])
def test_pool_grid_value_band_matches_jax(kind):
    C, P, R = 2, 30, 90
    sv = _sv(C, P, R, seed=2).astype("f4")
    sv[1, :, 60:] = np.nan
    grid = _grid(kind, C, P, R)[:, 0].astype("f4")
    halo = jw.grid_window_halo(grid, 2.0)
    for h in {halo, 0}:
        want = np.asarray(jw.pool_sv_nanmean_grid_device(sv, grid, 2.0, 2, 1.0, range_halo=h))
        got = _np(tw.pool_sv_nanmean_grid_device(sv, grid, 2.0, 2, 1.0, range_halo=h,
                                                  device=DEV))
        _close_db(got, want)
        mj = np.asarray(jw.transient_mask_grid_packed(sv, grid, 2.0, 2, 1.0, 6.0, range_halo=h))
        mt = _np(tw.transient_mask_grid_packed(sv, grid, 2.0, 2, 1.0, 6.0, range_halo=h,
                                               device=DEV))
        np.testing.assert_array_equal(mt, mj)


def test_pool_ping_varying_device_and_host_exact():
    C, P, R = 2, 20, 60
    sv = _sv(C, P, R, seed=3)
    depth = _grid("varying", C, P, R)
    want = np.asarray(jw.pool_sv_nanmean_device(sv.astype("f4"), depth.astype("f4"), 2.0, 3, 1.0))
    got = _np(tw.pool_sv_nanmean_device(sv.astype("f4"), depth.astype("f4"), 2.0, 3, 1.0,
                                        device=DEV))
    _close_db(got, want)
    want = jw.pool_sv_nanmean_host_exact(sv, depth, 2.0, 3, 1.0)
    np.testing.assert_array_equal(tw.pool_sv_nanmean_host_exact(sv, depth, 2.0, 3, 1.0), want)
    np.testing.assert_array_equal(  # the row work on the device, bit for bit
        tw.pool_sv_nanmean_exact_device(sv, depth, 2.0, 3, 1.0, device=DEV), want)


@pytest.mark.parametrize("P,W", [(21, 3), (7, 3), (5, 3), (30, 0)])
def test_exact_device_pooling_bit_identical_at_the_ping_edges(P, W):
    """The last valid centre (p = P - W) has no member p + W; P < 2W leaves
    no valid centre; W = 0 pools one ping."""
    sv = _sv(2, P, 50, seed=P)
    sv[0, 2, 5:9] = np.nan
    depth = _grid("varying", 2, P, 50, seed=P)
    assert tw._exact_rows_ok(depth)
    np.testing.assert_array_equal(
        tw.pool_sv_nanmean_exact_device(sv, depth, 1.5, W, 0.5, device=DEV),
        jw.pool_sv_nanmean_host_exact(sv, depth, 1.5, W, 0.5))


def test_quiet_window_after_loud_keeps_precision():
    """Direct member sums: a quiet window next to loud samples keeps its
    value (a float32 prefix-sum difference loses it)."""
    C, P, R = 1, 12, 64
    sv = np.full((C, P, R), -20.0, dtype="f4")
    sv[:, :, 32:] = -150.0
    grid = (np.arange(R) * 1.0)[None, :]
    lo, hi, v_r, halo = tw.grid_window_members(grid, 2.0, 0.0)
    got = _np(tw.pool_sv_nanmean_grid_idx_device(sv, np.ones((1, R), "f4"), lo, hi, v_r, 2,
                                                 range_halo=halo, device=DEV))
    lin = 10.0 ** (sv[0].astype("f8") / 10.0)
    want = np.full((P, R), np.nan)
    for p in range(2, P - 1):  # the ping window may end at P
        for r in range(2, R - 2):  # direct float64 member means
            want[p, r] = 10.0 * np.log10(lin[p - 2 : p + 3, r - 2 : r + 3].mean())
    _close_db(got[0], want)
    assert np.nanmax(np.abs(got[0, 5, 40:60] + 150.0)) < 1e-4


def test_downsample_upsample_matches_jax():
    C, P, R = 2, 25, 70
    sv = _sv(C, P, R, seed=4).astype("f4")
    sv[0, 3, 10:20] = np.nan
    grid = _grid("round", C, P, R)[:, 0]
    edges = np.arange(np.nanmin(grid), np.nanmax(grid) + 3.0, 3.0)
    n_b = len(edges) - 1
    idx_grid = np.clip(np.digitize(grid, edges) - 1, 0, n_b - 1).astype("i4")
    for a, b in zip(jw.downsample_upsample_grid_device(sv, idx_grid, n_b),
                    tw.downsample_upsample_grid_device(sv, idx_grid, n_b, device=DEV)):
        _close_db(_np(b), np.asarray(a))
    depth = _grid("varying", C, P, R)
    edges = np.arange(np.nanmin(depth), np.nanmax(depth) + 3.0, 3.0)
    n_b = len(edges) - 1
    bin_idx = np.clip(np.digitize(depth, edges) - 1, 0, n_b - 1).astype("i4")
    for a, b in zip(jw.downsample_upsample_depth_device(sv, bin_idx, n_b),
                    tw.downsample_upsample_depth_device(sv, bin_idx, n_b, device=DEV)):
        _close_db(_np(b), np.asarray(a))


def test_impulse_and_pack_match_jax():
    C, P, R = 2, 30, 41  # odd R: the bit padding
    sv = _sv(C, P, R, seed=5).astype("f4")
    sv[0, 12] += 25.0
    sv[1, 4, :10] = np.nan
    grid = _grid("round", C, P, R)[:, 0]
    edges = np.arange(np.nanmin(grid), np.nanmax(grid) + 2.0, 2.0)
    n_b = len(edges) - 1
    idx = np.clip(np.digitize(grid, edges) - 1, 0, n_b - 1).astype("i4")
    want = np.asarray(jw.impulse_mask_grid_device(sv, idx, n_b, 2, 10.0))
    got = _np(tw.impulse_mask_grid_device(sv, idx, n_b, 2, 10.0, device=DEV))
    assert want[0, 12].any()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(_np(tw.impulse_mask_grid_packed(sv, idx, n_b, 2, 10.0,
                                                                  device=DEV)),
                                  np.asarray(jw.impulse_mask_grid_packed(sv, idx, n_b, 2, 10.0)))
    m = np.random.default_rng(3).random((2, 5, 21)) > 0.5
    np.testing.assert_array_equal(_np(tw.pack_mask_device(torch.as_tensor(m))),
                                  np.packbits(m, axis=-1))


def test_nanmedian_even_count_averages_middle_values():
    x = torch.tensor([[4.0, 1.0, float("nan"), 3.0, 2.0],
                      [float("nan")] * 5,
                      [5.0, float("nan"), 1.0, 9.0, float("nan")]])
    got = tw._nanmedian(x).numpy()
    with np.errstate(invalid="ignore"):
        import warnings

        with warnings.catch_warnings():
            warnings.simplefilter("ignore", RuntimeWarning)
            want = np.nanmedian(x.numpy(), axis=-1)
    np.testing.assert_array_equal(got, want)  # 2.5, nan, 5.0
    assert got[0] == 2.5


def test_attenuated_ping_mask_matches_jax():
    C, P, R = 2, 60, 80
    sv = _sv(C, P, R, seed=6, base=-70.0)
    sv[:, :, 20:40] = np.random.default_rng(7).normal(-55.0, 2.0, (C, P, 20))
    sv[0, 20, 20:40] -= 20.0
    sv[1, 33, 20:40] -= 20.0
    sv[1, 7, 25:35] = np.nan
    sv = sv.astype("f4")
    grid = _grid("round", C, P, R)[:, 0]
    up = np.argmin(np.abs(grid - 10.0), axis=1).astype("i4")
    lw = np.argmin(np.abs(grid - 19.5), axis=1).astype("i4")  # even slab width (19 samples... )
    widths = np.maximum(lw - up, 0).astype("i4")
    for W, chunk in ((5, 16), (4, 256)):  # 2W * width even: the median averages
        want = np.asarray(jw.attenuated_ping_mask_grid_device(sv, up, widths, int(widths.max()),
                                                              W, -8.0, chunk=chunk))
        got = _np(tw.attenuated_ping_mask_grid_device(sv, up, widths, int(widths.max()), W, -8.0,
                                                      chunk=chunk, device=DEV))
        assert want[0, 20] and want[1, 33]
        np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------- clean api
MASK_KW = {
    "transient": dict(func="nanmean", depth_bin="3m", num_side_pings=4, exclude_above="2.0m",
                      transient_noise_threshold="6.0dB"),
    "impulse": dict(depth_bin="2m", num_side_pings=2, impulse_noise_threshold="8.0dB"),
    "attenuated": dict(upper_limit_sl="8.0m", lower_limit_sl="20.0m", num_side_pings=4,
                       attenuation_signal_threshold="-6.0dB"),
}
_FNS = {"transient": "mask_transient_noise", "impulse": "mask_impulse_noise",
        "attenuated": "mask_attenuated_signal"}


def _noisy(kind, C=2, P=48, R=64, seed=8):
    sv = _sv(C, P, R, seed=seed, base=-75.0)
    sv[0, 10] += 25.0  # impulse ping
    sv[1, 20:23, 30:] += 18.0  # transient blob
    sv[0, 30:33, 16:40] -= 22.0  # attenuated run
    return sv, _grid(kind, C, P, R, seed=seed)


@pytest.mark.parametrize("kind", ["round", "holes", "nonmono", "varying"])
@pytest.mark.parametrize("mask", ["transient", "impulse", "attenuated"])
def test_clean_masks_match_jax(kind, mask):
    sv, depth = _noisy(kind)
    jds, tds = _datasets(sv, depth)
    want = getattr(ep.clean, _FNS[mask])(jds, **MASK_KW[mask])
    got = getattr(et.clean, _FNS[mask])(tds, **MASK_KW[mask], device=DEV)
    assert got.dims == want.dims and got.name == want.name
    np.testing.assert_array_equal(got.values, want.values)
    if mask != "attenuated" or kind in ("round", "varying"):
        assert got.values.any()


def test_transient_nanmedian_and_index_binning_match_jax():
    sv, depth = _noisy("round", P=30, R=40)
    jds, tds = _datasets(sv, depth)
    for kw in (dict(func="nanmedian", depth_bin="3m", num_side_pings=3, exclude_above="0.0m"),
               dict(func="nanmean", use_index_binning=True, depth_bin="3m", num_side_pings=3,
                    exclude_above="1.0m"),
               dict(func="nanmedian", use_index_binning=True, depth_bin="2m", num_side_pings=2,
                    exclude_above="1.0m")):
        np.testing.assert_array_equal(et.clean.mask_transient_noise(tds, **kw, device=DEV).values,
                                      ep.clean.mask_transient_noise(jds, **kw).values)


def test_pool_and_downsample_utils_match_jax():
    sv, depth = _noisy("varying", P=20, R=50)
    np.testing.assert_array_equal(tcu.pool_Sv_nanmean(sv, depth, 2.0, 3, 1.0, device=DEV),
                                  jcu.pool_Sv_nanmean(sv, depth, 2.0, 3, 1.0))
    np.testing.assert_array_equal(tcu.pool_Sv_nanmedian(sv, depth, 2.0, 3, 1.0),
                                  jcu.pool_Sv_nanmedian(sv, depth, 2.0, 3, 1.0))
    sv_g, depth_g = _noisy("round", P=20, R=50)
    _close_db(tcu.pool_Sv_nanmean(sv_g, depth_g, 2.0, 3, 1.0, device=DEV),
              jcu.pool_Sv_nanmean(sv_g, depth_g, 2.0, 3, 1.0))
    for d in (depth, depth_g):
        for a, b in zip(tcu.downsample_upsample_along_depth(sv, d, 3.0, device=DEV)[:2],
                        jcu.downsample_upsample_along_depth(sv, d, 3.0)[:2]):
            _close_db(a, b)
    assert tcu.uniform_grid(depth) is None and tcu.uniform_grid(depth_g) is not None


def test_attenuated_outside_range_and_invalid_limits():
    sv, depth = _noisy("round", R=30)
    jds, tds = _datasets(sv, depth)
    got = et.clean.mask_attenuated_signal(tds, upper_limit_sl="400.0m",
                                          lower_limit_sl="500.0m", device=DEV)
    assert not got.values.any()
    with pytest.raises(ValueError):
        et.clean.mask_attenuated_signal(tds, upper_limit_sl="50.0m", lower_limit_sl="40.0m",
                                        device=DEV)
    with pytest.raises(ValueError):
        et.clean.mask_transient_noise(tds, func="nanmax", device=DEV)


@pytest.mark.parametrize("noise_max", [None, "-125.0dB"])
def test_background_noise_matches_jax(noise_max):
    sv, depth = _noisy("round", P=40, R=100)
    sv[:, :, 30:40] = -50.0
    jds, tds = _datasets(sv, depth)
    kw = dict(ping_num=10, range_sample_num=10, background_noise_max=noise_max)
    np.testing.assert_array_equal(et.clean.estimate_background_noise(tds, **kw).values,
                                  ep.clean.estimate_background_noise(jds, **kw).values)
    got = et.clean.remove_background_noise(tds, **kw)
    want = ep.clean.remove_background_noise(jds, **kw)
    for v in ("Sv_noise", "Sv_corrected"):
        np.testing.assert_array_equal(got[v].values, want[v].values)
        assert got[v].attrs == want[v].attrs
    assert got.attrs.get("processing_level") == want.attrs.get("processing_level")


@pytest.mark.parametrize("method,params", [
    ("fielding", {"r0": 900, "r1": 1000, "n": 10, "roff": 20}),
    ("matecho", {"start_depth": 220, "window_meter": 450, "window_ping": 20, "delta_db": 12}),
])
def test_detect_transient_matches_jax(method, params):
    C, P, R = 1, 80, 120
    sv = _sv(C, P, R, seed=9, base=-85.0)
    sv[0, 40, :] += 25.0
    depth = np.broadcast_to(np.arange(R) * 10.0, (C, P, R)).copy()
    jds, tds = _datasets(sv, depth)
    want = ep.clean.detect_transient(jds, method=method, params=params)
    got = et.clean.detect_transient(tds, method=method, params=params)
    assert got.name == want.name and got.dims == want.dims
    np.testing.assert_array_equal(got.values, want.values)
    assert (~got.values[0, 40]).any()
    with pytest.raises(ValueError):
        et.clean.detect_transient(tds, method="ryan")


def test_public_names_are_the_jax_packages():
    assert sorted(et.clean.__all__) == sorted(ep.clean.__all__)
    assert sorted(et.mask.__all__) == sorted(ep.mask.__all__)
    assert set(jw.__all__) <= set(tw.__all__)


def test_cuda_device_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    sv, depth = _noisy("round", P=16, R=20)
    _, tds = _datasets(sv, depth)
    with pytest.raises(RuntimeError, match="cuda"):
        et.clean.mask_impulse_noise(tds)


@pytest.mark.parametrize("exact", [False, True])
@pytest.mark.parametrize("varying_bottom", [False, True])
def test_matecho_core_matches_jax(exact, varying_bottom):
    """tests/test_detector_scaling.py's matecho kernel (histogram fast path
    and the exact path), bit-identical."""
    from echopype_torch.clean.transient_noise.matecho import _matecho_core as t_core
    from echopype_tpu.clean.transient_noise.matecho import _matecho_core as j_core

    rng = np.random.default_rng(4)
    n_r, n_ping = 120, 400
    r = np.arange(n_r) * 5.0
    sv = rng.normal(-85.0, 3.0, (n_r, n_ping))
    deep = (r >= 220) & (r <= 500)
    sv[np.ix_(deep, np.arange(5, n_ping, 37))] += 30.0
    kw = dict(start_depth=220, window_meter=450, window_ping=100, percentile=25, delta_db=12,
              min_window=20, exact=exact)
    if varying_bottom:
        kw["bottom_depth"] = 560.0 - 80.0 * np.sin(np.arange(n_ping) / 25.0)
    got, want = t_core(sv, r, **kw), j_core(sv, r, **kw)
    np.testing.assert_array_equal(got, want)
    assert want.any()
