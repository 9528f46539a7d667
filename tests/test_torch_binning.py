"""Port parity: the public binning names of ``ops/binning.py`` that no survey
path runs, and the ``block_g`` route of the uniform window step.

Same numpy inputs through the JAX package (its CPU backend) and the port
(``device="cpu"`` tensors).  Tolerances:

* ``blocked_banded_segment_sum``: exactly equal to the JAX result and to a
  loop oracle on integer-valued data (tests/test_parallel.py:324-350);
  rtol 3e-6 against JAX on random float data;
* ``choose_block_g``, ``row_bin_bounds``: identical;
* ``binned_sum_partials`` / ``binned_sum_raw``: counts and NaN counts exact;
  sums within rtol 1e-5 of JAX on data spanning at most 20 dB, and within
  rtol 1e-6 of a float64 numpy oracle everywhere (the JAX float32 prefix
  sums lose a quiet bin after loud samples, pinned below);
* ``binned_mean_linear``: within 1e-4 dB of JAX (tests/test_parallel.py:64)
  on data spanning 20 dB and of the float64 oracle within 1e-5 dB on 40 dB,
  identical NaN masks;
* ``binned_mean_1d``: rtol 1e-6, empty bins NaN;
* ``sv_mvbs_window_partials_uniform(block_g=8)``: the bits of the port's
  ``block_g=0``; counts exact and sums rtol 3e-6 against the JAX
  ``block_g=8`` (tests/test_parallel.py:363-385).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from echopype_torch.ops import binning as tb
from echopype_torch.parallel import pipeline as tp
from echopype_tpu.ops import binning as jb
from echopype_tpu.parallel import pipeline as jp

torch.set_num_threads(1)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _loop_segment_sums(vals, b):
    C, P, _ = vals.shape
    n_r = b.shape[1] - 1
    want = np.zeros((C, P, n_r))
    for c in range(C):
        for k in range(n_r):
            want[c, :, k] = vals[c, :, int(b[c, k]):int(b[c, k + 1])].sum(axis=-1)
    return want


def _random_segments(rng, trial, vals_fn):
    C, P = int(rng.integers(1, 4)), int(rng.integers(1, 7))
    N, n_r = int(rng.integers(20, 300)), int(rng.integers(1, 10))
    vals = vals_fn(rng, (C, P, N))
    b = np.sort(rng.integers(0, N + 1, (C, n_r + 1)), axis=1).astype("f8")
    if trial % 4 == 0:
        b[:, 0], b[:, -1] = 0.0, N  # aligned ends + clipped tails
    return vals, b, N, n_r


class TestBlockedBandedSegmentSum:
    def test_integer_exact_property(self):
        rng = np.random.default_rng(1)
        ran = 0
        for trial in range(60):
            vals, b, N, n_r = _random_segments(
                rng, trial, lambda r, s: r.integers(0, 64, s).astype("f4"))  # exact in f32
            G = tb.choose_block_g(b, N)
            if G == 0:
                continue
            ran += 1
            got = tb.blocked_banded_segment_sum(_t(vals), _t(b.astype("f4")), n_r, G).numpy()
            want = np.asarray(jb.blocked_banded_segment_sum(
                jnp.asarray(vals), jnp.asarray(b.astype("f4")), n_r, G))
            np.testing.assert_array_equal(got, want)
            np.testing.assert_array_equal(got, _loop_segment_sums(vals, b))
            # a smaller block is valid too, also one not a power of two
            odd = tb.blocked_banded_segment_sum(_t(vals), _t(b.astype("f4")), n_r, G - 1)
            np.testing.assert_array_equal(odd.numpy(), want)
        assert ran >= 15  # the guard must admit a healthy fraction

    def test_random_floats_match_jax(self):
        rng = np.random.default_rng(2)
        ran = 0
        for trial in range(60):
            vals, b, N, n_r = _random_segments(
                rng, trial, lambda r, s: r.uniform(0.0, 1.0, s).astype("f4"))
            G = tb.choose_block_g(b, N)
            if G == 0:
                continue
            ran += 1
            got = tb.blocked_banded_segment_sum(_t(vals), _t(b.astype("f4")), n_r, G).numpy()
            want = np.asarray(jb.blocked_banded_segment_sum(
                jnp.asarray(vals), jnp.asarray(b.astype("f4")), n_r, G))
            assert got.dtype == np.float32
            np.testing.assert_allclose(got, want, rtol=3e-6, atol=1e-30)
        assert ran >= 15

    def test_quiet_bin_after_loud_samples_in_one_block(self):
        """The JAX decomposition takes a bin's left part as block sum less the
        block's left partial; the port sums each bin on its own, so a quiet
        bin that shares its first block with loud samples keeps its
        precision."""
        G, N = 64, 256
        vals = np.full((1, 1, N), 1e-3, "f4")
        vals[..., :100] = 1e6  # bin 0 loud, bin 1 starts inside block 1
        b = np.array([[0.0, 100.0, 256.0]])
        assert tb.choose_block_g(b, N) == G
        want = _loop_segment_sums(vals.astype("f8"), b)
        got = tb.blocked_banded_segment_sum(_t(vals), _t(b.astype("f4")), 2, G).numpy()
        jax = np.asarray(jb.blocked_banded_segment_sum(
            jnp.asarray(vals), jnp.asarray(b.astype("f4")), 2, G))
        np.testing.assert_allclose(got, want, rtol=1e-6)
        assert abs(jax[0, 0, 1] / want[0, 0, 1] - 1.0) > 1e-2  # pinned

    @pytest.mark.parametrize("G", [0, 65])
    def test_block_breaking_the_rule_raises(self, G):
        b = np.array([[0.0, 100.0, 164.0, 256.0]])  # spacings 100, 64, 92
        assert tb.choose_block_g(b, 256) == 64
        with pytest.raises(ValueError, match="two bin boundaries"):
            tb.blocked_banded_segment_sum(_t(np.ones((1, 1, 256), "f4")), _t(b), 3, G)


def test_choose_block_g():
    # tests/test_parallel.py:352-361
    assert tb.choose_block_g(np.arange(0, 400, 80, dtype="f8")[None], 400) == 64
    assert tb.choose_block_g(np.array([[0.0, 3.0, 300.0]]), 300) == 0
    assert tb.choose_block_g(np.array([[0.0, 64.0, 64.0, 300.0]]), 300) == 64
    rng = np.random.default_rng(3)
    seen = set()
    for _ in range(200):
        N = int(rng.integers(10, 2000))
        b = np.sort(rng.integers(-5, N + 20, (int(rng.integers(1, 4)), int(rng.integers(2, 12)))),
                    axis=1).astype("f8")
        g_max = int(rng.choice([16, 64, 128]))
        got = tb.choose_block_g(b, N, g_max)
        assert got == jb.choose_block_g(b, N, g_max)
        seen.add(got)
    assert 0 in seen and len(seen) >= 3


@pytest.mark.parametrize("closed", ["left", "right"])
def test_row_bin_bounds(closed):
    rng = np.random.default_rng(4)
    er = np.cumsum(rng.uniform(0.1, 0.3, (2, 6, 50)), axis=2).astype("f4")
    er[0, 1, 30:] = np.nan  # ragged suffix
    er[1, 2, 45:] = np.nan
    er[1, 4] = np.nan  # a whole row
    er[0, 3, 10] = er[0, 3, 9]  # a repeated value on an edge's side
    edges = np.linspace(0.0, 10.0, 11).astype("f4")
    edges[3] = er[0, 3, 9]  # an edge exactly on a sample
    got = tb.row_bin_bounds(_t(er), _t(edges), closed).numpy()
    want = np.asarray(jb.row_bin_bounds(jnp.asarray(er), jnp.asarray(edges), closed))
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, want)


def _sv_grid(seed, lo_db, hi_db, C=2, P=40, R=60, vary=True):
    """Sv [C, P, R] uniform in [lo_db, hi_db] dB, echo_range by ping when
    ``vary`` (NaN suffixes on a few pings), and x bounds with pings outside
    the first and last bins."""
    rng = np.random.default_rng(seed)
    sv = rng.uniform(lo_db, hi_db, (C, P, R)).astype("f4")
    sv[0, 5, 7] = sv[1, 20, 33] = np.nan
    dr = rng.uniform(0.18, 0.22, (C, P, 1)) if vary else np.full((C, 1, 1), 0.2)
    er = (np.arange(R) * dr * np.ones((C, P, 1))).astype("f4")
    er[0, 11, 50:] = np.nan
    er[1, 30, 41:] = np.nan
    x_bounds = np.array([3, 9, 17, 18, 30, 37], "i4")  # one empty-ish bin, pings cut both ends
    r_edges = np.arange(0.0, 12.5, 1.5).astype("f4")
    return sv, er, r_edges, x_bounds


def _oracle(values, er, r_edges, x_bounds, lin, skipna=True, closed="left"):
    """float64 numpy sums / counts / NaN counts per (channel, x bin, range bin)."""
    C, P, R = values.shape
    n_x, n_r = len(x_bounds) - 1, len(r_edges) - 1
    e = np.asarray(r_edges, "f8")
    idx = np.searchsorted(e, er.astype("f8"), side="right" if closed == "left" else "left") - 1
    inr = (idx >= 0) & (idx < n_r) & ~np.isnan(er)
    xi = np.searchsorted(np.asarray(x_bounds), np.arange(P), side="right") - 1
    out = [np.zeros((C, n_x, n_r)) for _ in range(3)]
    v64 = values.astype("f8")
    v64 = 10.0 ** (v64 / 10.0) if lin else v64
    for c in range(C):
        for p in range(P):
            if not 0 <= xi[p] < n_x:
                continue
            for r in range(R):
                if not inr[c, p, r]:
                    continue
                k = (c, xi[p], idx[c, p, r])
                if np.isnan(values[c, p, r]):
                    out[2][k] += 1
                else:
                    out[0][k] += v64[c, p, r]
                    out[1][k] += 1
    return out


@pytest.mark.parametrize("vary", [True, False], ids=["by_ping", "uniform"])
@pytest.mark.parametrize("skipna", [True, False])
@pytest.mark.parametrize("closed", ["left", "right"])
def test_binned_sum_partials(vary, skipna, closed):
    sv, er, r_edges, x_bounds = _sv_grid(5, -70.0, -50.0, vary=vary)  # 20 dB of data
    got = [t.numpy() for t in tb.binned_sum_partials(_t(sv), _t(er), _t(r_edges), x_bounds,
                                                     skipna, closed)]
    want = [np.asarray(a) for a in jb.binned_sum_partials(
        jnp.asarray(sv), jnp.asarray(er), jnp.asarray(r_edges), jnp.asarray(x_bounds),
        skipna, closed)]
    assert got[0].dtype == np.float64 and got[0].shape == want[0].shape
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_array_equal(got[2], want[2])
    np.testing.assert_allclose(got[0], want[0], rtol=1e-5, atol=1e-30)
    oracle = _oracle(sv, er, r_edges, x_bounds, lin=True, skipna=skipna, closed=closed)
    np.testing.assert_allclose(got[0], oracle[0], rtol=1e-6, atol=1e-30)
    np.testing.assert_array_equal(got[1], oracle[1])
    np.testing.assert_array_equal(got[2], oracle[2] if not skipna else 0.0)
    assert (got[1] > 0).sum() > 0.5 * got[1].size


def test_binned_sum_raw():
    sv, er, r_edges, x_bounds = _sv_grid(6, -70.0, -50.0)
    vals = (10.0 ** (sv / 10.0)).astype("f4")  # a raw integrand of similar spread
    got = tb.binned_sum_raw(_t(vals), _t(er), _t(r_edges), x_bounds).numpy()
    want = np.asarray(jb.binned_sum_raw(jnp.asarray(vals), jnp.asarray(er),
                                        jnp.asarray(r_edges), jnp.asarray(x_bounds)))
    assert got.dtype == np.float64
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-30)
    oracle = _oracle(vals, er, r_edges, x_bounds, lin=False)[0]
    np.testing.assert_allclose(got, oracle, rtol=1e-6, atol=1e-30)


def test_quiet_bin_after_loud_samples():
    """A quiet range bin after loud samples (and a quiet ping bin after loud
    pings): the port holds the float64 oracle, the JAX float32 prefix sums
    lose the bin (pinned, as tests/test_torch_survey_sv.py pins the JAX
    streamers)."""
    sv, er, r_edges, x_bounds = _sv_grid(7, -70.0, -50.0)
    sv[:, :, :25] = 0.0  # loud near range
    sv[:, :, 25:] = -110.0  # quiet deep range
    sv[:, :17, :] = 10.0  # the first two ping bins louder still
    got = [t.numpy() for t in tb.binned_sum_partials(_t(sv), _t(er), _t(r_edges), x_bounds)]
    jax = np.asarray(jb.binned_sum_partials(jnp.asarray(sv), jnp.asarray(er),
                                            jnp.asarray(r_edges), jnp.asarray(x_bounds))[0])
    oracle = _oracle(sv, er, r_edges, x_bounds, lin=True)
    np.testing.assert_allclose(got[0], oracle[0], rtol=1e-6, atol=1e-30)
    quiet = oracle[1] > 0
    quiet &= oracle[0] < 1e-9 * oracle[1]
    assert quiet.any()
    assert np.max(np.abs(jax[quiet] / oracle[0][quiet] - 1.0)) > 1e-2
    raw = tb.binned_sum_raw(_t((10.0 ** (sv / 10.0)).astype("f4")), _t(er), _t(r_edges),
                            x_bounds).numpy()
    np.testing.assert_allclose(raw, oracle[0], rtol=1e-6, atol=1e-30)


@pytest.mark.parametrize("skipna", [True, False])
def test_binned_mean_linear(skipna):
    sv, er, r_edges, x_bounds = _sv_grid(8, -70.0, -50.0)
    got = tb.binned_mean_linear(_t(sv), _t(er), _t(r_edges), x_bounds, skipna).numpy()
    want = np.asarray(jb.binned_mean_linear(jnp.asarray(sv), jnp.asarray(er),
                                            jnp.asarray(r_edges), jnp.asarray(x_bounds), skipna))
    assert got.dtype == np.float64
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0, equal_nan=True)
    # on 40 dB of data against the float64 oracle, with its NaN rule: empty
    # bins, and with skipna=False any bin holding a NaN Sv
    sv, er, r_edges, x_bounds = _sv_grid(8, -80.0, -40.0)
    got = tb.binned_mean_linear(_t(sv), _t(er), _t(r_edges), x_bounds, skipna).numpy()
    s, c, n = _oracle(sv, er, r_edges, x_bounds, lin=True, skipna=skipna)
    bad = (c == 0) | ((n > 0) if not skipna else False)
    np.testing.assert_array_equal(np.isnan(got), bad)
    with np.errstate(invalid="ignore", divide="ignore"):
        np.testing.assert_allclose(got, 10.0 * np.log10(np.where(bad, np.nan, s / c)),
                                   atol=1e-5, rtol=0, equal_nan=True)
    assert (n > 0).any() and np.isfinite(got).any()


def test_binned_mean_1d():
    rng = np.random.default_rng(9)
    P, n_x = 80, 9
    values = rng.normal(45.0, 0.01, P)
    values[[3, 4, 40]] = np.nan
    x_idx = np.sort(rng.integers(-1, n_x + 2, P))
    x_idx[(x_idx == 5)] = 6  # bin 5 empty
    got = tb.binned_mean_1d(_t(values), _t(x_idx), n_x).numpy()
    want = np.asarray(jb.binned_mean_1d(jnp.asarray(values.astype("f4")), jnp.asarray(x_idx),
                                        n_x))
    ok = (x_idx >= 0) & (x_idx < n_x) & ~np.isnan(values)
    s = np.bincount(x_idx[ok], weights=values[ok], minlength=n_x)
    n = np.bincount(x_idx[ok], minlength=n_x)
    with np.errstate(invalid="ignore"):
        oracle = s / n
    assert got.dtype == np.float64 and np.isnan(got[5])
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_allclose(got, want, rtol=1e-6, equal_nan=True)
    np.testing.assert_allclose(got, oracle, rtol=1e-12, equal_nan=True)


def test_uniform_window_step_block_g():
    """tests/test_parallel.py:363-385 on the port: ``block_g=8`` gives the
    bits of ``block_g=0`` (K1's twin whatever ``block_g``), within 3e-6 of
    the JAX ``block_g=8``."""
    rng = np.random.default_rng(5)
    C, Pn, R, n_r, W = 3, 48, 260, 6, 4
    power = rng.integers(-12000, -2000, (C, Pn, R)).astype(np.int16)
    dr = np.tile(rng.uniform(0.15, 0.25, (C, 1)).astype("f4"), (1, Pn))
    tvg = 2 * dr
    ab = np.full((C, Pn), 0.01, "f4")
    off = rng.normal(-30, 2, (C, Pn)).astype("f4")
    vl = rng.integers(R - 10, R + 1, (C, Pn)).astype("i4")
    x_rel = np.sort(rng.integers(0, W, Pn)).astype("i4")
    r_edges = np.linspace(0, 0.25 * R, n_r + 1).astype("f4")
    args = (power, dr, tvg, ab, off, vl, x_rel, r_edges)
    bounds = tp.closed_bounds_k0_np(dr[:, 0], tvg[:, 0], r_edges, R)[0]
    assert tb.choose_block_g(bounds, R) >= 8
    s0, c0 = tp.sv_mvbs_window_partials_uniform(*args, W, n_r, device="cpu")
    s1, c1 = tp.sv_mvbs_window_partials_uniform(*args, W, n_r, 8, device="cpu")
    sj, cj = jp.sv_mvbs_window_partials_uniform(*[jnp.asarray(a) for a in args], W, n_r,
                                                block_g=8)
    assert torch.equal(c1, c0) and torch.equal(s1, s0)
    np.testing.assert_array_equal(c1.numpy(), np.asarray(cj))
    np.testing.assert_allclose(s1.numpy(), np.asarray(sj), rtol=3e-6, atol=1e-30)
    sums_only = tp.sv_mvbs_window_partials_uniform(*args, W, n_r, 8, False, device="cpu")
    assert torch.equal(sums_only, s1)
