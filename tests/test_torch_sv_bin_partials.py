"""Port parity: the fused Sv + bin-partials step (K3 / K4) and its cores.

The plain PyTorch twins of the CUDA kernels (echopype_torch/ops/
sv_bin_partials.py) and the drop-in cores ``sv_mvbs_core_fused`` /
``mvbs_core_fused`` are held against the JAX package's Pallas kernels run
with ``interpret=True`` and against its XLA core ``sv_mvbs_core_mxu``, on
the same numpy inputs, with the JAX package's own tolerances
(tests/test_parallel.py:96-108 and 147-171): Sv within rtol 1e-5 /
atol 1e-5 with identical NaN masks, bin sums within rtol 1e-4 (K3) and
5e-4 (K4, whose ``exp(...) r_tvg^2`` form rounds differently), counts exact.
On poisoned rows (a valid sample whose linear value is not finite) the
twins' NaN / inf masks equal the Pallas kernels'.  A float64 model of the
K4 kernel's work split is held to the twin (counts exact, sums rtol 3e-6).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from echopype_torch.ops import sv_bin_partials as sbp
from echopype_torch.parallel import pipeline as tp
from echopype_tpu.ops import pallas_pipeline as jpp
from echopype_tpu.parallel import pipeline as jp

torch.set_num_threads(1)

SV_TOL = dict(rtol=1e-5, atol=1e-5)
K3_SUM_RTOL, K4_SUM_RTOL = 1e-4, 5e-4


def _np(t):
    return t.cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def make_inputs(case, seed=0):
    """tests/test_parallel.py::make_inputs, plus the edge case ``case``."""
    C, Pn, R = (2, 91, 256) if case == "p91" else (2, 64, 256)
    rng = np.random.default_rng(seed)
    power = rng.normal(-80, 10, (C, Pn, R)).astype("f4")
    dr = np.full((C, Pn), 0.19, dtype="f4")
    tvg = 2 * dr
    ab = np.full((C, Pn), 0.01, dtype="f4")
    off = rng.normal(-30, 2, (C, Pn)).astype("f4")
    n_x, n_r = 8, 5
    x_idx = (np.arange(Pn) * n_x // Pn).astype("i4")
    r_edges = np.arange(0, 30.0, 5.0, dtype="f4")
    power[0, 3, 200:] = np.nan  # a ragged ping
    if case == "interior_nan":
        power[rng.random(power.shape) < 0.05] = np.nan
        power[1, 10, :] = np.nan  # a whole NaN ping
    elif case == "outside_pings":
        x_idx[:5] = -1
        x_idx[-7:] = n_x
    elif case == "per_channel_dr":
        dr = np.tile(rng.uniform(0.15, 0.25, (C, 1)), (1, Pn)).astype("f4")
        # off the sample grid: at shift == n dr exactly the Pallas kernel in
        # interpret mode gets k dr - shift as one FMA (not 0 at k = n), which
        # moves its NaN mask by a sample against plain float32 arithmetic
        tvg = (dr * rng.uniform(0.5, 3.5, (C, 1))).astype("f4")
        ab = rng.uniform(0.001, 0.05, (C, Pn)).astype("f4")
    return power, dr, tvg, ab, off, x_idx, r_edges, n_x, n_r


CASES = ["ragged", "interior_nan", "outside_pings", "per_channel_dr", "p91"]


@pytest.fixture(autouse=True)
def _no_launches():
    """On the CPU the wrappers run their plain twins: no kernel launches."""
    sbp.reset_launches()
    yield
    assert sbp.LAUNCHES == {"sv_bin_partials": 0, "mvbs_partials": 0}


def _jax_bin_matrix(dr, r_edges, R):
    bounds = jnp.clip(jnp.ceil(jnp.asarray(r_edges)[None, :] / jnp.asarray(dr[:, 0])[:, None]), 0, R)
    r_ids = jnp.arange(R, dtype=jnp.float32)[None, :, None]
    return bounds, ((r_ids >= bounds[:, None, :-1]) & (r_ids < bounds[:, None, 1:])).astype(
        jnp.float32)


def _ops(power, dr, tvg, ab, off, r_edges):
    t = [torch.from_numpy(np.ascontiguousarray(a)) for a in (power, dr, tvg, ab, off)]
    bounds = torch.from_numpy(sbp.core_bounds_np(dr[:, 0], r_edges, power.shape[2]))
    return dict(zip(("power", "dr", "tvg_shift", "absorption", "offset"), t), bounds=bounds)


class TestPerPingPartials:
    """The twins against the Pallas kernels, ping by ping (no ping reduction)."""

    @pytest.mark.parametrize("case", ["ragged", "interior_nan", "per_channel_dr"])
    def test_k3_twin_matches_pallas(self, case):
        power, dr, tvg, ab, off, _, r_edges, _, _ = make_inputs(case)
        _, m = _jax_bin_matrix(dr, r_edges, power.shape[2])
        sv_p, s_p, n_p = jpp.sv_bin_partials_pallas(power, dr, tvg, ab, off, m, tile_p=8,
                                                    interpret=True)
        sv_t, s_t, n_t = sbp.sv_bin_partials(**_ops(power, dr, tvg, ab, off, r_edges))
        np.testing.assert_array_equal(np.isnan(_np(sv_t)), np.isnan(np.asarray(sv_p)))
        np.testing.assert_allclose(_np(sv_t), np.asarray(sv_p), **SV_TOL)
        np.testing.assert_array_equal(_np(n_t), np.asarray(n_p))
        np.testing.assert_allclose(_np(s_t), np.asarray(s_p), rtol=K3_SUM_RTOL, atol=1e-30)

    @pytest.mark.parametrize("case", ["ragged", "interior_nan", "per_channel_dr", "p91"])
    def test_k4_twin_matches_pallas(self, case):
        power, dr, tvg, ab, off, _, r_edges, _, _ = make_inputs(case)
        _, m = _jax_bin_matrix(dr, r_edges, power.shape[2])
        s_p, n_p = jpp.mvbs_partials_pallas(power, dr, tvg, ab, off, m, interpret=True)
        P = power.shape[1]
        s_t, n_t = sbp.mvbs_partials(**_ops(power, dr, tvg, ab, off, r_edges))
        np.testing.assert_array_equal(_np(n_t), np.asarray(n_p)[:, :P])
        np.testing.assert_allclose(_np(s_t), np.asarray(s_p)[:, :P], rtol=K4_SUM_RTOL, atol=1e-30)


def poison(case, power, off):
    """Rows whose valid samples have a non-finite linear value: 600 dB
    overflows ``exp`` to inf; a NaN offset makes every valid lin of K4 NaN
    (and every Sv of K3 NaN, so K3 drops those samples).  Bounds of
    make_inputs: bins [0, 27), [27, 53), [53, 79), [79, 106), [106, 132)
    at dr 0.19 m."""
    power, off = power.copy(), off.copy()
    if case == "inf_in_bin":
        power[0, 7, 40] = 600.0
    elif case == "inf_past_bins":
        power[1, 9, 200] = 600.0
    elif case == "two_infs":
        power[0, 11, 30] = 600.0
        power[0, 11, 90] = 600.0
        power[1, 12, 60] = power[1, 12, 61] = 600.0  # two in one bin
    elif case == "nan_offset":
        off[1, 4] = np.nan
        power[0, 2, 100] = 600.0  # with an inf elsewhere
    return power, off


POISON_CASES = ["inf_in_bin", "inf_past_bins", "two_infs", "nan_offset"]


def assert_same_nonfinite(got, want, rtol):
    """Equal NaN and inf masks, finite values within ``rtol``."""
    got, want = _np(got), np.asarray(want)
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_array_equal(np.isinf(got), np.isinf(want))
    fin = np.isfinite(want)
    np.testing.assert_allclose(got[fin], want[fin], rtol=rtol, atol=1e-30)


class TestNonFinite:
    """A valid sample with a non-finite linear value spreads as the Pallas
    kernels' band product spreads it: NaN in every other bin of its ping."""

    @pytest.mark.parametrize("case", POISON_CASES)
    def test_twins_match_pallas_on_poisoned_rows(self, case):
        power, dr, tvg, ab, off, _, r_edges, _, _ = make_inputs("ragged")
        power, off = poison(case, power, off)
        _, m = _jax_bin_matrix(dr, r_edges, power.shape[2])
        ops = _ops(power, dr, tvg, ab, off, r_edges)
        sv_p, s3_p, n3_p = jpp.sv_bin_partials_pallas(power, dr, tvg, ab, off, m, tile_p=8,
                                                      interpret=True)
        s4_p, n4_p = jpp.mvbs_partials_pallas(power, dr, tvg, ab, off, m, interpret=True)
        sv_t, s3_t, n3_t = sbp.sv_bin_partials(**ops)
        s4_t, n4_t = sbp.mvbs_partials(**ops)
        np.testing.assert_array_equal(np.isnan(_np(sv_t)), np.isnan(np.asarray(sv_p)))
        np.testing.assert_array_equal(_np(n3_t), np.asarray(n3_p))
        np.testing.assert_array_equal(_np(n4_t), np.asarray(n4_p))
        assert_same_nonfinite(s3_t, s3_p, K3_SUM_RTOL)
        assert_same_nonfinite(s4_t, s4_p, K4_SUM_RTOL)
        # the rule, ping by ping: the poisoned pings' other bins are NaN
        bad = ~np.isfinite(_np(s4_t)).all(axis=2)
        assert bad.any() and np.isfinite(_np(s4_t)[~bad]).all()

    def test_window_level_spread_is_pinned(self):
        """What the port's cores do past the ping: ``banded_x_reduce`` is a
        0/1 product over pings too, so one poisoned ping (inf in bin 1,
        ping window 0) leaves its own (window, bin) inf and makes every other
        window and bin of its channel NaN; the other channel stays finite.
        The JAX package's own ping-window paths disagree with one another
        here, so this is outside the accuracy contract; the test only makes
        a change visible."""
        power, dr, tvg, ab, off, x_idx, r_edges, n_x, n_r = make_inputs("ragged")
        power, off = poison("inf_in_bin", power, off)
        want_inf = np.zeros((n_x, n_r), bool)
        want_inf[x_idx[7], 1] = True
        _, s3, c3 = sbp.sv_mvbs_core_fused(power, dr, tvg, ab, off, x_idx, r_edges, n_x, n_r,
                                           device="cpu")
        s4, c4 = sbp.mvbs_core_fused(power, dr, tvg, ab, off, x_idx, r_edges, n_x, n_r,
                                     device="cpu")
        for s, c in ((s3, c3), (s4, c4)):
            s = _np(s)
            np.testing.assert_array_equal(np.isinf(s[0]), want_inf)
            np.testing.assert_array_equal(np.isnan(s[0]), ~want_inf)
            assert np.isfinite(s[1]).all() and np.isfinite(_np(c)).all()


# ------------------------------------------------- K4's work split, modelled
K4_VEC, K4_THREADS = 16, 256
K4_SEG = K4_VEC * K4_THREADS


def k4_lin_f32(power, dr, shift, ab, off):
    """K4's per-sample (valid, lin) in float32, as the kernel rounds them."""
    R = power.shape[2]
    r_tvg = np.arange(R, dtype="f4")[None, None, :] * dr[:, :, None] - shift[:, :, None]
    valid = (r_tvg > 0) & ~np.isnan(power)
    with np.errstate(over="ignore", invalid="ignore"):
        e = (power + (np.float32(2.0) * ab)[:, :, None] * r_tvg) + off[:, :, None]
        lin = np.exp(np.float32(sbp.LN10_OVER_10) * e) * (r_tvg * r_tvg)
    return valid, lin


def k4_model(power, dr, shift, ab, off, bounds):
    """Float64 model of csrc/sv_bin_partials.cu's K4 work split.

    Per channel, the two-region path where every non-empty bin is at least
    K4_VEC samples wide (each thread's run of K4_VEC samples split once at
    the next bound, two slot sums a row, then per bin the touching threads'
    slots in thread order), else the general path (per bin its samples in
    order); segments of K4_SEG samples added in order; then the non-finite
    rule from the row's first and last non-finite valid sample.  Returns
    (s1, n1, per-channel path flags).
    """
    C, P, R = power.shape
    n_r = bounds.shape[1] - 1
    valid, lin = k4_lin_f32(power, dr, shift, ab, off)
    bad = valid & ~np.isfinite(lin)
    v = np.where(valid, lin.astype("f8"), 0.0)
    s1, n1 = np.zeros((C, P, n_r)), np.zeros((C, P, n_r), "i8")
    paths = []
    for c in range(C):
        cb = np.clip(bounds[c].astype("i8"), 0, R)
        w = np.diff(cb)
        two = bool(np.all((w == 0) | (w >= K4_VEC)))
        paths.append(two)
        for seg0 in range(0, max(R, 1), K4_SEG):
            seg1 = min(R, seg0 + K4_SEG)
            k0 = seg0 + K4_VEC * np.arange(K4_THREADS)
            if two:
                j = np.searchsorted(cb, k0, side="right") - 1  # the last bound <= k0
                nxt = np.where(j < n_r, cb[np.minimum(j + 1, n_r)], np.iinfo("i8").max)
                jsplit = np.minimum(nxt - k0, K4_VEC)
                b0 = np.where((j >= 0) & (j < n_r), j, -1)
                ks = k0[:, None] + np.arange(K4_VEC)[None, :]
                inside = ks < R
                ksafe = np.minimum(ks, max(R - 1, 0))
                low = np.arange(K4_VEC)[None, :] < jsplit[:, None]
                for p in range(P):
                    vv = np.where(inside, v[c, p][ksafe], 0.0)
                    ok = inside & valid[c, p][ksafe]
                    slot_s = np.stack([np.where(low, vv, 0.0).sum(1),
                                       np.where(low, 0.0, vv).sum(1)])
                    slot_n = np.stack([(ok & low).sum(1), (ok & ~low).sum(1)])
                    for b in range(n_r):
                        lo, hi = max(cb[b], seg0), min(cb[b + 1], seg1)
                        for t in range((lo - seg0) // K4_VEC, (hi - 1 - seg0) // K4_VEC + 1
                                       if lo < hi else 0):
                            slot = 0 if b0[t] == b else 1
                            s1[c, p, b] += slot_s[slot, t]
                            n1[c, p, b] += slot_n[slot, t]
            else:
                for p in range(P):
                    for b in range(n_r):
                        lo, hi = max(cb[b], seg0), min(cb[b + 1], seg1)
                        for k in range(lo, hi):
                            s1[c, p, b] += v[c, p, k]
                            n1[c, p, b] += valid[c, p, k]
        for p in range(P):
            f = np.flatnonzero(bad[c, p])
            if f.size:
                out = (f.min() < cb[:-1]) | (f.max() >= cb[1:])
                s1[c, p, out] = np.nan
    return s1, n1, paths


def _k4_case(case, seed=3):
    """(power, dr, shift, ab, off, bounds) for the work-split model."""
    rng = np.random.default_rng(seed)
    C, P, R = 2, 3, {"r4001": 4001, "r9000": 9000}.get(case, 4000)
    power = rng.normal(-90, 12, (C, P, R)).astype("f4")
    power[:, 1, int(rng.integers(0, R)):] = np.nan  # a ragged NaN suffix
    power[rng.random(power.shape) < 0.01] = np.nan
    power[1, 2, :] = np.nan  # a whole NaN ping
    dr = np.full((C, P), 0.18944, "f4")
    shift = (dr * np.float32(2.3)).astype("f4")
    ab = rng.uniform(0.002, 0.05, (C, P)).astype("f4")
    off = rng.normal(-30, 2, (C, P)).astype("f4")
    edges = np.arange(0, R * 0.18944 + 20.0, 20.0).astype("f4")
    bounds = sbp.core_bounds_np(dr[:, 0], edges, R)  # 38 bins of ~105 samples
    if case == "narrow":  # channel 0: widths 0..20 (general path); channel 1 as is
        bounds[0] = 3 + np.concatenate([[0], np.cumsum(rng.integers(0, 21, 38))])
    elif case == "one_sample_bins":  # and samples of F before and past the bins
        b = np.concatenate([np.arange(100, 136), [600, 3000]])
        bounds = np.stack([b, b])
        power[0, 0, 50] = power[1, 0, 3500] = 600.0
    elif case == "clipped":  # edges past R: empty bins clipped at R, and an empty bin
        e = np.arange(0, R * 0.18944 + 200.0, 20.0).astype("f4")
        bounds = sbp.core_bounds_np(dr[:, 0], e, R)
        bounds[:, 3] = bounds[:, 2]
    elif case == "decreasing":  # general path: a bin with lo > hi is empty
        bounds[0, 5] = bounds[0, 7]
    elif case == "poisoned":
        power[0, 0, 500] = 600.0
        power[0, 2, 3999] = 600.0  # the last sample
        off[1, 1] = np.nan
    return power, dr, shift, ab, off, bounds.astype("i4")


class TestK4WorkSplit:
    """The new K4's decomposition, modelled in float64, equals the twin."""

    @pytest.mark.parametrize("case", ["wide", "narrow", "one_sample_bins", "clipped",
                                      "decreasing", "r4001", "r9000", "poisoned"])
    def test_model_equals_twin(self, case):
        args = _k4_case(case)
        s_m, n_m, paths = k4_model(*args)
        t = [torch.from_numpy(np.ascontiguousarray(a)) for a in args]
        s_t, n_t = (_np(x).astype("f8") for x in sbp.mvbs_partials_plain(*t))
        np.testing.assert_array_equal(n_m, n_t)
        assert_same_nonfinite(s_m, s_t, 3e-6)
        want_two = {"narrow": [False, True], "one_sample_bins": [False, False],
                    "decreasing": [False, True]}.get(case, [True, True])
        assert paths == want_two
        if case in ("poisoned", "one_sample_bins"):
            assert np.isnan(s_m).any()


class TestFusedCores:
    @pytest.mark.parametrize("case", CASES)
    def test_sv_core_matches_pallas_and_mxu(self, case):
        args = make_inputs(case)
        sv_t, s_t, c_t = sbp.sv_mvbs_core_fused(*args, device="cpu")
        sv_p, s_p, c_p = jpp.sv_mvbs_core_pallas(*args, tile_p=8, interpret=True)
        sv_x, s_x, c_x = jp.sv_mvbs_core_mxu(*[jnp.asarray(a) for a in args[:7]], *args[7:])
        for sv_ref, s_ref, c_ref in ((sv_p, s_p, c_p), (sv_x, s_x, c_x)):
            np.testing.assert_array_equal(np.isnan(_np(sv_t)), np.isnan(np.asarray(sv_ref)))
            np.testing.assert_allclose(_np(sv_t), np.asarray(sv_ref), **SV_TOL)
            np.testing.assert_array_equal(_np(c_t), np.asarray(c_ref))
            np.testing.assert_allclose(_np(s_t), np.asarray(s_ref), rtol=K3_SUM_RTOL, atol=1e-6)

    @pytest.mark.parametrize("case", CASES)
    def test_mvbs_core_matches_pallas_and_mxu(self, case):
        args = make_inputs(case)
        s_t, c_t = sbp.mvbs_core_fused(*args, device="cpu")
        s_p, c_p = jpp.mvbs_core_pallas(*args, interpret=True)
        _, s_x, c_x = jp.sv_mvbs_core_mxu(*[jnp.asarray(a) for a in args[:7]], *args[7:])
        for s_ref, c_ref in ((s_p, c_p), (s_x, c_x)):
            np.testing.assert_array_equal(_np(c_t), np.asarray(c_ref))
            np.testing.assert_allclose(_np(s_t), np.asarray(s_ref), rtol=K4_SUM_RTOL, atol=1e-6)

    @pytest.mark.parametrize("case", CASES)
    def test_plain_cores_match_jax(self, case):
        """The port's plain ``sv_mvbs_core_mxu`` / ``sv_mvbs_core`` against
        the JAX package's (tests/test_parallel.py:66-75 tolerances)."""
        args = make_inputs(case)
        jargs = (*[jnp.asarray(a) for a in args[:7]], *args[7:])
        for port, ref in ((tp.sv_mvbs_core_mxu, jp.sv_mvbs_core_mxu),
                          (tp.sv_mvbs_core, jp.sv_mvbs_core)):
            sv_t, s_t, c_t = port(*args, device="cpu")
            sv_j, s_j, c_j = ref(*jargs)
            np.testing.assert_array_equal(np.isnan(_np(sv_t)), np.isnan(np.asarray(sv_j)))
            np.testing.assert_allclose(_np(sv_t), np.asarray(sv_j), rtol=1e-6, atol=1e-6)
            np.testing.assert_array_equal(_np(c_t), np.asarray(c_j))
            np.testing.assert_allclose(_np(s_t), np.asarray(s_j), rtol=1e-5, atol=1e-7)

    def test_k3_and_k4_agree(self):
        """K4's MVBS-only formula against K3's (the drop-in relation)."""
        args = make_inputs("interior_nan", seed=5)
        _, s3, c3 = sbp.sv_mvbs_core_fused(*args, device="cpu")
        s4, c4 = sbp.mvbs_core_fused(*args, device="cpu")
        np.testing.assert_array_equal(_np(c4), _np(c3))
        np.testing.assert_allclose(_np(s4), _np(s3), rtol=K4_SUM_RTOL)

    def test_tensor_inputs_equal_numpy_inputs(self):
        args = make_inputs("ragged", seed=2)
        want = sbp.sv_mvbs_core_fused(*args, device="cpu")
        got = sbp.sv_mvbs_core_fused(*[torch.from_numpy(a) for a in args[:7]], *args[7:],
                                     device="cpu")
        for g, w in zip(got, want):
            assert torch.equal(torch.nan_to_num(g, nan=-1.0), torch.nan_to_num(w, nan=-1.0))


class TestHostBounds:
    def test_core_bounds_bit_identical(self):
        rng = np.random.default_rng(21)
        for _ in range(10):
            C, R = int(rng.integers(1, 5)), int(rng.integers(10, 4000))
            dr0 = rng.uniform(0.05, 0.4, C).astype("f4")
            edges = (np.arange(int(rng.integers(2, 60))) * float(rng.uniform(1.0, 8.0))).astype("f4")
            want = jnp.clip(jnp.ceil(jnp.asarray(edges)[None, :] / jnp.asarray(dr0)[:, None]), 0, R)
            np.testing.assert_array_equal(sbp.core_bounds_np(dr0, edges, R),
                                          np.asarray(want).astype("i4"))

    def test_ping_bounds(self):
        x_idx = np.array([-1, -1, 0, 0, 2, 2, 2, 3, 5, 5], "i4")
        want = jnp.searchsorted(jnp.asarray(x_idx), jnp.arange(5, dtype=jnp.int32), side="left")
        np.testing.assert_array_equal(sbp.ping_bounds_np(x_idx, 4), np.asarray(want))
        with pytest.raises(ValueError, match="non-decreasing"):
            sbp.ping_bounds_np(x_idx[::-1], 4)


class TestDispatch:
    def test_other_devices_raise(self):
        power, dr, tvg, ab, off, _, r_edges, _, _ = make_inputs("ragged")
        meta = {k: v.to("meta") for k, v in _ops(power, dr, tvg, ab, off, r_edges).items()}
        for fn in (sbp.sv_bin_partials, sbp.mvbs_partials):
            with pytest.raises(ValueError, match="cuda or cpu"):
                fn(**meta)

    def test_n_r_mismatch_raises(self):
        args = list(make_inputs("ragged"))
        args[8] += 1
        with pytest.raises(ValueError, match="n_r"):
            sbp.sv_mvbs_core_fused(*args, device="cpu")

    def test_cuda_request_without_cuda_raises(self):
        if torch.cuda.is_available():
            pytest.skip("a CUDA device is present; this checks the no-fallback rule")
        with pytest.raises(RuntimeError, match="cuda"):
            sbp.mvbs_core_fused(*make_inputs("ragged"))
