"""Port parity: the fused Sv + bin-partials step (K3 / K4) and its cores.

The plain PyTorch twins of the CUDA kernels (echopype_torch/ops/
sv_bin_partials.py) and the drop-in cores ``sv_mvbs_core_fused`` /
``mvbs_core_fused`` are held against the JAX package's Pallas kernels run
with ``interpret=True`` and against its XLA core ``sv_mvbs_core_mxu``, on
the same numpy inputs, with the JAX package's own tolerances
(tests/test_parallel.py:96-108 and 147-171): Sv within rtol 1e-5 /
atol 1e-5 with identical NaN masks, bin sums within rtol 1e-4 (K3) and
5e-4 (K4, whose ``exp(...) r_tvg^2`` form rounds differently), counts exact.
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
