"""Port parity: the full survey-processing step on one device.

``echopype_torch.parallel.survey_pipeline_step`` / ``sharded_sv_mvbs_step``
(K3 with Sv, K4 without, ``sv_mvbs_core`` for ping-varying ``dr``; plain
twins on the CPU) against the JAX step on a one-device mesh
(``make_mesh(n_devices=1, channel_axis=1)``, tests/test_parallel.py:34) and
against the composed path the JAX package holds it to: ``ek_power_cal``
then ``binning.binned_mean_linear`` (tests/test_parallel.py:46-64).
Tolerances are the JAX tests': Sv rtol / atol 1e-5 with identical NaN
masks, MVBS within 1e-4 (1e-6 between the step with and without Sv in the
JAX package; here K4's formula rounds differently from K3's, so 1e-3 dB).

The last class runs ``chip_smoke.py``'s Sv-grid recipe at its dr and bins
on a small synthetic EK60 file: ``compute_Sv`` -> ``compute_MVBS`` against
the step fed from the same calibration inputs.  Range-bin membership is
fixed on the host in both forms, so they must agree here before the card
holds them to the same tolerance.
"""

import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import echopype_torch as et
from echopype_torch.ops import sv_bin_partials as sbp
from echopype_torch.parallel import pipeline as tp
from echopype_tpu.ops import binning as jb
from echopype_tpu.ops.calibration import ek_power_cal
from echopype_tpu.parallel import make_mesh, sharded_sv_mvbs_step
from echopype_tpu.parallel import pipeline as tp_jax

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))
sys.path.insert(0, str(REPO / "tests"))

import chip_smoke  # noqa: E402
from synth_ek60 import write_ek60_raw  # noqa: E402

torch.set_num_threads(1)

SV_TOL = dict(rtol=1e-5, atol=1e-5)
MVBS_TOL = dict(rtol=1e-4, atol=1e-4)


def _np(t):
    return t.cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def make_inputs(seed=0, ragged=True, outside=False):
    """tests/test_parallel.py::make_inputs (C=2, 64 pings, 128 samples)."""
    rng = np.random.default_rng(seed)
    C, Pn, R = 2, 64, 128
    power = rng.normal(-80, 10, (C, Pn, R)).astype("f4")
    dr = np.full((C, Pn), 0.19, dtype="f4")
    tvg = 2 * dr
    ab = np.full((C, Pn), 0.01, dtype="f4")
    off = rng.normal(-30, 2, (C, Pn)).astype("f4")
    n_x, n_r = 8, 5
    x_idx = (np.arange(Pn) // (Pn // n_x)).astype("i4")
    r_edges = np.arange(0, 30.0, 5.0, dtype="f4")
    if ragged:
        power[0, 3, 90:] = np.nan
        power[1, 17, 40:] = np.nan
    if outside:
        x_idx[:3] = -1
        x_idx[-5:] = n_x
    return power, dr, tvg, ab, off, x_idx, r_edges, n_x, n_r


@pytest.fixture(scope="module")
def mesh1():
    return make_mesh(n_devices=1, channel_axis=1)


@pytest.fixture(autouse=True)
def _no_launches():
    sbp.reset_launches()
    yield
    assert sbp.LAUNCHES == {"sv_bin_partials": 0, "mvbs_partials": 0}


class TestStepAgainstJax:
    @pytest.mark.parametrize("outside", [False, True], ids=["all_in", "pings_outside"])
    @pytest.mark.parametrize("with_sv", [True, False], ids=["k3", "k4"])
    def test_survey_pipeline_step(self, mesh1, with_sv, outside):
        power, dr, tvg, ab, off, x_idx, r_edges, n_x, n_r = make_inputs(outside=outside)
        args = (power, dr, tvg, ab, off, x_idx, r_edges)
        got = et.survey_pipeline_step(None, n_x, n_r, with_sv=with_sv, device="cpu")(*args)
        want = sharded_sv_mvbs_step(mesh1, n_x, n_r, with_sv=with_sv)(*args)
        if with_sv:
            (sv_t, got), (sv_j, want) = got, want
            np.testing.assert_array_equal(np.isnan(_np(sv_t)), np.isnan(np.asarray(sv_j)))
            np.testing.assert_allclose(_np(sv_t), np.asarray(sv_j), **SV_TOL)
        np.testing.assert_array_equal(np.isnan(_np(got)), np.isnan(np.asarray(want)))
        np.testing.assert_allclose(_np(got), np.asarray(want), **MVBS_TOL)

    def test_per_ping_dr_step(self, mesh1):
        """uniform_dr=False runs ``sv_mvbs_core`` (dr varying by ping)."""
        power, dr, tvg, ab, off, x_idx, r_edges, n_x, n_r = make_inputs(seed=4)
        dr = (dr * np.random.default_rng(4).uniform(0.97, 1.03, dr.shape)).astype("f4")
        args = (power, dr, tvg, ab, off, x_idx, r_edges)
        sv_t, m_t = tp.sharded_sv_mvbs_step(None, n_x, n_r, uniform_dr=False, device="cpu")(*args)
        sv_j, m_j = sharded_sv_mvbs_step(mesh1, n_x, n_r, uniform_dr=False)(*args)
        np.testing.assert_allclose(_np(sv_t), np.asarray(sv_j), **SV_TOL)
        np.testing.assert_array_equal(np.isnan(_np(m_t)), np.isnan(np.asarray(m_j)))
        np.testing.assert_allclose(_np(m_t), np.asarray(m_j), **MVBS_TOL)

    def test_matches_composed_calibration_and_binning(self):
        """tests/test_parallel.py:46-64: the fused step equals the standalone
        calibration + binning of the JAX package."""
        power, dr, tvg, ab, off, x_idx, r_edges, n_x, n_r = make_inputs(ragged=False)
        sv, mvbs = et.survey_pipeline_step(None, n_x, n_r, device="cpu")(
            power, dr, tvg, ab, off, x_idx, r_edges)
        sv_ref, er_ref = ek_power_cal(power, dr, tvg, ab, off, "Sv")
        x_bounds = jb.x_bounds_np(x_idx, np.arange(n_x + 1))
        mvbs_ref = np.asarray(jb.binned_mean_linear(
            sv_ref.astype("f4"), er_ref.astype("f4"), np.asarray(r_edges, "f4"), x_bounds))
        np.testing.assert_allclose(_np(sv), sv_ref, **SV_TOL)
        np.testing.assert_allclose(_np(mvbs), mvbs_ref, **MVBS_TOL)

    def test_with_and_without_sv_agree(self):
        args = make_inputs(seed=9)
        _, full = et.survey_pipeline_step(None, *args[7:], device="cpu")(*args[:7])
        lean = et.survey_pipeline_step(None, *args[7:], with_sv=False, device="cpu")(*args[:7])
        np.testing.assert_array_equal(np.isnan(_np(lean)), np.isnan(_np(full)))
        np.testing.assert_allclose(_np(lean), _np(full), rtol=0, atol=1e-3)

    def test_tensor_inputs(self):
        power, dr, tvg, ab, off, x_idx, r_edges, n_x, n_r = make_inputs(seed=2)
        step = et.survey_pipeline_step(None, n_x, n_r, device="cpu")
        sv_a, m_a = step(power, dr, tvg, ab, off, x_idx, r_edges)
        sv_b, m_b = step(*[torch.from_numpy(a) for a in (power, dr, tvg, ab, off, x_idx, r_edges)])
        assert torch.equal(sv_a.view(torch.int32), sv_b.view(torch.int32))
        assert torch.equal(m_a.view(torch.int32), m_b.view(torch.int32))


class TestMeshes:
    def test_one_device_mesh_accepted(self, mesh1):
        """The port's one-device mesh equals ``mesh=None`` bit for bit; a JAX
        mesh is refused (the port drives only its own meshes)."""
        args = make_inputs(seed=3)
        one = et.parallel.make_mesh(devices=["cpu"])
        _, m1 = et.survey_pipeline_step(one, *args[7:])(*args[:7])
        _, m0 = et.survey_pipeline_step(None, *args[7:], device="cpu")(*args[:7])
        np.testing.assert_array_equal(_np(m1), _np(m0))
        with pytest.raises(TypeError, match="make_mesh"):
            et.survey_pipeline_step(mesh1, *args[7:], device="cpu")

    @pytest.mark.parametrize("kw", [dict(n_devices=4, channel_axis=1),
                                    dict(n_devices=8, channel_axis=2, range_axis=2)],
                             ids=["ping_channel", "ping_channel_range"])
    def test_multi_device_meshes_raise(self, kw):
        """Multi-device meshes run: the port's mesh of repeated CPU devices
        against ``mesh=None`` and the JAX step on the same layout
        (tests/test_parallel.py:110-123 tolerances); a JAX mesh raises."""
        power, dr, tvg, ab, off, x_idx, r_edges, n_x, n_r = make_inputs(seed=6)
        args = (power, dr, tvg, ab, off, x_idx, r_edges)
        mesh = et.parallel.make_mesh(devices=["cpu"] * kw["n_devices"], **kw)
        sv_m, m_m = et.survey_pipeline_step(mesh, n_x, n_r)(*args)
        sv_0, m_0 = tp.sharded_sv_mvbs_step(None, n_x, n_r, device="cpu")(*args)
        jax_mesh = make_mesh(**kw)
        step_j = (tp_jax.sharded_sv_mvbs_step_3d(jax_mesh, n_x, n_r) if "range_axis" in kw
                  else sharded_sv_mvbs_step(jax_mesh, n_x, n_r))
        sv_j, m_j = step_j(*args)
        for sv in (sv_0, sv_j):
            np.testing.assert_array_equal(np.isnan(_np(sv_m)), np.isnan(_np(sv)))
            np.testing.assert_allclose(_np(sv_m), _np(sv), **SV_TOL)
        for m in (m_0, m_j):
            np.testing.assert_array_equal(np.isnan(_np(m_m)), np.isnan(_np(m)))
            np.testing.assert_allclose(_np(m_m), _np(m), **MVBS_TOL)
        with pytest.raises(TypeError, match="make_mesh"):
            tp.sharded_sv_mvbs_step(jax_mesh, n_x, n_r, device="cpu")

    def test_cuda_request_without_cuda_raises(self):
        if torch.cuda.is_available():
            pytest.skip("a CUDA device is present; this checks the no-fallback rule")
        with pytest.raises(RuntimeError, match="cuda"):
            et.survey_pipeline_step(None, 8, 5)


class TestSmokeRecipe:
    """chip_smoke.py's Sv-grid phase at its dr (0.18944 m) and bins (20 m x
    20 s), on a small file with its channels and 4,000 samples a ping."""

    @pytest.fixture(scope="class")
    def sv_grid(self, tmp_path_factory):
        path = tmp_path_factory.mktemp("smoke") / "SMOKEA-D20200101-T000000.raw"
        write_ek60_raw(path, n_pings=45, n_samples=4000, channels=chip_smoke.CHANNELS,
                       frequencies=chip_smoke.FREQS, seed=0, with_angle=False)
        ed = et.open_raw(str(path), sonar_model="EK60")
        ds_Sv = et.calibrate.compute_Sv(ed, device="cpu")
        mvbs = et.compute_MVBS(ds_Sv, range_bin="20m", ping_time_bin="20s", device="cpu")
        args, n_x, n_r = chip_smoke.sv_grid_step_inputs(ed, ds_Sv)
        return ds_Sv, mvbs, args, n_x, n_r

    def test_step_on_compute_mvbs_grid(self, sv_grid):
        ds_Sv, mvbs, args, n_x, n_r = sv_grid
        assert float(args[1][0, 0]) == pytest.approx(0.18944)
        assert mvbs["Sv"].values.shape == (5, n_x, n_r)
        sv3, m3 = et.survey_pipeline_step(None, n_x, n_r, device="cpu")(*args)
        m4 = et.survey_pipeline_step(None, n_x, n_r, with_sv=False, device="cpu")(*args)
        sv_ref = np.asarray(ds_Sv["Sv"].values)
        np.testing.assert_array_equal(np.isnan(_np(sv3)), np.isnan(sv_ref))
        np.testing.assert_allclose(_np(sv3), sv_ref, rtol=chip_smoke.SV_RTOL,
                                   atol=chip_smoke.SV_ATOL)
        want = np.asarray(mvbs["Sv"].values)
        np.testing.assert_array_equal(np.isnan(_np(m3)), np.isnan(want))
        np.testing.assert_allclose(_np(m3), want, rtol=0, atol=chip_smoke.MVBS_ATOL_DB)
        np.testing.assert_allclose(_np(m4), _np(m3), rtol=0, atol=chip_smoke.K4_VS_K3_DB)

    def test_range_membership_identical(self, sv_grid):
        """The step's host bounds ceil(edge / dr0) put every sample in the
        bin compute_MVBS's float64 membership of echo_range gives it."""
        ds_Sv, _, args, _, _ = sv_grid
        er = np.asarray(ds_Sv["echo_range"].values, dtype="f8")[:, 0, :]
        r_edges = args[6]
        bounds = sbp.core_bounds_np(args[1][:, 0], r_edges, er.shape[1])
        want = np.stack([np.searchsorted(row, r_edges.astype("f8"), side="left") for row in er])
        np.testing.assert_array_equal(bounds, want)
