"""Port parity: EK60 power-mode compute_Sv / compute_TS.

echopype_torch.calibrate runs the sonar equation in plain torch (float32,
here on the CPU) or in host float64 numpy; echopype_tpu.calibrate is the
reference, on the same synthetic EK60 files.  Tolerances: float32 Sv within
5e-5 dB (the JAX package's CPU float32 budget for power mode is 2.7e-5 dB,
docs/PERFORMANCE.md), echo_range exact, NaN masks identical; float64 within
1e-10 dB.
"""

import numpy as np
import pytest
import torch

import echopype_torch as et
import echopype_tpu as ep
from echopype_torch.ops.calibration import ek_power_cal
from echopype_tpu.ops.calibration import ek_power_cal as ek_power_cal_jax
from synth_ek60 import write_ek60_raw

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def ek60_files(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_cal")
    specs = {
        "plain": dict(),
        "ragged": dict(ragged=True),
        "skip": dict(skip_pings={2: {1, 5, 6}}),
        "jitter": dict(jitter_raw0=True, jitter_config=True),
    }
    out = {}
    for i, (name, kw) in enumerate(specs.items()):
        path = d / f"{name}-D20200101-T000000.raw"
        write_ek60_raw(path, n_pings=23, n_samples=240, seed=20 + i, with_angle=False, **kw)
        out[name] = path
    return out


def _both(path, fn, **kw):
    ed_t = et.open_raw(path, sonar_model="EK60")
    ed_j = ep.open_raw(path, sonar_model="EK60")
    return fn(et.calibrate, ed_t, device="cpu", **kw), fn(ep.calibrate, ed_j, **kw)


@pytest.mark.parametrize("name", ["plain", "ragged", "skip", "jitter"])
@pytest.mark.parametrize("precision,atol", [("float32", 5e-5), ("float64", 1e-10)])
def test_compute_sv_matches_jax(ek60_files, name, precision, atol):
    got, want = _both(
        ek60_files[name], lambda mod, ed, **kw: mod.compute_Sv(ed, **kw), precision=precision
    )
    g, w = np.asarray(got["Sv"].values), np.asarray(want["Sv"].values)
    np.testing.assert_array_equal(np.isnan(g), np.isnan(w))
    np.testing.assert_allclose(g, w, atol=atol, rtol=0, equal_nan=True)
    np.testing.assert_array_equal(
        np.asarray(got["echo_range"].values), np.asarray(want["echo_range"].values)
    )
    assert set(got.data_vars) == set(want.data_vars)
    assert got["Sv"].attrs["units"] == "dB"
    assert got.attrs["processing_function"] == "calibrate.compute_Sv"


def test_compute_ts_matches_jax(ek60_files):
    got, want = _both(ek60_files["jitter"], lambda mod, ed, **kw: mod.compute_TS(ed, **kw))
    g, w = np.asarray(got["TS"].values), np.asarray(want["TS"].values)
    np.testing.assert_array_equal(np.isnan(g), np.isnan(w))
    np.testing.assert_allclose(g, w, atol=5e-5, rtol=0, equal_nan=True)


def test_user_params_match_jax(ek60_files):
    kw = dict(env_params={"sound_speed": 1480.0}, cal_params={"sa_correction": -0.3})
    got, want = _both(ek60_files["plain"], lambda mod, ed, **k: mod.compute_Sv(ed, **k), **kw)
    np.testing.assert_allclose(got["Sv"].values, want["Sv"].values, atol=5e-5, rtol=0,
                               equal_nan=True)


def test_ek_power_cal_op_matches_jax():
    rng = np.random.default_rng(9)
    C, P, R = 3, 17, 64
    power = rng.uniform(-150, -20, (C, P, R)).astype("f4")
    power[:, :, 50:] = np.nan
    dr = rng.uniform(0.1, 0.3, (C, P))
    shift = 2 * dr
    ab = rng.uniform(0.001, 0.05, (C, P))
    off = rng.normal(-30, 2, (C, P))
    for cal_type in ("Sv", "TS"):
        got = ek_power_cal(power, dr, shift, ab, off, cal_type, device="cpu")
        want = ek_power_cal_jax(power, dr, shift, ab, off, cal_type)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(np.isnan(g), np.isnan(w))
            np.testing.assert_allclose(g, w, atol=5e-5, rtol=0, equal_nan=True)


def test_invalid_modes_raise(ek60_files):
    ed = et.open_raw(ek60_files["plain"], sonar_model="EK60")
    with pytest.raises(ValueError, match="waveform_mode"):
        et.calibrate.compute_Sv(ed, waveform_mode="BB", device="cpu")
    with pytest.raises(ValueError, match="encode_mode"):
        et.calibrate.compute_Sv(ed, encode_mode="complex", device="cpu")
    with pytest.raises(ValueError, match="has to be None or a dict"):
        et.calibrate.compute_Sv(ed, env_params=[1], device="cpu")


@pytest.mark.parametrize("case", ["AZFP", "AZFP6", "ecs_file"])
def test_unported_inputs_raise(ek60_files, case):
    """AZFP/AZFP6 calibration and ``ecs_file`` are ported
    (tests/test_torch_calibrate_azfp.py, test_torch_ecs.py): EK60 data
    labelled AZFP lacks the salinity AZFP needs, and a missing ECS file is
    not found, in the port as in the JAX package."""
    err, match = ((FileNotFoundError, "calibration.ecs") if case == "ecs_file"
                  else (ReferenceError, "salinity"))
    for pkg, extra in ((et, {"device": "cpu"}), (ep, {})):
        ed = pkg.open_raw(ek60_files["plain"], sonar_model="EK60")
        kw = dict(extra)
        if case == "ecs_file":
            kw["ecs_file"] = "calibration.ecs"
        else:
            ed.sonar_model = case
        with pytest.raises(err, match=match):
            pkg.calibrate.compute_Sv(ed, **kw)


def test_cuda_request_without_cuda_raises(ek60_files):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; this checks the no-fallback rule")
    ed = et.open_raw(ek60_files["plain"], sonar_model="EK60")
    with pytest.raises(RuntimeError, match="cuda"):
        et.calibrate.compute_Sv(ed)
