"""Port parity: EK80 compute_Sv / compute_TS (CW power, CW complex, BB).

``echopype_torch.calibrate`` (here with ``device="cpu"``) against
``echopype_tpu.calibrate`` on the synthetic EK80 files of
``tests/synth_ek80.py``, the cases of tests/test_calibrate_ek80.py and
tests/test_ek80_epochs.py.  Tolerances, with identical NaN masks in every
case:

* float64 (every mode) and CW complex (host float64 in both packages at
  either precision): within 1e-9 dB of the JAX package;
* CW power at float32: within 5e-5 dB (the power-mode float32 budget,
  tests/test_torch_calibrate.py);
* BB at float32 (the matched filter in float32): no further from the port's
  float64 than the JAX package's float32 is from its own float64 on the
  same input, plus 1e-4 dB.

echo_range and tau_effective are held to the same rules, the data
variables and the mode attrs must match.
"""

import numpy as np
import pytest
import torch

import echopype_torch as et
import echopype_tpu as ep

from synth_ek80 import (
    config_xml, environment_xml, make_fil1, make_raw3, make_xml0, parameter_xml,
    write_ek80_multisector, write_ek80_raw,
)
from test_ek80_epochs import write_two_epoch_ek80
from test_survey_epochs import write_two_epoch_bb

torch.set_num_threads(1)

F64_DB = 1e-9
POWER_F32_DB = 5e-5
BB_F32_SLACK_DB = 1e-4


def _wbt_power_file(path):
    """A WBT and a GPT channel in power mode (test_calibrate_ek80.py:207)."""
    rng = np.random.default_rng(11)
    t0 = np.datetime64("2021-02-01T00:00:00", "ns")
    channels = [
        {"id": "WBT 500100-15 ES120-7C", "tcvr_type": "WBT", "frequency": 120000.0,
         "pulse_durations": [256e-6, 512e-6, 1024e-6], "sample_intervals": [8e-6, 16e-6, 32e-6],
         "gains": [24.0, 25.0, 26.0], "sas": [0.0, -0.1, -0.2], "impedance": 5400,
         "fs": 1500000, "cal_freqs": None},
        {"id": "GPT 500101-15 ES38B", "tcvr_type": "GPT", "frequency": 38000.0,
         "pulse_durations": [256e-6, 512e-6, 1024e-6],
         "sample_intervals": [64e-6, 128e-6, 256e-6], "gains": [22.0, 23.0, 24.0],
         "sas": [0.0, -0.1, -0.2], "impedance": 5400, "fs": 500000, "cal_freqs": None},
    ]
    chunks = [make_xml0(t0, config_xml(channels)), make_xml0(t0, environment_xml())]
    for ch in channels:
        chunks.append(make_fil1(t0, ch["id"], 1, np.full(4, 0.25, dtype="c8"), 6))
        chunks.append(make_fil1(t0, ch["id"], 2, np.full(2, 0.5, dtype="c8"), 1))
    for p in range(4):
        ts = t0 + np.timedelta64(p + 1, "s")
        for ch in channels:
            chunks.append(make_xml0(ts, parameter_xml(
                ch["id"], 0, frequency=ch["frequency"], pulse_duration=1.024e-3,
                sample_interval=64e-6, transmit_power=500.0)))
            chunks.append(make_raw3(ts, ch["id"],
                                    power_idx=rng.integers(-20000, 0, 48).astype("<i2")))
    path.write_bytes(b"".join(chunks))


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("cal_ek80")
    out = {k: d / f"{k}-D20210201-T000000.raw" for k in
           ("default", "f16", "two_fm", "sectors3", "center", "epochs_cw", "epochs_bb",
            "epochs_on_pings", "wbt_power")}
    write_ek80_raw(out["default"], n_pings=5, n_samples=128)
    write_ek80_raw(out["f16"], n_pings=4, n_samples=96, seed=3, complex_f16=True,
                   with_power_channel=False)
    write_ek80_raw(out["two_fm"], n_pings=6, n_samples=100, seed=4, extra_fm_channel=True,
                   skip_pings={"WBT 400140-15 ES70-7C": {2}}, jitter_config=True)
    write_ek80_multisector(out["sectors3"], beam_type=17)
    write_ek80_multisector(out["center"], beam_type=49)
    write_two_epoch_ek80(out["epochs_cw"])
    write_two_epoch_ek80(out["epochs_bb"], waveform="BB", n_samples=96)
    write_two_epoch_bb(out["epochs_on_pings"], n_pings_per_epoch=3, n_samples=80)
    _wbt_power_file(out["wbt_power"])
    return {k: (et.open_raw(v, sonar_model="EK80"), ep.open_raw(v, sonar_model="EK80"))
            for k, v in out.items()}


def _run(files, name, cal_type, precision, **kw):
    ted, jed = files[name]
    got = getattr(et.calibrate, f"compute_{cal_type}")(ted, precision=precision, device="cpu",
                                                        **kw)
    want = getattr(ep.calibrate, f"compute_{cal_type}")(jed, precision=precision, **kw)
    return got, want


def _max_db(a, b):
    a, b = np.asarray(a, dtype="f8"), np.asarray(b, dtype="f8")
    np.testing.assert_array_equal(np.isnan(a), np.isnan(b))
    d = np.abs(a - b)
    return float(np.nanmax(d)) if np.isfinite(d).any() else 0.0


def _same_frame(got, want, cal_type):
    assert sorted(got.data_vars) == sorted(want.data_vars)
    for k in ("waveform_mode", "encode_mode", "units"):
        assert got[cal_type].attrs.get(k) == want[cal_type].attrs.get(k)
    for name in ("channel", "ping_time", "range_sample"):
        np.testing.assert_array_equal(np.asarray(got.coords[name].values),
                                      np.asarray(want.coords[name].values))
    assert _max_db(got["echo_range"].values, want["echo_range"].values) <= F64_DB
    if "tau_effective" in want:
        np.testing.assert_allclose(got["tau_effective"].values, want["tau_effective"].values,
                                   rtol=1e-12, equal_nan=True)


MODES = {"bb": ("BB", "complex"), "cw_complex": ("CW", "complex"), "cw_power": ("CW", "power")}


@pytest.mark.parametrize("cal_type", ["Sv", "TS"])
@pytest.mark.parametrize("mode", sorted(MODES))
@pytest.mark.parametrize("precision", ["float32", "float64"])
def test_default_file_matches_jax(files, mode, cal_type, precision):
    wm, em = MODES[mode]
    got, want = _run(files, "default", cal_type, precision, waveform_mode=wm, encode_mode=em)
    _same_frame(got, want, cal_type)
    err = _max_db(got[cal_type].values, want[cal_type].values)
    if precision == "float64" or mode == "cw_complex":
        assert err <= F64_DB
    elif mode == "cw_power":
        assert err <= POWER_F32_DB
    else:
        got64, want64 = _run(files, "default", cal_type, "float64", waveform_mode=wm,
                             encode_mode=em)
        port = _max_db(got[cal_type].values, got64[cal_type].values)
        jax = _max_db(want[cal_type].values, want64[cal_type].values)
        assert port <= jax + BB_F32_SLACK_DB
    assert np.isfinite(np.asarray(got[cal_type].values)).any()


BB_CASES = {
    "drop_last_hanning_zero": ("default", dict(drop_last_hanning_zero=True)),
    "complex_f16": ("f16", {}),
    "two_fm_channels": ("two_fm", {}),
    "epochs_bb": ("epochs_bb", {}),
    "epochs_on_pings": ("epochs_on_pings", {}),
    "user_params": ("default", dict(env_params={"sound_speed": 1490.0},
                                    cal_params={"gain_correction": 27.5})),
}


@pytest.mark.parametrize("case", sorted(BB_CASES))
@pytest.mark.parametrize("precision", ["float32", "float64"])
def test_bb_cases_match_jax(files, case, precision):
    name, kw = BB_CASES[case]
    got, want = _run(files, name, "Sv", precision, waveform_mode="BB", encode_mode="complex",
                     **kw)
    _same_frame(got, want, "Sv")
    err = _max_db(got["Sv"].values, want["Sv"].values)
    if precision == "float64":
        assert err <= F64_DB
    else:
        got64, want64 = _run(files, name, "Sv", "float64", waveform_mode="BB",
                             encode_mode="complex", **kw)
        port = _max_db(got["Sv"].values, got64["Sv"].values)
        jax = _max_db(want["Sv"].values, want64["Sv"].values)
        assert port <= jax + BB_F32_SLACK_DB


CW_CASES = {
    "three_sectors": ("sectors3", "complex", {}),
    "three_plus_center": ("center", "complex", {}),
    "epochs": ("epochs_cw", "complex", {}),
    "assume_single_filter_time": ("epochs_cw", "complex", dict(assume_single_filter_time=True)),
    "wbt_power_tau": ("wbt_power", "power", {}),
    "jitter_two_fm_power": ("two_fm", "power", {}),
}


@pytest.mark.parametrize("case", sorted(CW_CASES))
@pytest.mark.parametrize("cal_type", ["Sv", "TS"])
def test_cw_cases_match_jax(files, case, cal_type):
    name, em, kw = CW_CASES[case]
    for precision, tol in (("float64", F64_DB),
                           ("float32", F64_DB if em == "complex" else POWER_F32_DB)):
        got, want = _run(files, name, cal_type, precision, waveform_mode="CW", encode_mode=em,
                         **kw)
        _same_frame(got, want, cal_type)
        assert _max_db(got[cal_type].values, want[cal_type].values) <= tol
        assert np.isfinite(np.asarray(got[cal_type].values)).any()


def test_epoch_partition_matches_jax(files):
    from echopype_torch.calibrate.api import epoch_slice_dicts as t_slices
    from echopype_tpu.calibrate.api import epoch_slice_dicts as j_slices

    for name, n in (("epochs_cw", 1), ("epochs_bb", 1), ("epochs_on_pings", 2)):
        ted, jed = files[name]
        got = t_slices(ted["Sonar/Beam_group1"], ted["Vendor_specific"])
        want = j_slices(jed["Sonar/Beam_group1"], jed["Vendor_specific"])
        assert len(got) == len(want) == n
        for g, w in zip(got, want):
            assert g.keys() == w.keys() and all(str(g[k]) == str(w[k]) for k in g)


def test_wbt_power_channel_uses_replica_tau(files):
    got, _ = _run(files, "wbt_power", "Sv", "float32", waveform_mode="CW", encode_mode="power")
    chans = list(got.coords["channel"].values)
    tau = got["tau_effective"].values
    assert tau[chans.index("GPT 500101-15 ES38B"), 0] == pytest.approx(1.024e-3, rel=1e-9)
    assert 0 < tau[chans.index("WBT 500100-15 ES120-7C"), 0] < 1.024e-3


@pytest.mark.parametrize("kw, err", [
    (dict(waveform_mode="BB", encode_mode="power"), ValueError),
    (dict(), ValueError),
    (dict(waveform_mode="CW", encode_mode="power", assume_single_filter_time=True), ValueError),
    (dict(waveform_mode="BB", encode_mode="complex", ecs_file="cal.ecs"), FileNotFoundError),
])
def test_invalid_inputs_raise(files, kw, err):
    """Both packages reject the same inputs; a missing ECS file is not found
    (ECS calibration itself: tests/test_torch_ecs.py)."""
    ted, jed = files["default"]
    with pytest.raises(err):
        et.calibrate.compute_Sv(ted, device="cpu", **kw)
    with pytest.raises(err):
        ep.calibrate.compute_Sv(jed, **kw)
