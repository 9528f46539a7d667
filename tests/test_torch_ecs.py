"""Port parity: Echoview calibration supplement (ECS) files.

``echopype_torch/calibrate/ecs.py`` is the port's copy of the JAX
package's ECS parser and EV -> echopype mapping; ``compute_Sv(ecs_file=)``
feeds its parameters to the port's EK60 / EK80 calibration.  On the ECS
texts of ``tests/test_ecs.py`` the parser's results must equal the JAX
package's exactly, its errors must be the same, and ``compute_Sv`` with an
ECS file must equal ``echopype_tpu``'s within the calibration tolerances of
``tests/test_torch_calibrate.py`` (EK60: 5e-5 dB in float32, 1e-10 dB in
float64) and ``tests/test_torch_calibrate_ek80.py`` (float64: 1e-9 dB),
with identical NaN masks.  The ECS file replaces ``env_params`` and
``cal_params``, which a warning says.
"""

import numpy as np
import pytest

import echopype_torch as et
import echopype_tpu as ep
from echopype_torch.calibrate import ecs as tecs
from echopype_tpu.calibrate import ecs as jecs

from synth_ek60 import write_ek60_raw
from synth_ek80 import write_ek80_raw
from test_ecs import ECS_CONTENT, ECS_EK80_BB_CONTENT, ECS_EK80_BB_HZ_CONTENT

EK60_F32_DB, EK60_F64_DB, EK80_F64_DB = 5e-5, 1e-10, 1e-9

TEXTS = {
    "ek60": ECS_CONTENT,
    "ek80_bb": ECS_EK80_BB_CONTENT,
    "ek80_bb_hz": ECS_EK80_BB_HZ_CONTENT,
    "localcal_alias": ECS_CONTENT.replace(
        "SourceCal T1\n", "SourceCal T1\n    Ek60TransducerGain = 23.00\n")
    + "\nLocalCal T1\n    TransducerGain = 25.00\n",
    "tvg": ECS_CONTENT.replace(
        "SoundSpeed = 1473.0 # (meters per second)",
        "SoundSpeed = 1473.0 # (meters per second)\nTvgRangeCorrection = SimradEx60"),
    "two_localcals": ECS_EK80_BB_CONTENT
    + "\nLocalCal Another\n    SoundSpeed = 1450.0 # (meters per second)\n",
}


def _write(tmp_path, name, text):
    p = tmp_path / f"{name}.ecs"
    p.write_text(text)
    return str(p)


def _same_value(a, b):
    if isinstance(a, dict):
        assert isinstance(b, dict) and list(a) == list(b)
        for k in a:
            _same_value(a[k], b[k])
    elif isinstance(a, (list, tuple, np.ndarray)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    else:
        assert a == b or (a != a and b != b), (a, b)


def _same_dataset(got, want):
    if want is None:
        assert got is None
        return
    assert sorted(got.data_vars) == sorted(want.data_vars)
    for v in want.data_vars:
        assert got[v].dims == want[v].dims, v
        np.testing.assert_array_equal(np.asarray(got[v].values), np.asarray(want[v].values))
    for c in want.coords:
        np.testing.assert_array_equal(np.asarray(got.coords[c].values),
                                      np.asarray(want.coords[c].values))


class TestParser:
    @pytest.mark.parametrize("name", sorted(TEXTS))
    def test_parse_matches_jax(self, tmp_path, name):
        path = _write(tmp_path, name, TEXTS[name])
        got, want = tecs.ECSParser(path), jecs.ECSParser(path)
        got.parse()
        want.parse()
        assert (got.data_type, got.version) == (want.data_type, want.version)
        assert got.file_creation_time == want.file_creation_time
        _same_value(got.parsed_params, want.parsed_params)
        kw = {"localcal_name": "Another"} if name == "two_localcals" else {}
        _same_value(got.get_cal_params(**kw), want.get_cal_params(**kw))

    @pytest.mark.parametrize("name, sonar", [("ek60", "EK60"), ("localcal_alias", "EK60"),
                                             ("ek80_bb", "EK80"), ("ek80_bb_hz", "EK80")])
    def test_ev2ep_matches_jax(self, tmp_path, name, sonar):
        path = _write(tmp_path, name, TEXTS[name])
        got = tecs.ecs_ev2ep(tecs.ECSParser(path).get_cal_params(), sonar)
        want = jecs.ecs_ev2ep(jecs.ECSParser(path).get_cal_params(), sonar)
        for g, w in zip(got, want):
            _same_dataset(g, w)

    @pytest.mark.parametrize("ev_dict", [
        {"T1": {"Frequency": 18.0, "TransducerGain": 21.0, "Ek60TransducerGain": 23.0,
                "SaCorrectionFactor": -0.2, "EK60SaCorrection": -0.7},
         "T2": {"Frequency": 38.0, "EK60SaCorrection": -0.9, "SaCorrectionFactor": -0.1,
                "Ek60TransducerGain": 25.0, "TransducerGain": 27.0},
         "T3": {"Frequency": 120.0, "Ek60TransducerGain": 24.5}},
        {"T1": {"Frequency": 18.0, "TransducerGain": "notanumber"},
         "T2": {"Frequency": 38.0, "Ek60TransducerGain": 26.0}},
    ], ids=["duplicate_aliases", "malformed_value"])
    def test_ev2ep_dict_cases_match_jax(self, ev_dict):
        for g, w in zip(tecs.ecs_ev2ep(ev_dict, "EK60"), jecs.ecs_ev2ep(ev_dict, "EK60")):
            _same_dataset(g, w)

    def test_conform_channel_order_matches_jax(self, tmp_path):
        from echopype_torch.xrlite import DataArray as TDA
        from echopype_tpu.xrlite import DataArray as JDA

        path = _write(tmp_path, "ek60", ECS_CONTENT)
        out = []
        for mod, da in ((tecs, TDA), (jecs, JDA)):
            _, ds_cal, _ = mod.ecs_ev2ep(mod.ECSParser(path).get_cal_params(), "EK60")
            freq = da(np.array([38000.0, 18000.0]), ("channel",),
                      coords={"channel": np.array(["chB", "chA"], dtype=object)})
            out.append(mod.conform_channel_order(ds_cal, freq))
        _same_dataset(*out)
        assert list(out[0].coords["channel"].values) == ["chB", "chA"]

    @pytest.mark.parametrize("case, match", [
        ("bad_tvg", "TvgRangeCorrection"), ("junk_line", "line"), ("no_frequency", "Frequency"),
    ])
    def test_errors_match_jax(self, tmp_path, case, match):
        if case == "bad_tvg":
            text = TEXTS["tvg"].replace("TvgRangeCorrection = SimradEx60",
                                        "TvgRangeCorrection = Bogus")
        elif case == "junk_line":
            text = ECS_CONTENT + "\nthis is not an assignment\n"
        else:
            text = "\n".join(ln for ln in ECS_CONTENT.splitlines()
                             if "Frequency =" not in ln or "Table" in ln) + "\n"
        path = _write(tmp_path, case, text)
        for mod, xr in ((tecs, et.xrlite), (ep.calibrate.ecs, ep.xrlite)):
            freq = xr.DataArray(np.array([18000.0, 38000.0]), ("channel",),
                                coords={"channel": np.array(["c1", "c2"], dtype=object)},
                                name="frequency_nominal")
            with pytest.raises(ValueError, match=match):
                mod.ecs_to_params(path, "EK60", freq)


@pytest.fixture(scope="module")
def ek60_file(tmp_path_factory):
    path = tmp_path_factory.mktemp("ecs_ek60") / "ECS-D20200101-T000000.raw"
    write_ek60_raw(path, n_pings=12, n_samples=80, seed=2)
    return str(path)


def _max_db(a, b):
    a, b = np.asarray(a, dtype="f8"), np.asarray(b, dtype="f8")
    np.testing.assert_array_equal(np.isnan(a), np.isnan(b))
    d = np.abs(a - b)
    return float(np.nanmax(d)) if np.isfinite(d).any() else 0.0


class TestCalibration:
    @pytest.mark.parametrize("precision, tol", [("float32", EK60_F32_DB),
                                                ("float64", EK60_F64_DB)])
    @pytest.mark.parametrize("name", ["ek60", "localcal_alias", "tvg"])
    def test_ek60_compute_sv_matches_jax(self, tmp_path, ek60_file, name, precision, tol):
        ecs = _write(tmp_path, name, TEXTS[name])
        got = et.calibrate.compute_Sv(et.open_raw(ek60_file, sonar_model="EK60"), ecs_file=ecs,
                                      precision=precision, device="cpu")
        want = ep.calibrate.compute_Sv(ep.open_raw(ek60_file, sonar_model="EK60"),
                                       ecs_file=ecs, precision=precision)
        assert _max_db(got["Sv"].values, want["Sv"].values) <= tol
        assert sorted(got.data_vars) == sorted(want.data_vars)
        for v in ("sound_speed", "sound_absorption", "gain_correction", "sa_correction"):
            np.testing.assert_array_equal(np.asarray(got[v].values), np.asarray(want[v].values))
        np.testing.assert_allclose(np.asarray(got["sound_speed"].values), 1473.0)

    def test_ecs_equals_its_parameters_given_explicitly(self, tmp_path, ek60_file):
        """compute_Sv(ecs_file=) is compute_Sv with the ECS's env/cal
        parameters: the same device path, bit for bit."""
        ecs = _write(tmp_path, "ek60", ECS_CONTENT)
        ed = et.open_raw(ek60_file, sonar_model="EK60")
        env, cal = tecs.ecs_to_params(ecs, "EK60", ed["Sonar/Beam_group1"]["frequency_nominal"])
        a = et.calibrate.compute_Sv(ed, ecs_file=ecs, device="cpu")
        b = et.calibrate.compute_Sv(ed, env_params=env, cal_params=cal, device="cpu")
        np.testing.assert_array_equal(a["Sv"].values, b["Sv"].values)

    def test_ecs_takes_precedence_over_user_params(self, tmp_path, ek60_file, capfd):
        ecs = _write(tmp_path, "ek60", ECS_CONTENT)
        ed = et.open_raw(ek60_file, sonar_model="EK60")
        plain = et.calibrate.compute_Sv(ed, ecs_file=ecs, device="cpu")
        capfd.readouterr()
        both = et.calibrate.compute_Sv(ed, ecs_file=ecs, device="cpu",
                                       env_params={"sound_speed": 1400.0},
                                       cal_params={"gain_correction": 1.0})
        np.testing.assert_array_equal(plain["Sv"].values, both["Sv"].values)
        assert "ECS file takes precedence" in capfd.readouterr().err

    def test_zero_overlap_ecs_is_inert(self, tmp_path, ek60_file):
        text = ECS_CONTENT.replace("Frequency = 18.00", "Frequency = 333.00").replace(
            "Frequency = 38.00", "Frequency = 555.00")
        ecs = _write(tmp_path, "nooverlap", text)
        ed = et.open_raw(ek60_file, sonar_model="EK60")
        plain = et.calibrate.compute_Sv(ed, precision="float64", device="cpu")
        with_ecs = et.calibrate.compute_Sv(ed, ecs_file=ecs, precision="float64", device="cpu")
        np.testing.assert_array_equal(with_ecs["Sv"].values, plain["Sv"].values)

    @pytest.mark.parametrize("case", ["bb_hz_tables", "tableless_bb", "cw_complex", "cw_power"])
    def test_ek80_compute_sv_matches_jax(self, tmp_path, case):
        raw = tmp_path / "E80-D20210201-T000000.raw"
        if case == "tableless_bb":
            write_ek80_raw(raw, n_pings=3, n_samples=64, with_power_channel=False,
                           with_cw_complex=False)
            text = "\n".join(["Version 1.00", "SourceCal T1",
                              "    # Frequency = 70.00 # (kilohertz)",
                              "    TransducerGain = 26.30 # (decibels)"]) + "\n"
        else:
            write_ek80_raw(raw, n_pings=4, n_samples=64, seed=3)
            text = ECS_EK80_BB_HZ_CONTENT
        ecs = _write(tmp_path, case, text)
        wm, em = {"cw_complex": ("CW", "complex"), "cw_power": ("CW", "power")}.get(
            case, ("BB", "complex"))
        kw = dict(ecs_file=ecs, waveform_mode=wm, encode_mode=em, precision="float64")
        got = et.calibrate.compute_Sv(et.open_raw(raw, sonar_model="EK80"), device="cpu", **kw)
        want = ep.calibrate.compute_Sv(ep.open_raw(raw, sonar_model="EK80"), **kw)
        assert _max_db(got["Sv"].values, want["Sv"].values) <= EK80_F64_DB
        assert np.isfinite(np.asarray(got["Sv"].values)).any()
        np.testing.assert_array_equal(np.asarray(got["gain_correction"].values),
                                      np.asarray(want["gain_correction"].values))
