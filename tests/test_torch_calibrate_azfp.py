"""Port parity: AZFP / AZFP6 calibration (``calibrate/azfp.py``).

The AZFP sonar equation is host float64 numpy in the JAX package (it has no
device program), and the port's copy is the same code: ``compute_Sv`` /
``compute_TS`` and the streamer's ``_power_cal_inputs`` must equal
``echopype_tpu``'s bit for bit, on the files of ``tests/synth_azfp.py``,
``tests/test_azfp6.py`` and ``chip_smoke.py``'s four-frequency writer
(ragged bins).  ``device`` is checked and named in ``attrs["device"]``.
"""

import numpy as np
import pytest
import torch

import echopype_torch as et
import echopype_tpu as ep
from echopype_torch.calibrate.azfp import CalibrateAZFP as TCal
from echopype_tpu.calibrate.azfp import CalibrateAZFP as JCal

import chip_smoke
from synth_azfp import write_azfp_raw, write_azfp_xml
from test_azfp6 import write_azfp6_raw

ENV = {"salinity": 33.0, "pressure": 10.0}  # tests/test_azfp.py:74


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("cal_azfp")
    xml, xml4 = d / "instrument.XML", d / "four.XML"
    write_azfp_xml(xml)
    chip_smoke.write_azfp_xml4(xml4)
    out = {}
    write_azfp_raw(d / "21031500.01A", n_pings=6)
    out["azfp"] = ("AZFP", str(d / "21031500.01A"), str(xml))
    write_azfp_raw(d / "21031501.01A", n_pings=4, averaged=True, seed=2)
    out["azfp_averaged"] = ("AZFP", str(d / "21031501.01A"), str(xml))
    chip_smoke.write_azfp_raw4(d / "21031502.01A", hour=2, seed=3, n_pings=7,
                               num_bins=(50, 50, 40, 30))
    out["azfp_ragged"] = ("AZFP", str(d / "21031502.01A"), str(xml4))
    write_azfp6_raw(d / "22070100.azfp", n_pings=5)
    out["azfp6"] = ("AZFP6", str(d / "22070100.azfp"), None)
    write_azfp6_raw(d / "22070101.azfp", n_pings=3, averaged=True, seed=4)
    out["azfp6_averaged"] = ("AZFP6", str(d / "22070101.azfp"), None)
    return out


def _both(files, name):
    model, raw, xml = files[name]
    return (et.open_raw(raw, sonar_model=model, xml_path=xml),
            ep.open_raw(raw, sonar_model=model, xml_path=xml))


def _bits_equal(a, b):
    a, b = np.ascontiguousarray(np.asarray(a)), np.ascontiguousarray(np.asarray(b))
    return a.dtype == b.dtype and a.shape == b.shape and np.array_equal(
        a.view(np.uint8), b.view(np.uint8))


CASES = ["azfp", "azfp_averaged", "azfp_ragged", "azfp6", "azfp6_averaged"]


@pytest.mark.parametrize("cal_type", ["Sv", "TS"])
@pytest.mark.parametrize("name", CASES)
def test_compute_matches_jax_bit_for_bit(files, name, cal_type):
    ted, jed = _both(files, name)
    got = getattr(et.calibrate, f"compute_{cal_type}")(ted, env_params=ENV, device="cpu")
    want = getattr(ep.calibrate, f"compute_{cal_type}")(jed, env_params=ENV)
    assert sorted(got.data_vars) == sorted(want.data_vars)
    for v in want.data_vars:
        assert _bits_equal(got[v].values, want[v].values), v
        assert got[v].dims == want[v].dims, v
    for c in ("channel", "ping_time", "range_sample"):
        np.testing.assert_array_equal(np.asarray(got.coords[c].values),
                                      np.asarray(want.coords[c].values))
    assert got[cal_type].attrs["units"] == "dB"
    assert got.attrs["processing_function"] == f"calibrate.compute_{cal_type}"
    assert got.attrs["device"] == "cpu" and "device" not in want.attrs


def test_ragged_channels_stay_nan_past_their_bins(files):
    ted, _ = _both(files, "azfp_ragged")
    sv = np.asarray(et.calibrate.compute_Sv(ted, env_params=ENV, device="cpu")["Sv"].values)
    assert [int(np.isfinite(sv[c, 0]).sum()) for c in range(4)] == [50, 50, 40, 30]


@pytest.mark.parametrize("name", ["azfp", "azfp_ragged", "azfp6"])
def test_power_cal_inputs_match_jax(files, name):
    """The survey streamer's inputs (power, dr, shift, alpha, offset, r0)."""
    ted, jed = _both(files, name)
    got = TCal(ted, env_params=ENV, device="cpu")._power_cal_inputs("Sv")
    want = JCal(jed, env_params=ENV)._power_cal_inputs("Sv")
    assert len(got) == len(want) == 6
    for g, w in zip(got, want):
        assert _bits_equal(g, w)
    with pytest.raises(ValueError, match="Sv-only"):
        TCal(ted, env_params=ENV, device="cpu")._power_cal_inputs("TS")


def test_user_cal_params_match_jax(files):
    ted, jed = _both(files, "azfp")
    kw = dict(env_params=dict(ENV, temperature=9.5), cal_params={"EL": 141.0})
    got = et.calibrate.compute_Sv(ted, device="cpu", **kw)
    want = ep.calibrate.compute_Sv(jed, **kw)
    assert _bits_equal(got["Sv"].values, want["Sv"].values)


@pytest.mark.parametrize("missing", ["salinity", "pressure", "both"])
def test_requires_salinity_and_pressure(files, missing):
    ted, jed = _both(files, "azfp")
    env = {} if missing == "both" else {k: v for k, v in ENV.items() if k != missing}
    for pkg, ed, kw in ((et, ted, {"device": "cpu"}), (ep, jed, {})):
        with pytest.raises(ReferenceError, match="salinity" if missing != "pressure"
                           else "pressure"):
            pkg.calibrate.compute_Sv(ed, env_params=env, **kw)


def test_ecs_file_is_refused_for_azfp(files, tmp_path):
    ted, jed = _both(files, "azfp")
    ecs = tmp_path / "cal.ecs"
    ecs.write_text("Version 1.00\n")
    for pkg, ed, kw in ((et, ted, {"device": "cpu"}), (ep, jed, {})):
        with pytest.raises(ValueError, match="ECS"):
            pkg.calibrate.compute_Sv(ed, ecs_file=str(ecs), env_params=ENV, **kw)


def test_cuda_request_without_cuda_raises(files):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; this checks the no-fallback rule")
    ted, _ = _both(files, "azfp")
    with pytest.raises(RuntimeError, match="cuda"):
        et.calibrate.compute_Sv(ted, env_params=ENV)
