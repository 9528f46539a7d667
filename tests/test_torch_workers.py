"""Port parity: ``run_survey_mvbs_from_raw(..., workers=N)``.

``workers=N`` decodes the raw files in a spawned pool of N processes, one
file a task (``parallel/survey.py::_pool_decode_one``), and the eager path
consumes the decoded inputs in file order.  Held here, on the CPU, on three
files of tens of pings a model (as tests/test_survey.py:652-670):

* ``workers=2`` equals ``workers=0, prefetch=False`` bit for bit (atol 0,
  NaN where NaN) for EK60, EK80 CW power, AZFP and AZFP6, EK60 and AZFP also
  with ``freq_diff=`` (the EK80 power leg has one channel), and the pool
  really ran;
* ``workers=2`` is within tests/test_torch_survey.py's 1e-4 dB of the JAX
  package's ``workers=2``, with identical NaN masks and coordinates;
* the JAX routing: the prefetch streamer is off under ``workers``, one file
  takes no pool, and the noise-mask and complex routes ignore ``workers``;
* the worker body run in this process returns numpy only and leaves
  ``torch.cuda.is_initialized()`` False; a worker that fails makes the survey
  raise.
"""

import numpy as np
import pytest
import torch

import echopype_torch as et
from echopype_torch.parallel import survey as ts
from echopype_tpu.parallel import run_survey_mvbs_from_raw as jax_survey

from synth_azfp import write_azfp_raw, write_azfp_xml
from synth_ek60 import write_ek60_raw
from synth_ek80 import write_ek80_raw
from test_azfp6 import write_azfp6_raw

torch.set_num_threads(1)

ENV = {"salinity": 32.0, "pressure": 60.0}  # tests/test_survey.py:258
T0 = np.datetime64("2020-01-01T00:00:00", "ns")


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("workers")
    out = {"EK60": [], "EK80": [], "AZFP": [], "AZFP6": []}
    for i in range(3):
        p = d / f"PL{i}-D20200101-T00{i}000.raw"
        write_ek60_raw(p, n_pings=20 + 3 * i, n_samples=80 + 10 * i, seed=i, with_angle=False,
                       t0=T0 + np.timedelta64(i * 30, "s"), jitter_raw0=i == 2)
        out["EK60"].append(str(p))
        p = d / f"MX{i}-D20210201-T000000.raw"
        write_ek80_raw(p, n_pings=12, n_samples=128, seed=10 + i,
                       t0=np.datetime64("2021-02-01T00:00:00", "ns") + np.timedelta64(15 * i, "s"))
        out["EK80"].append(str(p))
        p = d / f"2103151{i}.01A"
        write_azfp_raw(p, n_pings=9, seed=i, minute=i)
        out["AZFP"].append(str(p))
        p = d / f"2207011{i}.azfp"
        write_azfp6_raw(p, n_pings=6, num_bins=40, seed=i, minute=i)
        out["AZFP6"].append(str(p))
    out["xml"] = str(d / "instrument.XML")
    write_azfp_xml(out["xml"])
    return out


KW = {
    "EK60": dict(range_bin="10m", ping_time_bin="10s", chunk_pings=16),
    "EK80": dict(sonar_model="EK80", range_bin="5m", ping_time_bin="5s", chunk_pings=8),
    "AZFP": dict(sonar_model="AZFP", env_params=ENV, range_bin="1.5m", ping_time_bin="20s",
                 chunk_pings=5),
    "AZFP6": dict(sonar_model="AZFP6", env_params=ENV, range_bin="2m", ping_time_bin="20s",
                  chunk_pings=4),
}
FD = {"EK60": "38kHz - 18kHz > 3.0dB", "AZFP": "125kHz - 38kHz > 3.0dB"}


def _kw(files, model):
    kw = dict(KW[model], device="cpu")
    if model == "AZFP":
        kw["xml_path"] = files["xml"]
    return kw


@pytest.fixture
def pool_calls(monkeypatch):
    """Counts the pools the survey starts (the real pool still runs)."""
    calls = []
    real = ts._pool_load

    def spy(raw_files, workers, args):
        calls.append((len(raw_files), workers))
        return real(raw_files, workers, args)

    monkeypatch.setattr(ts, "_pool_load", spy)
    return calls


@pytest.mark.parametrize("model, fd", [("EK60", False), ("EK60", True), ("EK80", False),
                                       ("AZFP", False), ("AZFP", True), ("AZFP6", False)],
                         ids=["ek60", "ek60_freq_diff", "ek80_power", "azfp",
                              "azfp_freq_diff", "azfp6"])
def test_pool_equals_in_process_bit_for_bit(files, pool_calls, monkeypatch, model, fd):
    kw = _kw(files, model)
    if fd:
        kw["freq_diff"] = FD[model]
    serial = et.run_survey_mvbs_from_raw(files[model], workers=0, prefetch=False, **kw)

    def no_streamer(*a, **k):
        raise AssertionError("the prefetch streamer ran under workers=")

    monkeypatch.setattr(ts, "_plan_from_scan", no_streamer)
    pooled = et.run_survey_mvbs_from_raw(files[model], workers=2, **kw)
    assert pool_calls == [(3, 2)]
    g, w = np.asarray(pooled["Sv"].values), np.asarray(serial["Sv"].values)
    assert g.dtype == w.dtype and np.isfinite(g).any()
    np.testing.assert_array_equal(g, w)
    for c in ("channel", "ping_time", "echo_range"):
        np.testing.assert_array_equal(np.asarray(pooled.coords[c].values),
                                      np.asarray(serial.coords[c].values))
    assert "ingest" in pooled.attrs["stage_timing"]


@pytest.mark.parametrize("model", ["EK60", "AZFP"])
def test_pool_matches_jax_pool(files, model):
    kw = _kw(files, model)
    got = et.run_survey_mvbs_from_raw(files[model], workers=2, **kw)
    kw.pop("device")
    want = jax_survey(files[model], workers=2, prefetch=False, **kw)
    g, w = np.asarray(got["Sv"].values, "f8"), np.asarray(want["Sv"].values, "f8")
    np.testing.assert_array_equal(np.isnan(g), np.isnan(w))
    np.testing.assert_allclose(g, w, atol=1e-4, rtol=0, equal_nan=True)
    for c in ("ping_time", "echo_range"):
        np.testing.assert_array_equal(np.asarray(got.coords[c].values),
                                      np.asarray(want.coords[c].values))
    assert np.isfinite(g).any()


def _no_pool(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("a pool was started")

    monkeypatch.setattr(ts, "_pool_load", refuse)


@pytest.mark.parametrize("route", ["noise_masks", "complex_chunked", "complex_fused",
                                   "one_file"])
def test_routes_that_ignore_workers(files, monkeypatch, route):
    """As in the JAX package (survey.py:1043-1075, 1112): the noise-mask and
    complex routes return before the pool, and one file decodes in process."""
    _no_pool(monkeypatch)
    if route == "noise_masks":
        raws, kw = files["EK60"][:2], dict(_kw(files, "EK60"), noise_masks={
            "impulse": {"range_var": "echo_range"}})
    elif route == "one_file":
        raws, kw = files["EK60"][:1], _kw(files, "EK60")
    else:
        raws, kw = files["EK80"][:2], dict(_kw(files, "EK80"), waveform_mode="CW",
                                           encode_mode="complex",
                                           device_fused=route == "complex_fused")
    got = et.run_survey_mvbs_from_raw(raws, workers=2, **kw)
    want = et.run_survey_mvbs_from_raw(raws, workers=0, **kw)
    np.testing.assert_array_equal(np.asarray(got["Sv"].values), np.asarray(want["Sv"].values))
    assert np.isfinite(np.asarray(got["Sv"].values)).any()


@pytest.mark.parametrize("model", ["EK60", "EK80", "AZFP"])
def test_worker_body_in_process(files, model):
    """The worker body returns what ``_load_inputs`` returns with the
    caller's calibrator, numpy only, and never initialises CUDA."""
    kw = _kw(files, model)
    args = (files[model][0], kw.get("sonar_model", "EK60"), "auto", kw.get("xml_path"),
            kw.get("env_params"), None)
    got = ts._pool_decode_one(args)
    make_cal = ts._power_calibrator(args[1], args[4], None, torch.device("cpu"))
    want = ts._load_inputs(args[0], args[1], "auto", args[3], make_cal)
    assert not torch.cuda.is_initialized()
    assert len(got) == len(want) == 9
    for g, w in zip(got, want):
        assert not isinstance(g, torch.Tensor)
        if isinstance(w, np.ndarray):
            assert isinstance(g, np.ndarray) and g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)
        else:
            assert g == w
    assert (got[5] is None) == (model != "AZFP")  # r0, the AZFP intercept


def test_failed_worker_raises(files, tmp_path):
    missing = str(tmp_path / "gone-D20200101-T000000.raw")
    with pytest.raises(FileNotFoundError):
        et.run_survey_mvbs_from_raw([files["EK60"][0], missing], workers=2,
                                    **_kw(files, "EK60"))
