"""The port's broadband (FM) path against the benchmark's plain reference.

``bench_port/reference/ek80.py`` computes echopype's broadband Sv and MVBS
in float64 from what the benchmark's EK80 writer drew.  Here, at a tiny
size on the CPU, on two FM channels of the ``ek80_fm_4ch`` configuration
that differ in sample interval (32 and 8 us) and replica length (38 and
149 taps), 4 sectors and 320 samples a ping:

* the fused survey (``run_survey_mvbs_from_raw(..., device_fused=True)``)
  within 5e-5 dB of the reference's MVBS, NaN masks and grids equal.  The
  fused step is float32 end to end: the offset alone rounds to float32 by
  up to 3.8e-6 dB, and the float32 matched filter and Sv add as much
  again (~5e-6 dB read); 5e-5 leaves a tenfold margin and lies far under
  a bfloat16 step (~0.2 dB);
* ``compute_Sv`` broadband (float64 direct matched filter on the host)
  sample by sample within 1e-6 dB over the samples within 100 dB of the
  channel's loudest, NaN masks equal everywhere.  The reference correlates
  by FFT, whose rounding is ~1e-16 of the loudest output: 100 dB down that
  is ~1e-11 relative, and the quieter tail samples (the last few of a
  ping, where only the replica's first taps reach) are left out;
* the reference's per-channel constants against ``CalibrateEK80``'s:
  replica, its norm, the effective pulse length, range step, TVG shift,
  absorption and Sv offset, to float64 rounding;
* the fused path's stages and counter reach ``profiling.TRACED`` under a
  profiler and cost nothing without one.
"""

import copy
import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import echopype_torch as et
from echopype_torch.calibrate.ek80 import CalibrateEK80
from echopype_torch.calibrate.ek80_complex import get_norm_fac
from echopype_torch.utils import profiling
from echopype_torch.utils.profiling import TRACED, trace

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from bench_port.reference import compare  # noqa: E402
from bench_port.reference import ek80 as ref  # noqa: E402
from bench_port.synth import ek80 as writer  # noqa: E402

torch.set_num_threads(1)

R, PINGS = 320, 24
KW = dict(sonar_model="EK80", waveform_mode="BB", encode_mode="complex", range_bin="5m",
          ping_time_bin="5s", device="cpu")
BB_STAGES = ("ek80_raw3", "ek80_beam_complex", "bb_params", "bb_host_stage", "bb_h2d",
             "bb_compress", "bb_sv_bins")


@pytest.fixture(autouse=True)
def no_specless_xarray(monkeypatch):
    """The profiler's first window looks up ``xarray``'s spec; the JAX
    package's facade, installed by other tests of the process, has none."""
    mod = sys.modules.get("xarray")
    if mod is not None and getattr(mod, "__spec__", None) is None:
        monkeypatch.delitem(sys.modules, "xarray")


@pytest.fixture(autouse=True)
def traced_left_empty():
    yield
    TRACED.clear()


@pytest.fixture(scope="module")
def config():
    cfg = json.loads((ROOT / "bench_port" / "configs" / "ek80_fm_4ch.json").read_text())
    cfg = copy.deepcopy(cfg)
    cfg["channels"] = [cfg["channels"][0], cfg["channels"][2]]  # ES38-7, ES120-7C
    cfg["samples_per_ping"] = R
    return cfg


@pytest.fixture(scope="module")
def made(config, tmp_path_factory):
    d = tmp_path_factory.mktemp("bb_reference")
    traffic = {"files": [{"name": "FM-D20210201-T000000.raw", "pings": PINGS},
                         {"name": "FM-D20210201-T000024.raw", "pings": PINGS}]}
    return writer.write_files(config, traffic, 2**31 + 71, d, "cpu")


def _got(out):
    return {"Sv": np.asarray(out["Sv"].values, dtype="f8"),
            "ping_time": np.asarray(out.coords["ping_time"].values,
                                    dtype="datetime64[ns]").astype("i8"),
            "echo_range": np.asarray(out.coords["echo_range"].values, dtype="f8"),
            "channel": [str(c) for c in out.coords["channel"].values]}


def test_tiny_configuration_keeps_two_intervals_and_replica_lengths(config, made):
    si = [ch["sample_interval"] for ch in config["channels"]]
    filters = made[0][1]["filters"]
    taps = [len(ref.replica(config, ch, filters[ch["channel_id"]])[0])
            for ch in config["channels"]]
    assert si == [3.2e-05, 8e-06] and taps == [38, 149] and max(taps) < R


@pytest.mark.parametrize("chunk_pings", [PINGS, 7], ids=["file_a_chunk", "chunks_of_7"])
def test_fused_survey_matches_the_reference(config, made, chunk_pings):
    out = et.run_survey_mvbs_from_raw([p for p, _ in made], device_fused=True,
                                      chunk_pings=chunk_pings, **KW)
    got, want = _got(out), ref.survey_mvbs(config, made, 5.0, 5)
    assert compare.grid_mismatch(got, want) == 0
    assert compare.nan_mismatch(got["Sv"], want["Sv"]) == 0
    assert np.isfinite(want["Sv"]).sum() > 10
    assert compare.max_db_gap(got["Sv"], want["Sv"]) < 5e-5


@pytest.mark.parametrize("ci", [0, 1], ids=["ES38-7", "ES120-7C"])
def test_compute_sv_broadband_matches_the_reference(config, made, ci):
    path, truth = made[1]
    ds = et.calibrate.compute_Sv(et.open_raw(path, sonar_model="EK80"), waveform_mode="BB",
                                 encode_mode="complex", precision="float64", device="cpu")
    got = np.asarray(ds["Sv"].values, dtype="f8")[ci]
    want = ref.sv_samples(config, truth, ci)
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    loud = np.isfinite(want) & (want > np.nanmax(want) - 100.0)
    assert loud.sum() > 0.9 * np.isfinite(want).sum()
    np.testing.assert_allclose(got[loud], want[loud], rtol=0, atol=1e-6)


@pytest.fixture(scope="module")
def port_terms(made):
    cal = CalibrateEK80(et.open_raw(made[0][0], sonar_model="EK80"), waveform_mode="BB",
                        encode_mode="complex")
    scal = cal._complex_sv_scalars()
    norm = get_norm_fac(scal["tx"])
    return scal, norm


@pytest.mark.parametrize("name", ["tx", "norm", "tau_eff", "dr", "shift", "alpha", "offset"])
def test_reference_terms_equal_the_calibrators(config, made, port_terms, name):
    scal, norm = port_terms
    for ci, ch in enumerate(config["channels"]):
        t = ref.channel_terms(config, ch, made[0][1]["filters"][ch["channel_id"]])
        if name == "tx":
            want = scal["tx"][ch["channel_id"]]
            assert t["tx"].shape == want.shape and t["zeros"] == 1
            np.testing.assert_allclose(t["tx"], want, rtol=0, atol=1e-14)
        elif name == "norm":
            assert t["norm"] == pytest.approx(float(norm.sel(channel=ch["channel_id"]).values),
                                              rel=1e-13)
        else:
            assert t[name] == pytest.approx(float(scal[name][ci, 0]), rel=1e-13, abs=1e-13)


def test_fused_stages_and_counter_land_in_traced(made, tmp_path):
    files = [p for p, _ in made]
    with trace(str(tmp_path)):
        et.run_survey_mvbs_from_raw(files, device_fused=True, chunk_pings=PINGS, **KW)
    assert set(BB_STAGES) <= set(TRACED.totals)
    assert all(TRACED.totals[n] > 0 for n in BB_STAGES)
    assert TRACED.counts["bb_h2d"] == TRACED.counts["bb_compress"] == 4  # 2 files x 2 channels
    truth = [tr["complex"] for _, tr in made]
    want = sum(2 * 4 * x.size for xs in truth for x in xs)  # real and imaginary float32
    assert TRACED.counters["bb_h2d_bytes"] == want


def test_fused_stages_cost_nothing_without_a_profiler(made):
    assert profiling.stage("bb_compress") is profiling.stage("bb_h2d")  # the shared no-op
    et.run_survey_mvbs_from_raw([p for p, _ in made], device_fused=True, chunk_pings=PINGS,
                                **KW)
    assert TRACED.report(log=False) == {} and not TRACED.counters
