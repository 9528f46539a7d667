"""The broadband cell ``ek80_bb_fused_survey``: its writer, its roofline, its
readers, and its comparison, at tiny sizes on the CPU.

* the writer's files open through the port and hold what its truth says:
  samples, ping times, per-channel sample intervals, FIL1 taps and
  decimations, the broadband calibration curves;
* ``roofline_bb`` on a step counted by hand;
* each reader of the cell's per-layer metrics on a recorded traced window,
  silent on an untraced run and where the program has no such stage,
  counter or ``TRACED``;
* a run with the fused path broken underneath (the replica's norm left
  out; every other ping left out of the means; one channel's bins moved by
  one range bin) comes out not correct, and an unbroken run correct;
* the bfloat16 control fails the cell's limits where the program passes;
  the bf16x3 matched filter's reading (``bf16x3_reading.py``) lies near the
  reference.
"""

import copy
import io
import json

import numpy as np
import pytest
import torch
from test_bench_port_metrics import _reader
from tiny import BENCH, tiny_bench

import echopype_torch as et
import echopype_torch.calibrate.ek80_complex as ek80_complex
import echopype_torch.ops.bb_pipeline as bb_pipeline
from bench_port import bf16x3_reading, control, roofline_bb
from bench_port.harness import main
from bench_port.synth import ek80 as writer
from echopype_torch.utils import profiling

CELL = "ek80_bb_fused_survey"
#: (samples a ping, [(file of the traffic, pings)], chunk): the four channels kept
TINY = {CELL: (320, [(0, 24), (1, 24)], 16)}
SEED = "2147483663"


def _config():
    return json.loads((BENCH / "configs" / "ek80_fm_4ch.json").read_text())


@pytest.fixture(scope="module")
def written(tmp_path_factory):
    cfg = copy.deepcopy(_config())
    cfg["samples_per_ping"] = 200
    traffic = {"files": [{"name": "FM-D20210201-T000000.raw", "pings": 5}]}
    return cfg, writer.write_files(cfg, traffic, 17, tmp_path_factory.mktemp("w"), "cpu")


def test_written_file_holds_its_truth(written):
    cfg, [(path, truth)] = written
    ed = et.open_raw(path, sonar_model="EK80")
    beam = ed["Sonar/Beam_group1"]
    ids = [str(c) for c in beam.coords["channel"].values]
    assert ids == [ch["channel_id"] for ch in cfg["channels"]]
    got = (np.asarray(beam["backscatter_r"].values) + 1j * np.asarray(beam["backscatter_i"].values))
    for ci, ch in enumerate(cfg["channels"]):
        np.testing.assert_array_equal(got[ci], truth["complex"][ci])
        assert np.all(np.asarray(beam["sample_interval"].values)[ci] == ch["sample_interval"])
        assert np.all(np.asarray(beam["transmit_frequency_start"].values)[ci]
                      == ch["frequency_start"])
    np.testing.assert_array_equal(
        np.asarray(beam.coords["ping_time"].values, dtype="datetime64[ns]").astype("i8"),
        truth["ping_time_ns"])
    assert set(np.asarray(beam["transmit_type"].values).ravel()) == {"LFM"}


def test_written_filters_and_calibration_curves(written):
    cfg, [(path, _)] = written
    vend = et.open_raw(path, sonar_model="EK80")["Vendor_specific"]
    for ci, ch in enumerate(cfg["channels"]):
        for name, stage, key in (("WBT", 1, "wbt_filter"), ("PC", 2, "pc_filter")):
            re = np.asarray(vend[f"{name}_coeffs_real"].values)[ci, 0]
            im = np.asarray(vend[f"{name}_coeffs_imag"].values)[ci, 0]
            taps = (re + 1j * im)[~np.isnan(re)]
            np.testing.assert_array_equal(taps, writer.filter_coefficients(cfg, ch, stage))
            assert np.asarray(vend[f"{name}_deci_fac"].values)[ci, 0] == ch[key]["decimation"]
        # 1 / sample interval = receiver rate / (WBT decimation x PC decimation)
        d = ch["wbt_filter"]["decimation"] * ch["pc_filter"]["decimation"]
        assert ch["sample_interval"] == pytest.approx(d / cfg["receiver_sampling_frequency"],
                                                      rel=1e-15)
        cal = ch["calibration"]
        gain = np.asarray(vend["gain"].sel(cal_channel_id=ch["channel_id"]).values)
        freqs = np.asarray(vend.coords["cal_frequency"].values)
        np.testing.assert_array_equal(gain[np.isin(freqs, cal["frequency"])], cal["gain"])


def test_roofline_of_a_step_counted_by_hand():
    # 2 pings x 4 sectors = 8 lanes of R = 100, L = 29: R + L - 1 = 128 = N, log2 N = 7;
    # a lane 2 x 5 x 128 x 7 + 6 x 128 = 9,728 operations
    assert roofline_bb.step_operations(8, 100, 29) == 8 * 9_728
    # samples 8 x 100 x 8 = 6,400; operands 2 x 32; replica 29 x 8; edges 4 x 4;
    # sums and counts 2 x 1 x 3 x 8
    assert roofline_bb.step_bytes(2, 4, 100, 29, 1, 3) == 6_400 + 64 + 232 + 16 + 48
    assert roofline_bb.step_bound_s(2, 4, 100, 29, 1, 3) == pytest.approx(
        max(77_824 / 67e12, 6_760 / 3.35e12), rel=1e-15)
    # R + L - 1 = 129 doubles N
    assert roofline_bb.step_operations(1, 100, 30) == 2 * 5 * 256 * 8 + 6 * 256


#: a recorded traced window of the cell: 4,000 pings (two surveys)
BB_REC = {
    "pings": 4_000, "window_s": 20.0, "setup_s": 22.0, "stages": {}, "spans": {},
    "bb_bound_s": 0.0184,
    "trace": {"busy_s": 1.2, "window_s": 20.0,
              "kernels": {"void gemmSN_NN_kernel<float>": 0.4, "elementwise_kernel": 0.2},
              "breakdown": {"device_ops": [["Memcpy HtoD (Pageable -> Device)", 0.7],
                                           ["void gemmSN_NN_kernel<float>", 0.4]]}},
}
BB_STAGES = {"ek80_raw3": 6.0, "ek80_beam_complex": 4.0, "bb_params": 1.2,
             "bb_host_stage": 0.8, "bb_h2d": 0.9, "bb_compress": 0.3, "bb_sv_bins": 0.2}
BB_COUNTERS = {"bb_h2d_bytes": 4.2e9}

#: metric -> (recorded run, value); ms per 1,000 pings over 4 kpings
BB_CASES = {
    "ek80_decode_ms_per_kping.bb": (BB_REC, 1_500.0),
    "ek80_beam_ms_per_kping.bb": (BB_REC, 1_000.0),
    "bb_params_ms_per_kping.bb": (BB_REC, 300.0),
    "bb_host_stage_ms_per_kping.bb": (BB_REC, 200.0),
    "bb_step_ms_per_kping.bb": (BB_REC, 350.0),
    "bb_h2d_gb_per_s.bb": (BB_REC, 6.0),
    "bb_fused_roofline_pct.bb": (BB_REC, 100 * 0.0184 / 0.6),
}
#: readers of the program's stages and counters (the roofline reads the trace alone)
PROGRAM_READ = sorted(n for n in BB_CASES if n != "bb_fused_roofline_pct.bb")


@pytest.fixture
def traced(monkeypatch):
    timer = profiling.StageTimer()
    timer.totals.update(BB_STAGES)
    timer.counters.update(BB_COUNTERS)
    monkeypatch.setattr(profiling, "TRACED", timer)


def test_every_new_metric_is_in_the_manifest_for_the_cell():
    from tiny import manifest

    m = manifest()
    mine = [x for x in m["per_layer"] if x["name"] in BB_CASES]
    assert len(mine) == len(BB_CASES)
    assert all(x["workloads"] == [CELL] and x["moves"] == "survey_pings_per_s" for x in mine)
    e2e = {x["name"]: x for x in m["end_to_end"]}
    assert CELL in e2e["survey_pings_per_s"]["workloads"]


@pytest.mark.parametrize("name", sorted(BB_CASES))
def test_reader_on_a_recorded_traced_window(name, traced):
    rec, want = BB_CASES[name]
    assert _reader(name).read(rec) == pytest.approx(want, rel=1e-12)


@pytest.mark.parametrize("name", sorted(BB_CASES))
def test_reader_is_silent_in_an_untraced_run(name, traced):
    rec, _ = BB_CASES[name]
    assert _reader(name).read(dict(rec, trace=None)) is None


@pytest.mark.parametrize("name", PROGRAM_READ)
def test_reader_is_silent_where_the_program_has_no_such_name(name, monkeypatch):
    monkeypatch.setattr(profiling, "TRACED", profiling.StageTimer())
    assert _reader(name).read(BB_CASES[name][0]) is None


@pytest.mark.parametrize("name", PROGRAM_READ)
def test_reader_is_silent_where_the_program_has_no_traced_timer(name, monkeypatch):
    monkeypatch.delattr(profiling, "TRACED")
    assert _reader(name).read(BB_CASES[name][0]) is None


def test_roofline_reader_is_silent_without_a_bound():
    assert _reader("bb_fused_roofline_pct.bb").read(dict(BB_REC, bb_bound_s=0.0)) is None


def _norm_left_out(mp):
    orig = ek80_complex.get_norm_fac
    mp.setattr(ek80_complex, "get_norm_fac", lambda chirp: orig(chirp) * 0 + 1.0)


def _half_the_pings(mp):
    orig = bb_pipeline.bb_chunk_window_partials

    def half(bs_r, bs_i, hr, hi, inv_norm, z_coef, dr, shift, alpha, offset, k0, valid_len,
             *a, **kw):
        valid_len = np.array(valid_len, copy=True)
        valid_len[1::2] = 0  # every other ping: no sample in its run, left out of the means
        return orig(bs_r, bs_i, hr, hi, inv_norm, z_coef, dr, shift, alpha, offset, k0,
                    valid_len, *a, **kw)

    mp.setattr(bb_pipeline, "bb_chunk_window_partials", half)


def _one_channel_shifted(mp):
    orig = bb_pipeline.bb_chunk_window_partials
    first = {}

    def shifted(bs_r, bs_i, hr, *a, **kw):
        sums, counts = orig(bs_r, bs_i, hr, *a, **kw)
        first.setdefault("taps", len(hr))
        if len(hr) == first["taps"]:  # the first channel's replica: its bins one range bin on
            sums, counts = torch.roll(sums, 1, dims=1), torch.roll(counts, 1, dims=1)
        return sums, counts

    mp.setattr(bb_pipeline, "bb_chunk_window_partials", shifted)


@pytest.mark.parametrize("fault", [_norm_left_out, _half_the_pings, _one_channel_shifted],
                         ids=lambda f: f.__name__)
def test_broken_fused_path_is_not_correct(tmp_path, monkeypatch, fault):
    bench = tiny_bench(tmp_path, TINY)
    fault(monkeypatch)
    res = main(["--workload", CELL, "--seed", SEED, "--seconds", "0.2"], device="cpu",
               bench_dir=bench, out=io.StringIO())
    assert res["correct"] is False, res["checks"]
    assert "calls_failed" not in res["checks"]
    assert any(c["value"] > c["limit"] for c in res["checks"].values())


def test_unbroken_run_is_correct(tmp_path):
    res = main(["--workload", CELL, "--seed", SEED, "--seconds", "0.2"], device="cpu",
               bench_dir=tiny_bench(tmp_path, TINY), out=io.StringIO())
    assert res["correct"] is True, res["checks"]
    assert res["checks"]["mvbs_max_db"]["value"] < 1e-4


def test_control_fails_and_program_passes(tmp_path):
    rows = control.main(["--workload", CELL, "--seeds", "11", "2147483660", "--program"],
                        device="cpu", bench_dir=tiny_bench(tmp_path, TINY), out=io.StringIO())
    assert [r["side"] for r in rows] == ["control_bf16", "program"] * 2
    for row in rows:
        over = [n for n, c in row["checks"].items() if c["value"] > c["limit"]]
        assert over == (["mvbs_max_db"] if row["side"] == "control_bf16" else []), row


def test_bf16x3_reading_lies_near_the_reference(tmp_path):
    rows = bf16x3_reading.main(["--workload", CELL, "--seeds", "19"], device="cpu",
                               bench_dir=tiny_bench(tmp_path, TINY), out=io.StringIO())
    assert [r["side"] for r in rows] == ["bf16x3"]
    checks = rows[0]["checks"]
    assert checks["grid_mismatch"]["value"] == 0 and checks["mvbs_nan_mismatch"]["value"] == 0
    assert 0 < checks["mvbs_max_db"]["value"] < 1e-3
