"""The frequency-differencing cell ``ek60_survey_freqdiff``: its roofline, its
readers, and its comparison, at tiny sizes on the CPU.

* ``roofline_fd`` on a step counted by hand;
* each reader of the cell's per-layer metrics on a recorded traced window,
  silent on an untraced run and where the program has no such stage,
  counter or ``TRACED``;
* a run with the masked path broken underneath (the mask ignored; the
  channels swapped, 38 - 120 kHz; the threshold moved by 0.5 dB; the mask
  applied to channel A alone; every other ping left out of the means)
  comes out not correct, and an unbroken run correct;
* the bfloat16 control fails the cell's limits where the program passes.
"""

import io
import json
import math

import pytest
from test_bench_port_faults import _survey_half_batch
from test_bench_port_metrics import _reader
from tiny import BENCH, manifest, tiny_bench

import echopype_torch.parallel.survey as survey
from bench_port import control, roofline_fd
from bench_port.harness import main
from echopype_torch.utils import profiling

CELL = "ek60_survey_freqdiff"
#: (samples a ping, [(file of the traffic, pings)], chunk), as the tiny ek60_survey
TINY = {CELL: (240, [(0, 40), (6, 41), (1, 40)], 30)}
SEED = "2147483661"


def test_roofline_of_a_step_counted_by_hand():
    # 3 pings x 10 samples: 5 channels x 13 + 2 = 67 operations a (ping, sample)
    assert roofline_fd.step_operations(3, 5, 10) == 30 * 67
    # power 3 x 5 x 10 x 2 = 300; operands 3 x (5 x 5 + 1) x 4 = 312; edges 4 x 4;
    # sums and counts 2 x 5 x 2 x 3 x 4 = 240
    assert roofline_fd.step_bytes(3, 5, 10, 2, 3) == 300 + 312 + 16 + 240
    assert roofline_fd.step_bound_s(3, 5, 10, 2, 3) == pytest.approx(
        max(2_010 / 67e12, 868 / 3.35e12), rel=1e-15)
    # the cell's chunk: 1,955 pings of 5 x 4,000 int16 samples, bound by bytes
    assert roofline_fd.step_bound_s(1955, 5, 4000, 98, 40) == pytest.approx(
        roofline_fd.step_bytes(1955, 5, 4000, 98, 40) / 3.35e12, rel=1e-15)


#: a recorded traced window of the cell: 50,830 pings (two surveys)
FD_REC = {
    "pings": 50_830, "window_s": 25.0, "setup_s": 24.0, "stages": {}, "spans": {},
    "fd_bound_s": 0.0006,
    "trace": {"busy_s": 1.5, "window_s": 25.0,
              "kernels": {"void at::native::elementwise_kernel": 0.9,
                          "void gemmSN_NN_kernel<float>": 0.3},
              "breakdown": {"device_ops": [["Memcpy HtoD (Pageable -> Device)", 0.5],
                                           ["void at::native::elementwise_kernel", 0.9]]}},
}
FD_STAGES = {"ingest": 20.332, "valid_len": 1.0166, "to_int16": 3.0498,
             "freqdiff_step": 1.5249}
FD_COUNTERS = {"h2d_bytes": 5.2e9, "fd_valid_samples": 1_016_600_000,
               "fd_kept_samples": 762_450_000}

#: metric -> (recorded run, value); ms per 1,000 pings over 50.83 kpings
FD_CASES = {
    "fd_decode_ms_per_kping.fd": (FD_REC, 400.0),
    "fd_staging_ms_per_kping.fd": (FD_REC, 80.0),
    "fd_step_ms_per_kping.fd": (FD_REC, 30.0),
    "fd_h2d_gb_per_s.fd": (FD_REC, 10.4),
    "fd_kept_pct.fd": (FD_REC, 75.0),
    "fd_step_roofline_pct.fd": (FD_REC, 100 * 0.0006 / 1.2),
    "device_idle_pct.fd": (FD_REC, 94.0),
}
#: readers of the program's stages and counters (the others read the trace alone)
PROGRAM_READ = sorted(n for n in FD_CASES
                      if n not in ("fd_step_roofline_pct.fd", "device_idle_pct.fd"))


@pytest.fixture
def traced(monkeypatch):
    timer = profiling.StageTimer()
    timer.totals.update(FD_STAGES)
    timer.counters.update(FD_COUNTERS)
    monkeypatch.setattr(profiling, "TRACED", timer)


def test_every_new_metric_is_in_the_manifest_for_the_cell():
    m = manifest()
    mine = [x for x in m["per_layer"] if x["name"] in FD_CASES]
    assert len(mine) == len(FD_CASES)
    assert all(x["workloads"] == [CELL] and x["moves"] == "survey_pings_per_s" for x in mine)
    e2e = {x["name"]: x for x in m["end_to_end"]}
    assert CELL in e2e["survey_pings_per_s"]["workloads"]
    assert [w for w in m["workloads"] if w["name"] == CELL][0]["traffic"] == CELL


def test_the_configuration_is_the_survey_deployment_with_its_criterion():
    """The masked cell's configuration holds every number of the unmasked
    survey's, names the criterion its workload runs, and is its own
    manifest entry."""
    m = manifest()
    w = [x for x in m["workloads"] if x["name"] == CELL][0]
    configs = {c["name"]: c for c in m["configs"]}
    mine, base = configs[w["config"]], configs["ek60_5freq_splitbeam"]
    assert mine["name"] != base["name"] and mine["source"] != base["source"]
    assert mine["reduced"] == base["reduced"]
    cfg = json.loads((BENCH.parent / mine["file"]).read_text())
    survey_cfg = json.loads((BENCH.parent / base["file"]).read_text())
    wl = json.loads((BENCH / "workloads" / f"{CELL}.json").read_text())
    assert wl["config"] == cfg["name"] == w["config"]
    assert cfg["freq_diff"] == wl["args"]["freq_diff"]
    same = ("samples_per_ping", "ping_interval_ns", "ping_offset_ns", "start_time",
            "cruise_length_h", "file_pings", "power_index_range",
            "ctd_update_sound_speed_range", "channels", "writer")
    assert {k: cfg[k] for k in same} == {k: survey_cfg[k] for k in same}


@pytest.mark.parametrize("name", sorted(FD_CASES))
def test_reader_on_a_recorded_traced_window(name, traced):
    rec, want = FD_CASES[name]
    assert _reader(name).read(rec) == pytest.approx(want, rel=1e-12)


@pytest.mark.parametrize("name", sorted(FD_CASES))
def test_reader_is_silent_in_an_untraced_run(name, traced):
    rec, _ = FD_CASES[name]
    assert _reader(name).read(dict(rec, trace=None)) is None


@pytest.mark.parametrize("name", PROGRAM_READ)
def test_reader_is_silent_where_the_program_has_no_such_name(name, monkeypatch):
    monkeypatch.setattr(profiling, "TRACED", profiling.StageTimer())
    assert _reader(name).read(FD_CASES[name][0]) is None


@pytest.mark.parametrize("name", PROGRAM_READ)
def test_reader_is_silent_where_the_program_has_no_traced_timer(name, monkeypatch):
    monkeypatch.delattr(profiling, "TRACED")
    assert _reader(name).read(FD_CASES[name][0]) is None


def test_roofline_reader_is_silent_without_a_bound():
    assert _reader("fd_step_roofline_pct.fd").read(dict(FD_REC, fd_bound_s=0.0)) is None


def _masked_step(mp, make):
    """The survey's masked step replaced by ``make(real, window, n_r, ia, ib,
    op, mesh, device)``."""
    real = survey.sharded_mvbs_partials_freqdiff

    def patched(mesh, window, n_r, ia, ib, op, device="cuda"):
        return make(real, window, n_r, ia, ib, op, mesh, device)

    mp.setattr(survey, "sharded_mvbs_partials_freqdiff", patched)


def _mask_ignored(mp):
    def make(real, window, n_r, ia, ib, op, mesh, device):
        step = real(mesh, window, n_r, ia, ib, ">", device=device)
        return lambda *a: step(*a[:-1], -math.inf)  # every finite difference passes

    _masked_step(mp, make)


def _channels_swapped(mp):
    _masked_step(mp, lambda real, window, n_r, ia, ib, op, mesh, device:
                 real(mesh, window, n_r, ib, ia, op, device=device))


def _threshold_moved(mp):
    def make(real, window, n_r, ia, ib, op, mesh, device):
        step = real(mesh, window, n_r, ia, ib, op, device=device)
        return lambda *a: step(*a[:-1], a[-1] + 0.5)

    _masked_step(mp, make)


def _mask_on_channel_a_alone(mp):
    def make(real, window, n_r, ia, ib, op, mesh, device):
        masked = real(mesh, window, n_r, ia, ib, op, device=device)
        plain = real(mesh, window, n_r, ia, ib, ">", device=device)

        def step(*a):
            (ms, mc), (ps, pc) = masked(*a), plain(*a[:-1], -math.inf)
            ps[ia], pc[ia] = ms[ia], mc[ia]
            return ps, pc

        return step

    _masked_step(mp, make)


@pytest.mark.parametrize("fault", [_mask_ignored, _channels_swapped, _threshold_moved,
                                   _mask_on_channel_a_alone, _survey_half_batch],
                         ids=lambda f: f.__name__)
def test_broken_masked_path_is_not_correct(tmp_path, monkeypatch, fault):
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
    checks = res["checks"]
    assert checks["mvbs_max_db"]["value"] < 1e-4
    assert {"fd_boundary_samples", "fd_boundary_bins", "fd_boundary_bins_unmatched"} <= set(checks)


def test_control_fails_and_program_passes(tmp_path):
    rows = control.main(["--workload", CELL, "--seeds", "11", "2147483660", "--program"],
                        device="cpu", bench_dir=tiny_bench(tmp_path, TINY), out=io.StringIO())
    assert [r["side"] for r in rows] == ["control_bf16", "program"] * 2
    for row in rows:
        over = [n for n, c in row["checks"].items() if c["value"] > c["limit"]]
        assert over == (["mvbs_max_db"] if row["side"] == "control_bf16" else []), row
