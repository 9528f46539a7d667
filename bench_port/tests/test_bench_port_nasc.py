"""The NASC cell ``ek60_nasc_chain``: its configuration, roofline, readers and
comparison, at tiny sizes on the CPU.

* the configuration holds the survey deployment's numbers and names the
  arguments its workload runs;
* ``roofline_nasc`` on a call counted by hand;
* each reader of the cell's per-layer metrics on a recorded traced window,
  silent on an untraced run and where the program has no such stage,
  counter or ``TRACED``;
* a run with the chain broken underneath (the mean height set to 1; every
  ping one distance bin on; ``depth_offset`` dropped; latitude and
  longitude swapped; every other ping left out of the means) comes out not
  correct, and an unbroken run correct;
* the bfloat16 control fails the cell's limits where the program passes.
"""

import io
import json

import numpy as np
import pytest
from test_bench_port_metrics import _reader
from tiny import BENCH, manifest, tiny_bench

import echopype_torch.commongrid.api as cg_api
import echopype_torch.consolidate as consolidate
from bench_port import control, roofline_nasc
from bench_port.harness import main
from echopype_torch.utils import profiling

CELL = "ek60_nasc_chain"
#: (samples a ping, [(file of the traffic, pings)], chunk): files 0, 2 (the
#: CTD update) and 1
TINY = {CELL: (240, [(0, 41), (2, 40), (1, 41)], None)}
SEED = "2147483661"


def _bench(tmp_path):
    """The tiny cell, with 0.02 nmi distance bins: a tiny file spans 7."""
    bench = tiny_bench(tmp_path, TINY)
    p = bench / "workloads" / f"{CELL}.json"
    wl = json.loads(p.read_text())
    wl["args"]["dist_bin"] = "0.02nmi"
    p.write_text(json.dumps(wl))
    return bench


def test_the_configuration_is_the_survey_deployment_integrated_to_nasc():
    """The NASC cell's configuration holds every number of the survey's
    deployment and names the grid, depth offset and sentence its workload
    runs; it is its own manifest entry."""
    m = manifest()
    w = [x for x in m["workloads"] if x["name"] == CELL][0]
    configs = {c["name"]: c for c in m["configs"]}
    mine, base = configs[w["config"]], configs["ek60_5freq_splitbeam"]
    assert mine["name"] != base["name"] and mine["source"] != base["source"]
    assert mine["reduced"] == base["reduced"] == ["cruise_length_h"]
    cfg = json.loads((BENCH.parent / mine["file"]).read_text())
    survey_cfg = json.loads((BENCH.parent / base["file"]).read_text())
    wl = json.loads((BENCH / "workloads" / f"{CELL}.json").read_text())
    assert wl["config"] == cfg["name"] == w["config"] and cfg["source"] == mine["source"]
    same = ("samples_per_ping", "ping_interval_ns", "ping_offset_ns", "start_time",
            "cruise_length_h", "file_pings", "power_index_range",
            "ctd_update_sound_speed_range", "channels", "writer")
    assert {k: cfg[k] for k in same} == {k: survey_cfg[k] for k in same}
    assert {ch["transducer_depth"] for ch in cfg["channels"]} == {cfg["depth_offset"]}
    for key in ("depth_offset", "nmea_sentence", "range_bin", "dist_bin"):
        assert wl["args"][key] == cfg[key]
    assert (wl["args"]["closed"], wl["args"]["skipna"]) == ("left", True)
    assert wl["warm"] == [0, 2]
    files = wl["traffic"]["files"]
    assert [f["pings"] for f in files] == [cfg["file_pings"]] * 5
    assert [i for i, f in enumerate(files) if "ctd_update_ping" in f] == [2]


def test_every_new_metric_is_in_the_manifest_for_the_cell():
    m = manifest()
    mine = [x for x in m["per_layer"] if x["name"] in NASC_CASES]
    assert len(mine) == len(NASC_CASES)
    assert all(x["workloads"] == [CELL] and x["moves"] == "chain_pings_per_s" for x in mine)
    chain = {x["name"]: x["workloads"] for x in m["per_layer"] if x["name"].endswith(".chain")}
    assert {n for n, w in chain.items() if CELL in w} == set(CHAIN_ON_NASC)
    assert all(chain[n] == ["ek60_sv_chain", CELL] for n in CHAIN_ON_NASC)
    e2e = {x["name"]: x for x in m["end_to_end"]}
    assert e2e["chain_pings_per_s"]["workloads"] == ["ek60_sv_chain", CELL]
    assert [w for w in m["workloads"] if w["name"] == CELL][0]["traffic"] == CELL


def test_roofline_of_a_call_counted_by_hand():
    # 3 pings x 2 channels x 10 samples: 15 operations a channel-sample
    assert roofline_nasc.call_operations(3, 2, 10) == 60 * 15
    # samples 60 x (2 + 4 + 4) = 600; operands 3 x (2 x 4 + 1) x 4 = 108;
    # sums, counts and heights 3 x 2 x 4 x 5 x 8 = 960
    assert roofline_nasc.call_bytes(3, 2, 10, 4, 5) == 600 + 108 + 960
    assert roofline_nasc.call_bound_s(3, 2, 10, 4, 5) == pytest.approx(
        max(900 / 67e12, 1_668 / 3.35e12), rel=1e-15)
    # the cell's call: 1,955 pings of 5 x 4,000 samples, 15 x 77 bins, bound by bytes
    assert roofline_nasc.call_bound_s(1955, 5, 4000, 15, 77) == pytest.approx(
        roofline_nasc.call_bytes(1955, 5, 4000, 15, 77) / 3.35e12, rel=1e-15)


#: a recorded traced window of the cell: 11,730 pings (six calls)
NASC_REC = {
    "pings": 11_730, "window_s": 30.0, "setup_s": 25.0, "stages": {},
    "spans": {"open_raw": 2.346, "compute_Sv": 1.173, "add_depth": 0.1, "add_location": 0.02,
              "compute_NASC": 23.46},
    "nasc_bound_s": 0.0007,
    "trace": {"busy_s": 1.2, "window_s": 30.0,
              "kernels": {"void at::native::elementwise_kernel": 0.25,
                          "void gemmSN_NN_kernel<float>": 0.1},
              "breakdown": {"device_ops": [["Memcpy DtoH (Device -> Pageable)", 0.8]]}},
}
NASC_STAGES = {"parse_raw": 1.0557, "set_groups": 1.173, "cal_inputs": 0.2346,
               "power_cal_device": 0.4692, "add_depth": 0.5865, "add_location": 0.05865,
               "nasc_prepare": 7.038, "bin_membership": 11.73, "bin_device": 3.519,
               "nasc_assemble": 0.1173}
NASC_COUNTERS = {"nasc_pings": 11_730, "nasc_sample_pings": 11_730}

#: metric -> (recorded run, value); ms per 1,000 pings over 11.73 kpings
NASC_CASES = {
    "compute_nasc_ms_per_kping.nasc": (NASC_REC, 2000.0),
    "consolidate_ms_per_kping.nasc": (NASC_REC, 55.0),
    "nasc_prepare_ms_per_kping.nasc": (NASC_REC, 600.0),
    "nasc_assemble_ms_per_kping.nasc": (NASC_REC, 10.0),
    "nasc_per_sample_pct.nasc": (NASC_REC, 100.0),
    "nasc_device_roofline_pct.nasc": (NASC_REC, 100 * 0.0007 / 0.35),
}
#: readers of the program's stages and counters (the others read the
#: benchmark's spans or the trace)
PROGRAM_READ = ["consolidate_ms_per_kping.nasc", "nasc_assemble_ms_per_kping.nasc",
                "nasc_per_sample_pct.nasc", "nasc_prepare_ms_per_kping.nasc"]
#: readers that read the trace or the program's traced stages
TRACE_READ = sorted(n for n in NASC_CASES if n != "compute_nasc_ms_per_kping.nasc")
#: the sequence chain's readers that the cell reports too, on the same
#: window: metric -> value (the layers both chains run)
CHAIN_ON_NASC = {
    "open_raw_ms_per_kping.chain": 200.0,
    "compute_sv_ms_per_kping.chain": 100.0,
    "parse_raw_ms_per_kping.chain": 90.0,
    "set_groups_ms_per_kping.chain": 100.0,
    "cal_inputs_ms_per_kping.chain": 20.0,
    "power_cal_device_ms_per_kping.chain": 40.0,
    "bin_membership_ms_per_kping.chain": 1000.0,
    "bin_device_ms_per_kping.chain": 300.0,
    "device_idle_pct.chain": 96.0,
}


@pytest.fixture
def traced(monkeypatch):
    timer = profiling.StageTimer()
    timer.totals.update(NASC_STAGES)
    timer.counters.update(NASC_COUNTERS)
    monkeypatch.setattr(profiling, "TRACED", timer)


@pytest.mark.parametrize("name", sorted(NASC_CASES))
def test_reader_on_a_recorded_traced_window(name, traced):
    rec, want = NASC_CASES[name]
    assert _reader(name).read(rec) == pytest.approx(want, rel=1e-12)


@pytest.mark.parametrize("name", sorted(CHAIN_ON_NASC))
def test_chain_reader_on_the_cells_traced_window(name, traced):
    """The chain's readers of the layers this cell runs read its window."""
    assert _reader(name).read(NASC_REC) == pytest.approx(CHAIN_ON_NASC[name], rel=1e-12)


@pytest.mark.parametrize("name", TRACE_READ)
def test_reader_is_silent_in_an_untraced_run(name, traced):
    rec, _ = NASC_CASES[name]
    assert _reader(name).read(dict(rec, trace=None)) is None


@pytest.mark.parametrize("name", PROGRAM_READ)
def test_reader_is_silent_where_the_program_has_no_such_name(name, monkeypatch):
    monkeypatch.setattr(profiling, "TRACED", profiling.StageTimer())
    assert _reader(name).read(NASC_CASES[name][0]) is None


@pytest.mark.parametrize("name", PROGRAM_READ)
def test_reader_is_silent_where_the_program_has_no_traced_timer(name, monkeypatch):
    monkeypatch.delattr(profiling, "TRACED")
    assert _reader(name).read(NASC_CASES[name][0]) is None


def test_consolidate_reader_is_silent_without_either_stage(monkeypatch):
    timer = profiling.StageTimer()
    timer.totals.update({"add_depth": 0.5})
    monkeypatch.setattr(profiling, "TRACED", timer)
    assert _reader("consolidate_ms_per_kping.nasc").read(NASC_REC) is None


def test_roofline_reader_is_silent_without_a_bound():
    assert _reader("nasc_device_roofline_pct.nasc").read(dict(NASC_REC, nasc_bound_s=0.0)) is None


def _height_one(mp):
    """The mean height left out: every bin's height sum is its ping count."""
    def ones(values, er, r_edges, x_bounds, **kw):
        pings = np.diff(np.asarray(x_bounds)).astype("f8")
        return np.broadcast_to(pings[None, :, None],
                               (values.shape[0], len(pings), len(r_edges) - 1)).copy()

    mp.setattr(cg_api.binning, "windowed_sum_raw_np", ones)


def _distance_bins_shifted(mp):
    """Every ping one distance bin on (the last bin's pings in none)."""
    bounds, index = cg_api.binning.x_bounds_np, cg_api.binning.bin_index_np

    def shifted_bounds(values, edges, closed="left"):
        b = bounds(values, edges, closed)
        return np.concatenate([b[:1], b[:-1]])

    def shifted_index(values, edges, closed="left"):
        i = index(values, edges, closed)
        return np.where((i >= 0) & (i < len(edges) - 2), i + 1, -1).astype(i.dtype)

    mp.setattr(cg_api.binning, "x_bounds_np", shifted_bounds)
    mp.setattr(cg_api.binning, "bin_index_np", shifted_index)


def _depth_offset_dropped(mp):
    orig = consolidate.add_depth
    mp.setattr(consolidate, "add_depth", lambda ds, **kw: orig(ds, **dict(kw, depth_offset=None)))


def _lat_lon_swapped(mp):
    orig = consolidate.add_location

    def swapped(*a, **kw):
        ds = orig(*a, **kw)
        lat, lon = ds["latitude"], ds["longitude"]
        ds["latitude"] = (lat.dims, np.asarray(lon.values), dict(lat.attrs))
        ds["longitude"] = (lon.dims, np.asarray(lat.values), dict(lon.attrs))
        return ds

    mp.setattr(consolidate, "add_location", swapped)


def _half_the_pings(mp):
    orig = cg_api.binning.windowed_partials_np

    def half(sv, *a, **kw):
        sv = np.array(sv, copy=True)
        sv[:, 1::2] = np.nan  # every other ping skipped by the NaN-skipping mean
        return orig(sv, *a, **kw)

    mp.setattr(cg_api.binning, "windowed_partials_np", half)


@pytest.mark.parametrize("fault", [_height_one, _distance_bins_shifted, _depth_offset_dropped,
                                   _lat_lon_swapped, _half_the_pings],
                         ids=lambda f: f.__name__)
def test_broken_chain_is_not_correct(tmp_path, monkeypatch, fault):
    bench = _bench(tmp_path)
    fault(monkeypatch)
    res = main(["--workload", CELL, "--seed", SEED, "--seconds", "0.2"], device="cpu",
               bench_dir=bench, out=io.StringIO())
    assert res["correct"] is False, res["checks"]
    assert "calls_failed" not in res["checks"]
    assert any(c["value"] > c["limit"] for c in res["checks"].values())


def test_unbroken_run_is_correct(tmp_path):
    res = main(["--workload", CELL, "--seed", SEED, "--seconds", "4.0"], device="cpu",
               bench_dir=_bench(tmp_path), out=io.StringIO())
    assert res["correct"] is True, res["checks"]
    assert res["attempted"] >= 3  # every file, the CTD update's included
    checks = res["checks"]
    assert checks["nasc_max_db"]["value"] < 1e-4
    assert checks["position_max_deg"]["value"] < 1e-9
    assert set(checks) == {"nasc_max_db", "nan_mismatch", "grid_mismatch", "position_max_deg",
                           "ping_time_mismatch", "dist_boundary_pings"}


def test_control_fails_and_program_passes(tmp_path):
    rows = control.main(["--workload", CELL, "--seeds", "11", "2147483660", "--program"],
                        device="cpu", bench_dir=_bench(tmp_path), out=io.StringIO())
    assert [r["side"] for r in rows] == ["control_bf16", "program"] * 2
    for row in rows:
        over = [n for n, c in row["checks"].items() if c["value"] > c["limit"]]
        want = ["nasc_max_db", "position_max_deg"] if row["side"] == "control_bf16" else []
        assert over == want, row
