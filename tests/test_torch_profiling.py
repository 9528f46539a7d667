"""``utils.profiling.trace``: a ``torch.profiler`` window written as a Chrome
trace, the counterpart of the JAX package's ``jax.profiler`` hook.

On the CPU (no CUDA initialised, so host activity only): a raw EK60 survey
traced into a fresh directory writes one ``*.pt.trace.json`` whose events
hold the survey's torch ops (the plain twin of K1 runs ``aten::exp`` and
the bin sums); the yielded profiler's ``key_averages()`` lists them too.
A body that raises still writes its trace and the error propagates.
``launch_span`` (the kernel wrappers' launch mark) is a no-op outside a
profiler window and a named host span inside one.  The port's xarray
facade carries a module spec, so a trace opens with it installed as
``xarray``.

Stages and counters: a stage is a no-op outside a window and a
``stage:<name>`` span inside one, over the interval its timer adds; the
window's stages and counters collect in ``profiling.TRACED``, which
``trace`` clears on entry.  The chain open_raw -> compute_Sv ->
compute_MVBS emits its nine stages as siblings, the streamed survey its
wait for the decode thread on the main thread; the power streamer counts
staged and padded pings, the window step the bytes it hands the device;
and no result changes under a window.

The profiler's first window imports torch's compiler stack, which runs
``importlib.util.find_spec`` over a list of packages, ``xarray`` among
them; the JAX package's facade, which the reference-oracle tests install
into ``sys.modules`` of the same process, has no spec and makes that
raise, so each test here runs with such a module out of ``sys.modules``.
"""

import ast
import contextlib
import importlib.util
import json
import sys
import threading
import time

import numpy as np
import pytest
import torch

import echopype_torch as et
from echopype_torch.utils import profiling
from echopype_torch.parallel import pipeline
from echopype_torch.utils.profiling import TRACED, StageTimer, launch_span, trace

from synth_ek60 import write_ek60_raw

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def no_specless_xarray(monkeypatch):
    mod = sys.modules.get("xarray")
    if mod is not None and getattr(mod, "__spec__", None) is None:
        monkeypatch.delitem(sys.modules, "xarray")


@pytest.fixture(autouse=True)
def traced_left_empty():
    yield
    TRACED.clear()


@pytest.fixture(scope="module")
def raw(tmp_path_factory):
    path = tmp_path_factory.mktemp("trace") / "T-D20200101-T000000.raw"
    write_ek60_raw(path, n_pings=30, n_samples=200, with_angle=False)
    return str(path)


@pytest.fixture(scope="module")
def raw_pair(tmp_path_factory):
    d = tmp_path_factory.mktemp("pair")
    paths = [d / "T-D20200101-T000000.raw", d / "T-D20200101-T001000.raw"]
    for i, path in enumerate(paths):
        write_ek60_raw(path, n_pings=30, n_samples=200, with_angle=False, seed=i,
                       t0=np.datetime64("2020-01-01T00:00:00", "ns") + np.timedelta64(600 * i, "s"))
    return [str(p) for p in paths]


def _events(log_dir):
    files = sorted(log_dir.glob("*.pt.trace.json"))
    assert len(files) == 1
    return json.loads(files[0].read_text())["traceEvents"]


def test_trace_writes_survey_ops(raw, tmp_path):
    log_dir = tmp_path / "trace"
    timer = StageTimer()
    with trace(str(log_dir)) as prof:
        mvbs = et.run_survey_mvbs_from_raw([raw], range_bin="5m", ping_time_bin="10s",
                                           chunk_pings=16, timer=timer, device="cpu")
    assert np.isfinite(mvbs["Sv"].values).any()
    names = {e.get("name") for e in _events(log_dir)}
    assert {"aten::exp", "aten::copy_"} <= names
    assert any(n.startswith("aten::") for n in names if n)
    ops = {a.key for a in prof.key_averages()}
    assert "aten::exp" in ops
    assert not torch.cuda.is_initialized()
    assert "ingest" in timer.report(log=False)


def test_trace_writes_on_error_and_propagates(tmp_path):
    log_dir = tmp_path / "err"
    with pytest.raises(ZeroDivisionError):
        with trace(str(log_dir)):
            torch.ones(3).exp()
            1 / 0
    assert "aten::exp" in {e.get("name") for e in _events(log_dir)}


def test_trace_is_exported():
    assert "trace" in profiling.__all__ and "StageTimer" in profiling.__all__


def test_launch_span_only_while_recording(tmp_path):
    assert isinstance(launch_span("ep_probe"), contextlib.nullcontext)
    with trace(str(tmp_path)):
        with launch_span("ep_probe"):
            torch.ones(2).exp()
    spans = [e for e in _events(tmp_path) if e.get("name") == "ep_probe"]
    assert [e.get("cat") for e in spans] == ["user_annotation"]


def test_trace_with_the_port_xarray_facade(tmp_path):
    from echopype_torch.xrlite import xarray_compat
    from test_torch_datatree import restoring_xarray_modules

    with restoring_xarray_modules():
        assert xarray_compat.install(force=True)
        assert importlib.util.find_spec("xarray") is sys.modules["xarray"].__spec__
        with trace(str(tmp_path)):
            torch.ones(2).exp()
    assert "aten::exp" in {e.get("name") for e in _events(tmp_path)}


CHAIN_STAGES = ("parse_raw", "set_groups", "cal_inputs", "power_cal_device", "sv_assemble",
                "mvbs_prepare", "bin_membership", "bin_device", "mvbs_assemble")


def _stage_spans(events):
    return [e for e in events if e.get("ph") == "X" and e.get("cat") == "user_annotation"
            and e["name"].startswith("stage:")]


def _chain(path):
    ed = et.open_raw(path, sonar_model="EK60")
    ds = et.calibrate.compute_Sv(ed, device="cpu")
    mvbs = et.commongrid.compute_MVBS(ds, range_bin="5m", ping_time_bin="10s", device="cpu")
    return ds, mvbs


def test_stage_and_count_are_no_ops_outside_a_window():
    ctx = profiling.stage("probe")
    assert isinstance(ctx, contextlib.nullcontext)
    with ctx as holder:
        assert holder is None
    profiling.count("probe_n", 3)
    assert TRACED.report(log=False) == {} and not TRACED.counters


@pytest.mark.parametrize("with_timer", [False, True])
def test_stage_is_a_span_over_the_interval_its_timer_adds(with_timer, tmp_path):
    timer = StageTimer() if with_timer else None
    with trace(str(tmp_path)):
        with profiling.stage("probe", timer) as holder:
            holder.append(torch.ones(2))
            time.sleep(0.02)
        profiling.count("probe_n", 5, timer)
    (span,) = [e for e in _stage_spans(_events(tmp_path)) if e["name"] == "stage:probe"]
    total = TRACED.totals["probe"]
    assert TRACED.counts["probe"] == 1 and TRACED.counters["probe_n"] == 5
    assert total >= 0.02 and total <= span["dur"] * 1e-6 <= total + 0.05
    if with_timer:
        assert timer.totals["probe"] == total and timer.counters["probe_n"] == 5
        assert list(timer.report(log=False)) == ["probe"]


def test_threads_sharing_a_timer_lose_no_update():
    timer, n_threads, n = StageTimer(), 16, 2000
    interval = sys.getswitchinterval()

    def work():
        for _ in range(n):
            timer.count("items", 1)
            with timer.stage("step"):
                pass

    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work) for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(interval)
    assert timer.counters["items"] == timer.counts["step"] == n_threads * n


def test_trace_clears_traced(tmp_path):
    TRACED.count("stale", 1)
    with TRACED.stage("stale_stage"):
        pass
    assert "stale_stage" in TRACED.report(log=False) and "stale" in TRACED.counters
    with trace(str(tmp_path)):
        assert TRACED.report(log=False) == {} and not TRACED.counters


def test_chain_emits_its_nine_stages_as_siblings(raw, tmp_path):
    with trace(str(tmp_path)):
        _chain(raw)
    spans = _stage_spans(_events(tmp_path))
    assert {e["name"] for e in spans} == {f"stage:{n}" for n in CHAIN_STAGES}
    assert set(TRACED.totals) == set(CHAIN_STAGES)
    for a in spans:  # no stage lies inside another: each name's total is self time
        for b in spans:
            if a is not b:
                assert not (b["ts"] <= a["ts"] and a["ts"] + a["dur"] <= b["ts"] + b["dur"]), \
                    (a["name"], b["name"])


def test_streamed_survey_waits_for_decode_on_the_main_thread(raw_pair, tmp_path):
    timer = StageTimer()
    with trace(str(tmp_path)):
        et.run_survey_mvbs_from_raw(raw_pair, range_bin="5m", ping_time_bin="10s",
                                    chunk_pings=16, timer=timer, prefetch=True, device="cpu")
    spans = _stage_spans(_events(tmp_path))
    waits = [e for e in spans if e["name"] == "stage:wait_decode"]
    scans = [e for e in spans if e["name"] == "stage:scan"]
    assert len(waits) == 2 and {e["tid"] for e in waits} == {scans[0]["tid"]}
    # the decode runs on the prefetch thread, which the profiler does not record
    assert "stage:ingest" not in {e["name"] for e in spans}
    assert timer.counts["ingest"] == 2 and "ingest" not in TRACED.totals
    assert TRACED.counts["wait_decode"] == timer.counts["wait_decode"] == 2
    assert threading.current_thread() is threading.main_thread()


@pytest.mark.parametrize("prefetch", [True, False])
def test_power_streamer_counts_staged_and_padded_pings(raw, prefetch, tmp_path):
    """30 pings in 16-ping chunks: two chunks, 32 pings staged, 2 of them padding."""
    timer = StageTimer()
    with trace(str(tmp_path)):
        et.run_survey_mvbs_from_raw([raw], range_bin="5m", ping_time_bin="10s",
                                    chunk_pings=16, timer=timer, prefetch=prefetch, device="cpu")
    for t in (timer, TRACED):
        assert t.counters["staged_pings"] == 32 and t.counters["padded_pings"] == 2


@pytest.mark.parametrize("prefetch", [True, False])
def test_survey_report_rows_are_stages_only(raw, prefetch):
    """Counters stay out of ``report()``: every row is a stage's
    {"total_s", "count"}, as callers that read ``total_s`` of each row expect."""
    timer = StageTimer()
    out = et.run_survey_mvbs_from_raw([raw], range_bin="5m", ping_time_bin="10s",
                                      chunk_pings=16, timer=timer, prefetch=prefetch, device="cpu")
    report = timer.report(log=False)
    totals = {k: v["total_s"] for k, v in report.items()}
    assert "ingest" in totals and not set(timer.counters) & set(report)
    assert all(set(v) == {"total_s", "count"} for v in report.values())
    assert timer.counters["staged_pings"] == 32
    attrs = ast.literal_eval(out.attrs["stage_timing"])
    assert attrs and all(set(v) == {"total_s", "count"} for v in attrs.values())


def test_h2d_bytes_counts_the_operands_bytes(tmp_path):
    ops = {"power": np.zeros((2, 16, 40), dtype="<i2"),
           "dr": np.ones((2, 32), dtype="f4")[:, ::2],  # not contiguous
           "xb": np.arange(5, dtype="i4"), "plan": np.arange(3, dtype="i8")}
    with trace(str(tmp_path)):
        got = pipeline._to_device(ops, "cpu")
    assert TRACED.counters["h2d_bytes"] == sum(v.nbytes for v in ops.values()) == 2732
    for k, v in ops.items():
        np.testing.assert_array_equal(got[k].numpy(), v)


def test_survey_h2d_bytes_are_its_window_steps_operands(raw, tmp_path, monkeypatch):
    handed = []
    to_device = pipeline._to_device

    def spy(ops, dev):
        handed.append(sum(np.ascontiguousarray(v).nbytes for v in ops.values()))
        return to_device(ops, dev)

    monkeypatch.setattr(pipeline, "_to_device", spy)
    with trace(str(tmp_path)):
        et.run_survey_mvbs_from_raw([raw], range_bin="5m", ping_time_bin="10s",
                                    chunk_pings=16, timer=StageTimer(), device="cpu")
    assert len(handed) == 2 and TRACED.counters["h2d_bytes"] == sum(handed)


@pytest.mark.parametrize("path", ["chain", "survey"])
def test_results_bit_identical_under_a_window(raw, path, tmp_path):
    def run():
        if path == "chain":
            ds, mvbs = _chain(raw)
            return [ds["Sv"].values, ds["echo_range"].values, mvbs["Sv"].values]
        out = et.run_survey_mvbs_from_raw([raw], range_bin="5m", ping_time_bin="10s",
                                          chunk_pings=16, device="cpu")
        return [out["Sv"].values]

    plain = run()
    with trace(str(tmp_path)):
        traced = run()
    assert TRACED.totals
    for a, b in zip(plain, traced):
        np.testing.assert_array_equal(a, b)
