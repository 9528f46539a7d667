"""Each metric reader on a recorded run, and the trace reduction."""

import pytest
from tiny import BENCH, manifest

from bench_port import tracing
from bench_port.harness import load_module
from bench_port.roofline import HBM_BYTES_PER_S

K1 = "void (anonymous namespace)::slab_partials_kernel<short, true, true>(Args<short>)"

SURVEY = {
    "pings": 50_000, "window_s": 20.0, "setup_s": 21.5,
    "stages": {"scan": 3.5, "ingest": 12.5, "to_int16": 3.75, "device_mvbs": 0.25,
               "accumulate": 0.005, "finalize": 0.01},
    "spans": {}, "kernel_bytes": 2.0e9,
    "trace": {"busy_s": 0.3, "window_s": 20.0, "kernels": {K1: 0.0012, "other": 1.0}},
}
CHAIN = {
    "pings": 8_000, "window_s": 10.0, "setup_s": 14.0, "stages": {},
    "spans": {"open_raw": 2.4, "compute_Sv": 0.7, "compute_MVBS": 8.0},
    "trace": {"busy_s": 0.05, "window_s": 10.0, "kernels": {}},
}
WANT = {
    "survey_pings_per_s": (SURVEY, 2500.0),
    "setup_s": (SURVEY, 21.5),
    "decode_ms_per_kping.survey": (SURVEY, 16.0 * 1e3 / 50),
    "staging_ms_per_kping.survey": (SURVEY, 3.75 * 1e3 / 50),
    "accumulate_ms_per_kping.survey": (SURVEY, 0.005 * 1e3 / 50),
    "device_step_ms_per_kping.survey": (SURVEY, 0.25 * 1e3 / 50),
    "window_kernels_roofline_pct.survey": (SURVEY, 100 * 2.0e9 / HBM_BYTES_PER_S / 0.0012),
    "device_idle_pct.survey": (SURVEY, 98.5),
    "chain_pings_per_s": (CHAIN, 800.0),
    "open_raw_ms_per_kping.chain": (CHAIN, 300.0),
    "compute_sv_ms_per_kping.chain": (CHAIN, 87.5),
    "compute_mvbs_ms_per_kping.chain": (CHAIN, 1000.0),
    "device_idle_pct.chain": (CHAIN, 99.5),
}


def _reader(name):
    return load_module(BENCH / "metrics" / f"{name}.py", "t_" + name.replace(".", "_"))


def test_every_manifest_metric_has_a_reader_and_a_case():
    names = {m["name"] for g in ("end_to_end", "per_layer") for m in manifest()[g]}
    assert names == set(WANT)
    assert {p.stem for p in (BENCH / "metrics").glob("*.py")} == names


@pytest.mark.parametrize("name", sorted(WANT))
def test_reader_on_a_recorded_run(name):
    rec, want = WANT[name]
    assert _reader(name).read(rec) == pytest.approx(want, rel=1e-12)


EMPTY = {"pings": 0, "window_s": 0.0, "setup_s": 1.0, "stages": {}, "spans": {},
         "trace": None}


@pytest.mark.parametrize("name", sorted(n for n in WANT if n != "setup_s"))
def test_reader_finds_nothing_in_a_run_without_its_source(name):
    """No pings, stages, spans or trace: every reader but set-up's is silent
    (the manifest's ``workloads`` decides which cells report a metric)."""
    assert _reader(name).read(EMPTY) is None


@pytest.mark.parametrize("name", sorted(n for n in WANT if n.endswith(("_pct.survey", "_pct.chain"))))
def test_trace_reader_finds_nothing_in_an_untraced_run(name):
    rec, _ = WANT[name]
    assert _reader(name).read(dict(rec, trace=None)) is None


def test_trace_reduction_busy_idle_and_host_attribution():
    ev = [
        {"ph": "X", "cat": "user_annotation", "name": "bench:window", "ts": 0, "dur": 100},
        {"ph": "X", "cat": "user_annotation", "name": "bench:survey", "ts": 0, "dur": 100},
        {"ph": "X", "cat": "user_annotation", "name": "stage:scan", "ts": 10, "dur": 30},
        {"ph": "X", "cat": "kernel", "name": "k", "ts": 20, "dur": 10},
        {"ph": "X", "cat": "gpu_memcpy", "name": "copy", "ts": 25, "dur": 10},
        {"ph": "X", "cat": "kernel", "name": "k", "ts": 90, "dur": 20},
    ]
    out = tracing.reduce_trace(ev)
    assert out["window_s"] == pytest.approx(100e-6)
    assert out["busy_s"] == pytest.approx(25e-6)  # [20, 35) and [90, 100)
    assert out["kernels"]["k"] == pytest.approx(20e-6)
    idle = dict(out["breakdown"]["idle_gaps"])
    assert idle["stage:scan"] == pytest.approx(15e-6)  # [10, 20) and [35, 40)
    assert idle["bench:survey"] == pytest.approx(60e-6)  # [0, 10) and [40, 90)
    assert out["breakdown"]["device_ops"][0] == ["k", pytest.approx(20e-6)]
