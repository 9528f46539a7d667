"""Entry ``survey``: ``run_survey_mvbs_from_raw`` over all of the cell's files.

The workload's ``args`` are the call's keywords (bins, chunk, prefetch,
sonar model, environment); the writer may add its own (AZFP: the
instrument XML).  The program's stage timer is the benchmark's
:class:`TracedStageTimer`, whose stages also open a ``stage:<name>`` span
while the profiler records, so the traced run names the device's idle gaps
by stage.  Every call's MVBS is compared with the plain reference's.
"""

from __future__ import annotations

import importlib
import contextlib

import numpy as np
import torch

from bench_port import roofline, tracing
from bench_port.reference import compare

__all__ = ["call", "call_files", "control_outputs", "files_in_turn", "judge", "per_sample_gap",
           "setup", "warm_files"]


def _timer():
    from echopype_torch.utils.profiling import StageTimer

    class TracedStageTimer(StageTimer):
        @contextlib.contextmanager
        def stage(self, name):
            span = (torch.profiler.record_function(f"stage:{name}")
                    if torch.autograd._profiler_enabled() else contextlib.nullcontext())
            with span, super().stage(name) as holder:
                yield holder

    return TracedStageTimer()


def setup(cell, seed, data_dir, device):
    cfg, wl = cell.config, cell.workload
    writer = importlib.import_module(f"bench_port.synth.{cfg['writer']}")
    made, extra = writer.write_files(cfg, wl["traffic"], seed, data_dir, device), {}
    if isinstance(made, tuple):
        made, extra = made
    ref = importlib.import_module(f"bench_port.reference.{cfg['reference']}")
    return {"cell": cell, "made": made, "kwargs": {**wl["args"], **extra}, "ref": ref,
            "device": device,
            "pings": sum(int(tr["ping_time_ns"].shape[0]) for _, tr in made)}


def call_files(state, i):
    return [p for p, _ in state["made"]]


def warm_files(state):
    """The set-up's warm call: the workload's ``warm`` files, one of each
    path the survey takes (K1, K2), not the whole survey."""
    return [state["made"][i][0] for i in state["cell"].workload["warm"]]


def files_in_turn(state):
    """Calls that take every file once: one survey."""
    return 1


def call(state, files, rec, warm=False):
    import echopype_torch as et

    timer = _timer()
    with tracing.span("survey"):
        out = et.run_survey_mvbs_from_raw(files, timer=timer, device=state["device"],
                                          **state["kwargs"])
    for name, t in timer.totals.items():
        rec["stages"][name] = rec["stages"].get(name, 0.0) + t
    got = {"Sv": np.asarray(out["Sv"].values, dtype="f8"),
           "ping_time": np.asarray(out.coords["ping_time"].values,
                                   dtype="datetime64[ns]").astype("i8"),
           "echo_range": np.asarray(out.coords["echo_range"].values, dtype="f8"),
           "channel": [str(c) for c in out.coords["channel"].values]}
    return got, state["pings"]


def reference(state, device, dtype=torch.float64, per_sample=False):
    kw, cfg = state["kwargs"], state["cell"].config
    return state["ref"].survey_mvbs(cfg, state["made"], _metres(kw["range_bin"]),
                                    _seconds(kw["ping_time_bin"]), int(kw["chunk_pings"]),
                                    env=kw.get("env_params"), dtype=dtype, device=device,
                                    per_sample=per_sample)


def control_outputs(state, device):
    """The lower-precision control in the program's place: the reference's
    survey MVBS with its per-sample arithmetic in bfloat16."""
    return [reference(state, device, dtype=torch.bfloat16)]


def judge(state, outputs, device, rec):
    ref = reference(state, device)
    rec["kernel_bytes"] = survey_bytes(state, ref) * len(outputs)
    checks = [
        ("mvbs_max_db", max((compare.max_db_gap(o["Sv"], ref["Sv"]) for o in outputs),
                            default=float("inf"))),
        ("mvbs_nan_mismatch", float(sum(compare.nan_mismatch(o["Sv"], ref["Sv"])
                                        for o in outputs))),
        ("grid_mismatch", float(sum(compare.grid_mismatch(o, ref) for o in outputs))),
    ]
    limits = state["cell"].workload["limits"]
    return [(n, v, float(limits[n])) for n, v in checks]


def per_sample_gap(state, outputs, device):
    """How far the program's survey MVBS lies from ``compute_MVBS``'s rule,
    every sample binned by its own range (a reading beside the cell's
    limits, which hold the streamer's rule): the widest gap, the bins
    farther than the cell's limit, the NaN-mask mismatches."""
    ref = reference(state, device, per_sample=True)
    lim = float(state["cell"].workload["limits"]["mvbs_max_db"])
    over = 0
    for o in outputs:
        a, b = np.asarray(o["Sv"]), ref["Sv"]
        both = np.isfinite(a) & np.isfinite(b)
        over += int(np.count_nonzero(np.abs(a[both] - b[both]) > lim))
    return [("per_sample_max_db", max(compare.max_db_gap(o["Sv"], ref["Sv"]) for o in outputs),
             lim),
            ("per_sample_bins_over", float(over), 0.0),
            ("per_sample_nan_mismatch",
             float(sum(compare.nan_mismatch(o["Sv"], ref["Sv"]) for o in outputs)), 0.0)]


def survey_bytes(state, ref):
    """Bytes one survey's window steps need (:mod:`bench_port.roofline`)."""
    kw, cfg = state["kwargs"], state["cell"].config
    bin_ns = _seconds(kw["ping_time_bin"]) * 1_000_000_000
    start, n_r = int(ref["ping_time"][0]), len(ref["echo_range"])
    chunk = int(kw["chunk_pings"])
    total = 0
    for _, tr in state["made"]:
        uniform, samples, itemsize = state["ref"].kernel_layout(cfg, tr)
        x = (tr["ping_time_ns"] - start) // bin_ns
        C = len(cfg["channels"])
        for lo in range(0, len(x), chunk):
            hi = min(lo + chunk, len(x))
            total += roofline.window_partials_bytes(C, hi - lo, samples, itemsize,
                                                    int(x[hi - 1] - x[lo] + 1), n_r, uniform)
    return total


def _metres(s):
    return float(str(s).rstrip("m"))


def _seconds(s):
    return int(str(s).rstrip("s"))
