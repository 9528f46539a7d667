"""Entry ``chain``: per file ``open_raw`` -> ``compute_Sv`` -> ``compute_MVBS``.

Call ``i`` takes file ``i mod n`` of the cell's files.  The benchmark's own
spans (host clock, and ``bench:<name>`` profiler spans while tracing) time
the three calls.  Every call's MVBS is compared with the plain reference's;
so is the whole Sv of a sample of the calls, drawn from the seed (the Sv
of one file is C x P x R floats, too many to keep for every call).
"""

from __future__ import annotations

import importlib
import time

import numpy as np
import torch

from bench_port import tracing
from bench_port.reference import compare

__all__ = ["call", "call_files", "control_outputs", "files_in_turn", "judge", "setup",
           "warm_files"]

#: share of the window's calls whose Sv is kept and compared
SV_SAMPLE_SHARE = 0.25


def setup(cell, seed, data_dir, device):
    cfg, wl = cell.config, cell.workload
    writer = importlib.import_module(f"bench_port.synth.{cfg['writer']}")
    made = writer.write_files(cfg, wl["traffic"], seed, data_dir, device)
    ref = importlib.import_module(f"bench_port.reference.{cfg['reference']}")
    keep = np.random.default_rng(int(seed) % 2**63).random(100_000) < SV_SAMPLE_SHARE
    keep[0] = True  # every window compares at least one call's Sv
    return {"cell": cell, "made": made, "ref": ref, "device": device, "keep": keep,
            "calls": 0}


def call_files(state, i):
    return [state["made"][i % len(state["made"])][0]]


def warm_files(state):
    """The set-up's warm call: one file (the workload's ``warm``)."""
    (i,) = state["cell"].workload["warm"]
    return [state["made"][i][0]]


def files_in_turn(state):
    """Calls that take every file once."""
    return len(state["made"])


def _timed(rec, name, fn):
    t0 = time.perf_counter()
    with tracing.span(name):
        out = fn()
    rec["spans"][name] = rec["spans"].get(name, 0.0) + time.perf_counter() - t0
    return out


def call(state, files, rec, warm=False):
    import echopype_torch as et

    args, dev = state["cell"].workload["args"], state["device"]
    (path,) = files
    i = None if warm else state["calls"]
    ed = _timed(rec, "open_raw", lambda: et.open_raw(path, sonar_model=args["sonar_model"]))
    ds = _timed(rec, "compute_Sv", lambda: et.calibrate.compute_Sv(ed, device=dev))
    mvbs = _timed(rec, "compute_MVBS", lambda: et.commongrid.compute_MVBS(
        ds, range_bin=args["range_bin"], ping_time_bin=args["ping_time_bin"], device=dev))
    got = {"file": None if warm else i % len(state["made"]),
           "Sv": np.asarray(mvbs["Sv"].values, dtype="f8"),
           "ping_time": np.asarray(mvbs.coords["ping_time"].values,
                                   dtype="datetime64[ns]").astype("i8"),
           "echo_range": np.asarray(mvbs.coords["echo_range"].values, dtype="f8"),
           "channel": [str(c) for c in mvbs.coords["channel"].values],
           "Sv_samples": None}
    if not warm:
        if state["keep"][i % len(state["keep"])]:
            got["Sv_samples"] = np.asarray(ds["Sv"].values)
        state["calls"] += 1
    return got, int(ds["Sv"].shape[1])


def reference(state, file_no, device, dtype=torch.float64, with_sv=True):
    args, cfg = state["cell"].workload["args"], state["cell"].config
    return state["ref"].chain_file(cfg, state["made"][file_no][1],
                                   float(str(args["range_bin"]).rstrip("m")),
                                   int(str(args["ping_time_bin"]).rstrip("s")),
                                   dtype=dtype, device=device, with_sv=with_sv)


def control_outputs(state, device):
    """The lower-precision control in the program's place: each file's Sv
    and MVBS by the reference with its per-sample arithmetic in bfloat16."""
    out = []
    for f in range(len(state["made"])):
        r = reference(state, f, device, dtype=torch.bfloat16)
        out.append({**r, "file": f})
    return out


def judge(state, outputs, device, rec):
    mvbs_db, sv_db, nan_bad, grid_bad = float("-inf"), float("-inf"), 0, 0
    for f in sorted({o["file"] for o in outputs}):
        mine = [o for o in outputs if o["file"] == f]
        with_sv = any(o["Sv_samples"] is not None for o in mine)
        ref = reference(state, f, device, with_sv=with_sv)
        for o in mine:
            mvbs_db = max(mvbs_db, compare.max_db_gap(o["Sv"], ref["Sv"]))
            nan_bad += compare.nan_mismatch(o["Sv"], ref["Sv"])
            grid_bad += compare.grid_mismatch(o, ref)
            if o["Sv_samples"] is not None:
                sv_db = max(sv_db, compare.max_db_gap(o["Sv_samples"], ref["Sv_samples"]))
                nan_bad += compare.nan_mismatch(o["Sv_samples"], ref["Sv_samples"])
        del ref
    if not outputs:
        mvbs_db = float("inf")
    limits = state["cell"].workload["limits"]
    checks = [("mvbs_max_db", mvbs_db), ("sv_max_db", max(sv_db, 0.0)),
              ("nan_mismatch", float(nan_bad)), ("grid_mismatch", float(grid_bad))]
    return [(n, v, float(limits[n])) for n, v in checks]
