"""Entry ``fd_survey``: the frequency-differenced survey,
``run_survey_mvbs_from_raw(..., freq_diff=...)`` over all of the cell's
EK60 files.

Set-up, the call and the files of each call are the ``survey`` entry's
(the workload's ``args`` carry ``freq_diff``); this entry compares with the
masked reference (``reference/ek60_fd.py``) under its boundary rule and
sets the bound of the window's masked steps (``roofline_fd.py``) for the
roofline reader.
"""

from __future__ import annotations

import numpy as np
import torch

from bench_port import roofline_fd
from bench_port.entries.survey import (_metres, _seconds, call, call_files, files_in_turn,
                                       setup, warm_files)
from bench_port.reference import compare, ek60_fd

__all__ = ["call", "call_files", "control_outputs", "files_in_turn", "judge", "setup",
           "warm_files"]


def reference(state, device, dtype=torch.float64):
    kw = state["kwargs"]
    return ek60_fd.survey_mvbs(state["cell"].config, state["made"], _metres(kw["range_bin"]),
                               _seconds(kw["ping_time_bin"]), int(kw["chunk_pings"]),
                               kw["freq_diff"], dtype=dtype, device=device)


def control_outputs(state, device):
    """The lower-precision control in the program's place: the masked
    reference with its per-sample arithmetic, the mask's included, in
    bfloat16."""
    return [reference(state, device, dtype=torch.bfloat16)]


def judge(state, outputs, device, rec):
    ref = reference(state, device)
    rec["fd_bound_s"] = survey_bound_s(state, ref) * len(outputs)
    lim = state["cell"].workload["limits"]
    got = [ek60_fd.boundary_readings(o["Sv"], ref, float(lim["mvbs_max_db"])) for o in outputs]
    checks = [
        ("mvbs_max_db", max((g["max_db"] for g in got), default=float("inf"))),
        ("mvbs_nan_mismatch", float(sum(g["nan_mismatch"] for g in got))),
        ("grid_mismatch", float(sum(compare.grid_mismatch(o, ref) for o in outputs))),
        ("fd_boundary_bins_unmatched", float(sum(g["unmatched"] for g in got))),
        ("fd_boundary_samples", float(ref["boundary"]["x"].shape[0])),
        ("fd_boundary_bins", float(max((g["boundary_bins"] for g in got), default=0))),
    ]
    return [(n, v, float(lim[n])) for n, v in checks]


def survey_bound_s(state, ref):
    """Seconds one survey's masked steps need at the card's bound: a step a
    chunk of each file, its windows from the reference's ping bins."""
    cfg, kw = state["cell"].config, state["kwargs"]
    C, R = len(cfg["channels"]), int(cfg["samples_per_ping"])
    bin_ns = _seconds(kw["ping_time_bin"]) * 1_000_000_000
    start, n_r = int(ref["ping_time"][0]), len(ref["echo_range"])
    chunk = int(kw["chunk_pings"])
    total = 0.0
    for _, tr in state["made"]:
        x = (np.asarray(tr["ping_time_ns"]) - start) // bin_ns
        for lo in range(0, len(x), chunk):
            hi = min(lo + chunk, len(x))
            total += roofline_fd.step_bound_s(hi - lo, C, R, int(x[hi - 1] - x[lo] + 1), n_r)
    return total
