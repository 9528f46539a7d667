"""Entry ``bb_survey``: the broadband survey, ``run_survey_mvbs_from_raw``
over all of the cell's EK80 files with ``device_fused``.

Set-up, the call and the files of each call are the ``survey`` entry's;
this entry compares with the broadband reference (``reference/ek80.py``)
and sets the bound of the window's fused steps (``roofline_bb.py``) for
the roofline reader.
"""

from __future__ import annotations

import numpy as np
import torch

from bench_port import roofline_bb
from bench_port.entries.survey import (_metres, _seconds, call, call_files, files_in_turn,
                                       setup, warm_files)
from bench_port.reference import compare

__all__ = ["bf16x3_outputs", "call", "call_files", "control_outputs", "files_in_turn",
           "judge", "setup", "warm_files"]


def reference(state, device, dtype=torch.float64, mf="fft64"):
    kw = state["kwargs"]
    return state["ref"].survey_mvbs(state["cell"].config, state["made"],
                                     _metres(kw["range_bin"]), _seconds(kw["ping_time_bin"]),
                                     dtype=dtype, device=device, mf=mf)


def control_outputs(state, device):
    """The lower-precision control in the program's place: the reference's
    survey MVBS with its per-sample arithmetic in bfloat16."""
    return [reference(state, device, dtype=torch.bfloat16)]


def bf16x3_outputs(state, device):
    """The reference with its matched filter as three bfloat16 products
    with float32 sums (the port's "HIGH" arithmetic): a reading beside the
    limits."""
    return [reference(state, device, mf="bf16x3")]


def judge(state, outputs, device, rec):
    ref = reference(state, device)
    rec["bb_bound_s"] = survey_bound_s(state, ref) * len(outputs)
    checks = [
        ("mvbs_max_db", max((compare.max_db_gap(o["Sv"], ref["Sv"]) for o in outputs),
                            default=float("inf"))),
        ("mvbs_nan_mismatch", float(sum(compare.nan_mismatch(o["Sv"], ref["Sv"])
                                        for o in outputs))),
        ("grid_mismatch", float(sum(compare.grid_mismatch(o, ref) for o in outputs))),
    ]
    limits = state["cell"].workload["limits"]
    return [(n, v, float(limits[n])) for n, v in checks]


def survey_bound_s(state, ref):
    """Seconds one survey's fused steps need at the card's bound: a step a
    (file, channel, chunk), its replica's length from the reference."""
    cfg, kw = state["cell"].config, state["kwargs"]
    R, B = int(cfg["samples_per_ping"]), int(cfg["sectors"])
    filters = state["made"][0][1]["filters"]
    taps = [len(state["ref"].replica(cfg, ch, filters[ch["channel_id"]])[0])
            for ch in cfg["channels"]]
    bin_ns = _seconds(kw["ping_time_bin"]) * 1_000_000_000
    start, n_r = int(ref["ping_time"][0]), len(ref["echo_range"])
    chunk = int(kw["chunk_pings"])
    total = 0.0
    for _, tr in state["made"]:
        x = (np.asarray(tr["ping_time_ns"]) - start) // bin_ns
        for lo in range(0, len(x), chunk):
            hi = min(lo + chunk, len(x))
            W = int(x[hi - 1] - x[lo] + 1)
            total += sum(roofline_bb.step_bound_s(hi - lo, B, R, L, W, n_r) for L in taps)
    return total
