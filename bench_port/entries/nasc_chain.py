"""Entry ``nasc_chain``: per file ``open_raw`` -> ``compute_Sv`` ->
``add_depth`` -> ``add_location`` -> ``compute_NASC``.

Call ``i`` takes file ``i mod n`` of the cell's files, and the benchmark's
own spans time the five calls, as in the ``chain`` entry; the warm-up
call takes each file the workload's ``warm`` names, one chain each.
Every call's NASC, grid, mean ping times and positions are compared with
the plain reference (``reference/ek60_nasc.py``); a ping in another
distance bin shows in the exact mean ping times of the two bins.  The
judge sets the bound of the window's device work
(``roofline_nasc.py``) for the roofline reader.
"""

from __future__ import annotations

import importlib

import numpy as np
import torch

from bench_port import roofline_nasc
from bench_port.entries.chain import _timed, call_files, files_in_turn
from bench_port.reference import compare

__all__ = ["call", "call_files", "control_outputs", "files_in_turn", "judge", "setup",
           "warm_files"]

#: a ping this close (nmi) to a distance-bin edge could fall either side
#: between the port's and the reference's distances: 150 times the largest
#: gap read between the two along the cell's track (6.7e-12 nmi, CPU)
DIST_EPS_NMI = 1e-9


def setup(cell, seed, data_dir, device):
    cfg, wl = cell.config, cell.workload
    writer = importlib.import_module(f"bench_port.synth.{cfg['writer']}")
    made = writer.write_files(cfg, wl["traffic"], seed, data_dir, device)
    ref = importlib.import_module(f"bench_port.reference.{cfg['reference']}")
    return {"cell": cell, "made": made, "ref": ref, "device": device, "calls": 0}


def warm_files(state):
    """The set-up's warm call: the files the workload's ``warm`` names, one
    of each grid route."""
    return [state["made"][i][0] for i in state["cell"].workload["warm"]]


def _chain(state, path, rec):
    import echopype_torch as et

    a, dev = state["cell"].workload["args"], state["device"]
    ed = _timed(rec, "open_raw", lambda: et.open_raw(path, sonar_model=a["sonar_model"]))
    ds = _timed(rec, "compute_Sv", lambda: et.calibrate.compute_Sv(ed, device=dev))
    ds = _timed(rec, "add_depth",
                lambda: et.consolidate.add_depth(ds, depth_offset=float(a["depth_offset"])))
    ds = _timed(rec, "add_location", lambda: et.consolidate.add_location(
        ds, ed, nmea_sentence=a["nmea_sentence"]))
    nasc = _timed(rec, "compute_NASC", lambda: et.commongrid.compute_NASC(
        ds, range_bin=a["range_bin"], dist_bin=a["dist_bin"], skipna=bool(a["skipna"]),
        closed=a["closed"], device=dev))
    return ds, nasc


def call(state, files, rec, warm=False):
    for path in files[:-1]:
        _chain(state, path, rec)
    ds, nasc = _chain(state, files[-1], rec)
    got = {"file": None if warm else state["calls"] % len(state["made"]),
           "NASC": np.asarray(nasc["NASC"].values, dtype="f8"),
           "distance": np.asarray(nasc.coords["distance"].values, dtype="f8"),
           "depth": np.asarray(nasc.coords["depth"].values, dtype="f8"),
           "channel": [str(c) for c in nasc.coords["channel"].values],
           "ping_time": np.asarray(nasc["ping_time"].values, dtype="datetime64[ns]").astype("i8"),
           "latitude": np.asarray(nasc["latitude"].values, dtype="f8"),
           "longitude": np.asarray(nasc["longitude"].values, dtype="f8")}
    if not warm:
        state["calls"] += 1
    return got, int(ds["Sv"].shape[1])


def reference(state, file_no, device, dtype=torch.float64):
    a, cfg = state["cell"].workload["args"], state["cell"].config
    return state["ref"].nasc_file(cfg, state["made"][file_no][1],
                                  float(str(a["range_bin"]).rstrip("m")),
                                  float(str(a["dist_bin"]).rstrip("nmi")),
                                  float(a["depth_offset"]), dtype=dtype, device=device)


def control_outputs(state, device):
    """The lower-precision control in the program's place: each file's NASC
    by the reference with its per-sample and per-ping arithmetic in
    bfloat16 (its distance, and so each ping's distance bin, float64)."""
    return [{**reference(state, f, device, dtype=torch.bfloat16), "file": f}
            for f in range(len(state["made"]))]


def _db(v):
    with np.errstate(invalid="ignore", divide="ignore"):
        return 10 * np.log10(np.asarray(v, dtype="f8"))


def _grid_mismatch(o, ref):
    bad = int(np.shape(o["NASC"]) != np.shape(ref["NASC"]))
    bad += int(list(o["channel"]) != list(ref["channel"]))
    for key in ("distance", "depth"):
        a, b = np.asarray(o[key]), np.asarray(ref[key])
        bad += int(a.shape != b.shape or not np.array_equal(a, b))
    return bad


def _position_gap(o, ref):
    gap, nan_bad = 0.0, 0
    for key in ("latitude", "longitude"):
        a, b = np.asarray(o[key]), np.asarray(ref[key])
        if a.shape != b.shape:
            return float("inf"), max(a.size, b.size, 1)
        nan_bad += int(np.count_nonzero(np.isnan(a) != np.isnan(b)))
        both = np.isfinite(a) & np.isfinite(b)
        if both.any():
            gap = max(gap, float(np.max(np.abs(a[both] - b[both]))))
    return gap, nan_bad


def judge(state, outputs, device, rec):
    a = state["cell"].workload["args"]
    dist_bin = float(str(a["dist_bin"]).rstrip("nmi"))
    db, nan_bad, grid_bad, pos, pt_bad, edge_bad = float("-inf"), 0, 0, 0.0, 0, 0
    bound = 0.0
    for f in sorted({o["file"] for o in outputs}):
        ref = reference(state, f, device)
        C, P, R = state["made"][f][1]["power"].shape
        edge_bad += int(np.count_nonzero(np.abs(
            ref["dist"][:, None] - np.append(ref["distance"], ref["distance"][-1] + dist_bin)
            [None, :]) < DIST_EPS_NMI))
        for o in (o for o in outputs if o["file"] == f):
            db = max(db, compare.max_db_gap(_db(o["NASC"]), _db(ref["NASC"])))
            nan_bad += compare.nan_mismatch(o["NASC"], ref["NASC"])
            grid_bad += _grid_mismatch(o, ref)
            gap, bad = _position_gap(o, ref)
            pos, nan_bad = max(pos, gap), nan_bad + bad
            t, u = np.asarray(o["ping_time"]), np.asarray(ref["ping_time"])
            pt_bad += (max(t.size, u.size, 1) if t.shape != u.shape
                       else int(np.count_nonzero(t != u)))
            bound += roofline_nasc.call_bound_s(P, C, R, len(ref["distance"]), len(ref["depth"]))
        del ref
    if not outputs:
        db = float("inf")
    rec["nasc_bound_s"] = bound
    limits = state["cell"].workload["limits"]
    checks = [("nasc_max_db", db), ("nan_mismatch", float(nan_bad)),
              ("grid_mismatch", float(grid_bad)), ("position_max_deg", pos),
              ("ping_time_mismatch", float(pt_bad)), ("dist_boundary_pings", float(edge_bad))]
    return [(n, v, float(limits[n])) for n, v in checks]
