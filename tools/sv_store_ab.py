#!/usr/bin/env python3
"""Time the Sv-store streamers of two checkouts on one CUDA card, in turns.

Run from the root of a checkout on a machine with an NVIDIA card:

    python3 tools/sv_store_ab.py --other DIR [--reps 3]

``DIR`` is another checkout (for example the parent commit unpacked with
``git archive`` into ``build/``).  For each checkout in the order this,
other, other, this (each in its own process, which imports
``echopype_torch`` from that checkout), ``run_survey_mvbs`` and
``run_survey_nasc`` run with ``mesh=None`` on ``cuda`` over two in-memory
layouts, ``reps`` times each:

- ``dryrun``: ``chip_smoke.mesh_sv_datasets`` (6 channels, 40,000 + 40,000
  + 21,056 pings, R = 64, chunks of 4,096) and ``mesh_nasc_datasets``;
- ``wide``: one file at the survey's width (5 channels x 10,000 pings x
  4,000 samples, 20 m x 20 s, chunks of 5,000), MVBS only.

Each run's wall and its ``device_binning`` stage are kept (median of the
reps).  The MVBS / NASC of the two checkouts are compared (max abs dB,
max relative).  Prints the card's name and power limit, then one JSON
object last, also written to ``chiprun_out/sv_store_ab.json``.  Imports
nothing of JAX.
"""

import argparse
import json
import pickle
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
OUT = ROOT / "chiprun_out"
WIDE_C, WIDE_P, WIDE_R = 5, 10_000, 4_000


def _wide(Dataset, seed=5):
    rng = np.random.default_rng(seed)
    t0 = np.datetime64("2021-01-01T00:00:00", "ns")
    dims = ("channel", "ping_time", "range_sample")
    ds = Dataset(coords={
        "channel": np.asarray([f"ch{k}" for k in range(WIDE_C)], dtype=object),
        "ping_time": t0 + (np.arange(WIDE_P) * 1_000_000_000).astype("timedelta64[ns]"),
        "range_sample": np.arange(WIDE_R)})
    ds["Sv"] = (dims, rng.normal(-70.0, 8.0, (WIDE_C, WIDE_P, WIDE_R)).astype("f4"))
    ds["echo_range"] = (dims, np.broadcast_to(np.arange(WIDE_R, dtype="f4") * 0.1875,
                                              (WIDE_C, WIDE_P, WIDE_R)).copy())
    return [ds]


def child(root, reps, out_path):
    """One checkout's runs; pickles {run: (walls, device_binning s, values)}."""
    import importlib.util

    sys.path.insert(0, str(root))
    import torch

    import echopype_torch as et

    # this checkout's chip_smoke (its data makers), the package from ``root``
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    chip_smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip_smoke)
    from echopype_torch.utils.profiling import StageTimer
    from echopype_torch.xrlite import Dataset

    assert Path(et.__file__).resolve().is_relative_to(Path(root).resolve()), et.__file__
    svs = chip_smoke.mesh_sv_datasets()
    nsv = chip_smoke.mesh_nasc_datasets()
    wide = _wide(Dataset)
    nkw = dict(range_bin="5m", dist_bin="0.1nmi", chunk_pings=4096, noise_masks={
        "impulse": dict(depth_bin="2m", num_side_pings=2, impulse_noise_threshold="10.0dB",
                        range_var="depth")})
    runs = {
        "dryrun_mvbs": (et.run_survey_mvbs, svs,
                        dict(range_bin="5m", ping_time_bin="20s", chunk_pings=4096), "Sv"),
        "dryrun_nasc": (et.run_survey_nasc, nsv, nkw, "NASC"),
        "wide_mvbs": (et.run_survey_mvbs, wide,
                      dict(range_bin="20m", ping_time_bin="20s", chunk_pings=5000), "Sv"),
    }
    got = {}
    for tag, (fn, data, kw, var) in runs.items():
        fn(data, device="cuda", **kw)  # warm-up: allocator, first launches
        walls, binning = [], []
        for _ in range(reps):
            timer = StageTimer()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = fn(data, device="cuda", timer=timer, **kw)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
            binning.append(timer.report(log=False)["device_binning"]["total_s"])
        got[tag] = (walls, binning, np.asarray(res[var].values))
    with open(out_path, "wb") as f:
        pickle.dump(got, f)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--other", required=True, help="root of the other checkout")
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--child", help=argparse.SUPPRESS)
    ap.add_argument("--out", help=argparse.SUPPRESS)
    a = ap.parse_args()
    if a.child:
        return child(a.child, a.reps, a.out)
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("sv_store_ab: this needs a CUDA card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    OUT.mkdir(exist_ok=True)
    roots = {"this": ROOT, "other": Path(a.other).resolve()}
    order = ("this", "other", "other", "this")
    turns = []
    for i, name in enumerate(order):
        out = OUT / f"sv_store_ab.{i}.pkl"
        subprocess.run([sys.executable, __file__, "--other", a.other, "--reps", str(a.reps),
                        "--child", str(roots[name]), "--out", str(out)], check=True,
                       timeout=1200)
        with open(out, "rb") as f:
            turns.append((name, pickle.load(f)))
        out.unlink()
    result = {"card": smi, "order": list(order), "reps": a.reps, "runs": {}}
    for tag in turns[0][1]:
        row = {}
        for i, (name, got) in enumerate(turns):
            walls, binning, _ = got[tag]
            row[f"{i}_{name}"] = {"wall_s": float(np.median(walls)),
                                  "device_binning_s": float(np.median(binning))}
        a_, b_ = (np.asarray(turns[k][1][tag][2], dtype="f8") for k in (0, 1))
        with np.errstate(invalid="ignore", divide="ignore"):
            row["this_vs_other_max_abs"] = float(np.nanmax(np.abs(a_ - b_)))
            row["this_vs_other_max_rel"] = float(np.nanmax(np.abs(a_ - b_) / np.abs(b_)))
        row["same_nan"] = bool(np.array_equal(np.isnan(a_), np.isnan(b_)))
        result["runs"][tag] = row
    line = json.dumps(result)
    (OUT / "sv_store_ab.json").write_text(line + "\n")
    print(line, flush=True)


if __name__ == "__main__":
    main()
