"""Tiny copies of the benchmark's cells for its CPU tests."""

from __future__ import annotations

import json
import shutil
import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parent.parent
ROOT = BENCH.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

#: a cell's sizes cut for the CPU: (samples a ping, [(file of the traffic,
#: pings)], chunk); the survey keeps its file with the sound-speed update
TINY = {"ek60_survey": (240, [(0, 40), (6, 41), (1, 40)], 30),
        "ek60_sv_chain": (240, [(0, 21), (1, 20)], None),
        "azfp_ooi_survey": (None, [(0, 30), (1, 30)], 40)}


def manifest():
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def tiny_bench(tmp_path, cells=TINY):
    """A benchmark folder under ``tmp_path`` whose configurations and
    workloads are the real ones at tiny sizes; entries, metrics, writers
    and references are the real files."""
    d = Path(tmp_path) / "bench"
    for sub in ("entries", "metrics"):
        shutil.copytree(BENCH / sub, d / sub)
    (d / "configs").mkdir()
    (d / "workloads").mkdir()
    for cell, (R, pings, chunk) in cells.items():
        wl = json.loads((BENCH / "workloads" / f"{cell}.json").read_text())
        cfg = json.loads((BENCH / "configs" / f"{wl['config']}.json").read_text())
        if R is not None:
            cfg["samples_per_ping"] = R
        else:  # AZFP: fewer bins a channel
            for ch in cfg["channels"]:
                ch["bins"] = ch["bins"] // 10
        files = []
        for i, n in pings:
            f = dict(wl["traffic"]["files"][i], pings=n)
            if "ctd_update_ping" in f:
                f["ctd_update_ping"] = n // 2
            files.append(f)
        wl["traffic"]["files"] = files
        kept = [i for i, _ in pings]
        wl["warm"] = [kept.index(i) for i in wl["warm"] if i in kept] or [0]
        if chunk is not None:
            wl["args"]["chunk_pings"] = chunk
        wl["args"]["ping_time_bin"] = "5s"
        if "prefetch" in wl["args"]:
            wl["args"]["prefetch"] = True
        (d / "configs" / f"{wl['config']}.json").write_text(json.dumps(cfg))
        (d / "workloads" / f"{cell}.json").write_text(json.dumps(wl))
    return d
