#!/usr/bin/env python3
"""The lower-precision control of a cell, and the program's own readings.

The control is the plain reference put in the program's place and computed
in bfloat16 (the precision below the float32 the configurations state),
judged by the cell's own comparison.  For each seed it writes the cell's
files, prints the control's checks and, with ``--program``, those of one
call of the measured program::

    python3 bench_port/control.py --workload ek60_survey --seeds 101 102 103 --program

One JSON line a seed and side: ``{"workload", "seed", "side", "checks"}``.
The limits in ``workloads/<cell>.json`` lie between the program's readings
and the control's (``PERF.md`` gives both).  With ``--per-sample`` (survey
cells, with ``--program``) a third side, ``program_vs_per_sample``, reads
how far the program's MVBS lies from ``compute_MVBS``'s per-sample bins.
Refuses to run without a CUDA card, as a run of the benchmark does; the
harness's CPU tests call :func:`main` with ``device="cpu"`` at tiny sizes.
"""

import argparse
import json
import shutil
import sys
import tempfile
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from bench_port.harness import HERE, Cell, Linker, check_card  # noqa: E402


def readings(cell, seed, device, program, work, per_sample=False):
    """[(side, checks)] of one seed: the control, and the program when asked."""
    entry = cell.entry
    data = Path(work) / f"seed{seed}"
    data.mkdir()
    try:
        state = entry.setup(cell, seed, data, device)
        out = [("control_bf16", entry.judge(state, entry.control_outputs(state, device), device,
                                            {}))]
        if program:
            got = []
            linker = Linker(data)
            for i in range(entry.files_in_turn(state)):
                with linker.fresh(entry.call_files(state, i)) as names:
                    got.append(entry.call(state, names, {"stages": {}, "spans": {}})[0])
            out.append(("program", entry.judge(state, got, device, {})))
            if per_sample:
                out.append(("program_vs_per_sample", entry.per_sample_gap(state, got, device)))
        return out
    finally:
        shutil.rmtree(data, ignore_errors=True)


def main(argv=None, device="cuda", bench_dir=HERE, manifest=None, out=sys.stdout):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--program", action="store_true")
    ap.add_argument("--per-sample", action="store_true")
    args = ap.parse_args(argv)
    cell = Cell(args.workload, bench_dir, manifest)
    if device == "cuda":
        check_card(int(cell.workload["chips"]))
    rows = []
    with tempfile.TemporaryDirectory(prefix="bench_port.control.") as work:
        for seed in args.seeds:
            for side, checks in readings(cell, seed, device, args.program, work,
                                         args.per_sample):
                row = {"workload": args.workload, "seed": seed, "side": side,
                       "checks": {n: {"value": v, "limit": lim} for n, v, lim in checks}}
                print(json.dumps(row), file=out, flush=True)
                rows.append(row)
    return rows


if __name__ == "__main__":
    main()
