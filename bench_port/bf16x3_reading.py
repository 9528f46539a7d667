#!/usr/bin/env python3
"""The broadband cell's reading of the matched filter in three bfloat16 products.

The plain reference with its matched filter as three bfloat16 products with
float32 sums (the port's "HIGH" arithmetic, ``entries/bb_survey.py:
bf16x3_outputs``), judged by the cell's own comparison against the float64
reference: a reading beside the cell's limits (``PERF.md`` gives it).  For
each seed it writes the cell's files and prints one JSON line::

    python3 bench_port/bf16x3_reading.py --workload ek80_bb_fused_survey --seeds 101 102

Refuses to run without a CUDA card, as a run of the benchmark does; its CPU
test calls :func:`main` with ``device="cpu"`` at a tiny size.
"""

import argparse
import json
import shutil
import sys
import tempfile
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from bench_port.harness import HERE, Cell, check_card  # noqa: E402


def main(argv=None, device="cuda", bench_dir=HERE, manifest=None, out=sys.stdout):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    cell = Cell(args.workload, bench_dir, manifest)
    if device == "cuda":
        check_card(int(cell.workload["chips"]))
    rows = []
    with tempfile.TemporaryDirectory(prefix="bench_port.bf16x3.") as work:
        for seed in args.seeds:
            data = Path(work) / f"seed{seed}"
            data.mkdir()
            try:
                state = cell.entry.setup(cell, seed, data, device)
                checks = cell.entry.judge(state, cell.entry.bf16x3_outputs(state, device),
                                          device, {})
            finally:
                shutil.rmtree(data, ignore_errors=True)
            row = {"workload": args.workload, "seed": seed, "side": "bf16x3",
                   "checks": {n: {"value": v, "limit": lim} for n, v, lim in checks}}
            print(json.dumps(row), file=out, flush=True)
            rows.append(row)
    return rows


if __name__ == "__main__":
    main()
