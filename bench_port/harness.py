"""The benchmark's run: set-up, measured window, comparison, result line.

Everything that belongs to one cell is found by name under the benchmark's
folder: ``workloads/<cell>.json`` (configuration, entry, traffic, limits),
``configs/<config>.json`` (the deployment and the writer that makes its
files), ``entries/<entry>.py`` (the calls into the measured package and the
comparison with the plain reference) and ``metrics/<metric>.py`` (one
reader a metric).  ``BENCHMARK.json`` at the checkout's root says which
metrics a cell reports.

A run (see ``run.py`` for the command line):

1. refuses to measure without the CUDA cards the cell asks for;
2. writes the cell's raw files from ``--seed`` into a fresh directory under
   ``TMPDIR`` and removes them at exit;
3. warms up with one call of the entry on the files it names
   (``warm_files``: one of each path the window's calls take);
4. calls the entry in a loop of whole calls until ``--seconds`` have
   passed, each call on fresh hard-linked names of the same files or
   directory stores (no cache keyed by path can serve a repeat); with
   ``--trace 1`` under ``torch.profiler``;
5. reads the device memory peak, frees the program's state, compares what
   the window's calls returned with the plain reference, and prints the
   checks on standard error and one JSON line on standard output.
"""

from __future__ import annotations

import argparse
import contextlib
import importlib.util
import json
import os
import shutil
import sys
import tempfile
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "echopype_tpu")


def forbidden_modules(names):
    """Module names whose top-level name, compared whole, is forbidden."""
    return sorted({n for n in names if n.split(".", 1)[0] in FORBIDDEN})


def load_json(path):
    return json.loads(Path(path).read_text())


def load_module(path, name):
    """Import the file ``path`` as module ``name`` (file names may hold dots)."""
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class Cell:
    """A cell found by name: its workload, configuration and entry."""

    def __init__(self, name, bench_dir=HERE, manifest=None):
        self.bench_dir = Path(bench_dir)
        self.name = name
        self.workload = load_json(self.bench_dir / "workloads" / f"{name}.json")
        self.config = load_json(self.bench_dir / "configs" / f"{self.workload['config']}.json")
        self.entry = load_module(self.bench_dir / "entries" / f"{self.workload['entry']}.py",
                                 f"bench_entry_{self.workload['entry']}")
        self.manifest = manifest if manifest is not None else load_json(ROOT / "BENCHMARK.json")

    def metric_names(self, trace):
        """The manifest's metrics this cell reports: end-to-end without
        tracing, per-layer with it."""
        group = self.manifest["per_layer" if trace else "end_to_end"]
        return [m["name"] for m in group if "workloads" not in m or self.name in m["workloads"]]

    def metric_units(self):
        return {m["name"]: m["unit"] for g in ("end_to_end", "per_layer")
                for m in self.manifest[g]}

    def reader(self, metric):
        return load_module(self.bench_dir / "metrics" / f"{metric}.py",
                           "bench_metric_" + metric.replace(".", "_"))


class Linker:
    """Fresh hard-linked names of the cell's files or directory stores for
    each call.

    A file gets one hard link.  A directory store (a zarr tree: one folder
    an array, one file a chunk) gets a tree of the same layout whose
    directories are made anew and whose regular files are hard links of the
    originals, so nothing is copied.  A symlink or special file inside a
    store, and two paths of one call with the same base name, are refused.
    The call's folder goes when the ``with`` block ends, also when its body
    raises; the originals stay.
    """

    def __init__(self, work_dir):
        self.work_dir = Path(work_dir)
        self.n = 0

    @contextlib.contextmanager
    def fresh(self, paths):
        names = [Path(p).name for p in paths]
        dup = sorted({n for n in names if names.count(n) > 1})
        if dup:
            raise ValueError(f"two of a call's paths share the base name {', '.join(dup)}")
        d = self.work_dir / f"call{self.n:05d}"
        self.n += 1
        d.mkdir()
        try:
            out = []
            for p, name in zip(paths, names):
                q = d / name
                if os.path.isdir(p):
                    _link_tree(p, q)
                else:
                    os.link(p, q)
                out.append(str(q))
            yield out
        finally:
            shutil.rmtree(d, ignore_errors=True)


def _link_tree(src, dst):
    """Make ``dst`` with ``src``'s layout: each directory anew, each regular
    file a hard link of the original."""
    os.mkdir(dst)
    with os.scandir(src) as entries:
        for e in entries:
            q = os.path.join(dst, e.name)
            if e.is_dir(follow_symlinks=False):
                _link_tree(e.path, q)
            elif e.is_file(follow_symlinks=False):
                os.link(e.path, q)
            else:
                raise ValueError(f"{e.path}: neither a regular file nor a directory; "
                                 "a store is linked file by file")


def parse_args(argv):
    ap = argparse.ArgumentParser(description="echopype_torch benchmark: one run of one cell")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def fail(msg, code=2):
    print(f"bench_port: {msg}", file=sys.stderr, flush=True)
    raise SystemExit(code)


def check_card(chips):
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this benchmark measures a CUDA card")
    if torch.cuda.device_count() < chips:
        fail(f"the cell needs {chips} CUDA devices, torch sees {torch.cuda.device_count()}")


def main(argv=None, t_start=None, device="cuda", bench_dir=HERE, manifest=None, out=None):
    """One run; returns the result dict (also printed).  ``device`` other
    than "cuda" is for the harness's own CPU tests and skips the look for a
    card."""
    t_start = time.perf_counter() if t_start is None else t_start
    args = parse_args(argv)
    cell = Cell(args.workload, bench_dir, manifest)
    if device == "cuda":
        check_card(int(cell.workload["chips"]))
    work = Path(tempfile.mkdtemp(prefix="bench_port.", dir=os.environ.get("TMPDIR")))
    try:
        return _run(cell, args, t_start, device, work, out)
    finally:
        shutil.rmtree(work, ignore_errors=True)


def _run(cell, args, t_start, device, work, out):
    import torch

    from bench_port import tracing

    entry = cell.entry
    data_dir = work / "files"
    data_dir.mkdir()
    t0 = time.perf_counter()
    state = entry.setup(cell, args.seed, data_dir, device)
    os.sync()  # the files' write-back ends in set-up, not in the window
    write_s = time.perf_counter() - t0
    linker = Linker(work)
    rec = {"cell": cell.name, "seed": args.seed, "write_s": write_s, "stages": {}, "spans": {},
           "pings": 0, "calls": 0, "call_s": [], "trace": None}
    t0 = time.perf_counter()
    with linker.fresh(entry.warm_files(state)) as names:
        entry.call(state, names, {"stages": {}, "spans": {}}, warm=True)
    warm_s = time.perf_counter() - t0
    if device == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    outputs, failed, error = [], 0, None
    prof = tracing.Profiler(work / "trace", device) if args.trace else None
    with prof if prof is not None else contextlib.nullcontext():
        rec["setup_s"] = time.perf_counter() - t_start  # the profiler's start is not set-up
        t_win = time.perf_counter()
        with tracing.span("window"):
            while True:
                t_call = time.perf_counter()
                with linker.fresh(entry.call_files(state, rec["calls"])) as names:
                    try:
                        result, pings = entry.call(state, names, rec)
                    except Exception as e:  # noqa: BLE001 - a failed call is a result
                        failed, error = failed + 1, repr(e)
                        rec["calls"] += 1
                        break
                if device == "cuda":
                    torch.cuda.synchronize()
                rec["call_s"].append(time.perf_counter() - t_call)
                outputs.append(result)
                rec["calls"] += 1
                rec["pings"] += pings
                if time.perf_counter() - t_win >= args.seconds:
                    break
        rec["window_s"] = time.perf_counter() - t_win
    if prof is not None:
        rec["trace"] = prof.summary()
    peak = torch.cuda.max_memory_allocated() if device == "cuda" else 0
    if device == "cuda":
        torch.cuda.empty_cache()

    t0 = time.perf_counter()
    checks = entry.judge(state, outputs, device, rec)
    judge_s = time.perf_counter() - t0
    if error is not None:
        checks.append(("calls_failed", float(failed), 0.0))
    correct = all(v <= lim for _, v, lim in checks) and not failed and bool(outputs)
    metrics = {}
    units = cell.metric_units()
    for name in cell.metric_names(bool(args.trace)):
        value = cell.reader(name).read(rec)
        if value is not None:
            metrics[name] = {"value": value, "unit": units[name]}
    dev = {"platform": "gpu" if device == "cuda" else device,
           "kind": torch.cuda.get_device_name(0) if device == "cuda" else device,
           "count": int(cell.workload["chips"]), "memory_peak_bytes": int(peak)}
    if rec["trace"] is not None:
        dev["busy_s"] = rec["trace"]["busy_s"]
        dev["window_s"] = rec["trace"]["window_s"]
    result = {"correct": correct, "attempted": rec["calls"], "failed": failed,
              "metrics": metrics, "device": dev}
    if rec["trace"] is not None:
        result["breakdown"] = rec["trace"]["breakdown"]
    result["checks"] = {n: {"value": v, "limit": lim} for n, v, lim in checks}

    bad = forbidden_modules(list(sys.modules))
    if bad:
        fail(f"modules of the JAX package or JAX are loaded: {', '.join(bad)}", code=3)
    stream = out if out is not None else sys.stdout
    print(json.dumps({"cell": cell.name, "calls": rec["calls"], "pings": rec["pings"],
                      "write_s": write_s, "warm_s": warm_s, "call_s": rec["call_s"],
                      "judge_s": judge_s, "stages": rec["stages"], "spans": rec["spans"],
                      "error": error}), file=sys.stderr)
    for n, v, lim in checks:
        print(f"check {n} {v!r} limit {lim!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), file=stream, flush=True)
    return result
