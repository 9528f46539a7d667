#!/usr/bin/env python3
"""Probe the K1 / K2 window kernels on one CUDA card: slab lengths and SASS.

Run from the root of a checkout on a machine with an NVIDIA card and nvcc:

    python3 tools/window_probe.py [--baseline OLD.cu]

At the survey chunk's shape (``chip_smoke.chunk_inputs``: 5 x 5,000 x 4,000
int16, 20 m range bins) and three window counts (W = 251, 2 and 1), it times
K1 (sums only, as the survey calls it) and K2 with CUDA events (median of
20) at slab lengths of 16, 32 and 64 pings (``SLAB_PINGS`` of the host's
slab plan); every length must give the default's counts exactly and its
sums within the float32 reordering.

It also counts instructions in SASS (``cuobjdump -sass``):

* of the library ``expf`` and ``log10f`` on sm_90a: three one-line kernels
  (copy, ``expf``, ``log10f``), each less the copy (NOPs not counted), and
  that less the moves of constants into registers, which a loop hoists
  (``in_loop``).  ``chip_smoke.py`` takes the ``in_loop`` counts for the
  instructions a sample needs;
* of the port's build of ``csrc/window_partials.cu``: per kernel, the
  opcodes that matter here, and for every loop that holds expf calls (a
  backward branch's span) its instructions per ``MUFU.EX2``: what the
  kernel's ping loop issues a sample, the masked short-ping path included.

With ``--baseline OLD.cu`` (another ``window_partials.cu`` with the same C
interface, e.g. ``git show HEAD~1:echopype_torch/csrc/window_partials.cu``)
it skips the slab sweep and instead compares the int16 instances of the
two builds: their SASS loops' instructions per ``MUFU.EX2``, and K1 (sums
only) and K2 at W = 251 timed in turns (baseline, committed, committed,
baseline; CUDA events, median of 20 each) on the same inputs, whose
partials must be equal bit for bit.  It times K1's float32 instance the
same way against a build with one row in flight (``kRowsK1F32 = 1``),
printing both builds' ptxas lines (registers and spills per kernel), and
runs the committed build's float32 instances (K1-f32, K2-f32) once at the
same shape (float32 dB power with NaN-suffix rows and one all-NaN row)
against their plain twins.

Prints one JSON object last and writes it, with the SASS, under
``chiprun_out/``.  Imports nothing of JAX.
"""

import argparse
import ctypes
import json
import re
import subprocess
import sys
from collections import Counter
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402
from echopype_torch.ops import _build  # noqa: E402
from echopype_torch.ops import window_partials as wp  # noqa: E402
from echopype_torch.parallel.pipeline import kernel_inputs_from_numpy  # noqa: E402

OUT = ROOT / "chiprun_out"
BUILD = ROOT / "build" / "window_probe"
WINDOWS = {251: chip_smoke.PING_BIN_S, 2: chip_smoke.COARSE_PING_BIN_S, 1: 100_000}
SLAB_SIZES = (16, 32, 64)
LIBM_SOURCE = r"""
extern "C" __global__ void f_copy(const float* x, float* y) { y[threadIdx.x] = x[threadIdx.x]; }
extern "C" __global__ void f_expf(const float* x, float* y) { y[threadIdx.x] = expf(x[threadIdx.x]); }
extern "C" __global__ void f_log10f(const float* x, float* y) {
  y[threadIdx.x] = log10f(x[threadIdx.x]);
}
"""
CONSTANT_MOVES = ("MOV", "HFMA2.MMA", "ULDC")  # constants into registers
_OPCODE = re.compile(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)")


def sass(path):
    """Function name -> [(address, opcode, branch target or None)], NOPs left out."""
    cuobjdump = Path(_build._nvcc()).with_name("cuobjdump")
    text = subprocess.run([str(cuobjdump), "-sass", str(path)], check=True, capture_output=True,
                          text=True, timeout=300).stdout
    kernels, name = {}, None
    for line in text.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            name = m.group(1)
            kernels[name] = []
            continue
        m = _OPCODE.search(line)
        if name and m and m.group(1) != "NOP":
            addr = int(re.search(r"/\*([0-9a-f]+)\*/", line).group(1), 16)
            target = re.search(r"BRA (0x[0-9a-f]+)", line)
            kernels[name].append((addr, m.group(1), int(target.group(1), 16) if target else None))
    return text, kernels


def libm_counts():
    """Instructions of the library expf / log10f, each kernel less the copy."""
    BUILD.mkdir(parents=True, exist_ok=True)
    src, cubin = BUILD / "libm.cu", BUILD / "libm.cubin"
    src.write_text(LIBM_SOURCE)
    subprocess.run([_build._nvcc(), "-cubin", "-gencode", "arch=compute_90a,code=sm_90a", "-O3",
                    "-o", str(cubin), str(src)], check=True, capture_output=True, text=True,
                   timeout=600)
    text, kernels = sass(cubin)
    (OUT / "libm.sass").write_text(text)
    ops = {name: Counter(op for _, op, _ in body) for name, body in kernels.items()}
    out = {}
    for fn in ("expf", "log10f"):
        extra = ops[f"f_{fn}"] - ops["f_copy"]
        n = sum(ops[f"f_{fn}"].values()) - sum(ops["f_copy"].values())
        moves = sum(v for k, v in extra.items() if k.startswith(CONSTANT_MOVES))
        out[fn] = {"instructions": n, "in_loop": n - moves, "opcodes": dict(sorted(extra.items()))}
    return out


def kernel_counts(lib, tag="window_partials"):
    """Per kernel of the port's build: opcode counts, and per loop holding
    expf calls its instructions per ``MUFU.EX2``."""
    text, kernels = sass(lib)
    (OUT / f"{tag}.sass").write_text(text)
    out = {}
    for name, body in kernels.items():
        ops = Counter(op for _, op, _ in body)
        loops = []
        for addr, _, target in body:
            if target is not None and target < addr:
                span = [op for a, op, _ in body if target <= a <= addr]
                ex2 = span.count("MUFU.EX2")
                if ex2:
                    loops.append({"instructions": len(span), "MUFU.EX2": ex2,
                                  "per_sample": round(len(span) / ex2, 2)})
        keep = {k: v for k, v in ops.items()
                if k.split(".")[0] in ("MUFU", "I2F", "FFMA", "FMUL", "FADD", "FMNMX", "FSETP",
                                       "FSEL", "PRMT", "LDG", "IADD3", "LOP3", "ISETP")}
        out[name] = {"instructions": sum(ops.values()), "MUFU.EX2": ops.get("MUFU.EX2", 0),
                     "loops": sorted(loops, key=lambda d: d["instructions"]),
                     "opcodes": dict(sorted(keep.items()))}
    return out


def plan_for(xb, slab_pings):
    saved, wp.SLAB_PINGS = wp.SLAB_PINGS, slab_pings
    try:
        return torch.from_numpy(wp.slab_plan(xb.cpu().numpy())).to(xb.device)
    finally:
        wp.SLAB_PINGS = saved


_SLAB_KERNEL = re.compile(r"slab_partials_kernelI([sf]?)Lb([01])ELb([01])E")


def _int16_loops(counts):
    """(uniform, vec16) -> the int16 slab kernel's loops' instructions per
    MUFU.EX2, keyed the same whether or not the sample type is a template
    argument (``s`` int16, ``f`` float in the mangled name)."""
    out = {}
    for name, row in counts.items():
        m = _SLAB_KERNEL.search(name)
        if m and m.group(1) != "f":
            out[f"uniform={m.group(2)} vec16={m.group(3)}"] = [
                loop["per_sample"] for loop in row["loops"]]
    return out


def nvcc_build(name, text):
    """Shared library of source ``text`` under build/; returns (path, the
    ptxas lines: each kernel's name, registers and spills)."""
    BUILD.mkdir(parents=True, exist_ok=True)
    src, lib = BUILD / f"{name}.cu", BUILD / f"{name}.so"
    src.write_text(text)
    res = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(lib), str(src)],
                         capture_output=True, text=True, timeout=600)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed on {name}:\n{res.stdout}{res.stderr}")
    return lib, [ln.strip() for ln in (res.stdout + res.stderr).splitlines()
                 if "registers" in ln or "spill" in ln or "Compiling entry" in ln]


def _timed_in_turns(libs, order, kernel, ops, extra):
    """Each build's output and CUDA-event ms, the builds run in ``order``."""
    outs, row = {}, {}
    for turn, tag in enumerate(order):
        _build._loaded["window_partials"] = libs[tag]
        out = kernel(**ops, **extra)
        outs.setdefault(tag, out if isinstance(out, tuple) else (out,))
        row[f"{tag}_{turn}_ms"] = chip_smoke.cuda_ms(lambda: kernel(**ops, **extra))
    return outs, row


def baseline_compare(baseline_src, lib):
    """SASS and timing of the int16 instances, baseline vs committed build;
    and K1-f32 with one row in flight instead of kRowsK1F32, timed beside
    the committed build."""
    committed_src = _build.CSRC / "window_partials.cu"
    base_lib, _ = nvcc_build("baseline", baseline_src.read_text())
    _, committed_ptxas = nvcc_build("committed", committed_src.read_text())
    rows1_text = re.sub(r"(constexpr int kRowsK1F32 = )\d+;", r"\g<1>1;",
                        committed_src.read_text())
    rows1_lib, rows1_ptxas = nvcc_build("k1f32_rows1", rows1_text)
    print("ptxas_committed", json.dumps(committed_ptxas), flush=True)
    print("ptxas_k1f32_rows1", json.dumps(rows1_ptxas), flush=True)
    sass_cmp = {"baseline": _int16_loops(kernel_counts(base_lib, "baseline")),
                "committed": _int16_loops(kernel_counts(lib, "window_partials"))}
    same_sass = sass_cmp["baseline"] == sass_cmp["committed"]
    print("sass_int16", json.dumps({"same": same_sass, **sass_cmp}), flush=True)
    libs = {"baseline": ctypes.CDLL(str(base_lib)), "committed": _build.load_library("window_partials"),
            "k1f32_rows1": ctypes.CDLL(str(rows1_lib))}
    rows = []
    for name, uniform, seed, f32, other in (("K1", True, 1, False, "baseline"),
                                            ("K2", False, 2, False, "baseline"),
                                            ("K1_f32", True, 7, True, "k1f32_rows1")):
        kernel = wp.window_partials_uniform if uniform else wp.window_partials
        extra = {"with_counts": False} if uniform else {}
        args = chip_smoke.chunk_inputs(seed, vary_dr=not uniform, f32=f32)
        ops = kernel_inputs_from_numpy(*args, uniform=uniform, device="cuda")
        outs, times = _timed_in_turns(libs, (other, "committed", "committed", other), kernel,
                                      ops, extra)
        _build._loaded["window_partials"] = libs["committed"]
        row = {"kernel": name, "W": args[-1], "against": other, **times,
               "bit_identical": all(torch.equal(a, b)
                                    for a, b in zip(outs[other], outs["committed"]))}
        base = (row[f"{other}_0_ms"] + row[f"{other}_3_ms"]) / 2
        row["committed_vs_other"] = round((row["committed_1_ms"] + row["committed_2_ms"])
                                          / 2 / base, 4)
        print(json.dumps(row), flush=True)
        rows.append(row)
        if not row["bit_identical"]:
            raise AssertionError(f"{name}: partials differ between the builds")
        del ops
        torch.cuda.empty_cache()
    return {"same_sass": same_sass, "sass": sass_cmp, "timing": rows,
            "ptxas": {"committed": committed_ptxas, "k1f32_rows1": rows1_ptxas}}


def f32_check():
    """K1-f32 and K2-f32 once against their plain twins at the chunk shape."""
    rows = []
    for uniform, seed in ((True, 1), (False, 2)):
        name = "K1_f32" if uniform else "K2_f32"
        args = chip_smoke.chunk_inputs(seed, vary_dr=not uniform, f32=True)
        ops = kernel_inputs_from_numpy(*args, uniform=uniform, device="cuda")
        kernel = wp.window_partials_uniform if uniform else wp.window_partials
        plain = wp.window_partials_uniform_plain if uniform else wp.window_partials_plain
        got = kernel(**ops)
        want = plain(**{k: v for k, v in ops.items() if k != "plan"})
        torch.cuda.synchronize()
        s_k, c_k = (t.double().cpu().numpy() for t in got)
        s_p, c_p = (t.double().cpu().numpy() for t in want)
        rel = np.abs(s_k - s_p) / np.where(s_p != 0, np.abs(s_p), 1.0)
        row = {"kernel": name, "counts_exact": bool(np.array_equal(c_k, c_p)),
               "max_rel_err": float(rel.max()), "finite": bool(np.isfinite(s_k).all()),
               "ms": chip_smoke.cuda_ms(lambda: kernel(**ops))}
        print(json.dumps(row), flush=True)
        rows.append(row)
        if not (row["counts_exact"] and row["finite"] and row["max_rel_err"] <= chip_smoke.SUM_RTOL):
            raise AssertionError(f"{name}: kernel disagrees with its plain twin")
        del ops
        torch.cuda.empty_cache()
    return rows


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--baseline", type=Path,
                        help="another window_partials.cu to compare the int16 instances with")
    cli = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("window_probe: needs a CUDA card")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    OUT.mkdir(exist_ok=True)
    lib, log = _build.build("window_partials")
    print("ptxas", json.dumps([ln.strip() for ln in log.splitlines()
                               if "registers" in ln or "spill" in ln]), flush=True)
    if cli.baseline:
        result = {"card": smi, "baseline": baseline_compare(cli.baseline, lib),
                  "f32": f32_check()}
        (OUT / "window_probe.json").write_text(json.dumps(result, indent=1))
        print(json.dumps({"ok": True, "same_sass": result["baseline"]["same_sass"],
                          "timing": result["baseline"]["timing"], "f32": result["f32"]}),
              flush=True)
        return
    result = {"card": smi, "libm": libm_counts(), "sass": kernel_counts(lib), "runs": []}
    print("libm", json.dumps(result["libm"]), flush=True)

    for uniform, seed in ((True, 1), (False, 2)):
        name = "K1" if uniform else "K2"
        kernel = wp.window_partials_uniform if uniform else wp.window_partials
        for W, bin_s in WINDOWS.items():
            args = chip_smoke.chunk_inputs(seed, vary_dr=not uniform, ping_bin_s=bin_s)
            assert args[-1] == W, (W, args[-1])
            ops = kernel_inputs_from_numpy(*args, uniform=uniform, device="cuda")
            want_s, want_c = (t.double().cpu().numpy() for t in kernel(**ops))
            row = {"kernel": name, "W": W}
            for S in SLAB_SIZES:
                split = {**ops, "plan": plan_for(ops["xb"], S)}
                got_s, got_c = (t.double().cpu().numpy() for t in kernel(**split))
                if not np.array_equal(got_c, want_c) or not np.allclose(
                        got_s, want_s, rtol=chip_smoke.SUM_RTOL, atol=0):
                    raise AssertionError(f"{name} W={W}: slab length {S} changes the partials")
                extra = {"with_counts": False} if uniform else {}
                row[f"S{S}_ms"] = chip_smoke.cuda_ms(lambda: kernel(**split, **extra))
                row[f"S{S}_slabs"] = split["plan"].shape[0] - W - 1
            print(json.dumps(row), flush=True)
            result["runs"].append(row)
            del ops, split
            torch.cuda.empty_cache()
    (OUT / "window_probe.json").write_text(json.dumps(result, indent=1))
    for name, row in result["sass"].items():
        print(name, json.dumps(row), flush=True)
    print(json.dumps({"ok": True, "libm": result["libm"], "runs": result["runs"]}), flush=True)


if __name__ == "__main__":
    main()
