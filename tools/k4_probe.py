#!/usr/bin/env python3
"""Probe K4 (``ep_mvbs_partials``) on one CUDA card: variants, SASS, ptxas.

Run from the root of a checkout on a machine with an NVIDIA card and nvcc:

    python3 tools/k4_probe.py [--baseline OLD.cu]

At ``chip_smoke.py``'s K4 shape (``chip_smoke.fused_inputs``: 5 x 5,000 x
4,000 float32 dB power, 38 range bins of ~105 samples) it builds variants of
``echopype_torch/csrc/sv_bin_partials.cu`` into ``build/k4_probe/`` by
changing one constant of a copy of the source each (rows a thread keeps in
flight ``kRows``, pings a block owns ``kSlab``, and scalar loads in place
of the 16-byte loads), and ``--baseline``, another source with the same C
interface (an earlier K4).  Each build's ptxas registers and spills are
kept.  Every variant must give the committed kernel's counts exactly and its
sums within rtol 1e-5; each is timed with CUDA events (median of 20), twice,
in turns (forward, then backward through the list), and K3
(``ep_sv_bin_partials``) of the committed and the baseline build with them.

It also counts instructions in SASS (``cuobjdump -sass``) of the committed
and the baseline build: per K4 kernel, every loop that holds ``MUFU.EX2``
(a backward branch's span) with its instructions per ``MUFU.EX2``, that
is what the loop issues per sample, loads, masks and stores included.

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
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "tools"))

import chip_smoke  # noqa: E402
from window_probe import sass  # noqa: E402
from echopype_torch.ops import _build  # noqa: E402
from echopype_torch.ops import sv_bin_partials as sbp  # noqa: E402

OUT = ROOT / "chiprun_out"
BUILD = ROOT / "build" / "k4_probe"
SOURCE = _build.CSRC / "sv_bin_partials.cu"
VEC_LAUNCH = "R % 4 == 0 && aligned16(power)"
MEMORY_OR_MUFU = ("LD", "ST", "BAR", "MUFU", "RED", "ATOM")
# variant -> {constant or text: replacement}; "committed" is the source as is
VARIANTS = {
    "committed": {},
    "rows2": {"kRows": 2},
    "rows4": {"kRows": 4},
    "slab16": {"kSlab": 16},
    "slab32": {"kSlab": 32},
    "slab64": {"kSlab": 64},
    "scalar_loads": {VEC_LAUNCH: "false"},
}


def variant_source(changes):
    text = SOURCE.read_text()
    for key, value in changes.items():
        if key == VEC_LAUNCH:
            assert key in text, key
            text = text.replace(key, value)
            continue
        pattern = rf"(constexpr int {key} = )\d+;"
        assert re.search(pattern, text), key
        text = re.sub(pattern, rf"\g<1>{value};", text)
    return text


def nvcc_build(name, text):
    """Shared library of ``text``; returns (path, ptxas lines)."""
    src, lib = BUILD / f"{name}.cu", BUILD / f"{name}.so"
    src.write_text(text)
    res = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(lib), str(src)],
                         capture_output=True, text=True, timeout=600)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed on {name}:\n{res.stdout}{res.stderr}")
    log = res.stdout + res.stderr
    return lib, [ln.strip() for ln in log.splitlines() if "registers" in ln or "spill" in ln
                 or "Compiling entry" in ln]


def caller(lib_path, with_sv=False):
    """``ep_mvbs_partials`` (or, ``with_sv``, ``ep_sv_bin_partials``) of one
    build as ``fn(ops) -> outputs``."""
    lib = ctypes.CDLL(str(lib_path))
    fn = lib.ep_sv_bin_partials if with_sv else lib.ep_mvbs_partials
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * (9 if with_sv else 8) + [ctypes.c_int] * 4 + [ctypes.c_void_p]

    def run(ops):
        C, P, R = ops["power"].shape
        n_r = ops["bounds"].shape[1] - 1
        s1 = torch.empty((C, P, n_r), dtype=torch.float32, device=ops["power"].device)
        n1 = torch.empty_like(s1)
        outs = ([torch.empty_like(ops["power"])] if with_sv else []) + [s1, n1]
        ptrs = [ops[k].data_ptr() for k in ("power", "dr", "tvg_shift", "absorption", "offset",
                                           "bounds")]
        status = fn(*ptrs, *[t.data_ptr() for t in outs], C, P, R, n_r,
                    torch.cuda.current_stream().cuda_stream)
        if status != 0:
            raise RuntimeError(f"{lib_path.name}: CUDA error {status}")
        return outs

    return run


def sass_loops(lib, tag):
    """Per K3 / K4 kernel of a build: its loops holding MUFU.EX2, with
    instructions per EX2 over the whole loop and over its common path: less
    every block of 16 or more instructions that a forward branch skips and
    that touches no memory and holds no MUFU (register work on a rare path,
    such as K4's search for non-finite samples)."""
    text, kernels = sass(lib)
    (OUT / f"k4_{tag}.sass").write_text(text)
    out = {}
    for name, body in kernels.items():
        if "mvbs" not in name and "sv_bin" not in name:
            continue
        loops = []
        for addr, _, target in body:
            if target is None or target >= addr:
                continue
            span = [(a, op, t) for a, op, t in body if target <= a <= addr]
            ex2 = sum(op == "MUFU.EX2" for _, op, _ in span)
            if not ex2:
                continue
            rare = set()
            for a, _, t in span:
                if t is not None and a < t <= addr:
                    block = [(b, op) for b, op, _ in span if a < b < t]
                    if len(block) >= 16 and not any(
                            op.startswith(MEMORY_OR_MUFU) for _, op in block):
                        rare |= {b for b, _ in block}
            common = [op for a, op, _ in span if a not in rare]
            ops = Counter(op.split(".")[0] for op in common)
            loops.append({"instructions": len(span), "MUFU.EX2": ex2,
                          "per_sample": round(len(span) / ex2, 2),
                          "common_instructions": len(common),
                          "common_per_sample": round(len(common) / ex2, 2),
                          **{k: ops.get(k, 0) for k in ("LDG", "STS", "LDS", "BAR", "SHFL")}})
        out[name] = {"instructions": len(body), "loops": loops}
    return out


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--baseline", type=Path, help="another K4 source to build and time")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("k4_probe: needs a CUDA card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True,
                         timeout=60).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    OUT.mkdir(exist_ok=True)
    BUILD.mkdir(parents=True, exist_ok=True)

    sources = {name: variant_source(ch) for name, ch in VARIANTS.items()}
    if args.baseline:
        sources["baseline"] = args.baseline.read_text()
    with ThreadPoolExecutor(len(sources)) as pool:  # one nvcc per variant, together
        built = dict(zip(sources, pool.map(lambda kv: nvcc_build(*kv), sources.items())))
    result = {"card": smi, "ptxas": {n: log for n, (_, log) in built.items()},
              "sass": {n: sass_loops(built[n][0], n) for n in ("committed", "baseline")
                       if n in built}}
    for name in result["sass"]:
        print("sass", name, json.dumps(result["sass"][name]), flush=True)

    ops, _ = sbp.fused_operands(*chip_smoke.fused_inputs(4), device="cuda")
    runs = {name: caller(lib) for name, (lib, _) in built.items()}
    want_s, want_c = (t.double().cpu().numpy() for t in runs["committed"](ops))
    plain_s, plain_c = (t.double().cpu().numpy() for t in sbp.mvbs_partials_plain(**ops))
    if not (np.array_equal(want_c, plain_c)
            and np.allclose(want_s, plain_s, rtol=chip_smoke.SUM_RTOL, atol=0)):
        raise AssertionError("the committed K4 disagrees with its plain twin")
    for name, run in runs.items():
        got_s, got_c = (t.double().cpu().numpy() for t in run(ops))
        if not (np.array_equal(got_c, want_c)
                and np.allclose(got_s, want_s, rtol=chip_smoke.SUM_RTOL, atol=0)):
            raise AssertionError(f"variant {name} changes the partials")
    times = {name: [] for name in runs}
    order = list(runs)
    # K3 of the committed and the baseline build, in turns, on the same inputs
    k3 = {f"K3_{n}": caller(built[n][0], with_sv=True) for n in ("committed", "baseline")
          if n in built}
    times.update({name: [] for name in k3})
    k3_order = list(k3)
    for names, k3_names in ((order, k3_order), (order[::-1], k3_order[::-1])):
        for name in names:
            times[name].append(chip_smoke.cuda_ms(lambda: runs[name](ops)))
        for name in k3_names:
            times[name].append(chip_smoke.cuda_ms(lambda: k3[name](ops)))
    nbytes = ops["power"].numel() * 4
    result["runs"] = {name: {"ms": t, "GBps": round(nbytes / 1e6 / min(t), 1)}
                      for name, t in times.items()}  # K3: the power read only
    for name, row in result["runs"].items():
        print("time", name, json.dumps(row), flush=True)
    (OUT / "k4_probe.json").write_text(json.dumps(result, indent=1))
    print(json.dumps({"ok": True, "card": smi, "runs": result["runs"]}), flush=True)


if __name__ == "__main__":
    main()
