#!/usr/bin/env python3
"""Order the terms of the matched filter's bf16x3 split product on a CUDA card.

Run from the root of a checkout on a machine with an NVIDIA card:

    python3 tools/split_product_probe.py [--rows 512000]

The matched filter's "HIGH" precision (``echopype_torch/ops/matched_filter.py``)
is one bf16 product with a float32 output whose depth K holds three terms
(``lo·Hhi``, ``hi·Hlo``, ``hi·Hhi``).  This probe forms random float32
operands at the ek80 phase's shape of ``chip_smoke.py`` (``rows`` = 8,000
lanes x 64 blocks, K = 770 float32 columns, 256 output columns, a third of
the block matrix non-zero), splits them into bf16 parts and computes the
product on the card (``torch.mm(..., out_dtype=torch.float32)``) with the
large term first along K and with the small terms first, and the single
term ("DEFAULT").  Each is held over the first 4,096 rows to the float64
product of the same bf16 parts and to its plain version (the parts upcast
to float32, one float32 matmul on the CPU), as max |error| / max |exact|,
and timed with CUDA events (mean of 10 after 3 warm-ups).  Prints the
card's name and power limit, the torch and CUDA versions, one line a case,
and one JSON object last, also written to
``chiprun_out/split_product_probe.json``.  Imports nothing of JAX.
"""

import argparse
import json
import subprocess
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
HEAD_ROWS = 4096


def split(v):
    hi = v.to(torch.bfloat16)
    return hi, (v - hi.float()).to(torch.bfloat16)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rows", type=int, default=512_000)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("split_product_probe: needs a CUDA card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60).stdout.strip()
    print(smi, torch.__version__, torch.version.cuda, flush=True)
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator().manual_seed(0)
    k, n = 770, 256
    X = torch.randn(args.rows, k, generator=g)
    H = torch.randn(k, n, generator=g) * (torch.rand(k, n, generator=g) < 0.35)
    (xh, xl), (hh, hl) = split(X), split(H)
    del X
    cases = {"HIGH large first": ([xh, xh, xl], [hh, hl, hh]),
             "HIGH small first": ([xl, xh, xh], [hh, hl, hh]),
             "DEFAULT": ([xh], [hh])}
    results = {}
    for name, (a_parts, b_parts) in cases.items():
        A, B = torch.cat(a_parts, 1), torch.cat(b_parts, 0)
        exact = A[:HEAD_ROWS].double() @ B.double()
        plain = (A[:HEAD_ROWS].float() @ B.float()).double()
        scale = float(exact.abs().max())
        Ad, Bd = A.to(dev), B.to(dev)
        del A
        y = torch.mm(Ad, Bd, out_dtype=torch.float32)
        card = y[:HEAD_ROWS].cpu().double()
        for _ in range(3):
            torch.mm(Ad, Bd, out_dtype=torch.float32)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(10):
            torch.mm(Ad, Bd, out_dtype=torch.float32)
        end.record()
        torch.cuda.synchronize()
        results[name] = {
            "card_vs_exact": float((card - exact).abs().max()) / scale,
            "plain_vs_exact": float((plain - exact).abs().max()) / scale,
            "card_vs_plain": float((card - plain).abs().max()) / scale,
            "ms": start.elapsed_time(end) / 10, "shape": [args.rows, Ad.shape[1], n],
        }
        print(name, json.dumps(results[name]), flush=True)
        del Ad, Bd, y
    out = {"card": smi, "torch": torch.__version__, "cases": results}
    (ROOT / "chiprun_out").mkdir(exist_ok=True)
    (ROOT / "chiprun_out" / "split_product_probe.json").write_text(json.dumps(out, indent=1))
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
