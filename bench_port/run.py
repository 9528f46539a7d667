#!/usr/bin/env python3
"""One run of one cell of the echopype_torch benchmark.

Run from the root of a checkout, on a machine with the CUDA cards the cell
asks for::

    python3 bench_port/run.py --workload ek60_survey --seed 7 --seconds 30 --trace 0

Prints the checks of the comparison with the plain reference as the last
lines of standard error, and one JSON object as the last line of standard
output: ``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's
end-to-end metrics, or with ``--trace 1`` its per-layer metrics),
``device``, with ``--trace 1`` ``breakdown``, and ``checks`` last.  Exits
with another code than 0, and prints no result, where torch sees no CUDA
card or fewer than the cell needs, or where JAX or the JAX package was
loaded.  See ``bench_port/harness.py``.
"""

import sys
import time

T_START = time.perf_counter()

from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from bench_port.harness import main  # noqa: E402

if __name__ == "__main__":
    main(sys.argv[1:], t_start=T_START)
