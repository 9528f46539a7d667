"""The lower-precision control fails each cell's limits; the program passes them.

At tiny sizes on the CPU.  On the card, at the cells' own sizes,
``python3 bench_port/control.py --workload <cell> --seeds ...`` reads the
same numbers (``PERF.md`` gives them and the limits set from them).
"""

import io
import math

import pytest
import torch
from tiny import tiny_bench

from bench_port import control


@pytest.mark.parametrize("cell", ["ek60_survey", "azfp_ooi_survey", "ek60_sv_chain"])
def test_control_fails_and_program_passes(tmp_path, cell):
    rows = control.main(["--workload", cell, "--seeds", "11", "2147483660", "13", "--program"],
                        device="cpu", bench_dir=tiny_bench(tmp_path), out=io.StringIO())
    assert len(rows) == 6
    for row in rows:
        over = [n for n, c in row["checks"].items() if c["value"] > c["limit"]]
        if row["side"] == "control_bf16":
            assert "mvbs_max_db" in over, row
        else:
            assert over == [], row


def test_per_sample_reading_beside_the_program_on_the_survey(tmp_path):
    rows = control.main(["--workload", "ek60_survey", "--seeds", "17", "--program",
                         "--per-sample"], device="cpu", bench_dir=tiny_bench(tmp_path),
                        out=io.StringIO())
    assert [r["side"] for r in rows] == ["control_bf16", "program", "program_vs_per_sample"]
    gap = rows[2]["checks"]
    assert set(gap) == {"per_sample_max_db", "per_sample_bins_over", "per_sample_nan_mismatch"}
    assert all(math.isfinite(c["value"]) for c in gap.values())


def test_control_refuses_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(SystemExit):
        control.main(["--workload", "ek60_survey", "--seeds", "1"],
                     bench_dir=tiny_bench(tmp_path), out=io.StringIO())
