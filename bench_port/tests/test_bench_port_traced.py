"""The readers of the program's own stages and counters (``bench_port/traced.py``):
on a recorded traced window, and silent on an untraced run or a program
without the stage, counter or ``TRACED`` (an older version of the
package)."""

import pytest
from test_bench_port_metrics import CHAIN, K1, SURVEY, _reader

from echopype_torch.utils import profiling

#: the program's stages (s) and counters in a recorded traced window
TRACED_STAGES = {"parse_raw": 1.6, "set_groups": 0.8, "cal_inputs": 0.04,
                 "power_cal_device": 0.6, "mvbs_prepare": 2.4, "bin_membership": 1.6,
                 "bin_device": 3.2, "mvbs_assemble": 0.08, "wait_decode": 9.5}
TRACED_COUNTERS = {"staged_pings": 65_000, "padded_pings": 39_585, "h2d_bytes": 2.6e9}

TRACED_SURVEY = dict(SURVEY, trace=dict(  # 50,000 pings
    SURVEY["trace"], breakdown={"device_ops": [
        ["Memcpy HtoD (Pageable -> Device)", 0.4], [K1, 0.0012],
        ["Memcpy DtoH (Device -> Pageable)", 0.5]]}))

#: metric -> (recorded run, value) for the readers of ``bench_port/traced.py``;
#: CHAIN has 8,000 pings
TRACED_CASES = {
    "parse_raw_ms_per_kping.chain": (CHAIN, 200.0),
    "set_groups_ms_per_kping.chain": (CHAIN, 100.0),
    "cal_inputs_ms_per_kping.chain": (CHAIN, 5.0),
    "power_cal_device_ms_per_kping.chain": (CHAIN, 75.0),
    "mvbs_prepare_ms_per_kping.chain": (CHAIN, 300.0),
    "bin_membership_ms_per_kping.chain": (CHAIN, 200.0),
    "bin_device_ms_per_kping.chain": (CHAIN, 400.0),
    "mvbs_assemble_ms_per_kping.chain": (CHAIN, 10.0),
    "wait_decode_ms_per_kping.survey": (TRACED_SURVEY, 190.0),
    "padded_ping_pct.survey": (TRACED_SURVEY, 100 * 39_585 / 65_000),
    "h2d_gb_per_s.survey": (TRACED_SURVEY, 6.5),
}


@pytest.fixture
def traced(monkeypatch):
    """``profiling.TRACED`` as the recorded traced window left it."""
    timer = profiling.StageTimer()
    timer.totals.update(TRACED_STAGES)
    timer.counters.update(TRACED_COUNTERS)
    monkeypatch.setattr(profiling, "TRACED", timer)
    return timer


@pytest.mark.parametrize("name", sorted(TRACED_CASES))
def test_reader_on_a_recorded_traced_window(name, traced):
    rec, want = TRACED_CASES[name]
    assert _reader(name).read(rec) == pytest.approx(want, rel=1e-12)


@pytest.mark.parametrize("name", sorted(TRACED_CASES))
def test_reader_is_silent_in_an_untraced_run(name, traced):
    rec, _ = TRACED_CASES[name]
    assert _reader(name).read(dict(rec, trace=None)) is None


@pytest.mark.parametrize("name", sorted(TRACED_CASES))
def test_reader_is_silent_where_the_program_has_no_such_name(name, monkeypatch):
    rec, _ = TRACED_CASES[name]
    monkeypatch.setattr(profiling, "TRACED", profiling.StageTimer())
    assert _reader(name).read(rec) is None


@pytest.mark.parametrize("name", sorted(TRACED_CASES))
def test_reader_is_silent_where_the_program_has_no_traced_timer(name, monkeypatch):
    rec, _ = TRACED_CASES[name]
    monkeypatch.delattr(profiling, "TRACED")
    assert _reader(name).read(rec) is None
