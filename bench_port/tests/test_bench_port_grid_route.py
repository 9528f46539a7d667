"""The reader of compute_MVBS's route counters (``grid_route_pct.chain``):
on a recorded traced window, and silent on an untraced run or a program
without the counters (a version of the package before the range-row
route)."""

import pytest
from test_bench_port_metrics import CHAIN, _reader

from echopype_torch.utils import profiling

#: metric -> (recorded run, value, the program's counters in its traced window)
GRID_CASES = {
    "grid_route_pct.chain": (CHAIN, 75.0, {"mvbs_pings": 8_000, "mvbs_grid_pings": 6_000}),
}


def _with_counters(monkeypatch, counters):
    timer = profiling.StageTimer()
    timer.counters.update(counters)
    monkeypatch.setattr(profiling, "TRACED", timer)


@pytest.mark.parametrize("name", sorted(GRID_CASES))
def test_reader_on_a_recorded_traced_window(name, monkeypatch):
    rec, want, counters = GRID_CASES[name]
    _with_counters(monkeypatch, counters)
    assert _reader(name).read(rec) == pytest.approx(want, rel=1e-12)


@pytest.mark.parametrize("name", sorted(GRID_CASES))
@pytest.mark.parametrize("counters", [{"mvbs_pings": 8_000, "mvbs_grid_pings": 0},
                                      {"mvbs_pings": 8_000, "mvbs_grid_pings": 8_000}])
def test_reader_spans_none_to_every_ping(name, counters, monkeypatch):
    rec, _, _ = GRID_CASES[name]
    _with_counters(monkeypatch, counters)
    assert _reader(name).read(rec) == 100.0 * counters["mvbs_grid_pings"] / 8_000


@pytest.mark.parametrize("name", sorted(GRID_CASES))
def test_reader_is_silent_in_an_untraced_run(name, monkeypatch):
    rec, _, counters = GRID_CASES[name]
    _with_counters(monkeypatch, counters)
    assert _reader(name).read(dict(rec, trace=None)) is None


@pytest.mark.parametrize("name", sorted(GRID_CASES))
@pytest.mark.parametrize("counters", [{}, {"mvbs_pings": 0, "mvbs_grid_pings": 0},
                                      {"staged_pings": 65_000}])
def test_reader_is_silent_where_the_program_has_no_such_counter(name, counters, monkeypatch):
    rec, _, _ = GRID_CASES[name]
    _with_counters(monkeypatch, counters)
    assert _reader(name).read(rec) is None


@pytest.mark.parametrize("name", sorted(GRID_CASES))
def test_reader_is_silent_where_the_program_has_no_traced_timer(name, monkeypatch):
    rec, _, _ = GRID_CASES[name]
    monkeypatch.delattr(profiling, "TRACED")
    assert _reader(name).read(rec) is None
