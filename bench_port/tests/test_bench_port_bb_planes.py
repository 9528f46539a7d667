"""The broadband cell's share of channel-pings staged from the parser's
float32 planes (``bb_plane_staged_pct.bb``): its reader on recorded traced
windows, silent where the program counted neither counter, has no
``TRACED``, or the run was not traced; and its manifest entry."""

import pytest
from test_bench_port_bb import BB_REC, CELL
from test_bench_port_metrics import _reader
from tiny import manifest

from echopype_torch.utils import profiling

NAME = "bb_plane_staged_pct.bb"
#: counters of a traced window -> the reading
COUNTED = {
    "planes_alone": ({"bb_plane_pings": 8_000, "bb_h2d_bytes": 4.2e9}, 100.0),
    "both": ({"bb_plane_pings": 6_000, "complex_widened_pings": 2_000}, 75.0),
    "widened_alone": ({"complex_widened_pings": 8_000}, 0.0),
    "neither": ({"bb_h2d_bytes": 4.2e9}, None),
}
#: the case ``test_bench_port_metrics.py``'s ``WANT`` takes for the reader
PLANE_CASES = {NAME: (BB_REC, None)}


def _traced(monkeypatch, counters):
    timer = profiling.StageTimer()
    timer.counters.update(counters)
    monkeypatch.setattr(profiling, "TRACED", timer)


@pytest.mark.parametrize("case", sorted(COUNTED))
def test_reader_on_a_recorded_traced_window(case, monkeypatch):
    counters, want = COUNTED[case]
    _traced(monkeypatch, counters)
    got = _reader(NAME).read(BB_REC)
    assert got == want if want is None else got == pytest.approx(want, rel=1e-12)


def test_reader_is_silent_in_an_untraced_run(monkeypatch):
    _traced(monkeypatch, COUNTED["both"][0])
    assert _reader(NAME).read(dict(BB_REC, trace=None)) is None


def test_reader_is_silent_where_the_program_has_no_traced_timer(monkeypatch):
    monkeypatch.delattr(profiling, "TRACED")
    assert _reader(NAME).read(BB_REC) is None


def test_the_metric_is_in_the_manifest_for_the_cell():
    m = manifest()
    mine = [x for x in m["per_layer"] if x["name"] == NAME]
    assert mine == [{"name": NAME, "unit": "%", "better": "higher",
                     "source": "program_counter",
                     "layer": "parallel.survey complex staging (_run_complex_fused)",
                     "moves": "survey_pings_per_s", "workloads": [CELL]}]
    assert m["per_layer"][-1] == mine[0]
