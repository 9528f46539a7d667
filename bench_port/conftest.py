"""Fixtures shared by the benchmark's CPU tests, beside ``tests/conftest.py``."""

import pytest


@pytest.fixture(autouse=True)
def want_holds_the_route_readers(request, monkeypatch):
    """For each test of ``test_bench_port_metrics.py``, the cases of the
    readers of compute_MVBS's route counters (``test_bench_port_grid_route.py``)
    join its ``WANT``, as ``tests/conftest.py`` joins those of the stage
    readers, so that its test that every manifest metric has a reader and a
    case holds.  Nothing changes at import time, and nothing outlives the
    test."""
    if request.path.name != "test_bench_port_metrics.py":
        return
    from test_bench_port_grid_route import GRID_CASES

    want = {name: case[:2] for name, case in GRID_CASES.items()}
    monkeypatch.setattr(request.module, "WANT", {**request.module.WANT, **want})
