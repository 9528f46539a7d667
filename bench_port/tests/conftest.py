"""Fixtures shared by the benchmark's CPU tests."""

import pytest


@pytest.fixture(autouse=True)
def want_holds_the_readers_added_later(request, monkeypatch):
    """``WANT`` of ``test_bench_port_metrics.py`` holds the cases of the
    readers that file was written with.  For each of its tests, the cases
    of the readers of the program's stages and counters
    (``test_bench_port_traced.py``) join it, so that its test that every
    manifest metric has a reader and a case holds; its parametrised tests
    were collected from its own cases.  Nothing changes at import time,
    and nothing outlives the test."""
    if request.path.name != "test_bench_port_metrics.py":
        return
    from test_bench_port_traced import TRACED_CASES

    monkeypatch.setattr(request.module, "WANT", {**request.module.WANT, **TRACED_CASES})
