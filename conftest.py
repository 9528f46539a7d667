"""Fixtures shared by the test trees, beside ``tests/conftest.py`` and
``bench_port/conftest.py``."""

import pytest


@pytest.fixture(autouse=True)
def want_holds_the_broadband_readers(request, monkeypatch):
    """For each test of ``bench_port/tests/test_bench_port_metrics.py``, the
    cases of the broadband, frequency-differencing and NASC cells' readers
    (``test_bench_port_bb.py``, ``test_bench_port_bb_planes.py``,
    ``test_bench_port_fd.py``, ``test_bench_port_nasc.py``) join its
    ``WANT``, as the two fixtures below this folder join those of the stage
    and route readers, so that its test that every manifest metric has a
    reader and a case holds.  Nothing changes at import time, and nothing
    outlives the test."""
    if request.path.name != "test_bench_port_metrics.py":
        return
    from test_bench_port_bb import BB_CASES
    from test_bench_port_bb_planes import PLANE_CASES
    from test_bench_port_fd import FD_CASES
    from test_bench_port_nasc import NASC_CASES

    monkeypatch.setattr(request.module, "WANT",
                        {**request.module.WANT, **BB_CASES, **FD_CASES, **PLANE_CASES,
                         **NASC_CASES})
