"""``utils.profiling.trace``: a ``torch.profiler`` window written as a Chrome
trace, the counterpart of the JAX package's ``jax.profiler`` hook.

On the CPU (no CUDA initialised, so host activity only): a raw EK60 survey
traced into a fresh directory writes one ``*.pt.trace.json`` whose events
hold the survey's torch ops (the plain twin of K1 runs ``aten::exp`` and
the bin sums); the yielded profiler's ``key_averages()`` lists them too.
A body that raises still writes its trace and the error propagates;
``StageTimer`` is unchanged beside it.  ``launch_span`` (the kernel
wrappers' launch mark) is a no-op outside a profiler window and a named
host span inside one.  The port's xarray facade carries a module spec, so
a trace opens with it installed as ``xarray``.

The profiler's first window imports torch's compiler stack, which runs
``importlib.util.find_spec`` over a list of packages, ``xarray`` among
them; the JAX package's facade, which the reference-oracle tests install
into ``sys.modules`` of the same process, has no spec and makes that
raise, so each test here runs with such a module out of ``sys.modules``.
"""

import contextlib
import importlib.util
import json
import sys

import numpy as np
import pytest
import torch

import echopype_torch as et
from echopype_torch.utils import profiling
from echopype_torch.utils.profiling import StageTimer, launch_span, trace

from synth_ek60 import write_ek60_raw

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def no_specless_xarray(monkeypatch):
    mod = sys.modules.get("xarray")
    if mod is not None and getattr(mod, "__spec__", None) is None:
        monkeypatch.delitem(sys.modules, "xarray")


@pytest.fixture(scope="module")
def raw(tmp_path_factory):
    path = tmp_path_factory.mktemp("trace") / "T-D20200101-T000000.raw"
    write_ek60_raw(path, n_pings=30, n_samples=200, with_angle=False)
    return str(path)


def _events(log_dir):
    files = sorted(log_dir.glob("*.pt.trace.json"))
    assert len(files) == 1
    return json.loads(files[0].read_text())["traceEvents"]


def test_trace_writes_survey_ops(raw, tmp_path):
    log_dir = tmp_path / "trace"
    timer = StageTimer()
    with trace(str(log_dir)) as prof:
        mvbs = et.run_survey_mvbs_from_raw([raw], range_bin="5m", ping_time_bin="10s",
                                           chunk_pings=16, timer=timer, device="cpu")
    assert np.isfinite(mvbs["Sv"].values).any()
    names = {e.get("name") for e in _events(log_dir)}
    assert {"aten::exp", "aten::copy_"} <= names
    assert any(n.startswith("aten::") for n in names if n)
    ops = {a.key for a in prof.key_averages()}
    assert "aten::exp" in ops
    assert not torch.cuda.is_initialized()
    assert "ingest" in timer.report(log=False)


def test_trace_writes_on_error_and_propagates(tmp_path):
    log_dir = tmp_path / "err"
    with pytest.raises(ZeroDivisionError):
        with trace(str(log_dir)):
            torch.ones(3).exp()
            1 / 0
    assert "aten::exp" in {e.get("name") for e in _events(log_dir)}


def test_trace_is_exported():
    assert "trace" in profiling.__all__ and "StageTimer" in profiling.__all__


def test_launch_span_only_while_recording(tmp_path):
    assert isinstance(launch_span("ep_probe"), contextlib.nullcontext)
    with trace(str(tmp_path)):
        with launch_span("ep_probe"):
            torch.ones(2).exp()
    spans = [e for e in _events(tmp_path) if e.get("name") == "ep_probe"]
    assert [e.get("cat") for e in spans] == ["user_annotation"]


def test_trace_with_the_port_xarray_facade(tmp_path):
    from echopype_torch.xrlite import xarray_compat
    from test_torch_datatree import restoring_xarray_modules

    with restoring_xarray_modules():
        assert xarray_compat.install(force=True)
        assert importlib.util.find_spec("xarray") is sys.modules["xarray"].__spec__
        with trace(str(tmp_path)):
            torch.ones(2).exp()
    assert "aten::exp" in {e.get("name") for e in _events(tmp_path)}
