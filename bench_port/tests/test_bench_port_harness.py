"""The harness: cells, entries and metrics found by name, the manifest's
limits, the import fence, and the refusal to measure without a card."""

import ast
import io
import json
import os
import re
import shutil
import subprocess
import sys

import pytest
import torch
from tiny import BENCH, ROOT, manifest, tiny_bench

from bench_port.harness import forbidden_modules, main

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")

DUMMY_ENTRY = '''
def setup(cell, seed, data_dir, device):
    return {"seed": seed}

def call_files(state, i):
    return []

def warm_files(state):
    return []

def call(state, files, rec, warm=False):
    rec["spans"]["dummy"] = rec["spans"].get("dummy", 0.0) + 1.0
    return {"x": state["seed"]}, 7

def judge(state, outputs, device, rec):
    return [("off_by", float(any(o["x"] != state["seed"] for o in outputs)), 0.0)]
'''


def test_dummy_cell_entry_and_metric_found_by_name(tmp_path):
    d = tmp_path / "b"
    for sub in ("configs", "workloads", "entries", "metrics"):
        (d / sub).mkdir(parents=True)
    (d / "configs" / "dummy_cfg.json").write_text("{}")
    (d / "workloads" / "dummy_cell.json").write_text(json.dumps(
        {"config": "dummy_cfg", "entry": "dummy_entry", "chips": 1}))
    (d / "entries" / "dummy_entry.py").write_text(DUMMY_ENTRY)
    (d / "metrics" / "dummy_spans.per_call.py").write_text(
        "def read(rec):\n    return rec['spans']['dummy'] / rec['calls']\n")
    (d / "metrics" / "silent.py").write_text("def read(rec):\n    return None\n")
    man = {"end_to_end": [{"name": "dummy_spans.per_call", "unit": "s"}],
           "per_layer": [{"name": "silent", "unit": "%"}]}
    out = io.StringIO()
    res = main(["--workload", "dummy_cell", "--seed", "3", "--seconds", "0.01"],
               device="cpu", bench_dir=d, manifest=man, out=out)
    assert res["correct"] and res["metrics"] == {"dummy_spans.per_call": {"value": 1.0,
                                                                          "unit": "s"}}
    assert json.loads(out.getvalue().splitlines()[-1]) == res
    assert list(res) == ["correct", "attempted", "failed", "metrics", "device", "checks"]
    traced = main(["--workload", "dummy_cell", "--seed", "3", "--seconds", "0.01",
                   "--trace", "1"], device="cpu", bench_dir=d, manifest=man, out=io.StringIO())
    assert traced["metrics"] == {}  # a reader that finds nothing leaves its metric out
    assert list(traced)[-1] == "checks"


def test_manifest_names_units_and_files():
    m = manifest()
    assert set(m) == {"command", "paths", "run_seconds", "configs", "workloads",
                      "end_to_end", "per_layer"}
    assert m["paths"] == ["bench_port"] and m["command"] == ["python3", "bench_port/run.py"]
    names = [x["name"] for g in ("configs", "workloads", "end_to_end", "per_layer")
             for x in m[g]]
    assert len(names) == len(set(names))
    for n in names + [w["traffic"] for w in m["workloads"]]:
        assert NAME.match(n), n
    for g in ("end_to_end", "per_layer"):
        for x in m[g]:
            assert UNIT.match(x["unit"]) and x["better"] in ("lower", "higher"), x
    assert "setup_s" in {x["name"] for x in m["end_to_end"]}
    for c in m["configs"]:
        assert (ROOT / c["file"]).is_file() and all(NAME.match(k) for k in c["reduced"])
        assert json.loads((ROOT / c["file"]).read_text())["name"] == c["name"]
    for w in m["workloads"]:
        spec = json.loads((BENCH / "workloads" / f"{w['traffic']}.json").read_text())
        assert spec["config"] == w["config"] and spec["chips"] == w["chips"] == 1
        assert len(w["why"]) <= 200
    e2e = {x["name"] for x in m["end_to_end"]}
    for x in m["per_layer"]:
        assert x["moves"] in e2e and x["source"] in (
            "device_trace", "program_span", "program_counter", "host_clock")


def test_forbidden_modules_compare_whole_top_level_names():
    assert forbidden_modules(["jax", "jax.numpy", "jaxlib.xla", "flax", "echopype_tpu.ops"]) \
        == ["echopype_tpu.ops", "flax", "jax", "jax.numpy", "jaxlib.xla"]
    assert forbidden_modules(["echopype_torch", "echopype_torch.ops", "jaxtyping",
                              "echopype_tpu_extra", "flaxen"]) == []


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_no_file_of_the_benchmark_imports_jax_and_the_reference_nothing_of_the_port():
    for path in BENCH.rglob("*.py"):
        tops = {n.split(".")[0] for n in _imports(path)}
        assert not tops & {"jax", "jaxlib", "flax", "echopype_tpu"}, path
        if "reference" in path.parts:  # plain NumPy / PyTorch, nothing of the port
            assert tops <= {"__future__", "numpy", "torch"}, (path, tops)


def test_the_run_imports_no_jax_on_the_cpu(tmp_path):
    """A whole run in a fresh interpreter loads nothing of JAX."""
    code = ("import sys; sys.path[:0] = [%r, %r]\n"
            "from tiny import tiny_bench\n"
            "from bench_port.harness import main, forbidden_modules\n"
            "main(['--workload', 'ek60_survey', '--seed', '5', '--seconds', '0.1'],"
            " device='cpu', bench_dir=tiny_bench(%r))\n"
            "print('LOADED', forbidden_modules(list(sys.modules)))\n"
            % (str(BENCH / "tests"), str(ROOT), str(tmp_path)))
    p = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                       timeout=600, env={**os.environ, "JAX_PLATFORMS": "cpu"})
    assert p.returncode == 0, p.stderr[-2000:]
    assert p.stdout.strip().splitlines()[-1] == "LOADED []"


def test_refuses_without_a_card_and_prints_no_result():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    p = subprocess.run([sys.executable, str(BENCH / "run.py"), "--workload", "ek60_survey",
                        "--seed", "1", "--seconds", "1"], capture_output=True, text=True,
                       timeout=300, cwd=ROOT)
    assert p.returncode != 0 and p.stdout.strip() == ""
    assert "torch.cuda.is_available() is false" in p.stderr


def test_fails_where_only_the_benchmark_is_checked_out(tmp_path):
    """Without the measured package beside it the run exits non-zero, no result."""
    shutil.copytree(BENCH, tmp_path / "bench_port",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    p = subprocess.run([sys.executable, "bench_port/run.py", "--workload", "ek60_survey",
                        "--seed", "1", "--seconds", "1"], capture_output=True, text=True,
                       timeout=300, cwd=tmp_path)
    assert p.returncode != 0 and p.stdout.strip() == ""


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.gpu
def test_tiny_cells_on_the_card(card, tmp_path):
    for cell in ("ek60_survey", "azfp_ooi_survey", "ek60_sv_chain"):
        res = main(["--workload", cell, "--seed", "2147483651", "--seconds", "1"],
                   bench_dir=tiny_bench(tmp_path / cell), out=io.StringIO())
        assert res["correct"] and res["device"]["platform"] == "gpu", res
