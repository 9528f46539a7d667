"""Fresh hard-linked names for each call: files, and directory stores linked
file by file, read by the port as the originals are and taken by a whole
run of the harness and by the control's readings."""

import io
import json
import os
import re
from pathlib import Path

import numpy as np
import pytest
import torch
from tiny import ROOT  # noqa: F401  (puts the checkout's root on sys.path)

from bench_port import control
from bench_port.harness import Cell, Linker, main

#: the Sv-like stores: channels, pings a store, samples a ping
C, P, R = 5, 300, 400


def _tree(root):
    """Nested directories with files, as a zarr store lays them out."""
    for rel, data in ((".zgroup", b'{"zarr_format": 2}'), ("Sv/.zarray", b"{}"),
                      ("Sv/0.0.0", b"\x01\x02\x03"), ("Sv/0.0.1", b"\x04"),
                      ("ping_time/.zarray", b"{}"), ("ping_time/0", b"\x05"),
                      ("deep/er/still/x", b"x")):
        f = root / rel
        f.parent.mkdir(parents=True, exist_ok=True)
        f.write_bytes(data)
    return root


def _files(root):
    return sorted(p.relative_to(root) for p in root.rglob("*") if p.is_file())


def test_a_file_gets_a_fresh_hard_link(tmp_path):
    f = tmp_path / "a.raw"
    f.write_bytes(b"raw bytes")
    linker = Linker(tmp_path / "work")
    linker.work_dir.mkdir()
    with linker.fresh([str(f)]) as (name,):
        assert name != str(f) and Path(name).name == "a.raw"
        assert os.stat(name).st_ino == os.stat(f).st_ino
        assert os.stat(f).st_nlink == 2
    assert not os.path.exists(name) and f.read_bytes() == b"raw bytes"
    assert os.stat(f).st_nlink == 1


def test_a_directory_tree_is_linked_file_by_file(tmp_path):
    src = _tree(tmp_path / "s.zarr")
    before = {r: (src / r).read_bytes() for r in _files(src)}
    linker = Linker(tmp_path / "work")
    linker.work_dir.mkdir()
    with linker.fresh([str(src)]) as (name,):
        q = Path(name)
        assert q != src and q.name == "s.zarr" and _files(q) == sorted(before)
        for d in [q] + [p for p in q.rglob("*") if p.is_dir()]:  # directories made anew
            assert not os.path.samefile(d, src / d.relative_to(q))
        for r in before:
            got, orig = os.stat(q / r), os.stat(src / r)
            assert got.st_ino == orig.st_ino and got.st_nlink == 2
    assert not q.exists() and os.listdir(linker.work_dir) == []

    with pytest.raises(RuntimeError, match="the body raised"):
        with linker.fresh([str(src)]) as (name,):
            assert Path(name).is_dir()
            raise RuntimeError("the body raised")
    assert not Path(name).exists() and os.listdir(linker.work_dir) == []
    assert {r: (src / r).read_bytes() for r in _files(src)} == before
    assert all(os.stat(src / r).st_nlink == 1 for r in before)


@pytest.mark.parametrize("kind", ["symlink", "fifo"])
def test_a_symlink_or_special_file_in_a_store_is_refused(tmp_path, kind):
    src = _tree(tmp_path / "s.zarr")
    odd = src / "Sv" / "odd"
    if kind == "symlink":
        odd.symlink_to(src / "Sv" / "0.0.0")
    else:
        os.mkfifo(odd)
    linker = Linker(tmp_path / "work")
    linker.work_dir.mkdir()
    msg = re.escape(f"{odd}: neither a regular file nor a directory")
    with pytest.raises(ValueError, match=msg):
        with linker.fresh([str(src)]):
            pass
    assert os.listdir(linker.work_dir) == []  # the partial tree went
    assert all(os.stat(src / r).st_nlink == 1 for r in _files(src) if r.name != "odd")


def test_two_paths_with_one_base_name_are_refused(tmp_path):
    a = _tree(tmp_path / "a" / "s.zarr")
    b = _tree(tmp_path / "b" / "s.zarr")
    linker = Linker(tmp_path / "work")
    linker.work_dir.mkdir()
    with pytest.raises(ValueError, match="share the base name s.zarr"):
        with linker.fresh([str(a), str(b)]):
            pass
    assert os.listdir(linker.work_dir) == []


def write_sv_stores(data_dir, seed, n_stores=3, ctd_store=2):
    """Sv-like zarr v2 stores (float64 Sv and echo_range, Blosc on), one
    after the other in time; store ``ctd_store`` changes its sound speed at
    its middle ping, so its range grid varies by ping."""
    from echopype_torch.storage import write_dataset
    from echopype_torch.xrlite import Dataset

    rng = np.random.default_rng(seed)
    t0 = np.datetime64("2017-06-20T01:10:27", "ns")
    paths = []
    for i in range(n_stores):
        c = np.full(P, 1500.0)
        if i == ctd_store:
            c[P // 2:] = 1490.0
        er = np.broadcast_to(np.arange(R) * (c[:, None] * 1.024e-4 / 2), (C, P, R))
        ds = Dataset(
            {"Sv": (("channel", "ping_time", "range_sample"), rng.uniform(-120, -40, (C, P, R))),
             "echo_range": (("channel", "ping_time", "range_sample"), er.copy())},
            coords={"channel": np.array([f"ch{k}" for k in range(C)], dtype=object),
                    "ping_time": t0 + ((i * P + np.arange(P)) * 10**9).astype("timedelta64[ns]"),
                    "range_sample": np.arange(R)})
        paths.append(write_dataset(Path(data_dir) / f"sv{i}.zarr", ds, compress=True))
    return paths


@pytest.fixture
def one_thread():
    """The port's per-ping route on the CPU sums in an order that can vary
    from call to call at eight threads (up to 3.3e-8 dB on these stores);
    at one thread it repeats bit for bit, so linked and original stores
    compare exactly."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


def _survey(paths):
    import echopype_torch as et

    return et.run_survey_mvbs(paths, range_bin="5m", ping_time_bin="20s", device="cpu")


def test_the_port_reads_linked_stores_bit_for_bit(tmp_path, one_thread):
    paths = write_sv_stores(tmp_path / "data", 7)
    assert json.loads((Path(paths[0]) / "Sv" / ".zarray").read_text())["compressor"]["id"] \
        in ("blosc", "zlib")
    want = _survey(paths)
    linker = Linker(tmp_path / "work")
    linker.work_dir.mkdir()
    with linker.fresh(paths) as names:
        got = _survey(names)
    assert got.attrs["routes"] == want.attrs["routes"] == ["grid", "grid", "per_ping"]
    for v in ("Sv", "ping_time", "echo_range", "channel"):
        np.testing.assert_array_equal(np.asarray(got[v].values), np.asarray(want[v].values))
    assert np.asarray(got["Sv"].values).tobytes() == np.asarray(want["Sv"].values).tobytes()


STORE_ENTRY = '''
import os
from pathlib import Path

import numpy as np
import torch
from test_bench_port_linker import P, _survey, write_sv_stores


def setup(cell, seed, data_dir, device):
    paths = write_sv_stores(data_dir, seed, **cell.config["stores"])
    want = _survey(paths)
    return {"paths": paths, "sv": np.asarray(want["Sv"].values),
            "routes": want.attrs["routes"]}

def call_files(state, i):
    return state["paths"]

def warm_files(state):
    return state["paths"]

def files_in_turn(state):
    return 2

def call(state, files, rec, warm=False):
    for name, orig in zip(files, state["paths"]):
        q, o = Path(name), Path(orig)
        if not q.is_dir() or q == o or os.path.samefile(q, o):
            raise AssertionError(f"{name} is not a fresh directory")
        if os.stat(q / "Sv" / ".zarray").st_ino != os.stat(o / "Sv" / ".zarray").st_ino:
            raise AssertionError(f"{name}: not hard links of {orig}")
    mv = _survey(files)
    return {"sv": np.asarray(mv["Sv"].values), "routes": mv.attrs["routes"]}, len(files) * P

def control_outputs(state, device):
    sv = torch.from_numpy(state["sv"]).to(torch.bfloat16).double().numpy()
    return [{"sv": sv, "routes": state["routes"]}]

def judge(state, outputs, device, rec):
    gap = max((float(np.nanmax(np.abs(o["sv"] - state["sv"]))) for o in outputs), default=0.0)
    nan = sum(int((np.isnan(o["sv"]) != np.isnan(state["sv"])).sum()) for o in outputs)
    routes = sum(o["routes"] != state["routes"] for o in outputs)
    return [("sv_max_db", gap, 0.0), ("nan_mismatch", float(nan), 0.0),
            ("routes_mismatch", float(routes), 0.0)]
'''


@pytest.fixture
def store_bench(tmp_path):
    """A throwaway benchmark folder whose one cell's traffic is directory stores."""
    d = tmp_path / "b"
    for sub in ("configs", "workloads", "entries", "metrics"):
        (d / sub).mkdir(parents=True)
    (d / "configs" / "sv_stores.json").write_text(json.dumps(
        {"name": "sv_stores", "stores": {"n_stores": 3, "ctd_store": 2}}))
    (d / "workloads" / "sv_store_cell.json").write_text(json.dumps(
        {"config": "sv_stores", "entry": "sv_store_entry", "chips": 1}))
    (d / "entries" / "sv_store_entry.py").write_text(STORE_ENTRY)
    (d / "metrics" / "pings_per_call.py").write_text(
        "def read(rec):\n    return rec['pings'] / rec['calls']\n")
    man = {"end_to_end": [{"name": "pings_per_call", "unit": "pings"}], "per_layer": []}
    return d, man


def test_a_whole_run_takes_directory_stores(store_bench, tmp_path, monkeypatch, one_thread):
    d, man = store_bench
    monkeypatch.setenv("TMPDIR", str(tmp_path))
    res = main(["--workload", "sv_store_cell", "--seed", "2147483659", "--seconds", "3"],
               device="cpu", bench_dir=d, manifest=man, out=io.StringIO())
    assert res["correct"] and res["failed"] == 0 and res["attempted"] >= 2, res
    assert res["metrics"] == {"pings_per_call": {"value": 900.0, "unit": "pings"}}
    assert res["checks"]["sv_max_db"]["value"] == 0.0
    assert [p.name for p in tmp_path.iterdir()] == ["b"]  # the run's files and links went


def test_the_control_reads_directory_stores(store_bench, tmp_path, one_thread):
    d, man = store_bench
    cell = Cell("sv_store_cell", d, man)
    work = tmp_path / "work"
    work.mkdir()
    sides = dict(control.readings(cell, 11, "cpu", True, work))
    assert all(v <= lim for _, v, lim in sides["program"])
    assert not all(v <= lim for _, v, lim in sides["control_bf16"])
    assert os.listdir(work) == []
