"""The port's frequency-differenced EK60 survey against the benchmark's plain reference.

``bench_port/reference/ek60_fd.py`` computes the masked survey MVBS in
float64 from what the benchmark's EK60 writer drew: a sample is kept iff
``Sv[120 kHz] - Sv[38 kHz] > 6 dB`` and a sample that fails joins no bin on
any channel.  Here, at a tiny size on the CPU (240 samples a ping, the
survey cell's files 0 / 6 / 1 at 40 / 41 / 40 pings, file 6 with its
sound-speed update, chunks of 30 pings, 20 m x 5 s bins):

* ``run_survey_mvbs_from_raw(freq_diff=...)`` within 1e-4 dB of the
  reference on every bin that holds no boundary sample (a sample whose
  float64 difference lies within the reference's ``eps`` of 6 dB), NaN
  masks and grids equal, and some choice for each boundary sample's
  decision matching the bins that hold one.  The masked step is float32:
  ~4e-6 dB read, as the unmasked survey; 1e-4 lies far under a bfloat16
  step (~0.4 dB);
* every other sample's decision matches: the port's per-bin counts equal
  the reference's on the bins without a boundary sample;
* ``eps`` bounds the float32 error of the port's ``Sv_A - Sv_B`` at the
  configuration's full 4,000 samples a ping;
* the masked step's stage (``freqdiff_step``) and its counters
  (``fd_valid_samples``, ``fd_kept_samples``, ``h2d_bytes``) reach
  ``profiling.TRACED`` under a profiler and cost nothing without one; kept
  <= valid, and kept equals the counts the MVBS was built from; the
  unmasked survey's K1/K2 step keeps its own stage, ``device_mvbs``.
"""

import copy
import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import echopype_torch as et
import echopype_torch.parallel.survey as ts
from echopype_torch.parallel import pipeline as tp
from echopype_torch.utils import profiling
from echopype_torch.utils.profiling import TRACED, StageTimer, trace

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from bench_port.reference import compare  # noqa: E402
from bench_port.reference import ek60 as ref60  # noqa: E402
from bench_port.reference import ek60_fd as ref  # noqa: E402
from bench_port.synth import ek60 as writer  # noqa: E402

torch.set_num_threads(1)

EQ = "120kHz - 38kHz > 6dB"
R, CHUNK = 240, 30
KW = dict(sonar_model="EK60", range_bin="20m", ping_time_bin="5s", chunk_pings=CHUNK,
          freq_diff=EQ, device="cpu")
SEEDS = [2147483661, 2**31 + 977]


@pytest.fixture(autouse=True)
def no_specless_xarray(monkeypatch):
    """The profiler's first window looks up ``xarray``'s spec; the JAX
    package's facade, installed by other tests of the process, has none."""
    mod = sys.modules.get("xarray")
    if mod is not None and getattr(mod, "__spec__", None) is None:
        monkeypatch.delitem(sys.modules, "xarray")


@pytest.fixture(autouse=True)
def traced_left_empty():
    yield
    TRACED.clear()


def _config(samples=R):
    cfg = json.loads((ROOT / "bench_port" / "configs" / "ek60_5freq_freqdiff.json").read_text())
    assert cfg["freq_diff"] == EQ
    cfg = copy.deepcopy(cfg)
    cfg["samples_per_ping"] = samples
    return cfg


def _traffic(pings=((0, 40), (6, 41), (1, 40))):
    wl = json.loads((ROOT / "bench_port" / "workloads" / "ek60_survey_freqdiff.json").read_text())
    files = []
    for i, n in pings:
        f = dict(wl["traffic"]["files"][i], pings=n)
        if "ctd_update_ping" in f:
            f["ctd_update_ping"] = n // 2
        files.append(f)
    return {"files": files}


@pytest.fixture(scope="module", params=SEEDS, ids=["seed_a", "seed_b"])
def survey(request, tmp_path_factory):
    cfg = _config()
    made = writer.write_files(cfg, _traffic(), request.param, tmp_path_factory.mktemp("fd"),
                              "cpu")
    return cfg, made, ref.survey_mvbs(cfg, made, 20.0, 5, CHUNK, EQ)


def _run(files, monkeypatch, **kw):
    """The survey's MVBS and the sums and counts it was finalised from."""
    seen = {}
    real = ts._finalize

    def keep(sums, counts, *a, **k):
        seen["sums"], seen["counts"] = sums, counts
        return real(sums, counts, *a, **k)

    monkeypatch.setattr(ts, "_finalize", keep)
    out = et.run_survey_mvbs_from_raw(files, **{**KW, **kw})
    return out, seen


def _got(out):
    return {"Sv": np.asarray(out["Sv"].values, dtype="f8"),
            "ping_time": np.asarray(out.coords["ping_time"].values,
                                    dtype="datetime64[ns]").astype("i8"),
            "echo_range": np.asarray(out.coords["echo_range"].values, dtype="f8"),
            "channel": [str(c) for c in out.coords["channel"].values]}


def test_the_file_with_the_sound_speed_update_is_kept(survey):
    _, made, want = survey
    c = made[1][1]["sound_speed"]
    assert len(set(c.tolist())) == 2
    assert 0 < want["counts"].sum() < 121 * 5 * R  # the mask removes some, not all


def test_masked_survey_matches_the_reference_under_the_boundary_rule(survey, monkeypatch):
    cfg, made, want = survey
    out, _ = _run([p for p, _ in made], monkeypatch)
    got = _got(out)
    assert compare.grid_mismatch(got, want) == 0
    r = ref.boundary_readings(got["Sv"], want, 1e-3)
    assert r["nan_mismatch"] == 0 and r["unmatched"] == 0
    assert r["boundary_bins"] == 5 * len({(int(x), int(j)) for x, j in
                                          zip(want["boundary"]["x"], want["boundary"]["j"][:, 0])})
    assert np.isfinite(want["Sv"]).sum() > 50
    assert r["max_db"] < 1e-4


def test_every_other_decision_matches_the_references(survey, monkeypatch):
    _, made, want = survey
    _, seen = _run([p for p, _ in made], monkeypatch)
    counts = np.asarray(seen["counts"])
    assert counts.shape == want["counts"].shape
    free = np.ones(counts.shape, dtype=bool)
    for x, js in zip(want["boundary"]["x"], want["boundary"]["j"]):
        for c, j in enumerate(js):
            if 0 <= j < counts.shape[2]:
                free[c, x, j] = False
    np.testing.assert_array_equal(counts[free], want["counts"][free])
    left = want["counts"][~free].sum()
    assert left <= counts[~free].sum() <= left + 5 * len(want["boundary"]["x"])


def test_eps_bounds_the_float32_difference_at_full_range(tmp_path):
    cfg = _config(4000)
    made = writer.write_files(cfg, _traffic(((6, 60),)), 91, tmp_path, "cpu")
    path, truth = made[0]
    make_cal = ts._power_calibrator("EK60", None, None, torch.device("cpu"))
    power, dr, shift, alpha, offset, *_ = ts._load_inputs(path, "EK60", "auto", None, make_cal)

    def f32(a):
        return torch.from_numpy(np.asarray(a, dtype="f4"))

    index = np.rint(power / np.float32(tp.INDEX2POWER)).astype("i2")
    np.testing.assert_array_equal(index, truth["power"])
    sv32 = tp._sv_chunk(torch.from_numpy(index).float() * tp.INDEX2POWER, f32(dr), f32(shift),
                        f32(alpha), f32(offset))
    k = ref60.channel_constants(cfg)
    dr64, sh64, off64 = ref60._ping_terms(k, truth["sound_speed"])
    sv64 = torch.stack([ref60._sv_rows(truth["power"][c], dr64[c], sh64[c],
                                       np.full(60, k["absorption_coefficient"][c]), off64[c],
                                       torch.float64, "cpu")[0] for c in range(5)])
    ia, ib, op, diff = ref.criterion(cfg, EQ)
    assert (ia, ib, op, diff) == (3, 1, ">", 6.0)
    d64 = sv64[ia] - sv64[ib]
    err = ((sv32[ia] - sv32[ib]).double() - d64)[torch.isfinite(d64)].abs().max().item()
    eps = ref.eps_db(cfg, made, ia, ib, diff)
    assert 1e-4 < eps < 3e-4  # about 3,500 float32 units of 2**-24
    assert 0 < err < eps


def test_boundary_rule_takes_either_decision_and_nothing_else():
    """One boundary sample in bin (0, 0) of one channel: the bin matches
    with the sample left out or taken in, and with no other value."""
    sums, counts = np.array([[[4.0, 2.0]]]), np.array([[[2.0, 1.0]]])
    want = {"Sv": ref60._to_db(sums, counts), "sums": sums, "counts": counts,
            "boundary": {"x": np.array([0]), "j": np.array([[0]]), "lin": np.array([[8.0]]),
                         "valid": np.array([[True]])}}
    out = want["Sv"].copy()
    assert ref.boundary_readings(out, want, 1e-3)["unmatched"] == 0
    out[0, 0, 0] = 10 * np.log10(12.0 / 3)
    r = ref.boundary_readings(out, want, 1e-3)
    assert r["unmatched"] == 0 and r["boundary_samples"] == 1 and r["boundary_bins"] == 1
    out[0, 0, 0] += 0.01
    assert ref.boundary_readings(out, want, 1e-3)["unmatched"] == 1
    out[0, 0, 1] += 0.01  # a bin without a boundary sample is held to the limit itself
    assert ref.boundary_readings(out, want, 1e-3)["max_db"] == pytest.approx(0.01)


def _chunks_and_valid(made):
    n = sum(-(-tr["power"].shape[1] // CHUNK) for _, tr in made)
    return n, sum(tr["power"].shape[1] for _, tr in made) * 5 * R


def test_masked_stage_and_counters_land_in_traced(survey, monkeypatch, tmp_path):
    _, made, _ = survey
    with trace(str(tmp_path)):
        out, seen = _run([p for p, _ in made], monkeypatch)
    n_chunks, valid = _chunks_and_valid(made)
    assert TRACED.counts["freqdiff_step"] == n_chunks and TRACED.totals["freqdiff_step"] > 0
    assert "device_mvbs" not in TRACED.totals
    assert TRACED.counters["fd_valid_samples"] == valid
    kept = TRACED.counters["fd_kept_samples"]
    assert 0 < kept <= valid
    assert kept == int(np.asarray(seen["counts"]).sum())
    # per padded chunk: int16 power, four float32 and one int64 operand a
    # channel-ping, int64 bin ids, and the int64 range-bin bounds of each channel
    known = n_chunks * (5 * CHUNK * R * 2 + 5 * CHUNK * (4 * 4 + 8) + CHUNK * 8)
    rest, per_edge = TRACED.counters["h2d_bytes"] - known, n_chunks * 5 * 8
    assert rest > 0 and rest % per_edge == 0
    assert rest // per_edge >= len(out.coords["echo_range"].values) + 1


def test_masked_stage_and_counters_cost_nothing_without_a_profiler(survey, monkeypatch):
    _, made, _ = survey
    timer = StageTimer()
    _run([p for p, _ in made], monkeypatch, timer=timer)
    assert TRACED.report(log=False) == {} and not TRACED.counters
    assert "freqdiff_step" in timer.totals and "device_mvbs" not in timer.totals
    assert not {"fd_valid_samples", "fd_kept_samples", "h2d_bytes"} & set(timer.counters)
    assert profiling.stage("freqdiff_step") is profiling.stage("device_mvbs")  # the no-op


def test_unmasked_survey_keeps_k1_k2_under_device_mvbs(survey, monkeypatch):
    _, made, _ = survey
    timer = StageTimer()
    et.run_survey_mvbs_from_raw([p for p, _ in made], **{**KW, "freq_diff": None},
                                timer=timer)
    assert "device_mvbs" in timer.totals and "freqdiff_step" not in timer.totals
