"""Port parity: raw EK60 -> survey-global MVBS, and the survey's host pieces.

echopype_torch.run_survey_mvbs_from_raw(device="cpu") runs the plain twins
of the CUDA window kernels; echopype_tpu.parallel.run_survey_mvbs_from_raw
is the reference on the same synthetic files.  MVBS within 1e-4 dB (as
tests/test_survey.py:46-47), identical NaN masks and coordinates, over the
streamed (prefetch) and eager paths, ragged pings, skipped pings, and a
file whose dr varies by ping (the K2 path).
"""

import numpy as np
import pandas as pd
import pytest
import torch

import echopype_torch as et
from echopype_torch.commongrid.utils import _parse_x_bin, ping_time_bin_edges
from echopype_torch.ops import window_partials as wp
from echopype_torch.parallel import survey as ts
from echopype_torch.utils.compute import _lin2log, _log2lin
from echopype_torch.utils.profiling import StageTimer
from echopype_tpu.commongrid.utils import ping_time_bin_edges as ping_time_bin_edges_pd
from echopype_tpu.parallel import run_survey_mvbs_from_raw as run_jax
from synth_ek60 import write_ek60_raw

torch.set_num_threads(1)

T0 = np.datetime64("2020-01-01T00:00:00", "ns")


@pytest.fixture(scope="module")
def raw_files(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_survey")
    specs = [
        ("ragged", dict(ragged=True, n_pings=41)),
        ("skip", dict(skip_pings={2: {3, 4, 17, 30}}, n_pings=37)),
        ("jitter", dict(jitter_raw0=True, n_pings=33)),
    ]
    out = {}
    for i, (name, kw) in enumerate(specs):
        path = d / f"{name}-D20200101-T000{i}00.raw"
        write_ek60_raw(path, n_samples=260 + 20 * i, seed=30 + i, with_angle=False,
                       t0=T0 + np.timedelta64(i * 47, "s"), **kw)
        out[name] = str(path)
    return out


def _assert_mvbs_close(got, want):
    g, w = np.asarray(got["Sv"].values), np.asarray(want["Sv"].values)
    for coord in ("ping_time", "echo_range"):
        np.testing.assert_array_equal(
            np.asarray(got.coords[coord].values), np.asarray(want.coords[coord].values)
        )
    np.testing.assert_array_equal(
        np.asarray(got.coords["channel"].values, dtype=str),
        np.asarray(want.coords["channel"].values, dtype=str),
    )
    np.testing.assert_array_equal(np.isnan(g), np.isnan(w))
    assert np.isfinite(g).any()
    np.testing.assert_allclose(g, w, atol=1e-4, rtol=0, equal_nan=True)


@pytest.mark.parametrize("prefetch", [True, False])
@pytest.mark.parametrize(
    "names", [("ragged", "skip"), ("jitter",), ("ragged", "skip", "jitter")],
    ids=["uniform", "dr_by_ping", "mixed"],
)
def test_survey_matches_jax(raw_files, names, prefetch):
    files = [raw_files[n] for n in names]
    kw = dict(sonar_model="EK60", range_bin="7m", ping_time_bin="15s", chunk_pings=13,
              prefetch=prefetch)
    wp.reset_launches()
    got = et.run_survey_mvbs_from_raw(files, device="cpu", **kw)
    assert wp.LAUNCHES == {"window_partials_uniform": 0, "window_partials": 0}
    assert got.attrs["device"] == "cpu"
    _assert_mvbs_close(got, run_jax(files, **kw))


def test_jitter_file_takes_the_per_ping_path(raw_files, monkeypatch):
    """The dr-varying file must reach K2's twin; the others K1's."""
    seen = []
    real_k1, real_k2 = ts.sv_mvbs_window_partials_uniform, ts.sv_mvbs_window_partials
    monkeypatch.setattr(ts, "sv_mvbs_window_partials_uniform",
                        lambda *a, **k: seen.append("K1") or real_k1(*a, **k))
    monkeypatch.setattr(ts, "sv_mvbs_window_partials",
                        lambda *a, **k: seen.append("K2") or real_k2(*a, **k))
    et.run_survey_mvbs_from_raw([raw_files["ragged"], raw_files["jitter"]], device="cpu",
                                range_bin="7m", ping_time_bin="15s", chunk_pings=20)
    assert seen == ["K1", "K1", "K1", "K2", "K2"]


def test_streamed_equals_eager_exactly(raw_files):
    files = list(raw_files.values())
    kw = dict(range_bin="5m", ping_time_bin="20s", chunk_pings=16, device="cpu")
    a = et.run_survey_mvbs_from_raw(files, prefetch=True, **kw)
    b = et.run_survey_mvbs_from_raw(files, prefetch=False, **kw)
    np.testing.assert_array_equal(a["Sv"].values, b["Sv"].values)
    np.testing.assert_array_equal(a.coords["echo_range"].values, b.coords["echo_range"].values)


def test_chunking_leaves_bins_in_place(raw_files):
    """Counts are exact integers, so NaN masks are chunk-invariant; sums
    only reassociate in float32."""
    files = [raw_files["ragged"], raw_files["skip"]]
    kw = dict(range_bin="7m", ping_time_bin="15s", device="cpu")
    a = et.run_survey_mvbs_from_raw(files, chunk_pings=7, **kw)
    b = et.run_survey_mvbs_from_raw(files, chunk_pings=5000, **kw)
    np.testing.assert_array_equal(np.isnan(a["Sv"].values), np.isnan(b["Sv"].values))
    np.testing.assert_allclose(a["Sv"].values, b["Sv"].values, atol=1e-4, equal_nan=True)


def test_corrupt_file_falls_back_to_eager(raw_files, tmp_path):
    bad = tmp_path / "bad-D20200101-T000000.raw"
    bad.write_bytes(open(raw_files["ragged"], "rb").read() + b"\x99" * 37)
    kw = dict(range_bin="7m", ping_time_bin="15s", device="cpu")
    a = et.run_survey_mvbs_from_raw([str(bad)], **kw)
    b = et.run_survey_mvbs_from_raw([str(bad)], prefetch=False, **kw)
    np.testing.assert_array_equal(a["Sv"].values, b["Sv"].values)


@pytest.mark.parametrize(
    "kw, item",
    [(dict(mesh=object()), 10), (dict(freq_diff="38kHz - 18kHz > 3dB", mesh=object()), 10),
     (dict(workers=2), 9), (dict(noise_masks={"impulse": {}}, workers=2), 9),
     (dict(sonar_model="EK80", waveform_mode="BB", encode_mode="complex",
           freq_diff="70kHz - 120kHz > 3dB", workers=2), 9),
     (dict(sonar_model="EK80", device_fused=True, mesh=object()), 10),
     (dict(sonar_model="ES80", noise_masks={"transient": {}}, mesh=object()), 10),
     (dict(sonar_model="AZFP"), 11), (dict(sonar_model="AZFP6"), 11)],
    ids=["mesh", "freq_diff", "workers", "noise_masks", "complex_freq_diff",
         "device_fused_mesh", "es80_noise_masks", "azfp", "azfp6"],
)
def test_unported_options_raise(raw_files, kw, item):
    """``mesh`` (ROADMAP Queue 1 item 10), ``workers`` (9) and AZFP (11) raise;
    ``freq_diff`` and ``noise_masks`` are ported, and an unported option asked
    alongside them still raises."""
    with pytest.raises(NotImplementedError, match=f"item {item}"):
        et.run_survey_mvbs_from_raw([raw_files["ragged"]], device="cpu", **kw)


def test_unknown_model_and_empty_input(raw_files):
    with pytest.raises(ValueError):
        et.run_survey_mvbs_from_raw([raw_files["ragged"]], sonar_model="AD2CP", device="cpu")
    with pytest.raises(ValueError, match="CW power"):
        et.run_survey_mvbs_from_raw([raw_files["ragged"]], waveform_mode="BB",
                                    encode_mode="complex", device="cpu")
    with pytest.raises(ValueError, match="no raw files"):
        et.run_survey_mvbs_from_raw([], device="cpu")


def test_cuda_request_without_cuda_raises(raw_files):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; this checks the no-fallback rule")
    with pytest.raises(RuntimeError, match="cuda"):
        et.run_survey_mvbs_from_raw([raw_files["ragged"]])


class TestHostPieces:
    @pytest.mark.parametrize("freq", ["20s", "1min", "0.5min", "2h", "7s", "250ms"])
    @pytest.mark.parametrize("start", ["2020-01-01T00:00:03.250", "2019-12-31T23:59:58.9",
                                       "2021-06-15T13:47:31.000001"])
    def test_ping_time_bin_edges_match_pandas(self, freq, start):
        t0 = np.datetime64(start, "ns")
        rng = np.random.default_rng(5)
        pt = t0 + np.sort(rng.integers(0, 3 * 3600 * 10**9, 50)).astype("timedelta64[ns]")
        np.testing.assert_array_equal(ping_time_bin_edges(pt, freq),
                                      ping_time_bin_edges_pd(pt, freq))
        one = np.array([t0], dtype="datetime64[ns]")
        np.testing.assert_array_equal(ping_time_bin_edges(one, freq),
                                      ping_time_bin_edges_pd(one, freq))

    @pytest.mark.parametrize("freq", ["1D", "1W", "MS", "20 parsecs", "0.3ns"])
    def test_unsupported_time_bins_raise(self, freq):
        with pytest.raises(ValueError):
            ping_time_bin_edges(np.array([T0]), freq)

    def test_parse_range_bin(self):
        assert _parse_x_bin("20m") == 20.0 and _parse_x_bin(" 2.5 M") == 2.5
        with pytest.raises(ValueError):
            _parse_x_bin("20s")
        with pytest.raises(TypeError):
            _parse_x_bin(20)
        assert ts._resolve_bin_m("5m", None) == ts._resolve_bin_m(5, None) == 5.0
        assert ts._resolve_bin_m("5m", 3.0) == 3.0

    def test_global_ping_bins_reject_reversed_time(self):
        edges = pd.date_range("2020-01-01", periods=4, freq="10s").values.astype("i8")
        pt = edges[:3] + 5
        np.testing.assert_array_equal(ts._global_ping_bins(pt, edges, 3), [0, 1, 2])
        with pytest.raises(ValueError, match="coerce_increasing_time"):
            ts._global_ping_bins(pt[::-1], edges, 3)

    def test_sanitize_excludes_nan_param_rows(self):
        power = np.zeros((2, 3, 4), dtype="f4")
        dr = np.array([[0.2, np.nan, 0.2], [np.nan, np.nan, np.nan]])
        out_power, out_dr = ts._sanitize_power_cal_inputs(power, dr)
        assert np.isnan(out_power[0, 1]).all() and np.isnan(out_power[1]).all()
        assert not np.isnan(out_power[0, [0, 2]]).any()
        np.testing.assert_array_equal(out_dr, [[0.2, 0.2, 0.2], [1.0, 1.0, 1.0]])

    def test_accumulator_lags_one_chunk(self):
        timer = StageTimer()
        acc = ts._PartialAccumulator(1, 5, 2, 3, timer)
        one = np.ones((1, 3, 2))
        acc.push(torch.ones(1, 3, 2), one, 0)
        assert acc.sums.sum() == 0  # held until the next push
        acc.push(torch.ones(1, 3, 2), one, 3)  # window clipped at n_x
        sums, counts = acc.finish()
        np.testing.assert_array_equal(sums[0, :, 0], [1, 1, 1, 1, 1])
        assert sums.dtype == np.float64 and timer.report(log=False)["accumulate"]["count"] == 2

    def test_stage_timer_counts_and_holder(self):
        timer = StageTimer()
        for _ in range(2):
            with timer.stage("work") as out:
                out.append(torch.ones(3))  # CPU tensors need no device sync
        report = timer.report(log=False)
        assert report["work"]["count"] == 2 and report["work"]["total_s"] >= 0

    def test_lin_log(self):
        x = np.array([1e-3, 1.0, 10.0])
        np.testing.assert_allclose(_lin2log(x), [-30.0, 0.0, 10.0])
        np.testing.assert_allclose(_lin2log(torch.tensor(x)).numpy(), [-30.0, 0.0, 10.0])
        np.testing.assert_allclose(_log2lin(_lin2log(torch.tensor(x))).numpy(), x)
