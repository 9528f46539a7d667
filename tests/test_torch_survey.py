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
from echopype_torch.echodata.simrad import retrieve_correct_beam_group
from echopype_torch.ops import window_partials as wp
from echopype_torch.parallel import survey as ts
from echopype_torch.utils.compute import _lin2log, _log2lin
from echopype_torch.utils.profiling import StageTimer
from echopype_tpu.commongrid.utils import ping_time_bin_edges as ping_time_bin_edges_pd
from echopype_tpu.parallel import run_survey_mvbs_from_raw as run_jax
from synth_azfp import write_azfp_raw, write_azfp_xml
from synth_ek60 import write_ek60_raw
from synth_ek80 import write_ek80_raw
from test_azfp6 import write_azfp6_raw

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
    assert not any(wp.LAUNCHES.values())
    assert got.attrs["device"] == "cpu"
    _assert_mvbs_close(got, run_jax(files, **kw))


def test_jitter_file_takes_the_per_ping_path(raw_files, monkeypatch):
    """The dr-varying file must reach K2's twin; the others K1's."""
    seen = []
    real = ts.sharded_mvbs_partials_closed

    def spy(mesh, *a, uniform=False, **k):
        seen.append("K1" if uniform else "K2")
        return real(mesh, *a, uniform=uniform, **k)

    monkeypatch.setattr(ts, "sharded_mvbs_partials_closed", spy)
    et.run_survey_mvbs_from_raw([raw_files["ragged"], raw_files["jitter"]], device="cpu",
                                range_bin="7m", ping_time_bin="15s", chunk_pings=20)
    assert seen == ["K1", "K1", "K1", "K2", "K2"]


@pytest.mark.parametrize("pad", ["full_chunk", "mesh"])
def test_padded_pings_park_past_the_window(raw_files, monkeypatch, pad):
    """Padded pings carry x bin ``window``, past every bin of their chunk:
    the power streamer's pad to a full chunk (K1/K2's x_rel), and the pad
    that splits a Sv chunk over a mesh's ping shards.  Their data is NaN or
    of valid length 0, so the bins alone cannot show where they park."""
    seen = []
    name, x_pos = (("sharded_mvbs_partials_closed", 6) if pad == "full_chunk"
                   else ("sharded_binned_partials", 3))
    real = getattr(ts, name)

    def spy(mesh, window, *a, **k):
        step = real(mesh, window, *a, **k)

        def run(*args):
            seen.append((np.asarray(args[x_pos]), window))
            return step(*args)
        return run

    monkeypatch.setattr(ts, name, spy)
    kw = dict(range_bin="7m", ping_time_bin="15s", chunk_pings=13, device="cpu")
    if pad == "full_chunk":
        et.run_survey_mvbs_from_raw([raw_files["ragged"], raw_files["skip"]], **kw)
    else:  # 4 ping shards: chunks of 16, the last 9 pings padded to 12
        sv = et.calibrate.compute_Sv(et.open_raw(raw_files["ragged"], sonar_model="EK60"),
                                     device="cpu")
        et.run_survey_mvbs([sv], mesh=et.parallel.make_mesh(devices=["cpu"] * 4), **kw)
    parked = []
    for x_rel, window in seen:
        n_real = int((x_rel < window).sum())
        assert (x_rel[:n_real] >= 0).all() and (x_rel[n_real:] == window).all()
        parked.append(len(x_rel) - n_real)
    # ragged's 41 pings and skip's 37 in chunks of 13; ragged's in 16, 16, 9 + 3
    assert parked == ([0, 0, 0, 11, 0, 0, 2] if pad == "full_chunk" else [0, 0, 3])


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


@pytest.fixture(scope="module")
def option_files(tmp_path_factory):
    """An EK80 file (two FM channels, a CW complex and a GPT power channel),
    a two-channel AZFP file with its XML and an AZFP6 file."""
    d = tmp_path_factory.mktemp("torch_survey_options")
    ek80, xml = d / "MX-D20210201-T000000.raw", d / "instrument.XML"
    azfp, azfp6 = d / "21031510.01A", d / "22070112.azfp"
    write_ek80_raw(ek80, n_pings=10, n_samples=96, seed=3, extra_fm_channel=True)
    write_azfp_xml(xml)
    write_azfp_raw(azfp, n_pings=9, seed=1)
    write_azfp6_raw(azfp6, n_pings=12, num_bins=50)
    ed = et.open_raw(str(ek80), sonar_model="EK80")
    bb = [str(c) for c in ed[retrieve_correct_beam_group(ed, "BB", "complex")]
          .coords["channel"].values]
    return {"ek80": str(ek80), "azfp": str(azfp), "azfp6": str(azfp6), "xml": str(xml),
            "bb_eq": f'"{bb[0]}" - "{bb[1]}" > 3.0dB'}


_BB = dict(sonar_model="EK80", waveform_mode="BB", encode_mode="complex", range_bin="2m")
_AZFP_ENV = {"salinity": 32.0, "pressure": 60.0}


@pytest.mark.parametrize(
    "file, kw, channel_axis",
    [("ragged", {}, 2), ("ragged", dict(freq_diff="38kHz - 18kHz > 3dB"), 1),
     ("ragged", dict(workers=2), 2),
     ("ragged", dict(noise_masks={"impulse": {"range_var": "echo_range"}}, workers=2), 2),
     ("ek80", dict(_BB, freq_diff="bb_eq", workers=2), 1),
     ("ek80", dict(_BB, device_fused=True), 1),
     ("ek80", dict(sonar_model="ES80", waveform_mode="CW", encode_mode="power",
                   noise_masks={"transient": {"range_var": "echo_range"}}), 1),
     ("azfp", dict(sonar_model="AZFP", xml_path="xml", env_params=_AZFP_ENV), 2),
     ("azfp6", dict(sonar_model="AZFP6", workers=2, env_params=_AZFP_ENV), 1)],
    ids=["mesh", "freq_diff", "workers", "noise_masks", "complex_freq_diff",
         "device_fused_mesh", "es80_noise_masks", "azfp", "azfp6"],
)
def test_unported_options_raise(raw_files, option_files, monkeypatch, file, kw, channel_axis):
    """``mesh`` with each of the other options: an 8-block CPU mesh (ping x
    channel; channel axis 1 where a frequency-differencing mask or one
    channel needs it) gives the one-device bins within 1e-4 dB (the JAX
    tests' mesh tolerance, tests/test_survey.py:383-389) with identical NaN
    masks and coordinates; ``device_fused`` with a mesh warns and takes the
    chunked complex path; a mesh that is not the port's raises TypeError."""
    paths = {**raw_files, **option_files}
    kw = {k: paths.get(v, v) if isinstance(v, str) else v for k, v in kw.items()}
    files = [paths[file]]
    with pytest.raises(TypeError, match="echopype_torch.parallel.make_mesh"):
        et.run_survey_mvbs_from_raw(files, mesh=object(), device="cpu", **kw)
    mesh = et.parallel.make_mesh(devices=["cpu"] * 8, channel_axis=channel_axis)
    warned = []
    monkeypatch.setattr(ts.logger, "warning", warned.append)
    got = et.run_survey_mvbs_from_raw(files, mesh=mesh, device="cpu", **kw)
    if kw.get("device_fused"):
        assert any("no mesh path" in w for w in warned)
        kw = dict(kw, device_fused=False)  # the chunked path is the one-device twin
    _assert_mvbs_close(got, et.run_survey_mvbs_from_raw(files, device="cpu", **kw))


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
    @pytest.mark.parametrize("freq", ["20s", "1min", "0.5min", "2h", "7s", "250ms", "1D", "2D"])
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

    @pytest.mark.parametrize("freq", ["1B", "1W", "MS", "20 parsecs", "0.3ns"])
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
