"""Port parity: the masking options of the survey streamers.

The cases of tests/test_survey_freqdiff.py and tests/test_survey_clean.py
(mesh cases aside) through ``echopype_torch``'s streamers (device="cpu":
the same torch ops the card runs), held to the JAX streamers and to the
JAX package's composed chains (compute_Sv -> frequency_differencing /
clean.mask_* -> apply_mask -> binning) under those files' tolerances:
1e-5 dB between streamers and against the composed Sv-store chain, 2e-4 dB
against the unfused raw chain (its float32 echo_range bins knife-edge
samples), 5e-3 dB fused against chunked broadband (0.2 dB in the last range
bin).  Within the port the fused noise-mask stream equals its composed
chain exactly, as in the JAX tests.
"""

import numpy as np
import pytest
import torch

import echopype_torch as et
import echopype_tpu as ep
from echopype_torch.ops import window_partials as wp
from echopype_torch.parallel import pipeline as tp
from echopype_torch.parallel import survey as ts
from echopype_torch.xrlite import Dataset as TDataset
from echopype_tpu.parallel import survey as js

from synth_ek60 import write_ek60_raw
from synth_ek80 import write_ek80_raw
from test_ref_commongrid import make_nasc_ds
from test_torch_commongrid import as_package

torch.set_num_threads(1)

ATOL = 1e-5
MASK_SPEC = {
    "impulse": dict(depth_bin="4m", num_side_pings=2, impulse_noise_threshold="10.0dB",
                    range_var="depth"),
    "transient": dict(func="nanmean", depth_bin="6m", num_side_pings=3, exclude_above="3.0m",
                      transient_noise_threshold="8.0dB", range_var="depth"),
    "attenuated": dict(upper_limit_sl="10.0m", lower_limit_sl="30.0m", num_side_pings=3,
                       attenuation_signal_threshold="5.0dB", range_var="depth"),
}
RAW_SPEC = {
    "impulse": dict(depth_bin="4m", num_side_pings=2, impulse_noise_threshold="10.0dB",
                    range_var="echo_range"),
    "attenuated": dict(upper_limit_sl="10.0m", lower_limit_sl="30.0m", num_side_pings=3,
                       attenuation_signal_threshold="5.0dB", range_var="echo_range"),
}


def _close(got, want, atol=ATOL, var="Sv"):
    g, w = np.asarray(got[var].values, dtype="f8"), np.asarray(want[var].values, dtype="f8")
    assert g.shape == w.shape
    np.testing.assert_array_equal(np.isnan(g), np.isnan(w))
    assert np.isfinite(g).any()
    np.testing.assert_allclose(g, w, rtol=0, atol=atol, equal_nan=True)


# ------------------------------------------------------------ noise masks
def _survey_files(n_files=2, n_ping=36, n_ch=2, n_r=30):
    """tests/test_survey_clean.py::_survey_files (JAX Datasets)."""
    files = []
    for i in range(n_files):
        ds = make_nasc_ds(n_ch=n_ch, n_ping=n_ping, n_r=n_r, seed=50 + i)
        pt = np.asarray(ds.coords["ping_time"].values) + np.timedelta64(i * (n_ping + 5), "s")
        ds.coords["ping_time"].values = pt
        sv = np.asarray(ds["Sv"].values)
        sv[0, 7 + i, :] += 30.0  # impulse ping
        sv[1, 14:17, 10:] += 20.0  # transient blob
        sv[0, 20:24, 5:15] -= 25.0  # attenuated run
        files.append(ds)
    return files


def _ported(files):
    return [as_package(ds, TDataset) for ds in files]


def _masked_copy(pkg, ds, spec, **kw):
    """The composed chain: OR of the clean masks -> NaN, in package ``pkg``."""
    fns = {"impulse": pkg.clean.mask_impulse_noise,
           "transient": pkg.clean.mask_transient_noise,
           "attenuated": pkg.clean.mask_attenuated_signal}
    flagged = None
    for kind, params in spec.items():
        m = np.asarray(fns[kind](ds, **params, **kw).values, dtype=bool)
        flagged = m if flagged is None else (flagged | m)
    out = ds.copy()
    out["Sv"] = (ds["Sv"].dims, np.where(flagged, np.nan, np.asarray(ds["Sv"].values)))
    return out


class TestNoiseMaskedMVBS:
    KW = dict(range_bin_m=5.0, ping_time_bin="6s")

    def test_fused_equals_composed(self):
        files = _survey_files()
        got = et.run_survey_mvbs(_ported(files), noise_masks=MASK_SPEC, device="cpu", **self.KW)
        composed = et.run_survey_mvbs([_masked_copy(et, d, MASK_SPEC, device="cpu")
                                       for d in _ported(files)], device="cpu", **self.KW)
        g = np.asarray(got["Sv"].values)
        assert np.isnan(g).sum() > 0
        np.testing.assert_array_equal(g, np.asarray(composed["Sv"].values))
        _close(got, js.run_survey_mvbs(files, noise_masks=MASK_SPEC, **self.KW))
        _close(got, js.run_survey_mvbs([_masked_copy(ep, d, MASK_SPEC) for d in files],
                                       **self.KW))
        assert "noise_masks" in got.attrs["stage_timing"]

    def test_masks_change_result(self):
        files = _ported(_survey_files())
        plain = et.run_survey_mvbs(files, device="cpu", **self.KW)
        fused = et.run_survey_mvbs(files, noise_masks=MASK_SPEC, device="cpu", **self.KW)
        assert not np.array_equal(np.asarray(plain["Sv"].values), np.asarray(fused["Sv"].values),
                                  equal_nan=True)

    def test_unknown_mask_kind_raises(self):
        with pytest.raises(ValueError, match="unknown noise mask"):
            et.run_survey_mvbs(_ported(_survey_files(n_files=1)), noise_masks={"bogus": {}},
                               device="cpu")


class TestNoiseMaskedNASC:
    def test_fused_equals_composed(self):
        files = _survey_files()
        kw = dict(range_bin="5m", dist_bin="0.05nmi")
        got = et.run_survey_nasc(_ported(files), noise_masks=MASK_SPEC, device="cpu", **kw)
        composed = et.run_survey_nasc([_masked_copy(et, d, MASK_SPEC, device="cpu")
                                       for d in _ported(files)], device="cpu", **kw)
        g, c = np.asarray(got["NASC"].values), np.asarray(composed["NASC"].values)
        np.testing.assert_array_equal(np.isnan(g), np.isnan(c))
        np.testing.assert_array_equal(g[~np.isnan(g)], c[~np.isnan(c)])
        want = js.run_survey_nasc(files, noise_masks=MASK_SPEC, **kw)
        w = np.asarray(want["NASC"].values)
        np.testing.assert_array_equal(np.isnan(g), np.isnan(w))
        np.testing.assert_allclose(g, w, rtol=1e-5, equal_nan=True)
        plain = et.run_survey_nasc(_ported(files), device="cpu", **kw)
        assert not np.array_equal(np.asarray(plain["NASC"].values), g, equal_nan=True)


@pytest.fixture(scope="module")
def ek60_pair(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("nm_raw")
    t0 = np.datetime64("2020-01-01T00:00:00", "ns")
    files = []
    for i in range(2):
        raw = tmp / f"NM{i}-D20200101-T000000.raw"
        write_ek60_raw(raw, n_pings=24, n_samples=60, seed=10 + i,
                       t0=t0 + np.timedelta64(30 * i, "s"))
        files.append(str(raw))
    return files


class TestFromRawNoiseMasks:
    KW = dict(range_bin_m=5.0, ping_time_bin="10s", chunk_pings=8)

    def test_from_raw_equals_composed(self, ek60_pair):
        got = et.run_survey_mvbs_from_raw(ek60_pair, sonar_model="EK60", noise_masks=RAW_SPEC,
                                          device="cpu", **self.KW)
        sv_files = [ep.calibrate.compute_Sv(ep.open_raw(f, sonar_model="EK60"))
                    for f in ek60_pair]
        composed = js.run_survey_mvbs([_masked_copy(ep, d, RAW_SPEC) for d in sv_files],
                                      **self.KW)
        _close(got, composed)
        _close(got, js.run_survey_mvbs_from_raw(ek60_pair, sonar_model="EK60",
                                                noise_masks=RAW_SPEC, **self.KW))

    def test_from_raw_masks_change_result(self, ek60_pair):
        kw = dict(sonar_model="EK60", device="cpu", **self.KW)
        plain = et.run_survey_mvbs_from_raw(ek60_pair[:1], **kw)
        masked = et.run_survey_mvbs_from_raw(ek60_pair[:1], noise_masks=RAW_SPEC, **kw)
        a, b = np.asarray(plain["Sv"].values), np.asarray(masked["Sv"].values)
        assert a.shape == b.shape
        assert not np.array_equal(np.nan_to_num(a), np.nan_to_num(b))


# --------------------------------------------------- frequency differencing
@pytest.fixture(scope="module")
def ek60_file(tmp_path_factory):
    path = tmp_path_factory.mktemp("fd_survey") / "FD-D20200101-T000000.raw"
    write_ek60_raw(path, n_pings=40, n_samples=120)
    return str(path)


class TestFreqDiffPower:
    def test_from_raw_matches_unfused_chain(self, ek60_file):
        ed = ep.open_raw(ek60_file, sonar_model="EK60")
        chans = [str(c) for c in ed["Sonar/Beam_group1"].coords["channel"].values]
        eq = f'"{chans[0]}" - "{chans[1]}" > 3.0dB'
        ds = ep.calibrate.compute_Sv(ed, precision="float32")
        masked = ep.mask.apply_mask(ds, ep.mask.frequency_differencing(ds, chanABEq=eq))
        want = ep.commongrid.compute_MVBS(masked, range_bin="21.3m", ping_time_bin="5s")
        tp.LAUNCHES["freqdiff_step"] = 0
        wp.reset_launches()
        got = et.run_survey_mvbs_from_raw([ek60_file], sonar_model="EK60", range_bin_m=21.3,
                                          ping_time_bin="5s", chunk_pings=16, freq_diff=eq,
                                          device="cpu")
        assert not any(wp.LAUNCHES.values())
        gv = np.asarray(got["Sv"].values)
        wv = want["Sv"].transpose("channel", "ping_time", "echo_range").values
        nb, nr = min(gv.shape[1], wv.shape[1]), min(gv.shape[2], wv.shape[2])
        g, w = gv[:, :nb, :nr], wv[:, :nb, :nr]
        np.testing.assert_array_equal(np.isnan(g), np.isnan(w))
        assert np.nanmax(np.abs(g - w)) < 2e-4
        # the JAX step scales int16 power by a float32 constant one ulp above
        # float32(INDEX2POWER), the one compute_Sv and the port use
        _close(got, js.run_survey_mvbs_from_raw([ek60_file], sonar_model="EK60",
                                                range_bin_m=21.3, ping_time_bin="5s",
                                                chunk_pings=16, freq_diff=eq), atol=1e-4)

    def test_freq_equation_form(self, ek60_file):
        kw = dict(sonar_model="EK60", range_bin_m=20.0, ping_time_bin="5s")
        got = et.run_survey_mvbs_from_raw([ek60_file], freq_diff="38kHz - 18kHz > 3.0dB",
                                          device="cpu", **kw)
        byname = et.run_survey_mvbs_from_raw(
            [ek60_file], device="cpu",
            freq_diff={"freqA": 38000.0, "freqB": 18000.0, "operator": ">", "diff": 3.0}, **kw)
        np.testing.assert_array_equal(got["Sv"].values, byname["Sv"].values)
        _close(got, js.run_survey_mvbs_from_raw([ek60_file], freq_diff="38kHz - 18kHz > 3.0dB",
                                                **kw), atol=1e-4)

    def test_eager_path_and_step_per_chunk(self, ek60_file, monkeypatch):
        seen = []
        real = ts.sharded_mvbs_partials_freqdiff
        monkeypatch.setattr(ts, "sharded_mvbs_partials_freqdiff",
                            lambda *a, **k: seen.append(1) or real(*a, **k))
        monkeypatch.setattr(ts, "_plan_from_scan", lambda *a, **k: pytest.fail("streamed"))
        et.run_survey_mvbs_from_raw([ek60_file, ek60_file], sonar_model="EK60",
                                    range_bin="20m", ping_time_bin="500s", chunk_pings=16,
                                    freq_diff="38kHz - 18kHz > 3.0dB", device="cpu")
        assert len(seen) == 6  # 40 pings in chunks of 16, two files

    def test_quiet_bin_no_cancellation(self):
        """A quiet range bin after loud samples keeps full precision, in the
        masked raw step (each bin sums only its own samples) and in the
        masked Sv-store stream."""
        C, P, R = 2, 8, 64
        power = np.full((C, P, R), -20.0, dtype="f4")
        power[:, :, R // 2:] = -150.0
        power[1] -= 10.0  # channel 0 - channel 1 = 10 dB > 3 dB: everything kept
        dr = np.full((C, P), 1.0, dtype="f4")
        zeros = np.zeros((C, P), dtype="f4")
        s, c = tp.sv_mvbs_window_partials_freqdiff(
            power, dr, zeros, zeros, zeros, np.full((C, P), R), np.zeros(P, dtype="i4"),
            np.array([0.0, 32.0, 64.0], dtype="f4"), 1, 2, 0, 1, ">", 3.0, device="cpu")
        k = np.arange(R, dtype="f8")
        sv = power.astype("f8") + 20.0 * np.log10(np.where(k > 0, k, 1.0))
        lin = np.where(k > 0, 10.0 ** (sv / 10.0), 0.0)
        want = np.stack([lin[:, :, :32].sum(axis=(1, 2)), lin[:, :, 32:].sum(axis=(1, 2))], 1)
        np.testing.assert_allclose(s.numpy()[:, 0], want, rtol=1e-6)
        np.testing.assert_array_equal(c.numpy()[:, 0], [[P * 31, P * 32]] * C)

        sv_db = np.stack([np.where(np.arange(R) < R // 2, -20.0, -150.0)] * P)[None]
        sv_db = np.concatenate([sv_db, sv_db - 10.0]).astype("f4")
        ds = TDataset(
            {"Sv": (("channel", "ping_time", "range_sample"), sv_db),
             "echo_range": (("channel", "ping_time", "range_sample"),
                            np.broadcast_to(np.arange(R) * 1.0, (C, P, R)).copy())},
            coords={"channel": np.array(["a", "b"], dtype=object),
                    "ping_time": np.datetime64("2022-01-01", "ns")
                    + np.arange(P).astype("timedelta64[s]").astype("timedelta64[ns]"),
                    "range_sample": np.arange(R)})
        mv = et.run_survey_mvbs([ds], range_bin="32m", ping_time_bin="100s",
                                freq_diff='"a" - "b" > 3.0dB', device="cpu")
        np.testing.assert_allclose(mv["Sv"].values[:, 0], [[-20.0, -150.0], [-30.0, -160.0]],
                                   atol=1e-4)

    def test_sv_store_streamer_freq_diff(self, ek60_file):
        ds = ep.calibrate.compute_Sv(ep.open_raw(ek60_file, sonar_model="EK60"))
        eq = "38kHz - 18kHz > 3.0dB"
        masked = ep.mask.apply_mask(ds, ep.mask.frequency_differencing(ds, freqABEq=eq))
        want = js.run_survey_mvbs([masked], range_bin_m=20.0, ping_time_bin="5s")
        tds = as_package(ds, TDataset)
        for chunk in (16, 5000):
            got = et.run_survey_mvbs([tds], range_bin_m=20.0, ping_time_bin="5s", freq_diff=eq,
                                     chunk_pings=chunk, device="cpu")
            _close(got, want)
        wobbly = as_package(ds, TDataset)  # per-ping route: a grid that varies by ping
        er = np.asarray(wobbly["echo_range"].values) * np.random.default_rng(0).uniform(
            0.98, 1.02, (1, ds.sizes["ping_time"], 1))
        wobbly["echo_range"] = (wobbly["echo_range"].dims, er)
        got = et.run_survey_mvbs([wobbly], range_bin_m=20.0, ping_time_bin="5s", freq_diff=eq,
                                 device="cpu")
        assert got.attrs["routes"] == ["per_ping"]
        tm = et.mask.apply_mask(wobbly, et.mask.frequency_differencing(wobbly, freqABEq=eq))
        _close(got, et.commongrid.compute_MVBS(tm, range_bin="20m", ping_time_bin="5s",
                                               device="cpu"))

    def test_unknown_channel_raises(self, ek60_file):
        with pytest.raises(ValueError, match="not in survey"):
            et.run_survey_mvbs_from_raw([ek60_file], sonar_model="EK60",
                                        freq_diff='"x" - "y" > 3dB', device="cpu")


# ------------------------------------------------ complex / broadband legs
@pytest.fixture(scope="module")
def bb_files(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("fd_bb")
    t0 = np.datetime64("2021-02-01T00:00:00", "ns")
    files = []
    for i in range(2):
        raw = tmp / f"FDBB{i}-D20210201-T000000.raw"
        write_ek80_raw(raw, n_pings=10, n_samples=96, seed=i,
                       t0=t0 + np.timedelta64(12 * i, "s"),
                       with_power_channel=False, extra_fm_channel=True)
        files.append(str(raw))
    ed = ep.open_raw(files[0], sonar_model="EK80")
    from echopype_tpu.echodata.simrad import retrieve_correct_beam_group

    chans = [str(c) for c in ed[retrieve_correct_beam_group(ed, "BB", "complex")]
             .coords["channel"].values]
    return files, f'"{chans[0]}" - "{chans[1]}" > 3.0dB'


class TestFreqDiffComplex:
    KW = dict(sonar_model="EK80", waveform_mode="BB", encode_mode="complex", range_bin_m=5.0,
              ping_time_bin="5s", chunk_pings=4)

    def test_chunked_bb_matches_composed(self, bb_files):
        files, eq = bb_files
        masked = []
        for f in files:
            ds = ep.calibrate.compute_Sv(ep.open_raw(f, sonar_model="EK80"), waveform_mode="BB",
                                         encode_mode="complex", precision="float32")
            masked.append(ep.mask.apply_mask(ds, ep.mask.frequency_differencing(ds,
                                                                                chanABEq=eq)))
        kw = {k: self.KW[k] for k in ("range_bin_m", "ping_time_bin", "chunk_pings")}
        want = js.run_survey_mvbs(masked, **kw)
        got = et.run_survey_mvbs_from_raw(files, freq_diff=eq, device="cpu", **self.KW)
        g, w = np.asarray(got["Sv"].values), np.asarray(want["Sv"].values)
        nb, nr = min(g.shape[1], w.shape[1]), min(g.shape[2], w.shape[2])
        np.testing.assert_allclose(g[:, :nb, :nr], w[:, :nb, :nr], rtol=0, atol=2e-4,
                                   equal_nan=True)
        _close(got, js.run_survey_mvbs_from_raw(files, freq_diff=eq, **self.KW))

    def test_fused_bb_matches_chunked(self, bb_files):
        files, eq = bb_files
        chunked = et.run_survey_mvbs_from_raw(files, freq_diff=eq, device="cpu", **self.KW)
        fused = et.run_survey_mvbs_from_raw(files, freq_diff=eq, device_fused=True,
                                            device="cpu", **self.KW)
        a, b = np.asarray(chunked["Sv"].values), np.asarray(fused["Sv"].values)
        assert a.shape == b.shape
        np.testing.assert_allclose(b[:, :, :-1], a[:, :, :-1], rtol=0, atol=5e-3,
                                   equal_nan=True)
        np.testing.assert_allclose(b[:, :, -1], a[:, :, -1], rtol=0, atol=0.2, equal_nan=True)
        _close(fused, js.run_survey_mvbs_from_raw(files, freq_diff=eq, device_fused=True,
                                                  **self.KW), atol=1e-4)

    def test_mask_changes_bb_result(self, bb_files):
        files, eq = bb_files
        plain = et.run_survey_mvbs_from_raw(files[:1], device="cpu", **self.KW)
        masked = et.run_survey_mvbs_from_raw(files[:1], freq_diff=eq, device="cpu", **self.KW)
        a, b = np.asarray(plain["Sv"].values), np.asarray(masked["Sv"].values)
        assert not np.array_equal(np.nan_to_num(a), np.nan_to_num(b))

    def test_fused_multi_epoch_routes_to_chunked(self, bb_files, monkeypatch):
        """Fused + freq_diff + a multi-filter_time file: the chunked path on
        the whole file's Sv (a warning says so), as the JAX package routes."""
        files, eq = bb_files
        want = et.run_survey_mvbs_from_raw(files, freq_diff=eq, device="cpu", **self.KW)
        monkeypatch.setattr(ts, "_n_filter_times", lambda ed: 2)
        monkeypatch.setattr(ts, "_run_complex_fused", lambda *a, **k: pytest.fail("fused"))
        warned = []
        monkeypatch.setattr(ts.logger, "warning", warned.append)
        got = et.run_survey_mvbs_from_raw(files, freq_diff=eq, device_fused=True, device="cpu",
                                          **self.KW)
        assert any("chunked compute_Sv path" in w for w in warned)
        _close(got, want)
