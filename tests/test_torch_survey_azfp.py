"""Port parity: the AZFP / AZFP6 legs of ``run_survey_mvbs_from_raw``.

AZFP power ships to the device as NaN-padded float32 dB and every chunk runs
K2's float32 instance with the echo_range intercept ``r0`` (its plain twin
here, on the CPU).  Held to the JAX package's streamer (tests/test_survey.py
:245-284, 340-353) within 1e-4 dB with identical NaN masks and coordinates,
and to the port's own compute_Sv -> compute_MVBS within the JAX test's rtol
2e-3 / atol 5e-2; the ``freq_diff=`` and ``noise_masks=`` legs against the
JAX package's.
"""

import numpy as np
import pytest
import torch

import echopype_torch as et
from echopype_torch.ops import window_partials as wp
from echopype_torch.parallel import survey as ts
from echopype_torch.utils.profiling import StageTimer
from echopype_tpu.parallel import make_mesh as jax_mesh
from echopype_tpu.parallel import run_survey_mvbs_from_raw as jax_survey

import chip_smoke
from synth_azfp import write_azfp_raw, write_azfp_xml
from test_azfp6 import write_azfp6_raw

torch.set_num_threads(1)

ENV = {"salinity": 32.0, "pressure": 60.0}  # tests/test_survey.py:258
ATOL_DB = 1e-4
MASKS = {"impulse": {"range_var": "echo_range"}, "transient": {"range_var": "echo_range"},
         "attenuated": {"range_var": "echo_range"}}


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("survey_azfp")
    xml, xml4 = d / "instrument.XML", d / "four.XML"
    write_azfp_xml(xml)
    chip_smoke.write_azfp_xml4(xml4)
    out = {"xml": str(xml), "xml4": str(xml4)}
    for m in range(3):  # three files a minute apart
        p = d / f"2103151{m}.01A"
        write_azfp_raw(p, n_pings=9, seed=m, minute=m)
        out[f"two_ch_{m}"] = str(p)
    for h in range(2):  # four ragged channels, consecutive hours
        p = d / f"2103152{h}.01A"
        chip_smoke.write_azfp_raw4(p, hour=20 + h, seed=10 + h, n_pings=40,
                                   num_bins=(60, 60, 48, 36))
        out[f"four_ch_{h}"] = str(p)
    p = d / "22070112.azfp"
    write_azfp6_raw(p, n_pings=12, num_bins=50)
    out["azfp6"] = str(p)
    return out


def _pair(raws, sonar_model, **kw):
    """(port on the CPU, JAX package) of one survey call."""
    got = et.run_survey_mvbs_from_raw(raws, sonar_model=sonar_model, env_params=ENV,
                                      device="cpu", **kw)
    want = jax_survey(raws, sonar_model=sonar_model, env_params=ENV, **kw)
    return got, want


def _assert_close(got, want):
    g, w = np.asarray(got["Sv"].values, "f8"), np.asarray(want["Sv"].values, "f8")
    assert g.shape == w.shape
    np.testing.assert_array_equal(np.isnan(g), np.isnan(w))
    np.testing.assert_allclose(g, w, atol=ATOL_DB, rtol=0, equal_nan=True)
    for c in ("channel", "ping_time", "echo_range"):
        np.testing.assert_array_equal(np.asarray(got.coords[c].values),
                                      np.asarray(want.coords[c].values))
    assert np.isfinite(g).any()


CASES = {
    "one_file": (["two_ch_0"], "xml", dict(range_bin="2m", ping_time_bin="5s", chunk_pings=4)),
    "three_files": (["two_ch_0", "two_ch_1", "two_ch_2"], "xml",
                    dict(range_bin="1.5m", ping_time_bin="20s", chunk_pings=5)),
    "one_chunk": (["two_ch_1"], "xml", dict(range_bin="3m", ping_time_bin="2s",
                                            chunk_pings=5000)),
    "four_ragged": (["four_ch_0", "four_ch_1"], "xml4",
                    dict(range_bin="1m", ping_time_bin="10s", chunk_pings=16)),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_azfp_matches_jax_streamer(files, case):
    names, xml, kw = CASES[case]
    wp.reset_launches()
    got, want = _pair([files[n] for n in names], "AZFP", xml_path=files[xml], **kw)
    assert not any(wp.LAUNCHES.values())
    assert got.attrs["device"] == "cpu"
    _assert_close(got, want)


def test_azfp6_matches_jax_streamer(files):
    got, want = _pair([files["azfp6"]], "AZFP6", range_bin="2m", ping_time_bin="5s",
                      chunk_pings=5)
    _assert_close(got, want)


def test_every_chunk_takes_the_float32_k2_step(files, monkeypatch):
    """Float32 power and the intercept reach K2's twin, never K1's; the
    staging and device stages carry their own names."""
    seen = []
    real = ts.sharded_mvbs_partials_closed

    def spy(mesh, *a, uniform=False, **k):
        if uniform:
            pytest.fail("K1 on an AZFP chunk")
        step = real(mesh, *a, **k)

        def k2(*args):  # power, dr, tvg_shift, absorption, offset, valid_len, x_rel, r_edges, r0
            seen.append((args[0].dtype, args[0].shape, bool(np.all(args[8][:, 0] > 0))))
            return step(*args)

        return k2

    monkeypatch.setattr(ts, "sharded_mvbs_partials_closed", spy)
    timer = StageTimer()
    et.run_survey_mvbs_from_raw([files["four_ch_0"]], sonar_model="AZFP",
                                xml_path=files["xml4"], env_params=ENV, range_bin="2m",
                                ping_time_bin="10s", chunk_pings=16, timer=timer, device="cpu")
    assert [s[0] for s in seen] == [np.float32] * 3  # 40 pings in chunks of 16
    assert all(s[1] == (4, 16, 60) for s in seen) and all(s[2] for s in seen)
    report = timer.report(log=False)
    assert report["device_mvbs_f32"]["count"] == 3 and report["pad_float32"]["count"] == 3
    assert "to_int16" not in report and "device_mvbs" not in report


def test_matches_composed_chain(files):
    """tests/test_survey.py:245-284 in the port: the streamer against
    compute_Sv -> compute_MVBS on the same bins."""
    raw, xml = files["four_ch_0"], files["xml4"]
    kw = dict(range_bin="2m", ping_time_bin="10s")
    got = et.run_survey_mvbs_from_raw([raw], sonar_model="AZFP", xml_path=xml, env_params=ENV,
                                      chunk_pings=16, device="cpu", **kw)
    sv = et.calibrate.compute_Sv(et.open_raw(raw, sonar_model="AZFP", xml_path=xml),
                                 env_params=ENV, device="cpu")
    want = et.compute_MVBS(sv, device="cpu", **kw)
    g, w = np.asarray(got["Sv"].values), np.asarray(want["Sv"].values)
    nx, nr = min(g.shape[1], w.shape[1]), min(g.shape[2], w.shape[2])
    np.testing.assert_allclose(g[:, :nx, :nr], w[:, :nx, :nr], rtol=2e-3, atol=5e-2)


def test_chunking_leaves_bins_in_place(files):
    raws = [files["four_ch_0"], files["four_ch_1"]]
    kw = dict(sonar_model="AZFP", xml_path=files["xml4"], env_params=ENV, range_bin="1m",
              ping_time_bin="10s", device="cpu")
    a = et.run_survey_mvbs_from_raw(raws, chunk_pings=7, **kw)
    b = et.run_survey_mvbs_from_raw(raws, chunk_pings=5000, **kw)
    np.testing.assert_array_equal(np.isnan(a["Sv"].values), np.isnan(b["Sv"].values))
    np.testing.assert_allclose(a["Sv"].values, b["Sv"].values, atol=ATOL_DB, equal_nan=True)


@pytest.mark.parametrize("eq", ["125kHz - 38kHz > 3.0dB", "38kHz - 125kHz <= 1.0dB"])
def test_freq_diff_matches_jax(files, eq):
    raws = [files["two_ch_0"], files["two_ch_1"]]
    got, want = _pair(raws, "AZFP", xml_path=files["xml"], range_bin="2m",
                      ping_time_bin="20s", chunk_pings=5, freq_diff=eq)
    _assert_close(got, want)


def test_freq_diff_four_channels_matches_jax(files):
    got, want = _pair([files["four_ch_0"]], "AZFP", xml_path=files["xml4"], range_bin="1m",
                      ping_time_bin="10s", chunk_pings=16,
                      freq_diff=chip_smoke.AZFP_FD_EQ)
    _assert_close(got, want)


@pytest.mark.parametrize("names, xml", [(["two_ch_0", "two_ch_1"], "xml"),
                                        (["four_ch_0"], "xml4")], ids=["two_ch", "four_ch"])
def test_noise_masks_match_jax(files, names, xml):
    got, want = _pair([files[n] for n in names], "AZFP", xml_path=files[xml], range_bin="2m",
                      ping_time_bin="20s", noise_masks=MASKS)
    _assert_close(got, want)


def test_options_still_refused(files):
    """``mesh=`` on the AZFP leg: a mesh that is not the port's raises
    TypeError; on the port's 8-block CPU mesh (ping 4 x channel 2; chunks of
    5 round up to 8, so a file's last chunk has parked ping blocks) the
    survey equals ``mesh=None`` and the JAX streamer on its 8-device mesh
    within 1e-4 dB, ``workers`` given or not."""
    kw = dict(sonar_model="AZFP", xml_path=files["xml"], env_params=ENV, device="cpu")
    with pytest.raises(TypeError, match="make_mesh"):
        et.run_survey_mvbs_from_raw([files["two_ch_0"]], mesh=object(), **kw)
    grid = dict(range_bin="2m", ping_time_bin="5s", chunk_pings=5)
    mesh = et.parallel.make_mesh(devices=["cpu"] * 8, channel_axis=2)
    raws = [files["two_ch_0"], files["two_ch_1"]]
    got = et.run_survey_mvbs_from_raw(raws, mesh=mesh, **grid, **kw)
    _assert_close(got, et.run_survey_mvbs_from_raw(raws, **grid, **kw))
    kw.pop("device")
    _assert_close(got, jax_survey(raws, mesh=jax_mesh(n_devices=8, channel_axis=2), **grid, **kw))
    one = [files["two_ch_0"]]
    _assert_close(et.run_survey_mvbs_from_raw(one, workers=2, mesh=mesh, device="cpu", **grid,
                                              **kw),
                  et.run_survey_mvbs_from_raw(one, device="cpu", **grid, **kw))


def test_missing_salinity_raises(files):
    with pytest.raises(ValueError, match="salinity"):
        et.run_survey_mvbs_from_raw([files["two_ch_0"]], sonar_model="AZFP",
                                    xml_path=files["xml"], device="cpu")


@pytest.mark.parametrize("model", ["AD2CP", "EK99"])
def test_other_models_raise(model):
    with pytest.raises(ValueError, match="power mode"):
        et.run_survey_mvbs_from_raw([], sonar_model=model, device="cpu")
