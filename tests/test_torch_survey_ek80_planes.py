"""The fused complex survey stages its samples from the parser's float32
planes: ``run_survey_mvbs_from_raw(..., device_fused=True)`` opens each file
through ``convert.api._open_raw_unfilled``, whose complex groups carry no
float64 ``backscatter_r`` / ``_i``, and ``_ComplexChunkStage`` writes each
(channel, chunk) from the group's ``ComplexLayout``.

* The MVBS is bit for bit the same call's with every group filled first
  (``open_raw``'s float64 groups, staged from their own samples), on the
  broadband and CW files, the two-epoch files, and with ``freq_diff``,
  also where multi-``filter_time`` files send the call to the chunked
  path, which fills the groups before ``compute_Sv``; and with
  ``use_swap=True``, which fills and spills as ``open_raw`` does.
* Counters of a traced window: the fused route widens nothing
  (``complex_widened_pings`` absent) and stages channels x pings from the
  planes (``bb_plane_pings``); the chunked route and ``open_raw`` widen.
* The swap decision is taken on the bytes of the filled tree.

All on the CPU (``device="cpu"``), against the port alone.
"""

import numpy as np
import pytest

import echopype_torch as et
from echopype_torch.convert import api as tapi
from echopype_torch.parallel import survey as ts
from echopype_torch.utils.profiling import TRACED, trace

from synth_ek80 import write_ek80_raw
from test_ek80_epochs import write_two_epoch_ek80
from test_survey_epochs import write_two_epoch_bb

T0 = np.datetime64("2021-02-01T00:00:00", "ns")


@pytest.fixture(scope="module")
def raw(tmp_path_factory):
    d = tmp_path_factory.mktemp("survey_ek80_planes")
    out = {"bb": [], "mixed": [], "two_fm": []}
    for i in range(2):
        t0 = T0 + np.timedelta64(12 * i, "s")
        for name, kw in (("bb", dict(with_cw_complex=False)),
                         ("mixed", dict(with_power_channel=True)),
                         ("two_fm", dict(extra_fm_channel=True))):
            path = str(d / f"{name.upper()}{i}-D20210201-T000000.raw")
            write_ek80_raw(path, n_pings=10, n_samples=96, seed=i, t0=t0,
                           **{"with_power_channel": False, **kw})
            out[name].append(path)
    out["epochs_bb"] = [str(d / "EPBB-D20210301-T000000.raw")]
    write_two_epoch_bb(out["epochs_bb"][0])
    out["epochs_cw"] = [str(d / "EPCW-D20210201-T000000.raw")]
    write_two_epoch_ek80(out["epochs_cw"][0], n_samples=200)
    ed = et.open_raw(out["two_fm"][0], sonar_model="EK80")
    chans = [str(c) for c in ed["Sonar/Beam_group1"].coords["channel"].values]
    out["freq_diff"] = f'"{chans[0]}" - "{chans[1]}" > 3.0dB'
    return out


#: case -> (files, waveform_mode, range bin, freq_diff, multi-epoch fallback)
CASES = {
    "bb": ("bb", "BB", "0.5m", False, False),
    "cw": ("mixed", "CW", "1m", False, False),
    "epochs_bb": ("epochs_bb", "BB", "1m", False, False),
    "epochs_cw": ("epochs_cw", "CW", "1m", False, False),
    "freq_diff": ("two_fm", "BB", "5m", True, False),
    "freq_diff_epochs": ("two_fm", "BB", "5m", True, True),
}


def _run(raw, case, **kw):
    files, wm, rb, fd, _ = CASES[case]
    if fd:
        kw["freq_diff"] = raw["freq_diff"]
    return et.run_survey_mvbs_from_raw(
        raw[files], sonar_model="EK80", waveform_mode=wm, encode_mode="complex", range_bin=rb,
        ping_time_bin="4s", chunk_pings=4, device_fused=True, device="cpu", **kw)


def _filled_first(monkeypatch):
    """The fused route opens every file through ``open_raw``: its groups
    hold their float64 samples."""
    monkeypatch.setattr(
        ts, "_open_raw_unfilled",
        lambda f, sonar_model, xml_path, use_swap: (
            et.open_raw(f, sonar_model=sonar_model, xml_path=xml_path, use_swap=use_swap), {}))


def _assert_same_mvbs(got, want):
    for coord in ("channel", "ping_time", "echo_range"):
        np.testing.assert_array_equal(np.asarray(got.coords[coord].values),
                                      np.asarray(want.coords[coord].values))
    g, w = np.asarray(got["Sv"].values), np.asarray(want["Sv"].values)
    assert np.isfinite(g).any()
    np.testing.assert_array_equal(g, w)  # NaN where NaN
    np.testing.assert_array_equal(g.view("u4" if g.dtype == np.float32 else "u8"),
                                  w.view("u4" if w.dtype == np.float32 else "u8"))


@pytest.mark.parametrize("case", sorted(CASES))
def test_fused_mvbs_equals_the_filled_groups(raw, case, monkeypatch, tmp_path):
    """From the planes, the MVBS of the filled groups bit for bit; the
    fallback to the chunked path fills each group first (a warning says
    the call left the fused path)."""
    if CASES[case][4]:
        monkeypatch.setattr(ts, "_n_filter_times", lambda ed: 2)
        warned = []
        monkeypatch.setattr(ts.logger, "warning", warned.append)
    with trace(str(tmp_path)):
        got = _run(raw, case)
    planes, widened = (TRACED.counters.get(k) for k in ("bb_plane_pings",
                                                         "complex_widened_pings"))
    if CASES[case][4]:
        assert any("chunked compute_Sv path" in w for w in warned)
        assert planes is None and widened > 0
    else:
        assert planes > 0 and widened is None
    _filled_first(monkeypatch)
    _assert_same_mvbs(got, _run(raw, case))


@pytest.mark.parametrize("case", ["bb", "cw", "freq_diff"])
def test_fused_window_counts_plane_pings_and_widens_nothing(raw, case, tmp_path):
    files, wm, _, _, _ = CASES[case]
    n_ch, n_ping = 0, 0
    for f in raw[files]:
        ed = et.open_raw(f, sonar_model="EK80")
        beam = ed[et.echodata.simrad.retrieve_correct_beam_group(ed, wm, "complex")]
        n_ch = beam.sizes["channel"]
        n_ping += beam.sizes["ping_time"]
    with trace(str(tmp_path)):
        _run(raw, case)
    assert "complex_widened_pings" not in TRACED.counters
    assert TRACED.counters["bb_plane_pings"] == n_ch * n_ping > 0


def test_chunked_route_and_open_raw_widen(raw, tmp_path):
    with trace(str(tmp_path / "chunked")):
        et.run_survey_mvbs_from_raw(raw["bb"], sonar_model="EK80", waveform_mode="BB",
                                    encode_mode="complex", range_bin="0.5m",
                                    ping_time_bin="4s", chunk_pings=4, device="cpu")
    assert TRACED.counters["complex_widened_pings"] == 20  # one channel, 2 x 10 pings
    assert "bb_plane_pings" not in TRACED.counters
    with trace(str(tmp_path / "open_raw")):
        ed = et.open_raw(raw["mixed"][0], sonar_model="EK80")
    groups = [ed[p] for p in ed.group_paths
              if p.startswith("Sonar/Beam_group") and "backscatter_i" in ed[p]]
    assert len(groups) == 2  # the FM and the CW complex groups
    assert TRACED.counters["complex_widened_pings"] == sum(
        g.sizes["channel"] * g.sizes["ping_time"] for g in groups)


def test_use_swap_fills_and_spills_as_open_raw(raw, monkeypatch, tmp_path):
    with trace(str(tmp_path)):
        got = _run(raw, "bb", use_swap=True)
    assert TRACED.counters["complex_widened_pings"] == 20
    assert "bb_plane_pings" not in TRACED.counters
    ed, layouts = tapi._open_raw_unfilled(raw["bb"][0], "EK80", use_swap=True)
    assert layouts == {}
    assert any("backscatter_r" in f.name for f in ed.swap_files)
    ed.cleanup_swap_files()
    _filled_first(monkeypatch)
    _assert_same_mvbs(got, _run(raw, "bb", use_swap=True))


def test_swap_is_decided_on_the_bytes_of_the_filled_tree(raw, monkeypatch):
    seen = []
    real = tapi._should_swap

    def spy(use_swap, ed, unfilled_bytes=0):
        seen.append(ed.nbytes + unfilled_bytes)
        return real(use_swap, ed, unfilled_bytes)

    monkeypatch.setattr(tapi, "_should_swap", spy)
    for f in (raw["mixed"][0], raw["two_fm"][0]):
        seen.clear()
        et.open_raw(f, sonar_model="EK80")
        _, layouts = tapi._open_raw_unfilled(f, "EK80")
        assert len(seen) == 2 and seen[0] == seen[1] and len(layouts) >= 1
