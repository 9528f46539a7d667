"""Port parity: the EK80 legs of run_survey_mvbs_from_raw, the fused BB
chunk step, and the EK80 slice as a chain.

``echopype_torch`` with ``device="cpu"`` (plain PyTorch: the matched
filter's float32 matmul, the bin sums, K1/K2's plain twins) against
``echopype_tpu`` on the synthetic EK80 files of ``tests/synth_ek80.py``.
Tolerances, NaN masks and coordinates identical in every case:

* power mode (K1/K2's twins) and the complex chunked streamer: within 1e-5
  dB of the JAX streamer (tests/test_survey.py:489);
* the fused streamer (float32 end to end in both packages): within 1e-4
  dB of the JAX fused streamer; fused vs chunked in the port at the JAX
  package's own bounds (tests/test_survey.py:536-538: 5e-3 dB, the last
  range bin 0.2 dB for its knife-edge sample; multi-``filter_time`` files
  2e-3 dB, tests/test_survey_epochs.py:90, and 5e-3 dB for CW, :575);
* ``bb_chunk_window_partials``: counts exact, sums within rtol 1e-4;
  ``bb_chunk_sv``: within 1e-3 dB (the float32 BB budget) and echo_range
  exact;
* ``open_raw`` -> ``compute_Sv`` -> ``compute_MVBS`` through each package:
  within 1e-4 dB.
"""

import numpy as np
import pytest
import torch

import echopype_torch as et
import echopype_tpu as ep
from echopype_torch.convert import api as tapi
from echopype_torch.convert.set_groups_ek80 import ComplexLayout
from echopype_torch.ops import bb_pipeline as tbb
from echopype_torch.ops import window_partials as wp
from echopype_torch.parallel import survey as ts
from echopype_torch.utils.profiling import StageTimer
from echopype_tpu.ops import bb_pipeline as jbb
from echopype_tpu.parallel import run_survey_mvbs_from_raw as run_jax

from synth_ek80 import CH_BB, write_ek80_raw
from test_ek80_epochs import write_two_epoch_ek80
from test_survey_epochs import write_two_epoch_bb
from test_torch_convert_ek80 import MIXES, _write_complex_mix

torch.set_num_threads(1)

T0 = np.datetime64("2021-02-01T00:00:00", "ns")


@pytest.fixture(scope="module")
def raw(tmp_path_factory):
    d = tmp_path_factory.mktemp("survey_ek80")
    out = {"bb": [], "mixed": []}
    for i in range(2):
        path = d / f"BB{i}-D20210201-T000000.raw"
        write_ek80_raw(path, n_pings=10, n_samples=256, seed=i,
                       t0=T0 + np.timedelta64(12 * i, "s"),
                       with_power_channel=False, with_cw_complex=False)
        out["bb"].append(str(path))
        path = d / f"MX{i}-D20210201-T000000.raw"
        write_ek80_raw(path, n_pings=12, n_samples=256, seed=10 + i,
                       t0=T0 + np.timedelta64(15 * i, "s"), skip_pings={
                           "GPT 400142-15 ES38B": {3}} if i else None)
        out["mixed"].append(str(path))
    out["epochs_bb"] = [str(d / "EPBB-D20210301-T000000.raw")]
    write_two_epoch_bb(out["epochs_bb"][0])
    out["epochs_cw"] = [str(d / "EPCW-D20210201-T000000.raw")]
    write_two_epoch_ek80(out["epochs_cw"][0], n_samples=200)
    return out


def _assert_mvbs_close(got, want, atol):
    g, w = np.asarray(got["Sv"].values), np.asarray(want["Sv"].values)
    for coord in ("ping_time", "echo_range"):
        np.testing.assert_array_equal(np.asarray(got.coords[coord].values),
                                      np.asarray(want.coords[coord].values))
    np.testing.assert_array_equal(np.asarray(got.coords["channel"].values, dtype=str),
                                  np.asarray(want.coords["channel"].values, dtype=str))
    np.testing.assert_array_equal(np.isnan(g), np.isnan(w))
    assert np.isfinite(g).any()
    np.testing.assert_allclose(g, w, atol=atol, rtol=0, equal_nan=True)


def _both(files, **kw):
    kw = dict(sonar_model="EK80", chunk_pings=4, **kw)
    got = et.run_survey_mvbs_from_raw(files, device="cpu", timer=StageTimer(), **kw)
    assert got.attrs["device"] == "cpu"
    return got, run_jax(files, **kw)


@pytest.mark.parametrize("prefetch", [True, False])
def test_power_leg_matches_jax(raw, prefetch):
    wp.reset_launches()
    got, want = _both(raw["mixed"], range_bin="5m", ping_time_bin="5s", prefetch=prefetch)
    assert not any(wp.LAUNCHES.values())
    _assert_mvbs_close(got, want, 1e-5)
    assert len(got.coords["channel"].values) == 1  # the GPT power channel


def test_power_leg_runs_k1_per_chunk(raw, monkeypatch):
    seen = []
    real = ts.sharded_mvbs_partials_closed

    def spy(mesh, *a, uniform=False, **k):
        seen.append("K1" if uniform else "K2")
        return real(mesh, *a, uniform=uniform, **k)

    monkeypatch.setattr(ts, "sharded_mvbs_partials_closed", spy)
    et.run_survey_mvbs_from_raw(raw["mixed"], sonar_model="EK80", range_bin="5m",
                                ping_time_bin="5s", chunk_pings=5, device="cpu")
    assert seen == ["K1"] * 6  # 12 + 11 pings in chunks of 5


MODES = {"bb": ("bb", "BB", "0.5m"), "cw": ("mixed", "CW", "1m")}


@pytest.mark.parametrize("mode", sorted(MODES))
def test_complex_chunked_matches_jax(raw, mode):
    files, wm, rb = MODES[mode]
    got, want = _both(raw[files], waveform_mode=wm, encode_mode="complex", range_bin=rb,
                      ping_time_bin="5s")
    _assert_mvbs_close(got, want, 1e-5)
    assert "chunk_calibrate" in got.attrs["stage_timing"]


@pytest.mark.parametrize("mode", sorted(MODES))
def test_fused_matches_jax_and_chunked(raw, mode):
    files, wm, rb = MODES[mode]
    kw = dict(waveform_mode=wm, encode_mode="complex", range_bin=rb, ping_time_bin="5s")
    fused, want = _both(raw[files], device_fused=True, **kw)
    _assert_mvbs_close(fused, want, 1e-4)
    assert "device_fused" in fused.attrs["stage_timing"]
    chunked = et.run_survey_mvbs_from_raw(raw[files], sonar_model="EK80", chunk_pings=4,
                                          device="cpu", **kw)
    a, b = np.asarray(chunked["Sv"].values), np.asarray(fused["Sv"].values)
    np.testing.assert_array_equal(np.isnan(a), np.isnan(b))
    np.testing.assert_allclose(b[:, :, :-1], a[:, :, :-1], rtol=0, atol=5e-3, equal_nan=True)
    np.testing.assert_allclose(b[:, :, -1], a[:, :, -1], rtol=0, atol=0.2, equal_nan=True)


@pytest.mark.parametrize("name, wm, atol", [("epochs_bb", "BB", 2e-3), ("epochs_cw", "CW", 5e-3)])
def test_multi_epoch_files(raw, name, wm, atol):
    """Epochs from epoch_slice_dicts on both streamers; chunks straddle
    the epoch boundary (chunk_pings=4)."""
    kw = dict(waveform_mode=wm, encode_mode="complex", range_bin="1m", ping_time_bin="4s")
    chunked, want_c = _both(raw[name], **kw)
    fused, want_f = _both(raw[name], device_fused=True, **kw)
    _assert_mvbs_close(chunked, want_c, 1e-5)
    _assert_mvbs_close(fused, want_f, 1e-4)
    a, b = np.asarray(chunked["Sv"].values), np.asarray(fused["Sv"].values)
    np.testing.assert_array_equal(np.isnan(a), np.isnan(b))
    assert np.nanmax(np.abs(a - b)) < atol


def _chunk_operands(seed, P=12, R=300, B=4, L=37, vary_dr=False):
    rng = np.random.default_rng(seed)
    bs = (rng.normal(0, 1e-3, (P, R, B)) + 1j * rng.normal(0, 1e-3, (P, R, B))).astype("c8")
    bs[3, 250:] = np.nan  # a ragged ping
    rep = rng.normal(size=L) + 1j * rng.normal(size=L)
    rep[:2] = 0.0  # the Hann taper's zero endpoint
    h = np.flipud(np.conj(rep))
    dr = np.full(P, 0.0118, "f4")
    if vary_dr:
        dr = (dr * rng.uniform(0.98, 1.02, P)).astype("f4")
    shift = np.full(P, 0.379, "f4")
    k0 = np.maximum(np.floor(shift.astype("f8") / dr) + 1, 0).astype("i4")
    vl = (~np.isnan(bs.real[..., 0])).sum(axis=1).astype("i4")
    x_rel = (np.arange(P) // 4).astype("i4")
    return (np.ascontiguousarray(bs.real), np.ascontiguousarray(bs.imag),
            np.ascontiguousarray(h.real, "f4"), np.ascontiguousarray(h.imag, "f4"),
            np.float32(1 / np.linalg.norm(rep) ** 2), rng.uniform(0.1, 0.2, P).astype("f4"),
            dr, shift, np.full(P, 0.02, "f4"), rng.normal(-20, 1, P).astype("f4"), k0, vl,
            x_rel)


@pytest.mark.parametrize("do_pc", [True, False], ids=["bb", "cw"])
@pytest.mark.parametrize("uniform_er", [True, False])
def test_bb_chunk_window_partials_matches_jax(do_pc, uniform_er):
    ops = _chunk_operands(4, vary_dr=not uniform_er)
    r_edges = np.arange(0, 300 * 0.0125 + 0.5, 0.5).astype("f4")
    s_t, c_t = tbb.bb_chunk_window_partials(*ops, r_edges, 3, do_pc, uniform_er=uniform_er,
                                            device="cpu")
    s_j, c_j = jbb.bb_chunk_window_partials(*ops, r_edges, 3, do_pc, uniform_er=uniform_er)
    np.testing.assert_array_equal(c_t.numpy(), np.asarray(c_j))
    np.testing.assert_allclose(s_t.numpy(), np.asarray(s_j), rtol=1e-4, atol=1e-30)
    assert (c_t.numpy() > 0).any()


def test_bb_chunk_precision_by_position():
    """The JAX parameter order: ``precision`` follows ``do_pc`` in both
    functions.  ``"HIGHEST"`` by position equals ``None`` bit for bit (it
    took the uniform-grid route before it had its own parameter); the
    reduced precisions ``"HIGH"`` and ``"DEFAULT"`` by position equal the
    same by keyword and change the sums, and any other value raises, as
    ``set_conv_precision`` does."""
    ops = _chunk_operands(4, vary_dr=True)
    r_edges = np.arange(0, 300 * 0.0125 + 0.5, 0.5).astype("f4")
    base = tbb.bb_chunk_window_partials(*ops, r_edges, 3, True, device="cpu")
    highest = tbb.bb_chunk_window_partials(*ops, r_edges, 3, True, "HIGHEST", device="cpu")
    for a, b in zip(base, highest):
        assert torch.equal(a, b) and a.dtype == torch.float64
    sv_ops = ops[:-1]
    base_sv = tbb.bb_chunk_sv(*sv_ops, True, device="cpu")
    for a, b in zip(base_sv, tbb.bb_chunk_sv(*sv_ops, True, "HIGHEST", device="cpu")):
        torch.testing.assert_close(a, b, rtol=0, atol=0, equal_nan=True)
    for reduced in ("HIGH", "DEFAULT"):
        pos = tbb.bb_chunk_window_partials(*ops, r_edges, 3, True, reduced, device="cpu")
        kw = tbb.bb_chunk_window_partials(*ops, r_edges, 3, True, precision=reduced,
                                          device="cpu")
        for a, b in zip(pos, kw):
            assert torch.equal(a, b)
        assert torch.equal(pos[1], base[1]) and not torch.equal(pos[0], base[0])
        sv, er = tbb.bb_chunk_sv(*sv_ops, True, reduced, device="cpu")
        torch.testing.assert_close(er, base_sv[1], rtol=0, atol=0, equal_nan=True)
        assert torch.equal(torch.isnan(sv), torch.isnan(base_sv[0]))
    with pytest.raises(ValueError):
        tbb.bb_chunk_window_partials(*ops, r_edges, 3, True, "float16", device="cpu")
    with pytest.raises(ValueError):
        tbb.bb_chunk_sv(*sv_ops, True, "float16", device="cpu")


@pytest.mark.parametrize("do_pc", [True, False], ids=["bb", "cw"])
def test_bb_chunk_sv_matches_jax(do_pc):
    ops = _chunk_operands(8)[:-1]
    sv_t, er_t = tbb.bb_chunk_sv(*ops, do_pc, device="cpu")
    sv_j, er_j = jbb.bb_chunk_sv(*ops, do_pc)
    sv_t, sv_j = sv_t.numpy(), np.asarray(sv_j)
    np.testing.assert_array_equal(np.isnan(sv_t), np.isnan(sv_j))
    np.testing.assert_allclose(sv_t, sv_j, atol=1e-3, rtol=0, equal_nan=True)
    np.testing.assert_array_equal(er_t.numpy(), np.asarray(er_j))
    assert np.isfinite(sv_t).any()


@pytest.mark.parametrize("wm, em, rb", [("BB", "complex", "0.5m"), ("CW", "power", "5m")])
def test_chain_matches_jax(raw, wm, em, rb):
    """open_raw -> compute_Sv -> compute_MVBS through each package."""
    path = raw["bb" if wm == "BB" else "mixed"][0]
    grid = dict(range_bin=rb, ping_time_bin="4s")
    ted = et.open_raw(path, sonar_model="EK80")
    got = et.compute_MVBS(et.calibrate.compute_Sv(ted, waveform_mode=wm, encode_mode=em,
                                                  device="cpu"), device="cpu", **grid)
    jed = ep.open_raw(path, sonar_model="EK80")
    want = ep.commongrid.compute_MVBS(ep.calibrate.compute_Sv(jed, waveform_mode=wm,
                                                              encode_mode=em), **grid)
    _assert_mvbs_close(got, want, 1e-4)


def _complex_group(seed, R, beam_dim=True, C=3, P=11, B=4):
    """A float64 [C, P, R, B] (or [C, P, R]) complex part with values that
    round to even, overflow, go subnormal, a ragged ping and an interior
    NaN in sector 0."""
    rng = np.random.default_rng(seed)
    g = rng.normal(0, 1e-3, (C, P, R, B))
    g[0, 0, :4, 0] = [1 + 2.0**-24, 1 + 3 * 2.0**-24, 1e39, 1e-42]
    g[1, 4, R - 9:] = np.nan  # a ragged ping
    g[2, 9, 5, 0] = np.nan  # interior, counted out of the valid length
    return g if beam_dim else g[..., 0]


#: file cases of the staging test: (writer, its keywords, chunk sizes); the
#: convert tests' layouts of ragged and skipped channels
STAGE_FILES = {
    "one_run": (write_ek80_raw, dict(n_samples=48, seed=41, with_power_channel=False,
                                     with_cw_complex=False), (4, 7)),
    "ragged_channels": (_write_complex_mix, MIXES["ragged_channels"], (4,)),
    "skipped_pings": (_write_complex_mix, MIXES["ragged_channels_skip"], (4,)),
    "duplicate_ping": (write_ek80_raw, dict(n_samples=48, seed=45,
                                            duplicate_pings={CH_BB: {2}}), (4,)),
    "cut_runs": (write_ek80_raw, dict(n_samples=48, seed=44, extra_fm_channel=True,
                                      skip_pings={CH_BB: {2, 3}}), (2, 3)),
}


@pytest.fixture(scope="module")
def stage_files(tmp_path_factory):
    d = tmp_path_factory.mktemp("stage_ek80")
    out = {}
    for name, (write, kw, _) in STAGE_FILES.items():
        out[name] = str(d / f"{name}-D20210201-T000000.raw")
        write(out[name], n_pings=7, **kw)
    return out


def _assert_chunk_is_the_cast(staged, ci, sl, want_r, want_i):
    """``staged.chunk(ci, sl)`` is the float32 cast's [ci, sl] bit for bit,
    its valid length the cast's NaN count of sector 0."""
    r, i, vl = staged.chunk(ci, sl)
    n = sl.stop - sl.start
    assert isinstance(r, np.ndarray) and r.shape == (n, *want_r.shape[2:])
    np.testing.assert_array_equal(r.view("u4"), want_r[ci, sl].view("u4"))
    np.testing.assert_array_equal(i.view("u4"), want_i[ci, sl].view("u4"))
    assert vl.dtype == np.int32
    np.testing.assert_array_equal(vl, (~np.isnan(want_r[ci, sl, :, 0])).sum(axis=1))


@pytest.mark.parametrize("case", ["4d", "3d", *STAGE_FILES])
def test_complex_chunk_stage_equals_the_whole_file_cast(case, stage_files):
    """Each (channel, chunk) staged through the one reused buffer pair is
    ``np.asarray(group, "f4")[ci, sl]`` bit for bit, NaN placement
    included, and its valid length the whole-file NaN count of sector 0.

    4d / 3d: the layout of a float64 group's own samples, with values that
    round to even, overflow and go subnormal; the last chunk is short (11
    pings in chunks of 4), and the second file's R differs, so its chunks
    take a new pair.  The file cases: the layout ``_open_raw_unfilled``
    keeps of each complex group, from the parser's float32 planes, against
    the group ``open_raw`` fills: one run a channel; channels of fewer
    samples and sectors than the group's; pings a channel skips; a
    duplicate ping; chunks that cut runs.  Filled from the layout, the
    group is ``open_raw``'s bit for bit."""
    staged = ts._ComplexChunkStage(4, torch.device("cpu"))
    if case in ("4d", "3d"):
        pairs = []
        for seed, R in ((0, 40), (1, 57)):
            bs_r, bs_i = (_complex_group(seed + k, R, case == "4d") for k in (0, 10))
            staged.file(ComplexLayout.of_group(bs_r, bs_i))
            pairs.append(staged.bufs)
            with np.errstate(over="ignore"):  # 1e39 -> inf, as the stage narrows it
                want_r, want_i = (np.asarray(a, "f4").reshape(3, 11, R, -1)
                                  for a in (bs_r, bs_i))
            for ci in range(3):
                for lo in (0, 4, 8):
                    _assert_chunk_is_the_cast(staged, ci, slice(lo, min(lo + 4, 11)),
                                              want_r, want_i)
            assert staged.bufs is pairs[-1]  # one pair for every chunk of the file
        assert pairs[0][0].shape[1] == 40 and pairs[1][0].shape[1] == 57
        vl = (~np.isnan(want_r[..., 0])).sum(axis=2)
        assert vl[2, 9] == 56 and vl[1, 4] == 48
        return
    path, (_, _, sizes) = stage_files[case], STAGE_FILES[case]
    ed, layouts = tapi._open_raw_unfilled(path, "EK80")
    full = et.open_raw(path, sonar_model="EK80")
    assert layouts and all(lay.planes for lay in layouts.values())
    runs, gaps, ragged, cut = 0, 0, False, False
    for bp, layout in layouts.items():
        assert "backscatter_r" not in ed[bp] and "backscatter_i" not in ed[bp]
        want_r, want_i = (np.asarray(full[bp][k].values, "f4")
                          for k in ("backscatter_r", "backscatter_i"))
        staged = ts._ComplexChunkStage(max(sizes), torch.device("cpu"))
        staged.file(layout)
        for size in sizes:
            for ci in range(len(layout.channels)):
                for lo in range(0, layout.n_t, size):
                    _assert_chunk_is_the_cast(staged, ci, slice(lo, min(lo + size, layout.n_t)),
                                              want_r, want_i)
        runs = max(runs, max(len(k) for k in layout.runs))
        cut |= any(d0 < lo < d0 + n for k in layout.runs for _, d0, n in k
                   for size in sizes for lo in range(0, layout.n_t, size))
        gaps += int(np.isnan(want_r).all(axis=(2, 3)).sum())
        ragged |= any(a.shape[1:] != want_r.shape[2:] for a in layout.real)
        layout.fill(ed[bp])
        for k in ("backscatter_r", "backscatter_i"):
            got, want = ed[bp][k].values, full[bp][k].values
            assert got.dtype == want.dtype == np.float64
            np.testing.assert_array_equal(got.view("u8"), want.view("u8"))
    # each case holds the layout it names
    assert (runs == 1) == (case in ("one_run", "ragged_channels"))
    assert (gaps > 0) == (case in ("skipped_pings", "cut_runs"))
    assert ragged == (case in ("ragged_channels", "skipped_pings"))
    assert cut or case != "cut_runs"


def test_complex_chunk_stage_aliases_nothing_across_channels():
    """The freq-diff route's stack: each channel's chunk staged in turn
    through the one pair and run to Sv (``bb_chunk_sv``), then stacked,
    equals each channel's chunk of the whole-file float32 cast run alone."""
    ops = _chunk_operands(3)
    P, R, B = ops[0].shape
    rng = np.random.default_rng(5)
    bs_r, bs_i = (np.stack([a] + [a * rng.uniform(0.5, 2.0) for _ in range(2)]).astype("f8")
                  for a in ops[:2])
    staged = ts._ComplexChunkStage(5, torch.device("cpu"))
    staged.file(ComplexLayout.of_group(bs_r, bs_i))
    f4_r, f4_i = np.asarray(bs_r, "f4"), np.asarray(bs_i, "f4")
    for lo in range(0, P, 5):
        sl = slice(lo, min(lo + 5, P))
        per_ping = [a[sl] for a in ops[5:11]]
        stacked = []
        for ci in range(3):
            r, i, vl = staged.chunk(ci, sl)
            stacked.append(tbb.bb_chunk_sv(r, i, *ops[2:5], *per_ping, vl, True, device="cpu"))
        for ci in range(3):
            vl = (~np.isnan(f4_r[ci, sl, :, 0])).sum(axis=1).astype("i4")
            alone = tbb.bb_chunk_sv(f4_r[ci, sl], f4_i[ci, sl], *ops[2:5], *per_ping, vl, True,
                                    device="cpu")
            for got, want in zip(stacked[ci], alone):
                torch.testing.assert_close(got, want, rtol=0, atol=0, equal_nan=True)
        assert not torch.equal(torch.nan_to_num(stacked[0][0]), torch.nan_to_num(stacked[1][0]))


def test_accumulator_takes_one_channel_partials():
    acc = ts._PartialAccumulator(2, 4, 3, 2, StageTimer())
    acc.push(torch.ones(2, 3), torch.ones(2, 3), 1, ch=1)
    acc.push(torch.full((2, 2, 3), 2.0), torch.ones(2, 2, 3), 3)  # all channels, clipped
    sums, counts = acc.finish()
    np.testing.assert_array_equal(sums[0, :, 0], [0, 0, 0, 2])
    np.testing.assert_array_equal(sums[1, :, 0], [0, 1, 1, 2])
    assert counts.sum() == 2 * 3 + 2 * 3
