"""Port parity: multi-device surveys (``echopype_torch.parallel.make_mesh``,
the ``sharded_*`` steps and ``mesh=`` on the three survey streamers).

The JAX side runs on the virtual 8-device CPU mesh of tests/conftest.py;
the port drives the same layouts in this one process on
``make_mesh(devices=["cpu"] * n)``, a grid that repeats the CPU.  Every
step is held to the JAX step on the same layout and to the port's own
``mesh=None``, at 1, 4 and 8 blocks, with the JAX tests' tolerances
(tests/test_parallel.py): Sv rtol / atol 1e-5 with identical NaN masks,
MVBS 1e-4 against JAX and 1e-5 against one device, window sums rtol 3e-6
and counts exact (:440-442), the streamers within 1e-4 dB
(tests/test_survey.py:383-421) and NASC rtol 1e-5 (tests/test_survey_nasc.py
:80-86).  Small shapes: 2-4 channels, at most a few hundred pings, R <= 128.
"""

import numpy as np
import pytest
import torch

import echopype_torch as et
import echopype_tpu as ep
from echopype_torch.parallel import pipeline as tp
from echopype_torch.xrlite import Dataset as TDataset
from echopype_tpu.parallel import make_mesh as jax_make_mesh
from echopype_tpu.parallel import pipeline as jp
from echopype_tpu.parallel import survey as js

from synth_azfp import write_azfp_raw, write_azfp_xml
from synth_ek60 import write_ek60_raw
from synth_ek80 import write_ek80_raw
from test_ek80_epochs import write_two_epoch_ek80
from test_survey_epochs import write_two_epoch_bb
from test_torch_commongrid import as_package
from test_torch_survey_masks import MASK_SPEC, RAW_SPEC, _survey_files
from test_torch_survey_sv import make_sv

torch.set_num_threads(1)

SV_TOL = dict(rtol=1e-5, atol=1e-5)
MVBS_JAX = dict(rtol=1e-4, atol=1e-4)
MVBS_ONE = dict(rtol=1e-5, atol=1e-5)
SUM_RTOL = 3e-6
# the plain twins against the XLA steps: their float32 log10 / exp differ
# from XLA's by an ulp or two, which a bin of one or two samples keeps
# (3.8e-6 and 4.4e-6 seen); the blocks against one device stay at SUM_RTOL
JAX_SUM_RTOL = 1e-5
STREAM_DB = 1e-4

#: (n_devices, channel_axis) of the 1-, 4- and 8-block layouts
LAYOUTS = {"1": (1, 1), "4": (4, 1), "8": (8, 2)}


def tmesh(n, channel_axis=1, range_axis=1):
    return et.parallel.make_mesh(devices=["cpu"] * n, channel_axis=channel_axis,
                                 range_axis=range_axis)


def jmesh(n, channel_axis=1, range_axis=1):
    return jax_make_mesh(n_devices=n, channel_axis=channel_axis, range_axis=range_axis)


def _np(t):
    return t.cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _same_nan(a, b):
    np.testing.assert_array_equal(np.isnan(_np(a)), np.isnan(_np(b)))


def make_inputs(C=2, Pn=64, R=128, seed=0):
    """tests/test_parallel.py::make_inputs with two ragged pings."""
    rng = np.random.default_rng(seed)
    power = rng.normal(-80, 10, (C, Pn, R)).astype("f4")
    dr = np.full((C, Pn), 0.19, dtype="f4")
    tvg = 2 * dr
    ab = np.full((C, Pn), 0.01, dtype="f4")
    off = rng.normal(-30, 2, (C, Pn)).astype("f4")
    n_x, n_r = 8, 5
    x_idx = (np.arange(Pn) // (Pn // n_x)).astype("i4")
    r_edges = np.arange(0, 30.0, 5.0, dtype="f4")
    power[0, 3, 90:] = np.nan
    power[1, 17, 40:] = np.nan
    return power, dr, tvg, ab, off, x_idx, r_edges, n_x, n_r


def window_inputs(seed=4, C=4, P=64, R=120, W=7, n_r=9, uniform=True, f32=False,
                  parked=0, dr_by_ping=False):
    """One survey chunk of window-relative ping bins (tests/test_parallel.py
    ::TestUniformFastPath): int16 or float32 dB power (NaN past the valid
    length, with the echo_range intercept ``r0``), ragged valid lengths,
    the last ``parked`` pings padding parked past the window."""
    rng = np.random.default_rng(seed)
    power = rng.integers(-12000, -2000, (C, P, R), dtype=np.int16)
    dr = np.repeat(rng.uniform(0.1, 0.3, (C, 1)).astype("f4"), P, axis=1)
    if dr_by_ping:
        dr = (dr * rng.uniform(0.97, 1.03, (C, P))).astype("f4")
    shift = 2 * dr
    if not uniform:  # TVG shift by ping: the K2 path on a uniform range grid
        shift = (shift * rng.uniform(0.5, 1.5, (C, P))).astype("f4")
    ab = np.full((C, P), 0.01, "f4")
    off = rng.normal(-30, 2, (C, P)).astype("f4")
    vl = rng.integers(R // 2, R + 1, (C, P)).astype("i4")
    x_rel = np.sort(rng.integers(0, W, P)).astype("i4")
    if parked:
        x_rel[-parked:] = W
        vl[:, -parked:] = 0
    r_edges = np.linspace(0, 0.3 * R, n_r + 1).astype("f4")
    r0 = None
    if f32:
        power = (power * np.float32(0.011758984205624481)).astype("f4")
        power[np.arange(R)[None, None, :] >= vl[:, :, None]] = np.nan
        r0 = np.repeat(rng.uniform(0.5, 2.0, (C, 1)).astype("f4"), P, axis=1)
    return (power, dr, shift, ab, off, vl, x_rel, r_edges, r0), W, n_r


def assert_windows(got, want, rtol=SUM_RTOL):
    np.testing.assert_allclose(_np(got[0]), _np(want[0]), rtol=rtol, atol=1e-30)
    np.testing.assert_array_equal(_np(got[1]), _np(want[1]))


# ------------------------------------------------------------------ meshes
class TestMakeMesh:
    @pytest.mark.parametrize("n, ch, rng", [(1, 1, 1), (4, 1, 1), (8, 1, 1), (8, 2, 1),
                                            (8, 4, 1), (8, 2, 2), (4, 1, 2)])
    def test_layouts_match_jax(self, n, ch, rng):
        t, j = tmesh(n, ch, rng), jmesh(n, ch, rng)
        assert t.devices.shape == j.devices.shape
        assert t.axis_names == j.axis_names
        assert t.shape == dict(j.shape) and t.size == j.size == n
        assert all(d == torch.device("cpu") for d in t.devices.flat)

    def test_invalid_layouts_raise(self):
        with pytest.raises(ValueError, match="divisible"):
            tmesh(8, 3)
        with pytest.raises(ValueError, match="divisible"):
            jmesh(8, 3)
        with pytest.raises(ValueError, match="divisible"):
            et.parallel.make_mesh(devices=[])

    def test_n_devices_takes_the_first(self):
        mesh = et.parallel.make_mesh(n_devices=2, devices=["cpu"] * 8)
        assert mesh.devices.shape == (2, 1) and mesh.size == 2

    def test_no_cuda_raises(self):
        if torch.cuda.is_available():
            pytest.skip("a CUDA device is present; this checks the no-fallback rule")
        for kw in ({}, {"n_devices": 4}, {"devices": ["cuda:0"] * 2}, {"devices": ["cuda"]}):
            with pytest.raises(RuntimeError, match="cuda|CUDA"):
                et.parallel.make_mesh(**kw)

    @pytest.mark.parametrize("foreign", ["object", "jax"])
    @pytest.mark.parametrize("entry", ["survey_pipeline_step", "sharded_sv_mvbs_step",
                                       "sharded_sv_mvbs_step_3d", "sharded_mvbs_step_closed",
                                       "sharded_mvbs_partials_closed",
                                       "sharded_binned_partials", "run_survey_mvbs",
                                       "run_survey_nasc", "run_survey_mvbs_from_raw"])
    def test_foreign_mesh_raises_type_error(self, entry, foreign):
        mesh = object() if foreign == "object" else jmesh(8, 2)
        fn = getattr(et.parallel, entry, None) or getattr(tp, entry)
        args = {"run_survey_mvbs": ([make_sv()],), "run_survey_nasc": ([make_sv()],),
                "run_survey_mvbs_from_raw": ([],)}.get(entry, (8, 5))
        with pytest.raises(TypeError, match="echopype_torch.parallel.make_mesh"):
            if entry.startswith("run_"):
                fn(*args, mesh=mesh, device="cpu")
            else:
                fn(mesh, *args)

    def test_parallel_all_covers_jax(self):
        assert set(ep.parallel.__all__) <= set(et.parallel.__all__)
        for name in et.parallel.__all__:
            assert getattr(et.parallel, name) is not None


# ----------------------------------------------------------------- steps
class TestSurveyStep:
    @pytest.mark.parametrize("layout", sorted(LAYOUTS))
    @pytest.mark.parametrize("with_sv", [True, False], ids=["k3", "k4"])
    @pytest.mark.parametrize("uniform_dr", [True, False], ids=["uniform", "per_ping"])
    def test_sharded_step(self, layout, with_sv, uniform_dr):
        power, dr, tvg, ab, off, x_idx, r_edges, n_x, n_r = make_inputs(seed=1)
        if not uniform_dr:
            dr = (dr * np.random.default_rng(1).uniform(0.97, 1.03, dr.shape)).astype("f4")
        args = (power, dr, tvg, ab, off, x_idx, r_edges)
        kw = dict(uniform_dr=uniform_dr, with_sv=with_sv)
        got = tp.sharded_sv_mvbs_step(tmesh(*LAYOUTS[layout]), n_x, n_r, **kw)(*args)
        one = tp.sharded_sv_mvbs_step(None, n_x, n_r, device="cpu", **kw)(*args)
        want = jp.sharded_sv_mvbs_step(jmesh(*LAYOUTS[layout]), n_x, n_r, **kw)(*args)
        if with_sv:
            (sv, got), (sv1, one), (svj, want) = got, one, want
            np.testing.assert_array_equal(_np(sv), _np(sv1))  # per-sample work is the same
            _same_nan(sv, svj)
            np.testing.assert_allclose(_np(sv), _np(svj), **SV_TOL)
        for other, tol in ((one, MVBS_ONE), (want, MVBS_JAX)):
            _same_nan(got, other)
            np.testing.assert_allclose(_np(got), _np(other), **tol)

    @pytest.mark.parametrize("n, ch", [(4, 1), (8, 2)], ids=["2x1x2", "2x2x2"])
    def test_3d_step(self, n, ch):
        """(ping, channel, range): the range blocks carry their global sample
        offset; bin sums add over the ping and range blocks."""
        power, dr, tvg, ab, off, x_idx, r_edges, n_x, n_r = make_inputs(seed=2)
        args = (power, dr, tvg, ab, off, x_idx, r_edges)
        sv, mvbs = et.survey_pipeline_step(tmesh(n, ch, 2), n_x, n_r)(*args)
        sv1, one = et.survey_pipeline_step(None, n_x, n_r, device="cpu")(*args)
        svj, want = jp.sharded_sv_mvbs_step_3d(jmesh(n, ch, 2), n_x, n_r)(*args)
        for s in (sv1, svj):
            _same_nan(sv, s)
            np.testing.assert_allclose(_np(sv), _np(s), **SV_TOL)
        for m in (one, want):
            _same_nan(mvbs, m)
            np.testing.assert_allclose(_np(mvbs), _np(m), **MVBS_JAX)

    @pytest.mark.parametrize("layout", sorted(LAYOUTS))
    def test_closed_step(self, layout):
        power, dr, tvg, ab, off, x_idx, r_edges, n_x, n_r = make_inputs(seed=3)
        vl = (~np.isnan(power)).sum(axis=2).astype("i4")
        args = (power, dr, tvg, ab, off, vl, x_idx, r_edges)
        got = tp.sharded_mvbs_step_closed(tmesh(*LAYOUTS[layout]), n_x, n_r)(*args)
        one = tp.sharded_mvbs_step_closed(None, n_x, n_r, device="cpu")(*args)
        want = jp.sharded_mvbs_step_closed(jmesh(*LAYOUTS[layout]), n_x, n_r)(*args)
        for other, tol in ((one, MVBS_ONE), (want, MVBS_ONE)):
            _same_nan(got, other)
            np.testing.assert_allclose(_np(got), _np(other), **tol)

    @pytest.mark.parametrize("kind", ["f32", "int16", "f32_r0"])
    def test_closed_core(self, kind):
        """tests/test_parallel.py:173-192: closed-form counts exact; NaN only
        as suffix padding.  The ping sums are differences of float32 prefix
        sums (the JAX function's precision note), which carry each
        implementation's per-ping rounding (2e-6 here) at the scale of the
        running total into every bin: sums within rtol 1e-5 (the JAX test's
        bound between two implementations of the step, :209-213) plus 1e-6
        of the largest bin."""
        (power, dr, shift, ab, off, vl, x_rel, r_edges, r0), W, n_r = window_inputs(
            seed=5, f32=kind != "int16")
        r0 = r0 if kind == "f32_r0" else None
        args = (power, dr, shift, ab, off, vl, x_rel, r_edges, W, n_r)
        s, c = tp.sv_mvbs_core_mxu_closed(*args, r0=r0, device="cpu")
        s_j, c_j = jp.sv_mvbs_core_mxu_closed(*args, r0=r0)
        np.testing.assert_array_equal(_np(c), np.asarray(c_j))
        np.testing.assert_allclose(_np(s), np.asarray(s_j), rtol=1e-5,
                                   atol=1e-6 * float(np.nanmax(s_j)))

    def test_ex60_core(self):
        """tests/test_parallel.py:83-92: the integer-shift core against the
        general one at tvg = 2 dr; and against the JAX ex60 core."""
        power, dr, tvg, ab, off, x_idx, r_edges, n_x, n_r = make_inputs(C=2, Pn=40, R=96)
        sv1, s1, _ = tp.sv_mvbs_core_mxu(power, dr, tvg, ab, off, x_idx, r_edges, n_x, n_r,
                                         device="cpu")
        sv2, s2, c2 = tp.sv_mvbs_core_ex60(power, dr, ab, off, x_idx, r_edges, n_x, n_r,
                                           device="cpu")
        np.testing.assert_allclose(_np(sv2), _np(sv1), rtol=1e-4, atol=2e-4)
        np.testing.assert_allclose(_np(s2), _np(s1), rtol=1e-3, atol=1e-6)
        svj, sj, cj = jp.sv_mvbs_core_ex60(power, dr, ab, off, x_idx, r_edges, n_x, n_r)
        _same_nan(sv2, svj)
        np.testing.assert_allclose(_np(sv2), np.asarray(svj), **SV_TOL)
        np.testing.assert_allclose(_np(s2), np.asarray(sj), rtol=1e-5, atol=1e-30)
        np.testing.assert_array_equal(_np(c2), np.asarray(cj))

    def test_transposed_uniform_step(self):
        """tests/test_parallel.py:386-411: the ping-minor twin equals the
        uniform window step (counts exact, sums rtol 2e-6), and the JAX
        twin."""
        rng = np.random.default_rng(3)
        C, Pn, R, n_r, W = 2, 256, 300, 7, 4
        power = rng.integers(-12000, -2000, (C, Pn, R)).astype(np.int16)
        dr = np.tile(rng.uniform(0.15, 0.25, (C, 1)).astype("f4"), (1, Pn))
        tvg, ab = 2 * dr, np.full((C, Pn), 0.01, "f4")
        off = rng.normal(-30, 2, (C, Pn)).astype("f4")
        vl = (np.full((C, Pn), R) - rng.integers(0, 5, (C, Pn))).astype("i4")
        x_rel = np.sort(rng.integers(0, W, Pn)).astype("i4")
        r_edges = np.linspace(0, 0.25 * R, n_r + 1).astype("f4")
        rest = (dr, tvg, ab, off, vl, x_rel, r_edges, W, n_r)
        s0, c0 = tp.sv_mvbs_window_partials_uniform(power, *rest, device="cpu")
        pT = np.ascontiguousarray(power.transpose(0, 2, 1))
        st, ct = tp.sv_mvbs_window_partials_uniform_t(pT, *rest, device="cpu")
        np.testing.assert_array_equal(_np(ct), _np(c0))
        np.testing.assert_allclose(_np(st), _np(s0), rtol=2e-6, atol=1e-30)
        sj, cj = jp.sv_mvbs_window_partials_uniform_t(pT, *rest)
        np.testing.assert_array_equal(_np(ct), np.asarray(cj))
        np.testing.assert_allclose(_np(st), np.asarray(sj), rtol=SUM_RTOL, atol=1e-30)


class TestWindowSteps:
    @pytest.mark.parametrize("layout", sorted(LAYOUTS))
    @pytest.mark.parametrize("kind", ["k1", "k2", "k2_f32_r0"])
    @pytest.mark.parametrize("parked", [0, 12], ids=["full", "parked_block"])
    def test_partials_closed(self, layout, kind, parked):
        """K1 / K2's twins per block against the JAX step and one device.
        With 12 parked pings of 64 the last ping block of 8 holds only
        padding (valid length 0, parked past the window)."""
        uniform = kind == "k1"
        args, W, n_r = window_inputs(uniform=uniform, f32=kind.endswith("r0"), parked=parked)
        mesh_args = dict(n_x_window=W, n_r=n_r, uniform=uniform)
        got = tp.sharded_mvbs_partials_closed(tmesh(*LAYOUTS[layout]), **mesh_args)(*args)
        one = tp.sharded_mvbs_partials_closed(None, device="cpu", **mesh_args)(*args)
        want = jp.sharded_mvbs_partials_closed(jmesh(*LAYOUTS[layout]), W, n_r,
                                               uniform=uniform)(*args)
        assert_windows(got, one)
        assert_windows(got, want, JAX_SUM_RTOL)

    @pytest.mark.parametrize("layout", ["4", "8"])
    def test_sums_only_and_host_counts(self, layout):
        """``with_counts=False`` returns K1's sums alone; the survey's host
        closed-form counts equal the step's counts."""
        args, W, n_r = window_inputs(seed=7, parked=9)
        mesh = tmesh(*LAYOUTS[layout])
        s, c = tp.sharded_mvbs_partials_closed(mesh, W, n_r, uniform=True)(*args)
        s_only = tp.sharded_mvbs_partials_closed(mesh, W, n_r, uniform=True,
                                                 with_counts=False)(*args)
        np.testing.assert_array_equal(_np(s_only), _np(s))
        power, dr, shift, _, _, vl, x_rel, r_edges, _ = args
        bounds, k0 = tp.closed_bounds_k0_np(dr[:, 0], shift[:, 0], r_edges, power.shape[2])
        np.testing.assert_array_equal(tp.closed_window_counts_np(bounds, k0, vl, x_rel, W),
                                      _np(c))

    def test_dr_by_ping_follows_the_chunk_first_ping(self):
        """With dr varying by ping, every block bins on the chunk's first-ping
        bounds, so the mesh equals one device (counts exact).  The JAX
        package's shard_map bins each block on its own first ping, so its
        mesh departs from its one device on this input: the reason the port
        is held here to its own one device."""
        args, W, n_r = window_inputs(seed=8, uniform=False, dr_by_ping=True, parked=5)
        got = tp.sharded_mvbs_partials_closed(tmesh(8, 2), W, n_r)(*args)
        assert_windows(got, tp.sv_mvbs_window_partials(*args[:8], W, n_r, device="cpu"))
        j_mesh = jp.sharded_mvbs_partials_closed(jmesh(8, 2), W, n_r)(*args)
        j_one = jp.sv_mvbs_window_partials(*args[:8], W, n_r, r0=args[8])
        assert not np.array_equal(np.asarray(j_mesh[1]), np.asarray(j_one[1]))

    @pytest.mark.parametrize("layout", ["1", "4"])
    @pytest.mark.parametrize("f32", [False, True], ids=["int16", "f32_r0"])
    def test_freqdiff(self, layout, f32):
        args, W, n_r = window_inputs(seed=9, C=3, f32=f32, parked=6)
        step_args = (W, n_r, 1, 0, ">")
        got = tp.sharded_mvbs_partials_freqdiff(tmesh(*LAYOUTS[layout]), *step_args)(
            *args, np.float32(2.0))
        one = tp.sv_mvbs_window_partials_freqdiff(*args[:8], W, n_r, 1, 0, ">", 2.0,
                                                  r0=args[8], device="cpu")
        want = jp.sharded_mvbs_partials_freqdiff(jmesh(*LAYOUTS[layout]), *step_args)(
            *args, np.float32(2.0))
        assert_windows(got, one)
        assert_windows(got, want, JAX_SUM_RTOL)
        assert float(_np(got[1]).sum()) > 0

    def test_freqdiff_needs_one_channel_block(self):
        for pkg, make in ((tp, tmesh), (jp, jmesh)):
            with pytest.raises(ValueError, match="channel mesh axis"):
                pkg.sharded_mvbs_partials_freqdiff(make(8, 2), 4, 5, 0, 1, ">")


class TestBinnedSteps:
    def _chunk(self, seed=11, C=4, P=48, R=60, W=6, pad=10, vary=False):
        rng = np.random.default_rng(seed)
        sv = rng.normal(-70, 10, (C, P, R)).astype("f4")
        sv[rng.random(sv.shape) < 0.05] = np.nan
        er = np.broadcast_to((np.arange(R) * 0.5)[None, None], (C, P, R)).copy()
        if vary:
            er = er * rng.uniform(0.97, 1.03, (C, P, 1))
        edges = np.arange(0, 32.0, 4.0)
        enc, enc_edges = tp.binning.exact_bin_encode_np(er, edges)[:2]
        x_rel = np.sort(rng.integers(0, W, P)).astype("i4")
        sv[:, P - pad:] = np.nan  # padded pings: NaN, parked past the window
        enc[:, P - pad:] = np.nan
        x_rel[P - pad:] = W
        return sv, enc, enc_edges, x_rel, W

    @pytest.mark.parametrize("layout", sorted(LAYOUTS))
    @pytest.mark.parametrize("kind", ["partials", "grid", "sum_raw", "row_sum"])
    def test_against_jax_and_one_device(self, layout, kind):
        sv, enc, edges, x_rel, W = self._chunk()
        row = enc[:, 0]
        vals = np.abs(sv[:, :, :]).astype("f4") * 1e-2
        args, build, kw = {
            "partials": ((sv, enc, edges, x_rel), "sharded_binned_partials",
                         dict(skipna=False, uniform_er=True)),
            "grid": ((sv, row, edges, x_rel), "sharded_binned_partials_grid",
                     dict(skipna=False)),
            "sum_raw": ((vals, enc, edges, x_rel), "sharded_binned_sum_raw",
                        dict(uniform_er=True)),
            "row_sum": ((vals[:, 0], row, edges, x_rel), "sharded_binned_row_sum", {}),
        }[kind]
        got = getattr(tp, build)(tmesh(*LAYOUTS[layout]), W, **kw)(*args)
        one = getattr(tp, build)(None, W, device="cpu", **kw)(*args)
        want = getattr(jp, build)(jmesh(*LAYOUTS[layout]), W, **kw)(*args)
        got, one, want = ([_np(t) for t in (x if isinstance(x, tuple) else (x,))]
                          for x in (got, one, want))
        for other in (one, want):
            np.testing.assert_allclose(got[0], other[0], rtol=1e-5, atol=1e-30)
            for g, w in zip(got[1:], other[1:]):
                np.testing.assert_array_equal(g, w)
        assert np.isfinite(got[0]).all() and got[0].sum() > 0

    @pytest.mark.parametrize("layout", ["4", "8"])
    def test_per_ping_route(self, layout):
        """A grid that varies by ping: each block adds every sample into its
        own bin (``index_put_``), and the mesh equals one device; the JAX
        streamers' prefix sums are not the reference here (ROADMAP Queue 3)."""
        sv, enc, edges, x_rel, W = self._chunk(seed=12, vary=True)
        assert not tp.binning.er_is_uniform(enc)
        got = tp.sharded_binned_partials(tmesh(*LAYOUTS[layout]), W)(sv, enc, edges, x_rel)
        one = tp.sharded_binned_partials(None, W, device="cpu")(sv, enc, edges, x_rel)
        np.testing.assert_allclose(_np(got[0]), _np(one[0]), rtol=1e-5, atol=1e-30)
        np.testing.assert_array_equal(_np(got[1]), _np(one[1]))
        again = tp.sharded_binned_partials(tmesh(*LAYOUTS[layout]), W)(sv, enc, edges, x_rel)
        assert all(torch.equal(a, b) for a, b in zip(got, again))


# ------------------------------------------------------------- streamers
def _assert_stream(got, want, var="Sv", atol=STREAM_DB, rtol=0.0):
    g, w = np.asarray(got[var].values, "f8"), np.asarray(want[var].values, "f8")
    assert g.shape == w.shape
    for k in got.coords:
        if k in want.coords:
            np.testing.assert_array_equal(np.asarray(got.coords[k].values, dtype=str),
                                          np.asarray(want.coords[k].values, dtype=str))
    np.testing.assert_array_equal(np.isnan(g), np.isnan(w))
    assert np.isfinite(g).any()
    np.testing.assert_allclose(g, w, rtol=rtol, atol=atol, equal_nan=True)


def _three(fn_port, fn_jax, t_mesh, j_mesh, **kw):
    """(port on its mesh, port one device, JAX on its mesh) of one call."""
    return (fn_port(mesh=t_mesh, device="cpu", **kw), fn_port(device="cpu", **kw),
            fn_jax(mesh=j_mesh, **kw))


@pytest.fixture(scope="module")
def ek60_files(tmp_path_factory):
    """tests/test_survey.py::TestMeshSurveyRunner's files: two EK60 files of
    30 pings, 40 s apart, and a third whose sound speed varies by ping."""
    d = tmp_path_factory.mktemp("torch_mesh_raw")
    t0 = np.datetime64("2020-01-01T00:00:00", "ns")
    files = []
    for i in range(3):
        raw = d / f"M{i}-D20200101-T000000.raw"
        write_ek60_raw(raw, n_pings=30, n_samples=120, t0=t0 + np.timedelta64(i * 40, "s"),
                       seed=i, jitter_raw0=i == 2)
        files.append(str(raw))
    return files


class TestRawStreamer:
    KW = dict(sonar_model="EK60", range_bin="5m", ping_time_bin="10s", chunk_pings=16)

    @pytest.mark.parametrize("prefetch", [True, False], ids=["streamed", "eager"])
    @pytest.mark.parametrize("layout", sorted(LAYOUTS))
    def test_ek60_matches_jax_and_one_device(self, ek60_files, prefetch, layout):
        """tests/test_survey.py:407-422 on 1, 4 and 8 blocks (chunks of 16
        on 8 devices: 4 ping blocks of 4)."""
        files = ek60_files[:2]
        got, one, want = _three(et.run_survey_mvbs_from_raw, js.run_survey_mvbs_from_raw,
                                tmesh(*LAYOUTS[layout]), jmesh(*LAYOUTS[layout]),
                                raw_files=files, prefetch=prefetch, **self.KW)
        _assert_stream(got, one)
        _assert_stream(got, want)

    @pytest.mark.parametrize("prefetch", [True, False], ids=["streamed", "eager"])
    def test_dr_by_ping_and_parked_blocks(self, ek60_files, prefetch):
        """The K2 file (sound speed by ping) and chunks of 13 on 8 ping
        blocks, rounded up to 16: each file's last chunk of 30 - 16 = 14
        pings leaves a block of padding.  Equal to one device in chunks of
        16 (K2 bins a chunk on its first ping's dr, so the chunking must
        match on that file)."""
        got = et.run_survey_mvbs_from_raw(ek60_files, mesh=tmesh(8, 1), prefetch=prefetch,
                                          device="cpu", **dict(self.KW, chunk_pings=13))
        _assert_stream(got, et.run_survey_mvbs_from_raw(ek60_files, prefetch=prefetch,
                                                        device="cpu", **self.KW))

    def test_freq_diff(self, ek60_files):
        """tests/test_survey_freqdiff.py:75-92."""
        kw = dict(self.KW, raw_files=ek60_files[:1], freq_diff="38kHz - 18kHz > 3.0dB")
        got, one, want = _three(et.run_survey_mvbs_from_raw, js.run_survey_mvbs_from_raw,
                                tmesh(8), jmesh(8), **kw)
        _assert_stream(got, one)
        _assert_stream(got, want)
        with pytest.raises(ValueError, match="channel mesh axis"):
            et.run_survey_mvbs_from_raw(mesh=tmesh(8, 2), device="cpu", **kw)
        with pytest.raises(ValueError, match="channel mesh axis"):
            js.run_survey_mvbs_from_raw(mesh=jmesh(8, 2), **kw)

    def test_noise_masks(self, ek60_files):
        """The two-pass route hands the mesh on to run_survey_mvbs."""
        kw = dict(self.KW, raw_files=ek60_files[:2], noise_masks=RAW_SPEC)
        got, one, want = _three(et.run_survey_mvbs_from_raw, js.run_survey_mvbs_from_raw,
                                tmesh(8, 2), jmesh(8, 2), **kw)
        _assert_stream(got, one)
        _assert_stream(got, want)

    def test_azfp(self, tmp_path):
        xml = tmp_path / "instrument.XML"
        write_azfp_xml(xml)
        raws = []
        for m in range(2):
            raws.append(str(tmp_path / f"2103151{m}.01A"))
            write_azfp_raw(raws[-1], n_pings=11, seed=m, minute=m)
        got, one, want = _three(et.run_survey_mvbs_from_raw, js.run_survey_mvbs_from_raw,
                                tmesh(8, 2), jmesh(8, 2), raw_files=raws, sonar_model="AZFP",
                                xml_path=str(xml), range_bin="2m", ping_time_bin="5s",
                                chunk_pings=6, env_params={"salinity": 32.0, "pressure": 60.0})
        _assert_stream(got, one)
        _assert_stream(got, want)

    @pytest.mark.parametrize("bad", ["channels", "range"])
    def test_layout_errors(self, ek60_files, bad):
        """tests/test_survey.py:424-433: channels not divisible by the channel
        axis; a range axis in a streamer."""
        t, j = (tmesh(8, 4), jmesh(8, 4)) if bad == "channels" else (tmesh(8, 1, 2),
                                                                      jmesh(8, 1, 2))
        match = "divisible" if bad == "channels" else "range_axis=1"
        with pytest.raises(ValueError, match=match):
            et.run_survey_mvbs_from_raw(ek60_files[:1], mesh=t, device="cpu", **self.KW)
        with pytest.raises(ValueError, match=match):
            js.run_survey_mvbs_from_raw(ek60_files[:1], mesh=j, **self.KW)


@pytest.fixture(scope="module")
def ek80_files(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_mesh_ek80")
    bb = d / "BBM-D20210201-T000000.raw"
    write_ek80_raw(bb, n_pings=16, n_samples=64, with_power_channel=False,
                   with_cw_complex=False, extra_fm_channel=True)
    ep_cw = d / "EPCW-D20210201-T000000.raw"
    write_two_epoch_ek80(ep_cw, n_samples=200)
    ep_bb = d / "EPBB-D20210301-T000000.raw"
    write_two_epoch_bb(ep_bb)
    return {"bb": str(bb), "epochs_cw": str(ep_cw), "epochs_bb": str(ep_bb)}


class TestComplexStreamer:
    BB = dict(sonar_model="EK80", waveform_mode="BB", encode_mode="complex", range_bin="5m",
              ping_time_bin="5s", chunk_pings=6)

    @pytest.mark.parametrize("channel_axis", [1, 2])
    def test_bb_chunked(self, ek80_files, channel_axis):
        """tests/test_survey.py:491-505 (chunks of 6 round up to 8 on 8 blocks)."""
        got, one, want = _three(et.run_survey_mvbs_from_raw, js.run_survey_mvbs_from_raw,
                                tmesh(8, channel_axis), jmesh(8, channel_axis),
                                raw_files=[ek80_files["bb"]], **self.BB)
        _assert_stream(got, one)
        _assert_stream(got, want)

    @pytest.mark.parametrize("name, wm", [("epochs_cw", "CW"), ("epochs_bb", "BB")])
    def test_epochs(self, ek80_files, name, wm):
        """Multi-filter_time files (one complex channel) stream per (channel,
        epoch) unit; a channel axis of 2 does not divide their one channel."""
        kw = dict(self.BB, waveform_mode=wm, range_bin="1m", ping_time_bin="4s", chunk_pings=4)
        files = [ek80_files[name]]
        got, one, want = _three(et.run_survey_mvbs_from_raw, js.run_survey_mvbs_from_raw,
                                tmesh(8), jmesh(8), raw_files=files, **kw)
        _assert_stream(got, one)
        _assert_stream(got, want)
        with pytest.raises(ValueError, match="divisible"):
            et.run_survey_mvbs_from_raw(files, mesh=tmesh(8, 2), device="cpu", **kw)

    def test_epoch_units_on_a_channel_axis(self, ek80_files, monkeypatch):
        """A two-channel file streamed per (channel, epoch) unit on a channel
        axis of 2: each one-channel unit runs on the first channel column."""
        from echopype_torch.parallel import survey as ts

        monkeypatch.setattr(ts, "_n_filter_times", lambda ed: 2)
        files = [ek80_files["bb"]]
        got = et.run_survey_mvbs_from_raw(files, mesh=tmesh(8, 2), device="cpu", **self.BB)
        _assert_stream(got, et.run_survey_mvbs_from_raw(files, device="cpu", **self.BB))

    def test_device_fused_takes_the_chunked_path(self, ek80_files, monkeypatch):
        from echopype_torch.parallel import survey as ts

        warned = []
        monkeypatch.setattr(ts.logger, "warning", warned.append)
        monkeypatch.setattr(ts, "_run_complex_fused", lambda *a, **k: pytest.fail("fused"))
        got = et.run_survey_mvbs_from_raw([ek80_files["bb"]], mesh=tmesh(8), device_fused=True,
                                          device="cpu", **self.BB)
        assert any("no mesh path" in w for w in warned)
        _assert_stream(got, js.run_survey_mvbs_from_raw([ek80_files["bb"]], mesh=jmesh(8),
                                                        device_fused=True, **self.BB))

    def test_freq_diff(self, ek80_files):
        ed = et.open_raw(ek80_files["bb"], sonar_model="EK80")
        from echopype_torch.echodata.simrad import retrieve_correct_beam_group

        chans = [str(c) for c in ed[retrieve_correct_beam_group(ed, "BB", "complex")]
                 .coords["channel"].values]
        kw = dict(self.BB, raw_files=[ek80_files["bb"]],
                  freq_diff=f'"{chans[0]}" - "{chans[1]}" > 3.0dB')
        got, one, want = _three(et.run_survey_mvbs_from_raw, js.run_survey_mvbs_from_raw,
                                tmesh(8, 2), jmesh(8, 2), **kw)
        _assert_stream(got, one)
        _assert_stream(got, want)


class TestSvStreamers:
    @pytest.mark.parametrize("layout", sorted(LAYOUTS))
    def test_mvbs(self, layout):
        """tests/test_survey.py:368-405: two files, interior NaN blocks,
        chunks straddling bins and an uneven last chunk."""
        dss = [make_sv(n_ping=61, seed=1), make_sv(n_ping=37, seed=2,
                                                   t0=np.datetime64("2022-06-01T00:01:10"))]
        sv = np.asarray(dss[0]["Sv"].values).copy()
        sv[:, 3:7, 10:30] = np.nan
        dss[0]["Sv"] = (dss[0]["Sv"].dims, sv)
        jax_dss = [as_package(ds, ep.xrlite.Dataset) for ds in dss]
        kw = dict(range_bin="5m", ping_time_bin="20s", chunk_pings=14)
        got = et.run_survey_mvbs(dss, mesh=tmesh(*LAYOUTS[layout]), device="cpu", **kw)
        _assert_stream(got, et.run_survey_mvbs(dss, device="cpu", **kw))
        _assert_stream(got, js.run_survey_mvbs(jax_dss, mesh=jmesh(*LAYOUTS[layout]), **kw))

    def test_mvbs_per_ping_route(self):
        """A range grid that varies by ping: the per-ping route on the mesh
        equals one device (the JAX streamer's prefix sums differ there on
        purpose, ROADMAP Queue 3)."""
        ds = make_sv(n_ping=50, seed=4)
        er = np.asarray(ds["echo_range"].values)
        ds["echo_range"] = (ds["echo_range"].dims,
                            er * np.random.default_rng(4).uniform(0.97, 1.03, er.shape[:2])[..., None])
        kw = dict(range_bin="5m", ping_time_bin="20s", chunk_pings=12)
        got = et.run_survey_mvbs([ds], mesh=tmesh(8, 2), device="cpu", **kw)
        assert got.attrs["routes"] == ["per_ping"]
        _assert_stream(got, et.run_survey_mvbs([ds], device="cpu", **kw))

    @pytest.mark.parametrize("option", ["freq_diff", "noise_masks"])
    def test_mvbs_masked(self, option):
        """tests/test_survey_clean.py:95-112 and the freq-diff mask, applied
        before the blocks split."""
        jax_dss = _survey_files()
        port = [as_package(ds, TDataset) for ds in jax_dss]
        chans = [str(c) for c in port[0].coords["channel"].values]
        extra = ({"noise_masks": MASK_SPEC} if option == "noise_masks"
                 else {"freq_diff": f'"{chans[1]}" - "{chans[0]}" > 3.0dB'})
        kw = dict(range_bin="5m", ping_time_bin="6s", chunk_pings=10, **extra)
        got = et.run_survey_mvbs(port, mesh=tmesh(8, 2), device="cpu", **kw)
        _assert_stream(got, et.run_survey_mvbs(port, device="cpu", **kw))
        _assert_stream(got, js.run_survey_mvbs(jax_dss, mesh=jmesh(8, 2), **kw))

    @pytest.mark.parametrize("layout", sorted(LAYOUTS))
    @pytest.mark.parametrize("masks", [False, True], ids=["plain", "noise_masks"])
    def test_nasc(self, layout, masks):
        """tests/test_survey_nasc.py:70-86: 61 + 45 pings, chunks of 16."""
        dss = [make_sv(n_ping=61, seed=5),
               make_sv(n_ping=45, seed=6, t0=np.datetime64("2022-06-01T00:02:00", "ns"),
                       lat0=45.0 + 62 * 3e-4)]
        jax_dss = [as_package(ds, ep.xrlite.Dataset) for ds in dss]
        kw = dict(range_bin="10m", dist_bin="0.1nmi", chunk_pings=16)
        if masks:
            kw["noise_masks"] = {"impulse": MASK_SPEC["impulse"]}
        got = et.run_survey_nasc(dss, mesh=tmesh(*LAYOUTS[layout]), device="cpu", **kw)
        nasc = dict(var="NASC", rtol=1e-5, atol=1e-8)
        _assert_stream(got, et.run_survey_nasc(dss, device="cpu", **kw), **nasc)
        _assert_stream(got, js.run_survey_nasc(jax_dss, mesh=jmesh(*LAYOUTS[layout]), **kw),
                       **nasc)

    def test_nasc_per_ping_route(self):
        ds = make_sv(n_ping=50, seed=7)
        dep = np.asarray(ds["depth"].values)
        ds["depth"] = (ds["depth"].dims,
                       dep * np.random.default_rng(7).uniform(0.97, 1.03, dep.shape[:2])[..., None])
        kw = dict(range_bin="10m", dist_bin="0.1nmi", chunk_pings=12)
        got = et.run_survey_nasc([ds], mesh=tmesh(8, 2), device="cpu", **kw)
        assert got.attrs["routes"] == ["per_ping"]
        _assert_stream(got, et.run_survey_nasc([ds], device="cpu", **kw), var="NASC",
                       rtol=1e-5, atol=1e-8)

    def test_layout_errors(self):
        for bad, match in (((8, 4), "divisible"), ((8, 1, 2), "range_axis=1")):
            with pytest.raises(ValueError, match=match):
                et.run_survey_mvbs([make_sv()], mesh=tmesh(*bad), device="cpu")
            with pytest.raises(ValueError, match=match):
                et.run_survey_nasc([make_sv()], mesh=tmesh(*bad), device="cpu")
