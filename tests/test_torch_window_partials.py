"""Port parity: the survey window step (K1 / K2 and their host helpers).

The plain PyTorch twins of the CUDA kernels (echopype_torch/ops/
window_partials.py), reached through the JAX-signature functions in
echopype_torch/parallel/pipeline.py, are held against the JAX package's XLA
functions and its Pallas kernels run with ``interpret=True``, on the same
numpy inputs: counts exact, sums within rtol 3e-6 (the reference's own
tolerance, tests/test_parallel.py:440-442).  The host bound/count helpers
must equal the JAX package's bit for bit.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from echopype_torch.ops import window_partials as wp
from echopype_torch.ops.binning import banded_x_reduce
from echopype_torch.parallel import pipeline as tp
from echopype_tpu.ops import binning as jb
from echopype_tpu.ops.pallas_window import window_partials_pallas, window_partials_pallas_uniform
from echopype_tpu.parallel import pipeline as jp

torch.set_num_threads(1)

RTOL, ATOL = 3e-6, 1e-30


def _np(t):
    return t.cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _uniform_inputs(seed=3):
    """tests/test_parallel.py:390-401."""
    rng = np.random.default_rng(seed)
    C, Pn, R, n_r, W = 2, 256, 300, 7, 4
    power = rng.integers(-12000, -2000, (C, Pn, R)).astype(np.int16)
    dr = np.tile(rng.uniform(0.15, 0.25, (C, 1)).astype("f4"), (1, Pn))
    tvg = 2 * dr
    ab = np.full((C, Pn), 0.01, "f4")
    off = rng.normal(-30, 2, (C, Pn)).astype("f4")
    vl = (np.full((C, Pn), R) - rng.integers(0, 5, (C, Pn))).astype("i4")
    x_rel = np.sort(rng.integers(0, W, Pn)).astype("i4")
    r_edges = np.linspace(0, 0.25 * R, n_r + 1).astype("f4")
    return power, dr, tvg, ab, off, vl, x_rel, r_edges, W, n_r


def _varying_inputs(seed=0, vary_dr=False):
    """tests/test_parallel.py:255-265; ``vary_dr`` gives each ping its own
    dr and TVG shift (the files K2 exists for)."""
    rng = np.random.default_rng(seed)
    C, P, R = 2, 128, 256
    n_x, n_r = 4, 5
    power = rng.integers(-12000, -2000, (C, P, R), dtype=np.int16)
    dr = np.full((C, P), 0.19, "f4")
    if vary_dr:
        dr = (dr * rng.uniform(0.97, 1.03, (C, P))).astype("f4")
    shift = (2 * dr).astype("f4")
    ab = np.full((C, P), 0.01, "f4")
    off = rng.normal(-30, 2, (C, P)).astype("f4")
    vl = rng.integers(R // 2, R + 1, (C, P)).astype("i4")
    x_rel = np.sort(rng.integers(0, n_x, P)).astype("i4")
    r_edges = np.linspace(0, 0.19 * R, n_r + 1).astype("f4")
    return power, dr, shift, ab, off, vl, x_rel, r_edges, n_x, n_r


@pytest.fixture(autouse=True)
def _no_launches():
    """On the CPU the wrappers run their plain twins: no kernel launches."""
    wp.reset_launches()
    yield
    assert wp.LAUNCHES == {"window_partials_uniform": 0, "window_partials": 0}


class TestUniformK1:
    def test_matches_xla(self):
        args = _uniform_inputs()
        s0, c0 = jp.sv_mvbs_window_partials_uniform(*[jnp.asarray(a) for a in args[:8]], *args[8:])
        s1, c1 = tp.sv_mvbs_window_partials_uniform(*args, device="cpu")
        np.testing.assert_array_equal(_np(c1), np.asarray(c0))
        np.testing.assert_allclose(_np(s1), np.asarray(s0), rtol=RTOL, atol=ATOL)

    def test_sums_only_equals_with_counts(self):
        args = _uniform_inputs(seed=8)
        s_only = tp.sv_mvbs_window_partials_uniform(*args, with_counts=False, device="cpu")
        s, _ = tp.sv_mvbs_window_partials_uniform(*args, device="cpu")
        np.testing.assert_array_equal(_np(s_only), _np(s))

    def test_matches_pallas_interpret(self):
        """Same host rows as tests/test_parallel.py:421-439, into both."""
        power, dr, tvg, ab, off, vl, x_rel, r_edges, W, n_r = _uniform_inputs()
        R = power.shape[2]
        dr0, sh0 = jnp.asarray(dr[:, 0]), jnp.asarray(tvg[:, 0])
        k = jnp.arange(R, dtype=jnp.float32)[None, :]
        rt = k * dr0[:, None] - sh0[:, None]
        k0 = jp._refine_k0(jnp.floor(sh0 / dr0) + 1.0, dr0, sh0)
        sprd = jnp.where(k >= k0[:, None], 20.0 * jnp.log10(jnp.maximum(rt, 1e-20)), -jnp.inf)
        edges = jnp.asarray(r_edges)[None, :]
        bounds = jnp.clip(jp._refine_bounds(jnp.ceil(edges / dr0[:, None]), dr0, edges),
                          k0[:, None], R)
        s_p, c_p = window_partials_pallas_uniform(
            jnp.asarray(power), sprd, 2.0 * rt, jnp.asarray(ab), jnp.asarray(off),
            jnp.asarray(vl.astype("f4")), jnp.asarray(x_rel), bounds, W, n_r,
            tile_p=128, interpret=True)
        ops = tp.kernel_inputs_from_numpy(power, dr, tvg, ab, off, vl, x_rel, r_edges, W,
                                          uniform=True, device="cpu")
        np.testing.assert_array_equal(_np(ops["bounds"]), np.asarray(bounds).astype("i4"))
        s_t, c_t = wp.window_partials_uniform(**ops)
        np.testing.assert_array_equal(_np(c_t), np.asarray(c_p))
        np.testing.assert_allclose(_np(s_t), np.asarray(s_p), rtol=RTOL, atol=ATOL)

    def test_parked_and_ragged_pings(self):
        """Pings parked past the window and short valid lengths join nothing."""
        power, dr, tvg, ab, off, vl, x_rel, r_edges, W, n_r = _uniform_inputs(seed=4)
        x_rel = x_rel.copy()
        x_rel[-20:] = W  # parked padding
        vl = vl.copy()
        vl[:, ::7] = 0
        vl[:, 1::5] = 17
        args = (power, dr, tvg, ab, off, vl, x_rel, r_edges, W, n_r)
        s0, c0 = jp.sv_mvbs_window_partials_uniform(*[jnp.asarray(a) for a in args[:8]], W, n_r)
        s1, c1 = tp.sv_mvbs_window_partials_uniform(*args, device="cpu")
        np.testing.assert_array_equal(_np(c1), np.asarray(c0))
        np.testing.assert_allclose(_np(s1), np.asarray(s0), rtol=RTOL, atol=ATOL)


class TestPerPingK2:
    @pytest.mark.parametrize("vary_dr", [False, True])
    def test_matches_xla(self, vary_dr):
        args = _varying_inputs(vary_dr=vary_dr)
        s0, c0 = jp.sv_mvbs_window_partials(*[jnp.asarray(a) for a in args[:8]], *args[8:])
        s1, c1 = tp.sv_mvbs_window_partials(*args, device="cpu")
        np.testing.assert_array_equal(_np(c1), np.asarray(c0))
        np.testing.assert_allclose(_np(s1), np.asarray(s0), rtol=RTOL, atol=ATOL)

    @pytest.mark.parametrize("vary_dr", [False, True])
    def test_matches_pallas_interpret(self, vary_dr):
        """Pallas inputs built as in tests/test_parallel.py:266-275."""
        power, dr, shift, ab, off, vl, x_rel, r_edges, n_x, n_r = _varying_inputs(vary_dr=vary_dr)
        R = power.shape[2]
        k0 = np.maximum(np.floor(shift.astype("f8") / dr.astype("f8")) + 1, 0).astype("f4")
        bounds = np.clip(
            np.ceil(r_edges[None, :].astype("f8") / dr[:, 0:1].astype("f8")), 0, R
        ).astype("f4")
        s_p, c_p = window_partials_pallas(
            power, dr, shift, ab, off, k0, vl.astype("f4"), x_rel, bounds,
            n_x, n_r, tile_p=64, interpret=True,
        )
        ops = tp.kernel_inputs_from_numpy(power, dr, shift, ab, off, vl, x_rel, r_edges, n_x,
                                          uniform=False, device="cpu")
        np.testing.assert_array_equal(_np(ops["k0"]), k0.astype("i4"))
        np.testing.assert_array_equal(_np(ops["bounds"]), bounds.astype("i4"))
        s_t, c_t = wp.window_partials(**ops)
        np.testing.assert_array_equal(_np(c_t), np.asarray(c_p))
        np.testing.assert_allclose(_np(s_t), np.asarray(s_p), rtol=RTOL, atol=ATOL)

    def test_uniform_file_k1_equals_k2(self):
        """On a uniform-dr chunk both kernels' twins give the same bins."""
        args = _uniform_inputs(seed=6)
        s1, c1 = tp.sv_mvbs_window_partials_uniform(*args, device="cpu")
        s2, c2 = tp.sv_mvbs_window_partials(*args, device="cpu")
        np.testing.assert_array_equal(_np(c1), _np(c2))
        np.testing.assert_allclose(_np(s1), _np(s2), rtol=RTOL, atol=ATOL)


class TestHostHelpers:
    def test_closed_bounds_k0_bit_identical(self):
        rng = np.random.default_rng(1234)
        for _ in range(8):
            C = int(rng.integers(1, 5))
            R = int(rng.integers(10, 4000))
            dr0 = rng.uniform(0.05, 0.4, C).astype("f4")
            sh0 = (dr0 * rng.integers(0, 4, C)).astype("f4")
            r_edges = np.arange(int(rng.integers(2, 60))) * float(rng.uniform(1.0, 8.0))
            b_t, k_t = tp.closed_bounds_k0_np(dr0, sh0, r_edges, R)
            b_j, k_j = jp.closed_bounds_k0_np(dr0, sh0, r_edges, R)
            assert b_t.dtype == b_j.dtype and k_t.dtype == k_j.dtype
            np.testing.assert_array_equal(b_t, b_j)
            np.testing.assert_array_equal(k_t, k_j)

    def test_refine_k0_matches_jax(self):
        """The knife-edge inputs of tests/test_parallel.py::TestRefineK0."""
        rng = np.random.default_rng(11)
        dr = np.concatenate([rng.uniform(0.05, 0.5, 200).astype("f4"), np.full(56, 0.19, "f4")])
        k_true = rng.integers(0, 50, dr.size)
        shift = np.where(
            rng.random(dr.size) < 0.5,
            (k_true * dr.astype("f8")).astype("f4"),
            (k_true * dr.astype("f8") + rng.uniform(0, 1, dr.size) * dr).astype("f4"),
        )
        quot = (shift.astype("f8") / dr.astype("f8")).astype("f4")
        for direction in (-np.inf, None, np.inf):
            qp = quot if direction is None else np.nextafter(quot, np.float32(direction))
            q = (np.floor(qp) + 1.0).astype("f4")
            want = np.asarray(jp._refine_k0(jnp.asarray(q), jnp.asarray(dr), jnp.asarray(shift)))
            np.testing.assert_array_equal(tp._refine_k0(q, dr, shift), want)
        np.testing.assert_array_equal(
            tp.closed_k0_np(dr, shift),
            np.asarray(jp._refine_k0(jnp.floor(jnp.asarray(shift) / jnp.asarray(dr)) + 1.0,
                                     jnp.asarray(dr), jnp.asarray(shift))),
        )

    def test_closed_window_counts_bit_identical(self):
        rng = np.random.default_rng(7)
        for trial in range(6):
            C, P, R = int(rng.integers(1, 5)), int(rng.integers(4, 40)), int(rng.integers(10, 200))
            n_x, n_r = int(rng.integers(1, 6)), int(rng.integers(2, 30))
            dr0 = rng.uniform(0.05, 0.4, C).astype("f4")
            valid_len = rng.integers(0, R + 1, (C, P)).astype("i4")
            if trial % 2 == 0:
                valid_len[:] = R
            x_rel = np.sort(rng.integers(0, n_x + 1, P)).astype("i4")
            r_edges = (np.arange(n_r + 1) * float(rng.uniform(1.0, 8.0))).astype("f4")
            bounds, k0 = jp.closed_bounds_k0_np(dr0, 2 * dr0, r_edges, R)
            np.testing.assert_array_equal(
                tp.closed_window_counts_np(bounds, k0, valid_len, x_rel, n_x),
                jp.closed_window_counts_np(bounds, k0, valid_len, x_rel, n_x),
            )

    def test_banded_x_reduce_matches_jax(self):
        rng = np.random.default_rng(2)
        blocks = rng.normal(size=(3, 50, 9)).astype("f4")
        W = 6
        x_rel = np.sort(rng.integers(0, W + 2, 50)).astype("i4")  # some parked past W
        want = np.asarray(jb.banded_x_reduce(jnp.asarray(blocks), jnp.asarray(x_rel), W))
        xb = np.searchsorted(x_rel, np.arange(W + 1), side="left")
        got = banded_x_reduce(torch.from_numpy(blocks), torch.from_numpy(xb))
        np.testing.assert_allclose(_np(got), want, rtol=1e-6, atol=1e-6)


class TestDispatch:
    def test_power_must_be_int16(self):
        args = list(_uniform_inputs())
        args[0] = args[0].astype("f4")
        with pytest.raises(TypeError, match="int16"):
            tp.sv_mvbs_window_partials_uniform(*args, device="cpu")

    def test_rejects_unsorted_ids_and_bad_lengths(self):
        args = list(_uniform_inputs())
        bad_x = args[6][::-1].copy()
        with pytest.raises(ValueError, match="non-decreasing"):
            tp.sv_mvbs_window_partials_uniform(*args[:6], bad_x, *args[7:], device="cpu")
        bad_vl = args[5] + 10
        with pytest.raises(ValueError, match="valid_len"):
            tp.sv_mvbs_window_partials_uniform(*args[:5], bad_vl, *args[6:], device="cpu")

    def test_n_r_mismatch_raises(self):
        args = list(_uniform_inputs())
        with pytest.raises(ValueError, match="n_r"):
            tp.sv_mvbs_window_partials_uniform(*args[:9], args[9] + 1, device="cpu")

    def test_other_devices_raise(self):
        ops = tp.kernel_inputs_from_numpy(*_uniform_inputs()[:9], uniform=True, device="cpu")
        meta = {k: v.to("meta") for k, v in ops.items()}
        with pytest.raises(ValueError, match="cuda or cpu"):
            wp.window_partials_uniform(**meta)

    def test_cuda_request_without_cuda_raises(self):
        if torch.cuda.is_available():
            pytest.skip("a CUDA device is present; this checks the no-fallback rule")
        with pytest.raises(RuntimeError, match="cuda"):
            tp.sv_mvbs_window_partials_uniform(*_uniform_inputs())


def _plan_parts(plan, xb):
    """Slab ping bounds ``sb`` (slab s is pings [sb[s], sb[s+1])) and each
    window's first slab ``wf``, as the kernels read ``slab_plan(xb)``."""
    xb = np.asarray(xb, dtype="i8")
    W = xb.size - 1
    n_slabs = plan.size - W - 1
    sw, wf = plan[:n_slabs].astype("i8"), plan[n_slabs:].astype("i8")
    i, n = np.arange(n_slabs) - wf[sw], np.diff(wf)[sw]
    sb = np.append(xb[sw] + i * np.diff(xb)[sw] // n, xb[-1])
    return sb, wf


class TestSlabPlan:
    """ops/window_partials.py::slab_plan, the host work split of K1 / K2:
    slabs tile every window, never cross one, hold at most SLAB_PINGS pings,
    and every window (empty ones too) owns at least one slab.  The slab
    length is the module's constant, set here per case."""

    @pytest.mark.parametrize("xb", [
        [0, 5000],                                   # W = 1: one long window
        list(range(0, 301)),                         # W = P: one ping a window
        [0, 20, 20, 20, 75, 75, 190, 191, 191],      # empty windows between
        [13, 13],                                    # one empty window
        [7],                                         # W = 0
        [3, 35, 67, 68],                             # windows of exactly 32 pings
    ], ids=["one_window", "ping_per_window", "empty_windows", "only_empty", "no_window",
            "slab_sized"])
    @pytest.mark.parametrize("slab_pings", [1, 16, wp.SLAB_PINGS])
    def test_tiles_windows(self, xb, slab_pings, monkeypatch):
        monkeypatch.setattr(wp, "SLAB_PINGS", slab_pings)
        xb = np.asarray(xb)
        W = xb.size - 1
        plan = wp.slab_plan(xb)
        assert plan.dtype == np.int32
        sb, wf = _plan_parts(plan, xb)
        assert sb[0] == xb[0] and sb[-1] == xb[-1] and np.all(np.diff(sb) >= 0)
        assert wf[0] == 0 and wf[-1] == sb.size - 1 and np.all(np.diff(wf) >= 1)
        assert np.all(np.diff(sb) <= slab_pings)
        for w in range(W):  # window w's slabs start and end on its bounds
            assert sb[wf[w]] == xb[w] and sb[wf[w + 1]] == xb[w + 1]
            lens = np.diff(sb[wf[w]: wf[w + 1] + 1])
            n = max(1, -(-(xb[w + 1] - xb[w]) // slab_pings))
            assert lens.size == n and lens.max() - lens.min() <= 1  # near-equal slabs

    def test_one_window_fills_the_card(self):
        """W = 1 still gives P / SLAB_PINGS blocks a channel."""
        plan = wp.slab_plan([0, 5000])
        assert plan.size - 1 - 1 == -(-5000 // wp.SLAB_PINGS)

    def test_one_slab_per_window_is_direct(self):
        """Windows of at most SLAB_PINGS pings: slab s is window s (the
        kernel then writes the outputs directly, no combine pass)."""
        xb = np.array([0, 20, 20, 52, 60])
        plan = wp.slab_plan(xb)
        np.testing.assert_array_equal(plan[:4], np.arange(4))  # slab s is window s
        sb, wf = _plan_parts(plan, xb)
        np.testing.assert_array_equal(sb, xb)
        np.testing.assert_array_equal(wf, np.arange(5))

    @pytest.mark.parametrize("xb", [[], [[0, 1]], [0, 5, 3]])
    def test_rejects_bad_bounds(self, xb):
        with pytest.raises(ValueError):
            wp.slab_plan(np.asarray(xb))


def _kernel_model(ops, uniform):
    """The CUDA kernels' decomposition in float64 numpy: per (channel, slab)
    per-sample sums over the slab's pings, masked k0 <= k < valid_len, then
    range-bin sums; closed-form int counts per slab; slab partials added in
    slab order per window."""
    o = {k: _np(v) for k, v in ops.items()}
    power = o["power"].astype("f8")
    C, P, R = power.shape
    bounds, vl = o["bounds"], o["valid_len"]
    W = o["xb"].size - 1
    sb, wf = _plan_parts(o["plan"], o["xb"])
    k = np.arange(R)
    if uniform:
        sv = (power * wp.INDEX2POWER + o["sprd_row"][:, None, :]
              + o["absorption"][..., None] * o["rt2_row"][:, None, :] + o["offset"][..., None])
        k0 = np.zeros((C, P), "i8")
    else:
        r = k * o["dr"][..., None].astype("f8") - o["tvg_shift"][..., None]
        sv = (power * wp.INDEX2POWER + 20 * np.log10(np.maximum(r, 1e-20))
              + 2 * o["absorption"][..., None] * r + o["offset"][..., None])
        k0 = o["k0"]
    valid = (k >= k0[..., None]) & (k < vl[..., None])
    lin = np.where(valid, np.exp(sv * wp.LN10_OVER_10), 0.0)
    n_slabs, n_r = sb.size - 1, bounds.shape[1] - 1
    ps = np.zeros((C, n_slabs, n_r))
    pc = np.zeros((C, n_slabs, n_r), "i8")
    for c in range(C):
        for s in range(n_slabs):
            per_sample = lin[c, sb[s]: sb[s + 1]].sum(axis=0)
            for b in range(n_r):
                lo, hi = bounds[c, b], bounds[c, b + 1]
                ps[c, s, b] = per_sample[lo:hi].sum()
                pc[c, s, b] = np.maximum(
                    0, np.minimum(hi, vl[c, sb[s]: sb[s + 1]])
                    - np.maximum(lo, k0[c, sb[s]: sb[s + 1]])).sum()
    sums = np.stack([ps[:, wf[w]: wf[w + 1]].sum(axis=1) for w in range(W)], axis=1)
    counts = np.stack([pc[:, wf[w]: wf[w + 1]].sum(axis=1) for w in range(W)], axis=1)
    return sums, counts


class TestKernelDecomposition:
    """What the CUDA kernels compute (slabs, per-sample sums, closed-form
    counts, slab partials combined) equals the plain twins on the CPU:
    counts exact, sums within RTOL (float64 model against float32 twin)."""

    @pytest.mark.parametrize("uniform", [True, False], ids=["K1", "K2"])
    @pytest.mark.parametrize("ids", ["windows", "one_window", "ping_per_window"])
    def test_model_matches_twin(self, uniform, ids):
        args = list(_varying_inputs(seed=4, vary_dr=not uniform)[:-1])
        P = args[0].shape[1]
        if ids == "one_window":
            args[6], args[8] = np.zeros(P, "i4"), 1
        elif ids == "ping_per_window":
            args[6], args[8] = np.arange(P, dtype="i4"), P
        args[6] = args[6].copy()
        args[6][-3:] = args[8]  # parked padding past the last window
        ops = tp.kernel_inputs_from_numpy(*args, uniform=uniform, device="cpu")
        twin = (wp.window_partials_uniform_plain if uniform else wp.window_partials_plain)(
            **{k: v for k, v in ops.items() if k != "plan"})
        sums, counts = _kernel_model(ops, uniform)
        np.testing.assert_array_equal(counts, _np(twin[1]))
        np.testing.assert_allclose(sums, _np(twin[0]), rtol=RTOL, atol=ATOL)
