"""The CUDA kernels (K1 / K2 window partials, K3 / K4 fused Sv + bin
partials) against their plain PyTorch twins, on the card.

Needs a CUDA device and nvcc; marked ``gpu`` and skipped elsewhere.  This
file imports neither jax nor the JAX package, so it also runs where JAX is
not installed:

    python -m pytest --noconftest -m gpu tests/test_torch_kernels_gpu.py -q

(``--noconftest`` skips tests/conftest.py, which sets up JAX.)  Small
shapes with the edge cases the survey produces: empty window bins, pings
parked past the window, short and zero valid lengths, a first valid sample
past bin edges; for K3 / K4 ragged NaN pings, interior NaNs, whole NaN
pings, a TVG shift off the sample grid, rows longer than one shared-memory
segment, and pings outside the ping bins.  K1 / K2 also at the slab
plan's edges: one window (many slabs), one ping a window, windows longer
than one slab, and rows of R = 4001 (not 16-byte aligned: scalar loads).
Their float32 dB instances (the AZFP path's type) the same way, with NaN
rows (suffix, whole ping, inside a ping) at R = 4001, 1000 (the AZFP
width) and 1004 (rows ending mid-thread), one ping, one window and long
windows, and the AZFP chunk step with the echo_range intercept against
the CPU.
K4 also at its work split's edges (bins narrower than a thread's 16
samples, one-sample, empty and clipped bins, R = 4001 and 9000, P = 1 and
P = 33), and K3 / K4 on poisoned rows (a valid sample whose linear value
is not finite), where NaN / inf masks must equal the twins'.
Counts exact, sums within rtol 1e-5 (float32 sums in another order), Sv
within rtol / atol 1e-5 with identical NaN masks, reruns bit-identical, one
launch counted per call; K1 / K2 give the same partials under another slab
split of the same windows.

The Sv-store streamers' plain-torch binning (``binned_window_partials_grid``,
``binned_window_row_sum``, and the per-ping route's per-sample scatter-add
in ``binned_window_partials`` / ``binned_window_sum_raw``) runs
on the card against ``device="cpu"`` at a full-width chunk, 5 x 5,000 x
4,000 float32: counts exact, sums within rtol 1e-5; the per-ping route run
twice on such a chunk is bit-identical.

EK80: the matched filter (``ops/matched_filter.py``) on the card at 2,000
pings x 4 sectors x 8,192 samples against the host float64 convolution,
with TF32 off inside its matmul (float32 and float64 products); its bf16
split products ("HIGH", "DEFAULT") against their plain version on the CPU
within 2e-6 of scale, and HIGH raising where the card's bf16 product does
not run; the fused BB chunk
(``ops/bb_pipeline.py``) run twice bit-identical and against the CPU.

Masks: each window program of ``ops/windows.py`` (pooled transient mask on
host membership runs and on value bands, impulse mask, per-ping depth
binning, attenuated mask) and the freq-diff survey step run twice
bit-identical on the card and against the CPU (Sv within 1e-4 dB with the
same NaN mask, masks equal, counts exact); the float64 pooling of a grid
that varies by ping equals the CPU bit for bit.
"""

import numpy as np
import pytest
import torch

from echopype_torch.ops import binning as tb
from echopype_torch.ops import sv_bin_partials as sbp
from echopype_torch.ops import window_partials as wp
from echopype_torch.parallel import pipeline as tp
from echopype_torch.parallel.pipeline import kernel_inputs_from_numpy

pytestmark = pytest.mark.gpu

torch.set_num_threads(1)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _chunk(seed, C=3, P=300, R=700, W=9, vary_dr=False, ids=None):
    rng = np.random.default_rng(seed)
    power = rng.integers(-12000, -2000, (C, P, R)).astype(np.int16)
    dr = np.tile(rng.uniform(0.15, 0.25, (C, 1)), (1, P)).astype("f4")
    if vary_dr:
        dr = (dr * rng.uniform(0.97, 1.03, (C, P))).astype("f4")
    shift = (dr * rng.integers(0, 12, (C, 1))).astype("f4")
    ab = rng.uniform(0.001, 0.05, (C, P)).astype("f4")
    off = rng.normal(-30, 2, (C, P)).astype("f4")
    vl = np.full((C, P), R, "i4")
    vl[:, ::11] = rng.integers(0, R, vl[:, ::11].shape)
    vl[:, ::29] = 0
    if ids is None:
        ids = np.sort(rng.integers(0, W - 2, P))  # the last window bins stay empty
        ids[-15:] = W  # parked padding
    edges = np.arange(0, 0.25 * R + 7.0, 7.0).astype("f4")
    return power, dr, shift, ab, off, vl, ids.astype("i4"), edges, W


def _compare(kernel, plain, counted, ops):
    wp.reset_launches()
    got = kernel(**ops)
    again = kernel(**ops)
    torch.cuda.synchronize()
    assert wp.LAUNCHES[counted] == 2
    want = plain(**{k: v for k, v in ops.items() if k != "plan"})
    for g, a in zip(got, again):
        assert torch.equal(g, a), "rerun not bit-identical"
    s_g, c_g = (t.cpu().numpy() for t in got)
    s_w, c_w = (t.cpu().numpy() for t in want)
    np.testing.assert_array_equal(c_g, c_w)
    np.testing.assert_allclose(s_g, s_w, rtol=1e-5, atol=1e-30)
    # another work split of the same windows (a slab a ping): the same
    # windows' partials, the sums added in another order
    saved, wp.SLAB_PINGS = wp.SLAB_PINGS, 1
    try:
        per_ping = torch.from_numpy(wp.slab_plan(ops["xb"].cpu().numpy())).to(ops["plan"].device)
    finally:
        wp.SLAB_PINGS = saved
    s_o, c_o = (t.cpu().numpy() for t in kernel(**{**ops, "plan": per_ping}))
    np.testing.assert_array_equal(c_o, c_g)
    np.testing.assert_allclose(s_o, s_g, rtol=1e-5, atol=1e-30)
    return c_g


@pytest.mark.parametrize("seed", [0, 1])
def test_k1_matches_plain(cuda, seed):
    args = _chunk(seed)
    ops = kernel_inputs_from_numpy(*args, uniform=True, device=cuda)
    c_g = _compare(wp.window_partials_uniform, wp.window_partials_uniform_plain,
                   "window_partials_uniform", ops)
    assert (c_g > 0).any() and (c_g == 0).any()
    sums_only = wp.window_partials_uniform(**ops, with_counts=False)
    assert torch.equal(sums_only, wp.window_partials_uniform(**ops)[0])


@pytest.mark.parametrize("seed", [0, 1])
def test_k2_matches_plain(cuda, seed):
    args = _chunk(seed, vary_dr=True)
    ops = kernel_inputs_from_numpy(*args, uniform=False, device=cuda)
    c_g = _compare(wp.window_partials, wp.window_partials_plain, "window_partials", ops)
    assert (c_g > 0).any() and (c_g == 0).any()


# (P, R, W, ping-bin ids): the slab plan's edge cases
SLAB_CASES = {
    "one_window": (300, 700, 1, np.zeros(300, "i4")),           # ~10 slabs, combined
    "ping_per_window": (120, 700, 120, np.arange(120, dtype="i4")),  # one slab each, direct
    "long_windows": (300, 700, 3, np.repeat(np.arange(3), 100).astype("i4")),
    "unaligned_rows": (150, 4001, 4, np.sort(np.arange(150) % 4).astype("i4")),
}


@pytest.mark.parametrize("uniform", [True, False], ids=["K1", "K2"])
@pytest.mark.parametrize("case", sorted(SLAB_CASES))
def test_slab_plan_edges_match_plain(cuda, uniform, case):
    P, R, W, ids = SLAB_CASES[case]
    ops = kernel_inputs_from_numpy(*_chunk(7, P=P, R=R, W=W, vary_dr=not uniform, ids=ids),
                                   uniform=uniform, device=cuda)
    if uniform:
        c_g = _compare(wp.window_partials_uniform, wp.window_partials_uniform_plain,
                       "window_partials_uniform", ops)
        sums_only = wp.window_partials_uniform(**ops, with_counts=False)
        assert torch.equal(sums_only, wp.window_partials_uniform(**ops)[0])
    else:
        c_g = _compare(wp.window_partials, wp.window_partials_plain, "window_partials", ops)
    assert (c_g > 0).any()


def test_cuda_and_cpu_dispatch_agree(cuda):
    args = _chunk(5)
    on_card = wp.window_partials_uniform(**kernel_inputs_from_numpy(*args, uniform=True,
                                                                    device=cuda))
    on_cpu = wp.window_partials_uniform(**kernel_inputs_from_numpy(*args, uniform=True,
                                                                   device="cpu"))
    np.testing.assert_array_equal(on_card[1].cpu().numpy(), on_cpu[1].numpy())
    np.testing.assert_allclose(on_card[0].cpu().numpy(), on_cpu[0].numpy(), rtol=1e-5)


def test_wrapper_rejects_bad_operands(cuda):
    ops = kernel_inputs_from_numpy(*_chunk(2), uniform=True, device=cuda)
    wp.reset_launches()
    with pytest.raises(TypeError, match="int16"):
        wp.window_partials_uniform(**{**ops, "power": ops["power"].double()})
    with pytest.raises(ValueError, match="contiguous"):
        wp.window_partials_uniform(**{**ops, "power": ops["power"].transpose(1, 2)
                                      .contiguous().transpose(1, 2)})
    with pytest.raises(ValueError, match="is on cpu"):
        wp.window_partials_uniform(**{**ops, "xb": ops["xb"].cpu()})
    with pytest.raises(ValueError, match="plan"):
        wp.window_partials_uniform(**{**ops, "plan": ops["plan"][:4].contiguous()})
    assert wp.LAUNCHES["window_partials_uniform"] == 0


def _chunk_f32(seed, **kw):
    """``_chunk`` as float32 dB power (the AZFP path's type): NaN past each
    valid length, one all-NaN ping, one NaN inside a ping; valid lengths
    recounted as the non-NaN samples."""
    power, dr, shift, ab, off, vl, ids, edges, W = _chunk(seed, **kw)
    vl[:, 0] = power.shape[2]  # ping 0 whole (``_chunk`` empties it), for P = 1
    db = (power * np.float32(wp.INDEX2POWER)).astype("f4")
    db[np.arange(db.shape[2])[None, None, :] >= vl[:, :, None]] = np.nan
    db[0, min(3, db.shape[1] - 1)] = np.nan
    db[-1, 0, min(40, db.shape[2] - 1)] = np.nan
    vl = (~np.isnan(db)).sum(axis=2).astype("i4")
    return db, dr, shift, ab, off, vl, ids, edges, W


# (P, R, W, ping-bin ids) of the float32 instances: rows not 16-byte
# aligned (scalar loads), the AZFP width, rows ending mid-thread (R % 8 ==
# 4: the second 16-byte load left out), one ping, one window, long windows
F32_CASES = {
    "unaligned_rows": (150, 4001, 4, np.sort(np.arange(150) % 4).astype("i4")),
    "azfp_width": (300, 1000, 9, None),
    "row_ends_mid_thread": (200, 1004, 5, np.sort(np.arange(200) % 5).astype("i4")),
    "one_ping": (1, 700, 1, np.zeros(1, "i4")),
    "one_window": (300, 700, 1, np.zeros(300, "i4")),
    "long_windows": (300, 700, 3, np.repeat(np.arange(3), 100).astype("i4")),
}


@pytest.mark.parametrize("uniform", [True, False], ids=["K1_f32", "K2_f32"])
@pytest.mark.parametrize("case", sorted(F32_CASES))
def test_f32_instances_match_plain(cuda, uniform, case):
    P, R, W, ids = F32_CASES[case]
    args = _chunk_f32(11, P=P, R=R, W=W, vary_dr=not uniform, ids=ids)
    ops = kernel_inputs_from_numpy(*args, uniform=uniform, device=cuda)
    assert ops["power"].dtype == torch.float32
    if uniform:
        c_g = _compare(wp.window_partials_uniform, wp.window_partials_uniform_plain,
                       "window_partials_uniform_f32", ops)
    else:
        c_g = _compare(wp.window_partials, wp.window_partials_plain, "window_partials_f32", ops)
    assert (c_g > 0).any()
    assert wp.LAUNCHES["window_partials_uniform"] == wp.LAUNCHES["window_partials"] == 0


def test_f32_r0_step_matches_cpu(cuda):
    """The AZFP chunk step (K2-f32 with the echo_range intercept) on the
    card against the same call on the CPU, and rerun bit-identical."""
    power, dr, shift, ab, off, vl, ids, edges, W = _chunk_f32(12, P=200, R=1000, W=6)
    shift = np.zeros_like(shift)
    r0 = np.tile(np.random.default_rng(3).uniform(0.3, 1.5, (power.shape[0], 1)),
                 (1, power.shape[1])).astype("f4")
    args = (power, dr, shift, ab, off, vl, ids, edges, W, len(edges) - 1)
    wp.reset_launches()
    on_card = tp.sv_mvbs_window_partials(*args, r0=r0, device=cuda)
    again = tp.sv_mvbs_window_partials(*args, r0=r0, device=cuda)
    assert wp.LAUNCHES["window_partials_f32"] == 2
    on_cpu = tp.sv_mvbs_window_partials(*args, r0=r0, device="cpu")
    for g, a in zip(on_card, again):
        assert torch.equal(g, a)
    np.testing.assert_array_equal(on_card[1].cpu().numpy(), on_cpu[1].numpy())
    np.testing.assert_allclose(on_card[0].cpu().numpy(), on_cpu[0].numpy(), rtol=1e-5,
                               atol=1e-30)


def _fused_chunk(seed, C=3, P=157, R=700, n_x=9):
    rng = np.random.default_rng(seed)
    power = rng.normal(-90.0, 12.0, (C, P, R)).astype("f4")
    for p in range(0, P, 13):
        power[:, p, int(rng.integers(0, R)):] = np.nan
    power[rng.random(power.shape) < 0.01] = np.nan
    power[1, 5 % P, :] = np.nan  # a whole NaN ping
    dr = np.tile(rng.uniform(0.15, 0.25, (C, 1)), (1, P)).astype("f4")
    shift = (dr * rng.uniform(0.5, 12.0, (C, 1))).astype("f4")
    ab = rng.uniform(0.001, 0.05, (C, P)).astype("f4")
    off = rng.normal(-30, 2, (C, P)).astype("f4")
    x_idx = np.sort(rng.integers(-1, n_x + 1, P)).astype("i4")  # some outside the bins
    edges = np.arange(0, 0.25 * R + 7.0, 7.0).astype("f4")
    return power, dr, shift, ab, off, x_idx, edges, n_x, len(edges) - 1


def _bits(t):
    """The bits of a float tensor (float32 or the binning's float64)."""
    return t.contiguous().view(torch.int32 if t.element_size() == 4 else torch.int64)


def _compare_fused(with_sv, ops):
    """Kernel vs twin on the card: counts exact, equal NaN / inf masks of
    the sums and the finite ones within rtol 1e-5, Sv within rtol / atol
    1e-5 with identical NaN masks, a rerun bit-identical, one launch a call."""
    kernel = sbp.sv_bin_partials if with_sv else sbp.mvbs_partials
    plain = sbp.sv_bin_partials_plain if with_sv else sbp.mvbs_partials_plain
    name = "sv_bin_partials" if with_sv else "mvbs_partials"
    sbp.reset_launches()
    got, again = kernel(**ops), kernel(**ops)
    torch.cuda.synchronize()
    assert sbp.LAUNCHES[name] == 2
    want = plain(**ops)
    for g, a in zip(got, again):
        assert torch.equal(_bits(g), _bits(a)), "rerun not bit-identical"
    if with_sv:
        sv_g, sv_w = got[0].cpu().numpy(), want[0].cpu().numpy()
        np.testing.assert_array_equal(np.isnan(sv_g), np.isnan(sv_w))
        np.testing.assert_allclose(sv_g, sv_w, rtol=1e-5, atol=1e-5)
    s_g, c_g = (t.cpu().numpy() for t in got[-2:])
    s_w, c_w = (t.cpu().numpy() for t in want[-2:])
    np.testing.assert_array_equal(c_g, c_w)
    np.testing.assert_array_equal(np.isnan(s_g), np.isnan(s_w))
    np.testing.assert_array_equal(np.isinf(s_g), np.isinf(s_w))
    fin = np.isfinite(s_w)
    np.testing.assert_allclose(s_g[fin], s_w[fin], rtol=1e-5, atol=1e-30)
    return s_g, c_g


@pytest.mark.parametrize("with_sv", [True, False], ids=["k3", "k4"])
@pytest.mark.parametrize("R", [700, 9000], ids=["one_segment", "three_segments"])
def test_fused_kernels_match_plain(cuda, with_sv, R):
    ops, _ = sbp.fused_operands(*_fused_chunk(R, R=R), device=cuda)
    _, c_g = _compare_fused(with_sv, ops)
    assert (c_g > 0).any() and (c_g == 0).any()


def _with_bounds(ops, rows):
    b = torch.tensor(np.asarray(rows, "i4"), device=ops["power"].device)
    return {**ops, "bounds": b.expand(ops["power"].shape[0], -1).contiguous()}


# K4's work split at its edges: (P, R, bounds or None for 7 m bins)
K4_CASES = {
    "narrow_bins": (157, 700, np.concatenate([[2], 2 + np.cumsum(np.arange(40) % 13)])),
    "one_sample_bins": (157, 700, np.concatenate([np.arange(50, 90), [300, 650]])),
    "empty_and_clipped": (157, 700, [0, 40, 40, 200, 200, 700, 700, 700]),
    "unaligned_rows": (40, 4001, None),
    "long_rows": (40, 9000, None),
    "one_ping": (1, 700, None),
    "partial_slab": (33, 4000, None),
}


@pytest.mark.parametrize("case", sorted(K4_CASES))
def test_k4_work_split_edges_match_plain(cuda, case):
    P, R, rows = K4_CASES[case]
    ops, _ = sbp.fused_operands(*_fused_chunk(3, P=P, R=R), device=cuda)
    if rows is not None:
        ops = _with_bounds(ops, rows)
    _, c_g = _compare_fused(False, ops)
    assert (c_g > 0).any()


@pytest.mark.parametrize("with_sv", [True, False], ids=["k3", "k4"])
def test_fused_kernels_spread_nonfinite_as_plain(cuda, with_sv):
    """Valid samples whose lin is not finite: NaN in every other bin of the
    ping, as the twins' (and the Pallas kernels') band product gives it."""
    power, dr, shift, ab, off, *rest = _fused_chunk(11, P=40, R=9000)
    power[0, 3, 400] = 600.0                         # inside a bin
    power[1, 4, 8990] = 600.0                        # at the row's end
    power[2, 5, 100] = power[2, 5, 5000] = 600.0     # two bins, two segments
    power[0, 6, 60] = power[0, 6, 61] = 600.0        # two in one bin
    off[1, 7] = np.nan                               # K4: every valid lin NaN
    ops, _ = sbp.fused_operands(power, dr, shift, ab, off, *rest, device=cuda)
    s_g, _ = _compare_fused(with_sv, ops)
    assert np.isnan(s_g).any() and np.isinf(s_g).any()
    narrow = _with_bounds(ops, np.concatenate([[50], 50 + np.cumsum(np.arange(60) % 9)]))
    _compare_fused(with_sv, narrow)
    _compare_fused(with_sv, _with_bounds(ops, [0, 300, 100, 700, 9000]))  # decreasing


def test_fused_cores_card_equals_cpu(cuda):
    args = _fused_chunk(7)
    sbp.reset_launches()
    sv_g, s_g, c_g = sbp.sv_mvbs_core_fused(*args, device=cuda)
    s4_g, c4_g = sbp.mvbs_core_fused(*args, device=cuda)
    assert sbp.LAUNCHES == {"sv_bin_partials": 1, "mvbs_partials": 1}
    sv_c, s_c, c_c = sbp.sv_mvbs_core_fused(*args, device="cpu")
    s4_c, c4_c = sbp.mvbs_core_fused(*args, device="cpu")
    np.testing.assert_allclose(sv_g.cpu().numpy(), sv_c.numpy(), rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(c_g.cpu().numpy(), c_c.numpy())
    np.testing.assert_array_equal(c4_g.cpu().numpy(), c4_c.numpy())
    np.testing.assert_allclose(s_g.cpu().numpy(), s_c.numpy(), rtol=1e-5, atol=1e-30)
    np.testing.assert_allclose(s4_g.cpu().numpy(), s4_c.numpy(), rtol=1e-5, atol=1e-30)


def test_fused_wrapper_rejects_bad_operands(cuda):
    ops, _ = sbp.fused_operands(*_fused_chunk(3), device=cuda)
    sbp.reset_launches()
    with pytest.raises(TypeError, match="float32"):
        sbp.sv_bin_partials(**{**ops, "power": ops["power"].double()})
    with pytest.raises(TypeError, match="int32"):
        sbp.mvbs_partials(**{**ops, "bounds": ops["bounds"].long()})
    with pytest.raises(ValueError, match="contiguous"):
        sbp.sv_bin_partials(**{**ops, "power": ops["power"].transpose(1, 2)
                               .contiguous().transpose(1, 2)})
    with pytest.raises(ValueError, match="is on cpu"):
        sbp.mvbs_partials(**{**ops, "dr": ops["dr"].cpu()})
    with pytest.raises(ValueError, match="shape"):
        sbp.sv_bin_partials(**{**ops, "offset": ops["offset"][:, :-1].contiguous()})
    assert sbp.LAUNCHES == {"sv_bin_partials": 0, "mvbs_partials": 0}


def _sv_chunk(seed, C=5, P=5000, R=4000, n_x=251, bin_m=20.0, vary=False):
    """A full-width Sv chunk with encoded range membership (the streamers'
    operands): ragged and interior NaNs, pings parked past the window."""
    rng = np.random.default_rng(seed)
    sv = rng.normal(-80.0, 15.0, (C, P, R)).astype("f4")
    sv[rng.random((C, P, R), dtype=np.float32) < 1e-3] = np.nan
    er = (np.arange(R) * 0.18944)[None, None] - 2.0
    er = er * rng.uniform(0.97, 1.03, (C, P, 1)) if vary else np.broadcast_to(er, (1, 1, R))
    edges = np.arange(0, R * 0.2 + bin_m, bin_m)
    x_rel = np.sort(rng.integers(0, n_x, P)).astype("i4")
    x_rel[-40:] = n_x
    return sv, er, edges, x_rel, n_x


def _to(dev, *arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)).to(dev) for a in arrays]


def _close(got, want):
    for g, w in zip(got, want):
        g, w = g.cpu().numpy(), w.numpy()
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-30)


@pytest.mark.parametrize("skipna", [True, False])
def test_grid_binning_card_equals_cpu(cuda, skipna):
    sv, er, edges, x_rel, n_x = _sv_chunk(11)
    row = np.broadcast_to(tb.exact_bin_encode_np(er, edges)[0][0], (5, er.shape[2]))
    enc_edges = np.arange(len(edges), dtype="f4")
    args = (sv, row, enc_edges, x_rel)
    got = tb.binned_window_partials_grid(*_to(cuda, *args), n_x, skipna=skipna)
    want = tb.binned_window_partials_grid(*_to("cpu", *args), n_x, skipna=skipna)
    np.testing.assert_array_equal(got[1].cpu().numpy(), want[1].numpy())
    _close(got, want)
    ddep = np.full(row.shape, 0.18944, "f4")
    h_args = (ddep[:, :-1], row[:, :-1], enc_edges, x_rel)
    _close([tb.binned_window_row_sum(*_to(cuda, *h_args), n_x)],
           [tb.binned_window_row_sum(*_to("cpu", *h_args), n_x)])


def test_rows_binning_card_equals_cpu(cuda):
    sv, er, edges, x_rel, n_x = _sv_chunk(12, P=2000, vary=True)
    enc, enc_edges = tb.exact_bin_encode_np(er, edges)[:2]
    args = (sv, enc, enc_edges, x_rel)
    got = tb.binned_window_partials(*_to(cuda, *args), n_x, skipna=False)
    want = tb.binned_window_partials(*_to("cpu", *args), n_x, skipna=False)
    np.testing.assert_array_equal(got[1].cpu().numpy(), want[1].numpy())
    _close(got, want)
    ddep = np.diff(er, axis=2).astype("f4")
    h_args = (ddep, enc[:, :, :-1], enc_edges, x_rel)
    _close([tb.binned_window_sum_raw(*_to(cuda, *h_args), n_x)],
           [tb.binned_window_sum_raw(*_to("cpu", *h_args), n_x)])


def test_per_ping_route_rerun_bit_identical(cuda):
    """The per-ping route (``binned_window_partials`` without ``uniform_er``:
    each sample added into its own bin) run twice on one full-width chunk,
    5 x 5,000 x 4,000 float32 on a ping-varying grid: sums and counts
    bit-identical."""
    sv, er, edges, x_rel, n_x = _sv_chunk(13, vary=True)
    enc, enc_edges = tb.exact_bin_encode_np(er, edges)[:2]
    args = _to(cuda, sv, enc, enc_edges, x_rel)
    first = tb.binned_window_partials(*args, n_x)
    second = tb.binned_window_partials(*args, n_x)
    torch.cuda.synchronize()
    for a, b in zip(first, second):
        assert torch.equal(_bits(a), _bits(b)), "per-ping route rerun not bit-identical"
    assert (first[1] > 0).any()


# ---------------------------------------------------------------- EK80 / BB
def _bb_replica():
    """The synthetic BB channel's transmit replica (tests/synth_ek80.py:
    50-90 kHz, 1.024 ms, fs 1.5 MHz, its WBT and PC filters)."""
    from echopype_torch.calibrate import ek80_complex as ekc

    y, _ = ekc.tapered_chirp(1500000, 1.024e-3, 0.0078125, 50000.0, 90000.0)
    coeff = {"wbt_fil": np.full(4, 0.25, dtype="c8"), "pc_fil": np.full(2, 0.5, dtype="c8"),
             "wbt_decifac": 6, "pc_decifac": 1}
    return ekc.filter_decimate_chirp(coeff, y, 1500000.0)[0]


def _bb_samples(seed, P, R=8192, B=4):
    rng = np.random.default_rng(seed)
    bs = (rng.normal(0, 1e-3, (P, R, B)) + 1j * rng.normal(0, 1e-3, (P, R, B))).astype("c8")
    bs[::97, R - 300:, :] = np.nan  # some ragged pings
    return bs


def test_matched_filter_card_vs_host_f64(cuda):
    """2,000 pings x 4 sectors x 8,192 samples, L from the synthetic BB
    channel, on the card (float32 samples, float64 product); every 125th
    ping's lanes held to the host float64 convolution (max |error| / max
    |exact| < 1e-12) and to the same product on the CPU; NaN samples
    restored, the structural-zero tail 0."""
    from echopype_torch.ops import matched_filter as mf

    rep = _bb_replica()
    bs = _bb_samples(17, 2000)
    mf.reset_launches()
    got = mf.pulse_compress_channel(bs, rep, precision="float32", device=cuda)
    assert mf.LAUNCHES["toeplitz_matmul"] == 1
    pick = (slice(None, None, 125), slice(None), slice(None))  # 16 pings x 4 sectors
    want = mf.pulse_compress_channel(bs[pick], rep, precision="float64")
    cpu = mf.pulse_compress_channel(bs[pick], rep, precision="float32", device="cpu")
    np.testing.assert_array_equal(np.isnan(got[pick]), np.isnan(want))
    ok = ~np.isnan(want)
    scale = np.abs(want[ok]).max()
    assert np.abs(got[pick][ok] - want[ok]).max() / scale < 1e-12
    assert np.abs(got[pick][ok] - cpu[ok]).max() / scale < 1e-12
    z = mf._leading_zeros(rep)
    tail = got[:, -z:][~np.isnan(got[:, -z:])] if z else np.zeros(1)
    assert np.all(tail == 0)


def test_tf32_off_inside_the_card_matmul(cuda, monkeypatch):
    """The card's matmul runs with TF32 off, at the float32 matmul precision
    "highest" (the port's entry points switch TF32 off, ``device.py``); a
    caller's TF32 setting comes back after the product itself."""
    from echopype_torch.ops import matched_filter as mf

    seen = []
    real = torch.matmul

    def spy(*a, **k):
        seen.append((a[0].is_cuda, torch.backends.cuda.matmul.allow_tf32,
                     torch.get_float32_matmul_precision()))
        return real(*a, **k)

    monkeypatch.setattr(torch, "matmul", spy)
    mf.pulse_compress_channel(_bb_samples(3, 8, R=1000), _bb_replica(), precision="float32",
                              device=cuda)
    assert seen == [(True, False, "highest")]
    x = torch.randn(16, 1000, device=cuda)
    h = torch.randn(40, device=cuda)
    saved = torch.backends.cuda.matmul.allow_tf32
    try:
        torch.backends.cuda.matmul.allow_tf32 = True
        mf._toeplitz_conv(x, x, h, h, 39, 1000)
        assert torch.backends.cuda.matmul.allow_tf32 is True
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved
    assert seen[1][:2] == (True, False)


@pytest.mark.parametrize("precision", ["HIGH", "DEFAULT"])
def test_split_product_card_vs_cpu_plain(cuda, precision):
    """The bf16 split product on the card's tensor cores, one launch,
    against its plain version on the CPU: 100 pings x 4 sectors x 8,192
    samples of noise through the synthetic BB replica, float32 out, max
    |error| / max |plain| < 2e-6 (float32 sums in another order)."""
    from echopype_torch.ops import matched_filter as mf

    rep = np.flipud(np.conj(_bb_replica()))
    lanes = np.nan_to_num(_bb_samples(23, 100)).transpose(0, 2, 1).reshape(-1, 8192)
    t = [torch.from_numpy(np.ascontiguousarray(a, "f4"))
         for a in (lanes.real, lanes.imag, rep.real, rep.imag)]
    L = len(rep)
    mf.reset_launches()
    card = mf._toeplitz_conv(*(x.to(cuda) for x in t), L - 1, 8192, precision=precision)
    torch.cuda.synchronize()
    assert mf.LAUNCHES["toeplitz_matmul"] == 1
    plain = mf._toeplitz_conv(*t, L - 1, 8192, precision=precision)
    scale = max(float(p.abs().max()) for p in plain)
    for c, p in zip(card, plain):
        assert c.dtype == torch.float32 and c.is_cuda
        assert float((c.cpu() - p).abs().max()) / scale < 2e-6


def test_split_product_raises_without_the_bf16_product(cuda, monkeypatch):
    """Where the card's bf16 product with a float32 output does not run,
    HIGH raises: no float32 or plain fall-back, no launch counted."""
    from echopype_torch.ops import matched_filter as mf

    def missing(*a, **k):
        raise NotImplementedError("aten::mm.dtype is missing")

    monkeypatch.setattr(torch, "mm", missing)
    x = torch.randn(4, 500, device=cuda)
    h = torch.randn(40, device=cuda)
    mf.reset_launches()
    with pytest.raises(NotImplementedError, match="mm.dtype"):
        mf._toeplitz_conv(x, x, h, h, 39, 500, precision="HIGH")
    assert mf.LAUNCHES["toeplitz_matmul"] == 0


@pytest.mark.parametrize("uniform_er", [True, False])
def test_fused_bb_chunk_rerun_bit_identical(cuda, uniform_er):
    """``bb_chunk_window_partials`` on one channel's chunk of 1,000 pings x
    8,192 samples x 4 sectors, twice on the card: bit-identical; and within
    rtol 1e-4 of the CPU (counts exact)."""
    from echopype_torch.ops.bb_pipeline import bb_chunk_window_partials

    P, R = 1000, 8192
    bs = _bb_samples(5, P, R)
    rep = np.flipud(np.conj(_bb_replica()))
    rng = np.random.default_rng(6)
    dr = np.full(P, 16e-6 * 1480 / 2, "f4")
    if not uniform_er:
        dr = (dr * rng.uniform(0.99, 1.01, P)).astype("f4")
    shift = np.full(P, 1480 * 1.024e-3 / 4, "f4")
    k0 = np.maximum(np.floor(shift.astype("f8") / dr) + 1, 0).astype("i4")
    vl = (~np.isnan(bs.real[..., 0])).sum(axis=1).astype("i4")
    x_rel = (np.arange(P) // 20).astype("i4")
    r_edges = np.arange(0, R * 0.012 + 5.0, 5.0).astype("f4")
    args = (np.ascontiguousarray(bs.real), np.ascontiguousarray(bs.imag),
            np.ascontiguousarray(rep.real, "f4"), np.ascontiguousarray(rep.imag, "f4"),
            np.float32(1e-2), np.full(P, 0.13, "f4"), dr, shift, np.full(P, 0.02, "f4"),
            np.full(P, -20.0, "f4"), k0, vl, x_rel, r_edges, 50, True)
    a = bb_chunk_window_partials(*args, uniform_er=uniform_er, device=cuda)
    b = bb_chunk_window_partials(*args, uniform_er=uniform_er, device=cuda)
    torch.cuda.synchronize()
    for g, h in zip(a, b):
        assert torch.equal(_bits(g), _bits(h)), "fused BB chunk rerun not bit-identical"
    s_c, c_c = bb_chunk_window_partials(*args, uniform_er=uniform_er, device="cpu")
    np.testing.assert_array_equal(a[1].cpu().numpy(), c_c.numpy())
    np.testing.assert_allclose(a[0].cpu().numpy(), s_c.numpy(), rtol=1e-4, atol=1e-30)
    assert (c_c > 0).any()


# ----------------------------------------------- clean masks and freq_diff
def _windows_cases(kind):
    """(program, args, kwargs) of ops/windows.py on 3 x 300 x 500 Sv with
    noise: a round-number grid (host membership), a non-monotone grid
    (value bands), a per-ping bin index."""
    from echopype_torch.ops import windows as tw

    rng = np.random.default_rng(11)
    C, P, R = 3, 300, 500
    sv = rng.normal(-75.0, 4.0, (C, P, R)).astype("f4")
    sv[0, 100] += 30.0
    sv[1, 150:153, 200:] += 20.0
    sv[0, 200:205, 100:180] -= 25.0
    sv[2, :, 450:] = np.nan
    grid = np.broadcast_to(np.arange(R) * 0.25, (C, R)).copy()
    if kind == "pool_idx":
        lo, hi, v_r, halo = tw.grid_window_members(grid, 2.0, 3.0)
        return tw.transient_mask_grid_idx_device, (
            sv, np.isfinite(grid).astype("f4"), lo, hi, v_r, 25, 8.0), dict(range_halo=halo)
    if kind == "pool_values":
        g = grid.astype("f4")
        g[:, 60:64] = g[:, 60:64][:, ::-1]
        return tw.pool_sv_nanmean_grid_device, (sv, g, 2.0, 10, 1.0), dict(range_halo=0)
    edges = np.arange(0, R * 0.25 + 5.0, 5.0)
    idx = np.clip(np.digitize(grid, edges) - 1, 0, len(edges) - 2).astype("i4")
    if kind == "impulse":
        return tw.impulse_mask_grid_device, (sv, idx, len(edges) - 1, 2, 10.0), {}
    if kind == "downsample_ping":
        heave = rng.uniform(0, 1.0, (1, P, 1))
        bins = np.clip(np.digitize(np.arange(R) * 0.25 + heave + np.zeros((C, 1, 1)), edges)
                       - 1, 0, len(edges) - 2).astype("i4")
        return tw.downsample_upsample_depth_device, (sv, bins, len(edges) - 1), {}
    widths = np.array([80, 81, 60], dtype="i4")  # even and odd slab medians
    return tw.attenuated_ping_mask_grid_device, (
        sv, np.array([100, 120, 140], "i4"), widths, 81, 15, -6.0), dict(chunk=64)


@pytest.mark.parametrize("kind", ["pool_idx", "pool_values", "impulse", "downsample_ping",
                                  "attenuated"])
def test_windows_programs_card_equals_cpu(cuda, kind):
    """Each device program of ops/windows.py on the card: twice bit-identical,
    and against device="cpu" (Sv within 1e-4 dB, NaN masks and masks equal)."""
    fn, args, kw = _windows_cases(kind)
    a = fn(*args, **kw, device=cuda)
    b = fn(*args, **kw, device=cuda)
    torch.cuda.synchronize()
    want = fn(*args, **kw, device="cpu")
    for g, h, w in zip(*(x if isinstance(x, tuple) else (x,) for x in (a, b, want))):
        assert g.is_cuda
        assert torch.equal(g, h) if g.dtype == torch.bool else torch.equal(_bits(g), _bits(h))
        g, w = g.cpu().numpy(), w.numpy()
        if g.dtype == bool:
            np.testing.assert_array_equal(g, w)
        else:
            np.testing.assert_array_equal(np.isnan(g), np.isnan(w))
            np.testing.assert_allclose(g, w, rtol=0, atol=1e-4, equal_nan=True)


def test_freqdiff_step_card_equals_cpu(cuda):
    """``sv_mvbs_window_partials_freqdiff`` at 5 x 2,000 x 4,000 int16: twice
    bit-identical on the card, counts equal to the CPU's, sums rtol 1e-5,
    one launch counted per call."""
    from echopype_torch.parallel import pipeline as tp

    rng = np.random.default_rng(12)
    C, P, R = 5, 2000, 4000
    power = rng.integers(-9000, -2000, (C, P, R)).astype("i2")
    dr = np.full((C, P), 0.1894, "f4")
    shift = np.full((C, P), 0.38, "f4")
    alpha = np.linspace(0.002, 0.05, C, dtype="f4")[:, None] * np.ones((1, P), "f4")
    offset = np.full((C, P), -20.0, "f4")
    vl = np.full((C, P), R, "i4")
    vl[:, 7] = 1500
    x_rel = (np.arange(P) // 100).astype("i4")
    edges = np.arange(0, R * 0.1894 + 20.0, 20.0).astype("f4")
    args = (power, dr, shift, alpha, offset, vl, x_rel, edges, 20, len(edges) - 1,
            1, 0, ">", 3.0)
    tp.LAUNCHES["freqdiff_step"] = 0
    a = tp.sv_mvbs_window_partials_freqdiff(*args, device=cuda)
    b = tp.sv_mvbs_window_partials_freqdiff(*args, device=cuda)
    torch.cuda.synchronize()
    assert tp.LAUNCHES["freqdiff_step"] == 2
    for g, h in zip(a, b):
        assert torch.equal(_bits(g), _bits(h))
    s, c = tp.sv_mvbs_window_partials_freqdiff(*args, device="cpu")
    np.testing.assert_array_equal(a[1].cpu().numpy(), c.numpy())
    np.testing.assert_allclose(a[0].cpu().numpy(), s.numpy(), rtol=1e-5, atol=1e-30)
    assert 0 < c.sum() < C * P * R


def test_exact_pooling_card_equals_cpu(cuda):
    """``pool_sv_nanmean_exact_device`` (float64 searches, gathers and adds
    for a depth grid that varies by ping) on the card equals the CPU bit for
    bit at 3 x 120 x 2,000."""
    from echopype_torch.ops import windows as tw

    rng = np.random.default_rng(13)
    C, P, R = 3, 120, 2000
    sv = rng.normal(-75.0, 4.0, (C, P, R))
    sv[1, 40:43, 900:] += 20.0
    depth = np.arange(R) * 0.1894 + rng.uniform(0.0, 0.4, (1, P, 1)) + np.zeros((C, 1, 1))
    got = tw.pool_sv_nanmean_exact_device(sv, depth, 10.0, 25, 50.0, device=cuda)
    want = tw.pool_sv_nanmean_exact_device(sv, depth, 10.0, 25, 50.0, device="cpu")
    np.testing.assert_array_equal(got, want)
    assert np.isfinite(got).any()


@pytest.mark.parametrize("model", ["EK60", "AZFP"])
def test_workers_pool_on_card_bit_identical(cuda, tmp_path, model):
    """``workers=2`` decodes in spawned processes that never touch the card;
    the survey then equals ``workers=0, prefetch=False`` on the card bit for
    bit, with the same launches: K1 for the uniform-dr EK60 files' chunks,
    K2 for the file whose sound speed varies by ping, K2-f32 for AZFP."""
    import echopype_torch as et
    from synth_azfp import write_azfp_raw, write_azfp_xml
    from synth_ek60 import write_ek60_raw

    t0 = np.datetime64("2020-01-01T00:00:00", "ns")
    files, kw = [], dict(range_bin="10m", ping_time_bin="10s", chunk_pings=16)
    for i, n in enumerate((20, 23, 26)):
        if model == "EK60":
            p = tmp_path / f"PL{i}-D20200101-T00{i}000.raw"
            write_ek60_raw(p, n_pings=n, n_samples=80, seed=i, with_angle=False,
                           t0=t0 + np.timedelta64(i * 30, "s"), jitter_raw0=i == 2)
        else:
            p = tmp_path / f"2103151{i}.01A"
            write_azfp_raw(p, n_pings=n, seed=i, minute=i)
        files.append(str(p))
    if model == "AZFP":
        write_azfp_xml(tmp_path / "instrument.XML")
        kw.update(sonar_model="AZFP", xml_path=str(tmp_path / "instrument.XML"),
                  env_params={"salinity": 32.0, "pressure": 60.0}, range_bin="1.5m")
    chunks = [-(-n // 16) for n in (20, 23, 26)]
    want = ({"window_partials_uniform": chunks[0] + chunks[1], "window_partials": chunks[2]}
            if model == "EK60" else {"window_partials_f32": sum(chunks)})
    runs = []
    for workers in (2, 0):
        wp.reset_launches()
        runs.append(et.run_survey_mvbs_from_raw(files, workers=workers, prefetch=False,
                                                device=cuda, **kw))
        torch.cuda.synchronize()
        assert {k: v for k, v in wp.LAUNCHES.items() if v} == want
    g, w = (np.asarray(r["Sv"].values) for r in runs)
    np.testing.assert_array_equal(g, w)
    assert np.isfinite(g).any()


# ------------------------------------------------------------------ meshes
def _meshes(n=4, **kw):
    """The same layout on ``n`` blocks of the card and of the CPU."""
    from echopype_torch.parallel import make_mesh

    return (make_mesh(n, devices=["cuda:0"] * n, **kw), make_mesh(n, devices=["cpu"] * n, **kw))


@pytest.mark.parametrize("kind", ["k1", "k2", "k1_f32", "k2_f32"])
def test_mesh_window_kernels_per_block_match_plain(cuda, kind):
    """K1 / K2 (int16 and float32) once per block of a 4-block mesh of the
    card, against the plain twins on the same blocks of the CPU: counts
    exact, sums rtol 1e-5; the last ping block holds only parked padding and
    comes back as zeros; the rerun is bit-identical."""
    on_card, on_cpu = _meshes()
    uniform = kind.startswith("k1")
    ops = (_chunk_f32(11) if kind.endswith("f32") else _chunk(11, vary_dr=not uniform))
    power, dr, shift, ab, off, vl, ids, edges, W = ops[:9]
    ids = ids.copy()
    vl = vl.copy()
    ids[-80:] = W  # 300 pings: the last block of 75 is all padding
    vl[:, -80:] = 0
    args = (power, dr, shift, ab, off, vl, ids, edges)
    n_r = len(edges) - 1
    name = ("window_partials_uniform" if uniform else "window_partials") + (
        "_f32" if kind.endswith("f32") else "")
    wp.reset_launches()
    got = tp.sharded_mvbs_partials_closed(on_card, W, n_r, uniform=uniform)(*args)
    again = tp.sharded_mvbs_partials_closed(on_card, W, n_r, uniform=uniform)(*args)
    torch.cuda.synchronize()
    assert wp.LAUNCHES[name] == 8
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    want = tp.sharded_mvbs_partials_closed(on_cpu, W, n_r, uniform=uniform)(*args)
    np.testing.assert_array_equal(got[1].cpu().numpy(), want[1].numpy())
    np.testing.assert_allclose(got[0].cpu().numpy(), want[0].numpy(), rtol=1e-5, atol=1e-30)
    assert float(got[1].sum()) > 0


@pytest.mark.parametrize("with_sv", [True, False], ids=["k3", "k4"])
def test_mesh_fused_step_per_block_matches_plain(cuda, with_sv):
    """K3 / K4 once per (ping, channel) block of the card's mesh against
    the plain twins on the CPU's: Sv within rtol / atol 1e-5 with identical
    NaN masks, MVBS within 1e-4 dB; a rerun bit-identical."""
    on_card, on_cpu = _meshes(4, channel_axis=1)
    power, dr, shift, ab, off, x_idx, edges, n_x, n_r = _fused_chunk(12, P=160)
    args = (power, dr, shift, ab, off, x_idx, edges)
    name = "sv_bin_partials" if with_sv else "mvbs_partials"
    sbp.reset_launches()
    got = tp.survey_pipeline_step(on_card, n_x, n_r, with_sv=with_sv)(*args)
    again = tp.survey_pipeline_step(on_card, n_x, n_r, with_sv=with_sv)(*args)
    torch.cuda.synchronize()
    assert sbp.LAUNCHES[name] == 8
    want = tp.survey_pipeline_step(on_cpu, n_x, n_r, with_sv=with_sv)(*args)
    got, again, want = ((x if with_sv else (None, x)) for x in (got, again, want))
    assert torch.equal(_bits(got[1]), _bits(again[1]))
    if with_sv:
        sv_g, sv_w = got[0].cpu().numpy(), want[0].numpy()
        np.testing.assert_array_equal(np.isnan(sv_g), np.isnan(sv_w))
        np.testing.assert_allclose(sv_g, sv_w, rtol=1e-5, atol=1e-5)
    m_g, m_w = got[1].cpu().numpy(), want[1].numpy()
    np.testing.assert_array_equal(np.isnan(m_g), np.isnan(m_w))
    np.testing.assert_allclose(m_g, m_w, rtol=0, atol=1e-4 if with_sv else 1e-3)


def test_mesh_surveys_rerun_bit_identical(cuda, tmp_path):
    """The raw survey (K1 for the uniform file, K2 for the file whose sound
    speed varies by ping, once per block) and the Sv-store survey on a
    (ping 2, channel 2) mesh of the card: two runs bit-identical, within
    1e-4 dB of the same mesh on the CPU, K1 / K2 four launches a chunk."""
    import echopype_torch as et
    from synth_ek60 import write_ek60_raw

    t0 = np.datetime64("2020-01-01T00:00:00", "ns")
    files = []
    for i, n in enumerate((40, 37)):
        p = tmp_path / f"MS{i}-D20200101-T00{i}000.raw"
        write_ek60_raw(p, n_pings=n, n_samples=90, seed=i, with_angle=False,
                       t0=t0 + np.timedelta64(i * 50, "s"), jitter_raw0=i == 1)
        files.append(str(p))
    on_card, on_cpu = _meshes(4, channel_axis=2)
    kw = dict(range_bin="5m", ping_time_bin="10s", chunk_pings=15)  # 16: 8 a ping block
    runs = []
    for _ in range(2):
        wp.reset_launches()
        runs.append(et.run_survey_mvbs_from_raw(files, mesh=on_card, **kw))
        torch.cuda.synchronize()
        assert {k: v for k, v in wp.LAUNCHES.items() if v} == {
            "window_partials_uniform": 4 * 3, "window_partials": 4 * 3}
    cpu = et.run_survey_mvbs_from_raw(files, mesh=on_cpu, **kw)
    a, b, w = (np.asarray(r["Sv"].values) for r in (*runs, cpu))
    np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(np.isnan(a), np.isnan(w))
    np.testing.assert_allclose(a, w, rtol=0, atol=1e-4, equal_nan=True)
    sv = [et.calibrate.compute_Sv(et.open_raw(f, sonar_model="EK60"), device=cuda) for f in files]
    skw = dict(range_bin="5m", ping_time_bin="10s", chunk_pings=10)
    s1, s2 = (np.asarray(et.run_survey_mvbs(sv, mesh=on_card, **skw)["Sv"].values)
              for _ in range(2))
    s_cpu = np.asarray(et.run_survey_mvbs(sv, mesh=on_cpu, **skw)["Sv"].values)
    np.testing.assert_array_equal(s1, s2)
    np.testing.assert_allclose(s1, s_cpu, rtol=0, atol=1e-4, equal_nan=True)
    assert np.isfinite(s1).any()
