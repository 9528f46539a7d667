"""Binned echo-integration (MVBS / NASC): host membership, device bin sums.

Counterpart of ``echopype_tpu/ops/binning.py`` (which imports jax, so its
host helpers are copied here, not imported).  The ping axis is sorted, so
every ping bin is a contiguous run and reduces by a 0/1 matmul.

* Host, numpy: bin membership in float64 (:func:`exact_bin_encode_np`, the
  reference's elementwise digitize, shipped as ``idx + 0.5`` against
  integer edges so the device compares exact values), and the ping chunk
  loop :func:`_windowed_accumulate`, whose window partials add up in
  float64 on the host.  :func:`choose_block_g` picks the block size of
  :func:`blocked_banded_segment_sum` from the host's bin bounds.
* Device, plain torch: :func:`_banded_x_reduce_xb` (ping windows) and the
  range bins, by one of two rules: on a ping-invariant grid a per-channel
  0/1 matmul against the grid row (:func:`_uniform_bin_matmul`; the survey
  streamers pass the row itself, ``*_grid``, ``*_row_sum``), on a grid that
  varies by ping a scatter-add of each sample into its own bin
  (:func:`_sample_bin_sums`).  Every bin sums only its own samples, and
  every float32 matmul runs with TF32 off (``device.py``).  The window
  partials sum their pings' range sums in float64: a chunk split over a
  mesh's ping blocks then gives the one-device sums up to float64 rounding,
  where float32 window sums of other groupings differed by up to 2.2e-6 dB
  on a 101,056-ping survey.
* The JAX package's other public names, on the same device rules:
  :func:`banded_x_reduce` (window-relative ids), :func:`row_bin_bounds`,
  :func:`blocked_banded_segment_sum`, :func:`binned_sum_partials`,
  :func:`binned_sum_raw`, :func:`binned_mean_linear` (the last three on the
  windowed routes above, with one window bin per ping bin) and
  :func:`binned_mean_1d`.  No survey path of the port runs any of them:
  the streamers and ``compute_MVBS`` / ``compute_NASC`` take the windowed
  routes, and the uniform survey step takes K1 whatever its ``block_g``.
"""

from __future__ import annotations

import warnings

import numpy as np
import torch

from ..device import no_tf32, resolve_device

__all__ = [
    "banded_x_reduce",
    "bin_index_np",
    "binned_mean_1d",
    "binned_mean_linear",
    "binned_sum_partials",
    "binned_sum_raw",
    "binned_window_partials",
    "binned_window_partials_grid",
    "binned_window_row_sum",
    "binned_window_sum_raw",
    "blocked_banded_segment_sum",
    "choose_block_g",
    "er_is_uniform",
    "exact_bin_encode_np",
    "row_bin_bounds",
    "windowed_partials_np",
    "windowed_sum_raw_np",
    "x_bounds_np",
]


# ------------------------------------------------------------------ host side
def bin_index_np(values: np.ndarray, edges: np.ndarray, closed: str = "left") -> np.ndarray:
    """Bin index per element, -1 outside all bins (host; pandas-Interval exact)."""
    right = closed == "right"
    idx = np.digitize(values, edges, right=right) - 1
    n_bins = len(edges) - 1
    invalid = (idx < 0) | (idx >= n_bins)
    if values.dtype.kind == "f":
        invalid |= np.isnan(values)
    return np.where(invalid, -1, idx).astype("i4")


def x_bounds_np(sorted_values: np.ndarray, edges: np.ndarray, closed: str = "left") -> np.ndarray:
    """Boundary positions [n_bins+1] of each bin in a sorted 1-D value array.

    Elements of bin b live at positions [bounds[b], bounds[b+1]).
    closed='left':  [lo, hi)  -> side='left' search of each edge.
    closed='right': (lo, hi]  -> side='right' search of each edge.
    """
    side = "left" if closed == "left" else "right"
    return np.searchsorted(sorted_values, edges, side=side).astype("i4")


def choose_block_g(bounds: np.ndarray, n_valid: int, g_max: int = 64) -> int:
    """Pick a static block size for :func:`blocked_banded_segment_sum`.

    Valid G: no block of G samples may contain two distinct bin boundaries
    (equivalently min over channels of min consecutive-bound spacing >= G;
    boundary values clipped outside [0, n_valid] collapse and don't count).
    Returns the largest power of two <= min spacing (capped at g_max), or 0
    when none >= 8 exists — callers fall back to the plain banded matmul.
    Host-side: ``bounds`` are the f64-exact per-channel bin bounds the
    kernels reproduce on device (``_refine_bounds`` pins them to the grid).
    """
    b = np.clip(np.asarray(bounds, dtype="f8"), 0, n_valid)
    d = np.diff(b, axis=-1)
    d = d[d > 0]
    if d.size == 0 or d.min() < 8:  # sub-8 spacing: 1 << log2(<1) would raise
        return 0
    g = 1 << int(np.floor(np.log2(d.min())))
    return min(g, g_max)


def er_is_uniform(er) -> bool:
    """True when every ping of each channel shares one finite range grid.

    The uniform case (ping-invariant sample interval, the instrument norm)
    takes the 0/1 matmul against the grid row; a ping-varying grid the
    per-sample scatter-add.  A NaN where the row is finite (a short ping)
    still counts as uniform: that sample joins no bin.
    """
    er = np.asarray(er)
    if er.ndim < 3:
        return True
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", category=RuntimeWarning)
        ref = np.nanmax(er, axis=1)  # [C, R]
    return bool(np.all(np.isnan(er) | (er == ref[:, None, :])))


def _window_ids(x_bounds, P: int) -> np.ndarray:
    """Sorted-ping bin ids from boundary positions: out-of-range prefix pings
    map to -1 and suffix pings to n_x, outside any window bin either way."""
    return (np.searchsorted(np.asarray(x_bounds), np.arange(P), side="right") - 1).astype("i8")


def _windowed_accumulate(kernel, shape_cpn, n_x: int, x_bounds, chunk_pings: int, n_out: int):
    """Drive a window kernel over ping chunks, accumulating float64 globals.

    kernel(lo, hi, x_rel, window) -> tuple of n_out [C, window, n_r] partials;
    shape_cpn = (C, P, n_r) of the global output layout.
    """
    C, P, n_r = shape_cpn
    ids = _window_ids(x_bounds, P)
    outs = [np.zeros((C, n_x, n_r), dtype="f8") for _ in range(n_out)]
    for lo in range(0, P, chunk_pings):
        hi = min(lo + chunk_pings, P)
        ids_c = ids[lo:hi]
        real = ids_c[(ids_c >= 0) & (ids_c < n_x)]
        if real.size == 0:
            continue
        x_base = int(real[0])
        window = int(real[-1]) - x_base + 1
        parts = kernel(lo, hi, (ids_c - x_base).astype("i4"), window)
        for o, p in zip(outs, parts):
            o[:, x_base : x_base + window] += _host_f8(p)
    return outs


def _host_f8(t):
    return (t.cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)).astype("f8")


def exact_bin_encode_np(er, r_edges, closed="left"):
    """Resolve bin membership on host in float64 and re-encode for float32.

    Binning the range values on the host in float64 (elementwise, the
    reference's digitize semantics) and shipping ``idx + 0.5`` against
    integer edges makes the device's float32 comparisons exact on any grid.
    NaN and out-of-bin samples encode as NaN (no bin).

    Returns (er_enc f4, edges_enc f4, idx i8, ok bool); idx/ok are the raw
    elementwise membership.
    """
    er64 = np.asarray(er, dtype="f8")
    edges64 = np.asarray(r_edges, dtype="f8")
    n_r = len(edges64) - 1
    side = "right" if closed == "left" else "left"
    idx = np.searchsorted(edges64, er64, side=side) - 1
    ok = (idx >= 0) & (idx < n_r) & ~np.isnan(er64)
    er_enc = np.where(ok, idx + 0.5, np.nan).astype("f4")
    return er_enc, np.arange(n_r + 1, dtype="f4"), idx, ok


def _to_dev(a, dev, dtype="f4"):
    return torch.from_numpy(np.ascontiguousarray(a, dtype=dtype)).to(dev)


def _encoded_chunks(er, r_edges, closed, device):
    """The shared set-up of the ``windowed_*_np`` entries: (device, encoded
    er, encoded edges on the device, uniform_er, value dtype).

    A ping-varying grid sums in float64 (its bins were summed in float64 on
    the host before the device route took them, as the reference's flox
    accumulation does); a ping-invariant grid in float32, the banded matmul.
    """
    dev = resolve_device(device)
    er_enc, edges = exact_bin_encode_np(er, r_edges, closed)[:2]
    uniform = er_is_uniform(er_enc)
    return dev, er_enc, _to_dev(edges, dev), uniform, "f4" if uniform else "f8"


def windowed_partials_np(sv, er, r_edges, x_bounds, skipna=True, closed="left",
                         chunk_pings=8192, device="cuda"):
    """(sums, counts, nan_counts) float64 [C, n_x, n_r] of linear Sv per bin.

    Membership resolves on the host in float64 (:func:`exact_bin_encode_np`;
    pass ``er`` and ``r_edges`` at full precision); :func:`binned_window_partials`
    runs on ``device`` chunk by chunk, each bin accumulating independently,
    and the chunks' partials add up in float64 on the host.
    """
    dev, er, edges_t, uniform, dtype = _encoded_chunks(er, r_edges, closed, device)

    def kernel(lo, hi, x_rel, window):
        return binned_window_partials(
            _to_dev(sv[:, lo:hi], dev, dtype), _to_dev(er[:, lo:hi], dev), edges_t,
            _to_dev(x_rel, dev, "i4"), window, skipna=skipna, closed=closed, uniform_er=uniform,
        )

    return _windowed_accumulate(kernel, (sv.shape[0], sv.shape[1], len(edges_t) - 1),
                                len(x_bounds) - 1, x_bounds, chunk_pings, 3)


def windowed_sum_raw_np(values, er, r_edges, x_bounds, closed="left", chunk_pings=8192,
                        device="cuda"):
    """NaN-skipping raw bin sums (float64) of ``values``, as
    :func:`windowed_partials_np` bins them."""
    dev, er, edges_t, uniform, dtype = _encoded_chunks(er, r_edges, closed, device)

    def kernel(lo, hi, x_rel, window):
        return (binned_window_sum_raw(
            _to_dev(values[:, lo:hi], dev, dtype), _to_dev(er[:, lo:hi], dev), edges_t,
            _to_dev(x_rel, dev, "i4"), window, closed=closed, uniform_er=uniform,
        ),)

    return _windowed_accumulate(kernel, (values.shape[0], values.shape[1], len(edges_t) - 1),
                                len(x_bounds) - 1, x_bounds, chunk_pings, 1)[0]


# ---------------------------------------------------------------- device side
def _banded_x_reduce_xb(blocks, xb):
    """Sum the ping axis of ``blocks`` [C, P, K] over the runs of ``xb``.

    xb: int [W+1] non-decreasing ping bounds; pings past ``xb[W]`` (padding
    parked past the window) join no bin.  One matmul against the 0/1
    membership matrix, in ``blocks``' dtype, so every bin is an independent
    sum over its own pings.  Returns [C, W, K].
    """
    P = blocks.shape[1]
    p_ids = torch.arange(P, device=blocks.device)[:, None]
    mx = ((p_ids >= xb[None, :-1]) & (p_ids < xb[None, 1:])).to(blocks.dtype)
    return torch.einsum("cpk,pw->cwk", blocks, mx)


def banded_x_reduce(blocks, x_rel, n_x_window: int):
    """Reduce the ping axis of ``blocks`` [C, P, K] onto a local bin window.

    x_rel: sorted int [P] window-relative bin ids; ids outside [0,
    n_x_window) join no bin (park padded pings past the window).  Each
    output bin is an independent sum over its own pings (the JAX package's
    signature; :func:`_banded_x_reduce_xb` takes the window's ping bounds
    instead).  Returns [C, n_x_window, K] in ``blocks``' dtype.
    """
    with no_tf32():
        return _banded_x_reduce_xb(blocks, _x_rel_bounds(x_rel, n_x_window))


def _x_rel_bounds(x_rel, n_x_window):
    """Window ping bounds [W+1] of sorted window-relative ids (on their device)."""
    return torch.searchsorted(
        x_rel, torch.arange(n_x_window + 1, dtype=x_rel.dtype, device=x_rel.device), side="left"
    )


def _prefix_gather_diff(values, bounds, axis):
    """Sums of contiguous runs: cumsum with a zero prepended, gather, diff.

    values: [..., N, ...]; bounds: positions in [0, N] along ``axis``.
    """
    cs = torch.cumsum(values, dim=axis)
    cs = torch.cat([torch.zeros_like(cs.narrow(axis, 0, 1)), cs], dim=axis)
    return torch.diff(torch.gather(cs, axis, bounds.long()), dim=axis)


def _uniform_bin_matmul(vals3, er_grid, r_edges, closed: str):
    """[C, P, R] -> [C, P, n_r] bin sums by a per-channel 0/1 matmul.

    Membership is taken directly against the channel's range grid (er_grid
    [C, R], NaN -> no bin): each bin sums only its own samples.
    """
    eg = torch.where(torch.isnan(er_grid), torch.inf, er_grid)[:, :, None]  # [C, R, 1]
    if closed == "right":
        m = (eg > r_edges[None, None, :-1]) & (eg <= r_edges[None, None, 1:])
    else:
        m = (eg >= r_edges[None, None, :-1]) & (eg < r_edges[None, None, 1:])
    return torch.bmm(vals3, m.to(vals3.dtype))


def _grid_of(er):
    """The ping-invariant grid [C, R] of ``er`` (nanmax over pings)."""
    g = torch.where(torch.isnan(er), -torch.inf, er).amax(dim=1)
    return torch.where(g == -torch.inf, torch.nan, g)


def _sample_bin_sums(er, r_edges, closed: str):
    """Range-bin sums for a grid that varies by ping: a function taking
    [C, P, R] values to [C, P, n_r].

    Each sample adds into its own bin (an accumulating ``index_put_`` by
    its (channel, ping, bin) id), so a quiet bin after loud samples keeps
    its precision, and the samples of a row may come in any order, NaN
    ranges anywhere.  On the card ``index_put_`` sorts the ids and adds
    each bin's samples in their order, so reruns are bit-identical; the
    float atomics of ``scatter_add_`` were not (two runs at 5 x 5,000 x
    4,000 differed, tests/test_torch_kernels_gpu.py).
    """
    n_r = r_edges.shape[0] - 1
    idx = torch.searchsorted(r_edges.to(er.dtype), er.contiguous(),
                             side="right" if closed == "left" else "left") - 1
    ids = torch.where((idx >= 0) & (idx < n_r) & ~torch.isnan(er), idx, n_r)
    C, P = er.shape[:2]
    rows = torch.arange(C * P, device=er.device).view(C, P, 1) * (n_r + 1)
    flat = (rows + ids).reshape(-1)

    def reduce(values):
        out = values.new_zeros(C * P * (n_r + 1))
        out.index_put_((flat,), values.reshape(-1), accumulate=True)
        return out.view(C, P, n_r + 1)[:, :, :n_r]

    return reduce


def _range_bin_sums(er, r_edges, closed: str, uniform_er: bool):
    """[C, P, R] -> [C, P, n_r] range-bin sums over ``er``'s grid: the 0/1
    matmul on its ping-invariant row, else the per-sample scatter-add."""
    if uniform_er:
        grid = _grid_of(er)
        return lambda values: _uniform_bin_matmul(values, grid, r_edges, closed)
    return _sample_bin_sums(er, r_edges, closed)


def _window_partials(sv_db, in_bin, range_sums, x_rel, n_x_window, skipna):
    """(sums, counts, nan_counts) [C, n_x_window, n_r] of linear Sv:
    ``range_sums`` bins the range axis, ``in_bin`` (broadcast to sv_db)
    marks the samples whose range joins a bin."""
    lin = torch.pow(10.0, sv_db / 10.0)
    isnan_sv = torch.isnan(sv_db)
    ok = in_bin & ~isnan_sv
    s1 = range_sums(torch.where(ok, lin, 0.0))
    n1 = range_sums(ok.to(lin.dtype))
    nan1 = torch.zeros_like(n1) if skipna else range_sums((isnan_sv & in_bin).to(lin.dtype))
    n_r = s1.shape[2]
    stacked = _banded_x_reduce_xb(torch.cat([s1, n1, nan1], dim=2).double(),
                                  _x_rel_bounds(x_rel, n_x_window))
    return stacked[:, :, :n_r], stacked[:, :, n_r : 2 * n_r], stacked[:, :, 2 * n_r :]


def binned_window_partials(sv_db, er, r_edges, x_rel, n_x_window: int, skipna: bool = True,
                           closed: str = "left", uniform_er: bool = False):
    """Chunk-invariant partial bin sums on a local ping-bin window.

    sv_db, er [C, P, R] (float32, or float64 sums from float64 sv_db);
    r_edges [n_r+1]; x_rel [P] sorted window-relative ping-bin ids (ids
    outside [0, n_x_window) join no bin).  ``uniform_er`` (decide with
    :func:`er_is_uniform`) takes the per-channel 0/1 matmul over the range
    axis, as :func:`binned_window_partials_grid` does; otherwise each sample
    adds into its own bin.  Returns (sums, counts, nan_counts)
    [C, n_x_window, n_r] float64 (the ping sums accumulate in float64).
    """
    return _window_partials(sv_db, ~torch.isnan(er),
                            _range_bin_sums(er, r_edges, closed, uniform_er),
                            x_rel, n_x_window, skipna)


def binned_window_sum_raw(values, er, r_edges, x_rel, n_x_window: int, closed: str = "left",
                          uniform_er: bool = False):
    """NaN-skipping raw sums on a local ping-bin window: [C, n_x_window, n_r]
    float64 (the ping sums accumulate in float64)."""
    ok = ~torch.isnan(values) & ~torch.isnan(er)
    s1 = _range_bin_sums(er, r_edges, closed, uniform_er)(torch.where(ok, values, 0.0))
    return _banded_x_reduce_xb(s1.double(), _x_rel_bounds(x_rel, n_x_window))


def binned_window_partials_grid(sv_db, er_grid, r_edges, x_rel, n_x_window: int,
                                skipna: bool = True, closed: str = "left"):
    """:func:`binned_window_partials` on one range row shared by every ping.

    er_grid [C, R] float32 (NaN = no bin) replaces the [C, P, R] range
    operand; membership and results equal ``binned_window_partials(...,
    uniform_er=True)`` on the row broadcast over the pings.  Returns
    (sums, counts, nan_counts) float64 [C, n_x_window, n_r].
    """
    return _window_partials(sv_db, ~torch.isnan(er_grid)[:, None, :],
                            lambda v: _uniform_bin_matmul(v, er_grid, r_edges, closed),
                            x_rel, n_x_window, skipna)


def binned_window_row_sum(values_row, er_row, r_edges, x_rel, n_x_window: int,
                          closed: str = "left"):
    """Raw bin sums of one row shared by every ping, times each window bin's
    ping count: [C, n_x_window, n_r].

    values_row / er_row [C, R] float32 (the NASC height integrand on a
    ping-invariant depth grid).  Pings are counted from ``x_rel`` through
    the window's ping bounds, so ids outside [0, n_x_window) count nowhere.
    """
    ok = ~torch.isnan(values_row) & ~torch.isnan(er_row)
    s_row = _uniform_bin_matmul(torch.where(ok, values_row, 0.0)[:, None, :], er_row,
                                r_edges, closed)[:, 0, :]
    ping_counts = torch.diff(_x_rel_bounds(x_rel, n_x_window)).to(s_row.dtype)
    return s_row[:, None, :] * ping_counts[None, :, None]


# ----------------------------- the JAX package's other public binning names
def row_bin_bounds(er, edges, closed: str = "left"):
    """Per-row bin-boundary positions by binary search: int32 [C, P, n_edges].

    er: [C, P, R] increasing along R; NaNs count as +inf, so they are
    excluded only as a suffix of the row (the ragged-padding layout) or a
    whole row, as in the JAX package.  A bin of ``closed="left"`` edges
    holds the samples ``[bounds[b], bounds[b+1])`` of its row.  No path of
    the port uses it: a grid that varies by ping bins each sample on its
    own (:func:`_sample_bin_sums`), NaN ranges anywhere.
    """
    rows = torch.where(torch.isnan(er), torch.inf, er).contiguous()
    e = edges.to(rows.dtype).expand(*rows.shape[:2], edges.shape[-1]).contiguous()
    return torch.searchsorted(rows, e, side="left" if closed == "left" else "right").to(
        torch.int32)


def blocked_banded_segment_sum(vals, bounds, n_r: int, G: int):
    """Contiguous-segment sums of ``vals``: float32 [C, P, n_r].

    vals   : float32 [C, P, N] (already masked: out-of-segment samples are 0)
    bounds : [C, n_r+1] integral segment boundaries in [0, N], sorted
    G      : the block size from :func:`choose_block_g`; it must keep that
             function's rule (no G-sample block holds two distinct
             boundaries), else ``ValueError``.
    Segment b sums ``vals[..., bounds[b]:bounds[b+1]]``.

    The JAX package splits each bin into float32 blocks of G samples so
    that its matrix unit keeps float32 precision.  Here each bin is one
    segment sum, whatever G: a float64 product against the 0/1 bin
    selectors, rounded once to float32.  Integer-valued inputs sum
    exactly, a quiet bin after loud samples keeps its precision, and the
    card and the CPU give the same float32 sums.
    """
    C, P, N = vals.shape
    b = bounds.to(vals.device).clamp(0, N)
    d = torch.diff(b, dim=-1)
    if G < 1 or bool(((d > 0) & (d < G)).any()):
        raise ValueError(f"G={G}: a block of G samples holds two bin boundaries")
    k = torch.arange(N, device=vals.device)[None, :, None]
    sel = ((k >= b[:, None, :-1]) & (k < b[:, None, 1:])).to(torch.float64)  # [C, N, n_r]
    return torch.bmm(vals.double(), sel).to(torch.float32)


def _window_ids_on(x_bounds, P: int, dev):
    xb = x_bounds.cpu().numpy() if isinstance(x_bounds, torch.Tensor) else x_bounds
    return torch.from_numpy(_window_ids(xb, P)).to(dev)


def binned_sum_partials(sv_db, er, r_edges, x_bounds, skipna: bool = True,
                        closed: str = "left"):
    """Linear-domain partial sums per (channel, x_bin, range_bin).

    sv_db, er [C, P, R] tensors (er increasing along R); r_edges [n_r+1];
    x_bounds [n_x+1] ping positions of the x-bin boundaries (host array or
    tensor).  :func:`binned_window_partials` with one window bin per x bin
    (pings outside ``[x_bounds[0], x_bounds[-1])`` join none), so every
    range and ping bin sums only its own samples.  Returns (sums, counts,
    nan_counts) float64 [C, n_x, n_r] (the JAX package's are float32, from
    prefix sums that lose a quiet bin after loud samples); with
    ``skipna=False``, ``nan_counts`` counts the NaN Sv at valid ranges.
    """
    x_rel = _window_ids_on(x_bounds, sv_db.shape[1], sv_db.device)
    return binned_window_partials(sv_db, er, r_edges, x_rel, len(x_bounds) - 1, skipna, closed)


def binned_mean_linear(sv_db, er, r_edges, x_bounds, skipna: bool = True,
                       closed: str = "left"):
    """Mean of linear Sv per bin, back in dB: float64 [C, n_x, n_r].

    :func:`binned_sum_partials`' sums over its counts; a bin with no sample,
    or with ``skipna=False`` any NaN Sv, is NaN.
    """
    sums, counts, nan_counts = binned_sum_partials(sv_db, er, r_edges, x_bounds, skipna, closed)
    mean = sums / torch.where(counts > 0, counts, 1.0)
    good = (counts > 0) & (nan_counts == 0)
    return torch.where(good, 10.0 * torch.log10(mean), torch.nan)


def binned_sum_raw(values, er, r_edges, x_bounds, closed: str = "left"):
    """NaN-skipping raw sum per (channel, x_bin, range_bin): float64
    [C, n_x, n_r], :func:`binned_window_sum_raw` with one window bin per x
    bin (the JAX package's is float32)."""
    x_rel = _window_ids_on(x_bounds, values.shape[1], values.device)
    return binned_window_sum_raw(values, er, r_edges, x_rel, len(x_bounds) - 1, closed)


def binned_mean_1d(values, x_idx, n_x: int):
    """NaN-mean of a [P] tensor per x bin (latitude / longitude): float64
    [n_x], NaN for a bin with no finite value.  ``x_idx`` [P] gives each
    element's bin; elements outside [0, n_x) join none.  Sums and counts
    accumulate in float64 by an accumulating ``index_put_`` (deterministic
    on the card)."""
    x_idx = x_idx.to(values.device, torch.int64)
    ok = (x_idx >= 0) & (x_idx < n_x) & ~torch.isnan(values)
    idx = (x_idx[ok],)
    sums = torch.zeros(n_x, dtype=torch.float64, device=values.device)
    sums.index_put_(idx, values[ok].double(), accumulate=True)
    counts = torch.zeros_like(sums).index_put_(
        idx, torch.ones(idx[0].shape, dtype=torch.float64, device=values.device), accumulate=True)
    return torch.where(counts > 0, sums / torch.where(counts > 0, counts, 1.0), torch.nan)
