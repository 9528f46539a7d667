"""Binned echo-integration (MVBS / NASC): host membership, device bin sums.

Counterpart of ``echopype_tpu/ops/binning.py`` (which imports jax, so its
host helpers are copied here, not imported).  Both grouping axes are
monotone (ping time sorted, range monotone along the sample axis), so every
bin is a contiguous run and no scatter is needed.

* Host, numpy: bin membership in float64 (:func:`exact_bin_encode_np`, the
  reference's elementwise digitize), the exact float64 accumulation for
  ping-varying range grids (:func:`_host_exact_partials_np`), and the ping
  chunk loop :func:`_windowed_accumulate`, whose window partials add up
  in float64 on the host.
* Device, plain torch: :func:`banded_x_reduce` (ping windows),
  :func:`_uniform_bin_matmul` (range bins on a ping-invariant grid),
  :func:`row_bin_bounds` + :func:`_prefix_gather_diff` (per-row bins), and
  the window partials built from them.  Every float32 matmul runs with TF32
  off (``device.py``), so a bin sums its own samples at full float32.
"""

from __future__ import annotations

import warnings

import numpy as np
import torch

from ..device import resolve_device

__all__ = [
    "banded_x_reduce",
    "bin_index_np",
    "binned_window_partials",
    "binned_window_sum_raw",
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


def er_is_uniform(er) -> bool:
    """True when every ping of each channel shares one finite range grid.

    The uniform case (ping-invariant sample interval, the instrument norm)
    takes the cancellation-free banded-matmul range reduction; a ping-varying
    grid takes the exact float64 host accumulation.
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
    elementwise membership for exact host-side accumulation.
    """
    er64 = np.asarray(er, dtype="f8")
    edges64 = np.asarray(r_edges, dtype="f8")
    n_r = len(edges64) - 1
    side = "right" if closed == "left" else "left"
    idx = np.searchsorted(edges64, er64, side=side) - 1
    ok = (idx >= 0) & (idx < n_r) & ~np.isnan(er64)
    er_enc = np.where(ok, idx + 0.5, np.nan).astype("f4")
    return er_enc, np.arange(n_r + 1, dtype="f4"), idx, ok


def _x_index_from_bounds_np(x_bounds, P):
    """Per-ping x-bin index from boundary positions; -1 = outside all bins."""
    b = np.clip(np.asarray(x_bounds, dtype="i8"), 0, P)
    xi = np.searchsorted(b, np.arange(P), side="right") - 1
    xi[(xi < 0) | (xi >= len(b) - 1)] = -1
    return xi


def _host_exact_partials_np(sv, ridx, ok_r, n_r, x_bounds, skipna, lin_domain, chunk_pings=8192):
    """Exact float64 host bincount accumulation for ping-varying range grids.

    A per-row prefix-sum reduction loses quiet bins to float32 cancellation
    when the range grid varies by ping, so the public entries take this
    exact path, as the reference's float64 flox accumulation does.  Works
    over ping chunks so the float64 temporaries stay bounded.
    """
    sv = np.asarray(sv)
    C, P, R = sv.shape
    n_x = len(x_bounds) - 1
    xi = _x_index_from_bounds_np(x_bounds, P)
    sums = np.zeros((C, n_x, n_r), dtype="f8")
    counts = np.zeros_like(sums)
    nans = np.zeros_like(sums)
    for lo in range(0, P, chunk_pings):
        hi = min(lo + chunk_pings, P)
        svc = np.asarray(sv[:, lo:hi], dtype="f8")
        okr_c = ok_r[:, lo:hi]
        valid = okr_c & (xi[lo:hi] >= 0)[None, :, None]
        lab = xi[None, lo:hi, None] * n_r + np.where(okr_c, ridx[:, lo:hi], 0)
        vals = np.power(10.0, svc / 10.0) if lin_domain else svc
        nan_sv = np.isnan(svc)
        okv = valid & ~nan_sv
        for c in range(C):
            sel = okv[c]
            lc = lab[c][sel]
            sums[c] += np.bincount(lc, weights=vals[c][sel], minlength=n_x * n_r).reshape(n_x, n_r)
            counts[c] += np.bincount(lc, minlength=n_x * n_r).reshape(n_x, n_r)
            if not skipna:
                ln = lab[c][valid[c] & nan_sv[c]]
                nans[c] += np.bincount(ln, minlength=n_x * n_r).reshape(n_x, n_r)
    return sums, counts, nans


def _to_dev(a, dev, dtype="f4"):
    return torch.from_numpy(np.ascontiguousarray(a, dtype=dtype)).to(dev)


def windowed_partials_np(sv, er, r_edges, x_bounds, skipna=True, closed="left",
                         chunk_pings=8192, device="cuda"):
    """(sums, counts, nan_counts) float64 [C, n_x, n_r] of linear Sv per bin.

    Membership resolves on the host in float64 (:func:`exact_bin_encode_np`;
    pass ``er`` and ``r_edges`` at full precision).  A ping-invariant grid
    runs :func:`binned_window_partials` on ``device`` chunk by chunk, each
    bin accumulating independently; a ping-varying grid takes the exact
    float64 host path (:func:`_host_exact_partials_np`).
    """
    dev = resolve_device(device)
    er, r_edges, ridx, ok_r = exact_bin_encode_np(er, r_edges, closed)
    if not er_is_uniform(er):
        return _host_exact_partials_np(sv, ridx, ok_r, len(r_edges) - 1, x_bounds, skipna,
                                       lin_domain=True, chunk_pings=chunk_pings)
    edges_t = _to_dev(r_edges, dev)

    def kernel(lo, hi, x_rel, window):
        return binned_window_partials(
            _to_dev(sv[:, lo:hi], dev), _to_dev(er[:, lo:hi], dev), edges_t,
            _to_dev(x_rel, dev, "i4"), window, skipna=skipna, closed=closed, uniform_er=True,
        )

    return _windowed_accumulate(kernel, (sv.shape[0], sv.shape[1], len(r_edges) - 1),
                                len(x_bounds) - 1, x_bounds, chunk_pings, 3)


def windowed_sum_raw_np(values, er, r_edges, x_bounds, closed="left", chunk_pings=8192,
                        device="cuda"):
    """NaN-skipping raw bin sums (float64) of ``values``, as
    :func:`windowed_partials_np` bins them."""
    dev = resolve_device(device)
    er, r_edges, ridx, ok_r = exact_bin_encode_np(er, r_edges, closed)
    if not er_is_uniform(er):
        return _host_exact_partials_np(values, ridx, ok_r, len(r_edges) - 1, x_bounds,
                                       skipna=True, lin_domain=False,
                                       chunk_pings=chunk_pings)[0]
    edges_t = _to_dev(r_edges, dev)

    def kernel(lo, hi, x_rel, window):
        return (binned_window_sum_raw(
            _to_dev(values[:, lo:hi], dev), _to_dev(er[:, lo:hi], dev), edges_t,
            _to_dev(x_rel, dev, "i4"), window, closed=closed, uniform_er=True,
        ),)

    return _windowed_accumulate(kernel, (values.shape[0], values.shape[1], len(r_edges) - 1),
                                len(x_bounds) - 1, x_bounds, chunk_pings, 1)[0]


# ---------------------------------------------------------------- device side
def banded_x_reduce(blocks, xb):
    """Sum the ping axis of ``blocks`` [C, P, K] over the runs of ``xb``.

    xb: int [W+1] non-decreasing ping bounds; pings past ``xb[W]`` (padding
    parked past the window) join no bin.  One float32 matmul against the 0/1
    membership matrix, so every bin is an independent sum over its own
    pings.  Returns [C, W, K] float32.
    """
    P = blocks.shape[1]
    p_ids = torch.arange(P, device=blocks.device)[:, None]
    mx = ((p_ids >= xb[None, :-1]) & (p_ids < xb[None, 1:])).to(torch.float32)
    return torch.einsum("cpk,pw->cwk", blocks, mx)


def _x_rel_bounds(x_rel, n_x_window):
    """Window ping bounds [W+1] of sorted window-relative ids (on their device)."""
    return torch.searchsorted(
        x_rel, torch.arange(n_x_window + 1, dtype=x_rel.dtype, device=x_rel.device), side="left"
    )


def row_bin_bounds(er, edges, closed: str = "left"):
    """Per-row bin-boundary positions by binary search: int32 [C, P, n_edges].

    er: [C, P, R] monotone increasing along R.  NaNs map to +inf, so they
    drop out only as a row suffix (ragged padding) or whole rows.
    """
    side = "left" if closed == "left" else "right"
    er_clean = torch.where(torch.isnan(er), torch.inf, er).contiguous()
    values = edges.to(er.dtype).expand(*er.shape[:2], edges.shape[0]).contiguous()
    return torch.searchsorted(er_clean, values, side=side).to(torch.int32)


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
    return torch.bmm(vals3, m.to(torch.float32))


def _grid_of(er):
    """The ping-invariant grid [C, R] of ``er`` (nanmax over pings)."""
    g = torch.where(torch.isnan(er), -torch.inf, er).amax(dim=1)
    return torch.where(g == -torch.inf, torch.nan, g)


def binned_window_partials(sv_db, er, r_edges, x_rel, n_x_window: int, skipna: bool = True,
                           closed: str = "left", uniform_er: bool = False):
    """Chunk-invariant partial bin sums on a local ping-bin window.

    sv_db, er [C, P, R] float32; r_edges [n_r+1]; x_rel [P] sorted
    window-relative ping-bin ids (ids outside [0, n_x_window) join no bin).
    ``uniform_er`` (decide with :func:`er_is_uniform`) takes the per-channel
    0/1 matmul over the range axis instead of per-row prefix sums.  Returns
    (sums, counts, nan_counts) float32 [C, n_x_window, n_r].
    """
    lin = torch.pow(10.0, sv_db / 10.0)
    isnan_sv = torch.isnan(sv_db)
    ok = ~isnan_sv
    if uniform_er:
        er_grid = _grid_of(er)
        okv = ok & ~torch.isnan(er)
        s1 = _uniform_bin_matmul(torch.where(okv, lin, 0.0), er_grid, r_edges, closed)
        n1 = _uniform_bin_matmul(okv.to(torch.float32), er_grid, r_edges, closed)
        nan1 = torch.zeros_like(n1) if skipna else _uniform_bin_matmul(
            (isnan_sv & ~torch.isnan(er)).to(torch.float32), er_grid, r_edges, closed)
    else:
        rb = row_bin_bounds(er, r_edges, closed)
        s1 = _prefix_gather_diff(torch.where(ok, lin, 0.0), rb, 2)
        n1 = _prefix_gather_diff(ok.to(torch.float32), rb, 2)
        nan1 = torch.zeros_like(n1) if skipna else _prefix_gather_diff(
            isnan_sv.to(torch.float32), rb, 2)
    n_r = s1.shape[2]
    stacked = banded_x_reduce(torch.cat([s1, n1, nan1], dim=2), _x_rel_bounds(x_rel, n_x_window))
    return stacked[:, :, :n_r], stacked[:, :, n_r : 2 * n_r], stacked[:, :, 2 * n_r :]


def binned_window_sum_raw(values, er, r_edges, x_rel, n_x_window: int, closed: str = "left",
                          uniform_er: bool = False):
    """NaN-skipping raw sums on a local ping-bin window: [C, n_x_window, n_r]."""
    ok = ~torch.isnan(values)
    if uniform_er:
        okv = ok & ~torch.isnan(er)
        s1 = _uniform_bin_matmul(torch.where(okv, values, 0.0), _grid_of(er), r_edges, closed)
    else:
        rb = row_bin_bounds(er, r_edges, closed)
        s1 = _prefix_gather_diff(torch.where(ok, values, 0.0), rb, 2)
    return banded_x_reduce(s1, _x_rel_bounds(x_rel, n_x_window))
