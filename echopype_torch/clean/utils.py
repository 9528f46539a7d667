"""Windowed helpers for noise removal.

Counterpart of ``echopype_tpu/clean/utils.py`` (capability parity:
echopype/clean/utils.py).  Pooling and depth down/up-sampling run the
device programs of ``ops/windows.py`` on ``device`` ("cuda" by default,
"cpu" for the plain path) when the depth grid is the same for every ping;
a grid that varies by ping pools on the host in float64.  The median
paths, the echopy masks and the index-binning filter are host numpy, as in
the JAX package.
"""

from __future__ import annotations

import re

import numpy as np

from ..utils.compute import _lin2log, _log2lin

__all__ = [
    "extract_dB",
    "pool_Sv_nanmean",
    "pool_Sv_nanmedian",
    "downsample_upsample_along_depth",
    "echopy_impulse_noise_mask",
    "echopy_attenuated_signal_mask",
]


def extract_dB(db_str: str) -> float:
    """Parse '12.0dB' strings (clean/utils.py:13)."""
    if not isinstance(db_str, str):
        raise TypeError("dB value must be a string like '12.0dB'")
    m = re.match(r"([\-\d.]+)\s*(dB)", db_str.strip())
    if m is None:
        raise ValueError(f"Invalid dB string {db_str!r}; must look like '12.0dB'")
    return float(m.group(1))


def uniform_grid(depth: np.ndarray):
    """[C, P, R] depth -> the shared [C, R] grid when pings agree, else None.

    Instrument depth grids are almost always ping-invariant per channel; the
    band-matmul window programs require it.
    """
    if depth.ndim != 3:
        return None
    if depth.shape[1] == 1:
        return depth[:, 0]
    first = np.broadcast_to(depth[:, :1], depth.shape)
    if np.array_equal(depth, first, equal_nan=True):
        return depth[:, 0]
    return None


def pool_Sv_nanmean(
    sv: np.ndarray,
    depth: np.ndarray,
    depth_bin: float,
    num_side_pings: int,
    exclude_above: float,
    device="cuda",
):
    """Pooled (windowed nanmean in linear domain) Sv per channel.

    sv, depth: [C, P, R].  Output NaN where the window would extend outside
    the valid depth/ping domain (pool_Sv validity rules, utils.py:75-85).
    A ping-invariant grid pools on ``device`` (ops/windows.py: host float64
    membership runs, or float32 value bands on a non-monotone grid); a grid
    that varies by ping in float64, bit-identical to the JAX package's host
    path (its row work on ``device``; on the host where a row has NaN or is
    out of order).
    """
    from ..ops.windows import (
        grid_window_halo,
        grid_window_members,
        _exact_rows_ok,
        pool_sv_nanmean_exact_device,
        pool_sv_nanmean_grid_device,
        pool_sv_nanmean_grid_idx_device,
        pool_sv_nanmean_host_exact,
    )

    grid = uniform_grid(depth)
    if grid is not None:
        members = grid_window_members(grid, depth_bin, exclude_above)
        if members is not None:
            # f64-exact membership/validity resolved on host (reference
            # compares in float64; window edges on round-number grids land
            # exactly on d±bin) — integer bounds feed the band matmuls
            lo, hi, v_r, halo = members
            out = pool_sv_nanmean_grid_idx_device(
                np.asarray(sv, dtype="f4"),
                np.isfinite(np.asarray(grid, dtype="f8")).astype("f4"),
                lo, hi, v_r,
                int(num_side_pings),
                range_halo=halo,
                device=device,
            )
        else:  # non-monotone grid: order-free f32 value-band kernel
            out = pool_sv_nanmean_grid_device(
                np.asarray(sv, dtype="f4"),
                np.asarray(grid, dtype="f4"),
                float(depth_bin),
                int(num_side_pings),
                float(exclude_above),
                range_halo=grid_window_halo(grid, depth_bin),
                device=device,
            )
    else:
        # ping-varying depth: member sets aren't shared index runs and the
        # reference's f64 edge rounding is not reproducible in f32 — the
        # float64 path, its row searches and prefix-sum differences on the
        # device where every row is finite and sorted (bit-identical)
        args = (sv, depth, float(depth_bin), int(num_side_pings), float(exclude_above))
        if _exact_rows_ok(depth):
            out = pool_sv_nanmean_exact_device(*args, device=device)
        else:
            out = pool_sv_nanmean_host_exact(*args)
    return _host(out).astype("f8")


def _host(t):
    return t.cpu().numpy() if hasattr(t, "cpu") else np.asarray(t)


def pool_Sv_nanmedian(
    sv: np.ndarray,
    depth: np.ndarray,
    depth_bin: float,
    num_side_pings: int,
    exclude_above: float,
):
    """Windowed nanmedian pooling (linear domain) using index windows.

    Median is not separable; this uses a sliding 2D index window sized from
    the median depth step (the reference's index-binning median via
    dask-image generic_filter, utils.py:109-181).
    """
    C, P, R = sv.shape
    out = np.full((C, P, R), np.nan)
    lin = _log2lin(sv)
    for c in range(C):
        d = depth[c]
        dstep = np.nanmedian(np.diff(d, axis=1))
        half_r = max(1, int(round(depth_bin / dstep)))
        pw, rw = 2 * num_side_pings + 1, 2 * half_r + 1
        padded = np.pad(lin[c], ((num_side_pings,) * 2, (half_r,) * 2), constant_values=np.nan)
        win = np.lib.stride_tricks.sliding_window_view(padded, (pw, rw))
        import warnings

        with warnings.catch_warnings():
            warnings.simplefilter("ignore", category=RuntimeWarning)
            pooled = _lin2log(np.nanmedian(win, axis=(2, 3)))
        p_idx = np.arange(P)
        d_min, d_max = np.nanmin(d), np.nanmax(d)
        valid = (
            (d - depth_bin >= d_min)
            & (d + depth_bin <= d_max)
            & (d - depth_bin >= exclude_above)
            & (p_idx[:, None] - num_side_pings >= 0)
            & (p_idx[:, None] + num_side_pings <= P)
        )
        out[c] = np.where(valid, pooled, np.nan)
    return out


def downsample_upsample_along_depth(sv: np.ndarray, depth: np.ndarray, depth_bin: float,
                                    device="cuda"):
    """Depth-bin mean (linear) then broadcast back per sample, on ``device``.

    Returns (downsampled [C,P,B], upsampled [C,P,R], bin_idx [C,P,R]).
    Mirrors clean/utils.py:184-252: bins start at global depth min, left-closed.
    """
    from ..ops.windows import downsample_upsample_depth_device, downsample_upsample_grid_device

    d_min, d_max = np.nanmin(depth), np.nanmax(depth)
    edges = np.arange(d_min, d_max + depth_bin, depth_bin)
    n_b = max(len(edges) - 1, 1)
    grid = uniform_grid(depth)
    if grid is not None:
        # left-closed binning on the shared grid: one one-hot matmul down,
        # a gather back
        idx_grid = np.clip(np.digitize(grid, edges) - 1, 0, n_b - 1).astype("i4")
        down, up = downsample_upsample_grid_device(
            np.asarray(sv, dtype="f4"), idx_grid, int(n_b), device=device
        )
        bin_idx = np.broadcast_to(idx_grid[:, None, :], sv.shape)
    else:
        # left-closed binning on the bin-left edges (digitize on left edges);
        # each sample adds into its own bin on the device
        bin_idx = np.digitize(depth, edges) - 1
        bin_idx = np.clip(bin_idx, 0, n_b - 1).astype("i4")
        down, up = downsample_upsample_depth_device(
            np.asarray(sv, dtype="f4"), bin_idx, int(n_b), device=device
        )
    return _host(down).astype("f8"), _host(up).astype("f8"), bin_idx


def echopy_impulse_noise_mask(sv: np.ndarray, num_side_pings: int, threshold: float):
    """Two-sided ping comparison (clean/utils.py:318-335); sv: [P, R] (ping, range)
    transposed relative to echopy's [R, P], handled by caller."""
    P, R = sv.shape
    fwd = np.full((P, R), np.inf)
    bwd = np.full((P, R), np.inf)
    if P > num_side_pings:
        fwd[: P - num_side_pings] = sv[: P - num_side_pings] - sv[num_side_pings:]
        bwd[num_side_pings:] = sv[num_side_pings:] - sv[: P - num_side_pings]
    fwd[np.isnan(fwd)] = np.inf
    bwd[np.isnan(bwd)] = np.inf
    return (fwd > threshold) & (bwd > threshold)


def echopy_attenuated_signal_mask(
    sv: np.ndarray,
    depth: np.ndarray,
    upper_limit_sl: float,
    lower_limit_sl: float,
    num_side_pings: int,
    threshold: float,
):
    """Ping-vs-block median comparison in scattering layer (utils.py:338-377).

    sv, depth: [P, R].  Whole pings are masked when the ping median is more
    than ``threshold`` below the block median.
    """
    P, R = sv.shape
    mask = np.zeros((P, R), dtype=bool)
    lin = _log2lin(sv)
    import warnings

    # plain argmin, NOT nanargmin: the reference's np.argmin treats NaN as
    # the minimum (clean/utils.py:349-350), so a NaN-holed depth row yields
    # up == lw == first-NaN-index -> empty slab -> the ping is never masked.
    # Faithful quirk included.
    up_idx = np.argmin(np.abs(depth - upper_limit_sl), axis=1)
    lw_idx = np.argmin(np.abs(depth - lower_limit_sl), axis=1)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", category=RuntimeWarning)
        for p in range(P):
            if p - num_side_pings < 0 or p + num_side_pings > P - 1:
                continue
            up, lw = up_idx[p], lw_idx[p]
            slab = lin[p, up:lw]
            if np.all(np.isnan(slab)):
                continue
            ping_median = _lin2log(np.nanmedian(slab))
            block = lin[p - num_side_pings : p + num_side_pings, up:lw]
            block_median = _lin2log(np.nanmedian(block))
            if (ping_median - block_median) < threshold:
                mask[p, :] = True
    return mask


def _box_nanmean_2d(x: np.ndarray, size_p: int, size_r: int) -> np.ndarray:
    """Exact NaN-skipping box-mean filter with scipy-'reflect' boundary.

    Equivalent to ``generic_filter(x, np.nanmean, size=(size_p, size_r),
    mode='reflect')`` (the reference's dask-image pooling,
    reference: clean/utils.py:161-169) but via symmetric-padded summed-area
    tables: O(P*R) instead of O(P*R*window).
    """
    hp, hr = size_p // 2, size_r // 2
    xp = np.pad(x, ((hp, hp), (hr, hr)), mode="symmetric")
    good = ~np.isnan(xp)
    vals = np.where(good, xp, 0.0)

    def _box_sum(a):
        # summed-area table with a zero row/col prefix
        s = np.zeros((a.shape[0] + 1, a.shape[1] + 1), dtype="f8")
        np.cumsum(a, axis=0, out=s[1:, 1:])
        np.cumsum(s[1:, 1:], axis=1, out=s[1:, 1:])
        return (
            s[size_p:, size_r:]
            - s[:-size_p, size_r:]
            - s[size_p:, :-size_r]
            + s[:-size_p, :-size_r]
        )

    sums = _box_sum(vals)
    cnts = _box_sum(good.astype("f8"))
    with np.errstate(invalid="ignore", divide="ignore"):
        return np.where(cnts > 0, sums / cnts, np.nan)


def index_binning_pool_Sv(
    sv: np.ndarray,
    depth: np.ndarray,
    func: str,
    depth_bin: float,
    num_side_pings: int,
    exclude_above: float,
) -> np.ndarray:
    """Index-binned pooled Sv (mean/median image filter over the echogram).

    Mirrors the reference's dask-image path exactly, including its quirks:
    the per-channel range-sample window from the mean depth step
    (reference: clean/utils.py:130-134), the ``argmin`` over the *raveled*
    3-D exclusion mask (clean/utils.py:142), and reflect ('symmetric')
    boundary handling.
    """
    C, P, R = sv.shape
    with np.errstate(invalid="ignore"):
        nrs_all = np.ceil(
            depth_bin / np.nanmean(np.diff(depth, axis=2), axis=(1, 2))
        ).astype(int)
    mrs = int(np.argmin((depth <= exclude_above).ravel()))
    pooled = np.full((C, P, R), np.nan)
    for c in range(C):
        trimmed = sv[c, :, mrs:]
        lin = _log2lin(trimmed)
        size_p = 2 * num_side_pings + 1
        size_r = 2 * int(nrs_all[c]) + 1
        if func == "nanmean":
            filt = _box_nanmean_2d(lin, size_p, size_r)
        else:
            import scipy.ndimage as ndi

            filt = ndi.generic_filter(lin, np.nanmedian, size=(size_p, size_r), mode="reflect")
        pooled[c, :, mrs:] = _lin2log(filt)
    return pooled
