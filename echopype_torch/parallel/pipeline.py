"""Survey device step: int16 power chunk -> window bin partials.

Counterpart of the single-device parts of
``echopype_tpu/parallel/pipeline.py`` that the raw->MVBS survey runs:
``sv_mvbs_window_partials_uniform`` (per-channel uniform ``dr``, the
instrument norm) and ``sv_mvbs_window_partials`` (``dr`` varying by ping;
the EK case, ``r0`` = 0), plus the host helpers that fix their bin bounds.

Nothing is divided on the device.  The range-bin sample bounds and the
first valid sample ``k0`` come from the host in float32, refined against
exact float32 products (``_refine_bounds`` / ``_refine_k0``), so they are
the ones the JAX package computes, bit for bit.  The window counts of the
uniform path come from the host in closed form (``closed_window_counts_np``)
and the kernel returns sums only.
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import resolve_device
from ..ops.window_partials import window_partials, window_partials_uniform

__all__ = [
    "closed_bounds_k0_np",
    "closed_k0_np",
    "closed_window_counts_np",
    "kernel_inputs_from_numpy",
    "sv_mvbs_window_partials",
    "sv_mvbs_window_partials_uniform",
]

_ONE = np.float32(1.0)


def _refine_bounds(bounds, dr0, edges):
    """Smallest q with q*dr0 >= edge on the float32 sample grid.

    ``bounds`` is ``ceil(edges / dr0)``; a quotient off by one ULP at an
    exactly integral edge/dr ratio would shift a bin boundary by one sample
    against the sums' own ``k*dr`` grid, so two exact multiplications pin it.
    """
    q = bounds
    q = np.where((q - _ONE) * dr0[:, None] >= edges, q - _ONE, q)
    return np.where(q * dr0[:, None] < edges, q + _ONE, q)


def _refine_k0(k0, dr, shift):
    """Pin k0 (smallest k with k*dr > shift) to the float32 sample grid —
    the same knife edge as :func:`_refine_bounds`, strict inequality."""
    k0 = np.where((k0 - _ONE) * dr > shift, k0 - _ONE, k0)
    k0 = np.where(k0 * dr <= shift, k0 + _ONE, k0)
    return np.maximum(k0, np.float32(0.0))


def closed_k0_np(dr, shift):
    """First sample with ``k*dr > shift``, elementwise, float32."""
    dr = np.asarray(dr, dtype="f4")
    shift = np.asarray(shift, dtype="f4")
    return _refine_k0((np.floor(shift / dr) + _ONE).astype("f4"), dr, shift)


def closed_bounds_k0_np(dr0, sh0, r_edges, R):
    """Range-bin sample bounds [C, n_r+1] (clipped to [0, R]) and k0 [C].

    Float32 host values, bit-identical to the JAX package's device
    refinement and to its ``closed_bounds_k0_np``.
    """
    dr0 = np.asarray(dr0, dtype="f4")
    edges = np.asarray(r_edges, dtype="f4")[None, :]
    q = np.ceil(edges / dr0[:, None]).astype("f4")
    bounds = np.clip(_refine_bounds(q, dr0, edges), np.float32(0.0), np.float32(R))
    return bounds, closed_k0_np(dr0, sh0)


def closed_window_counts_np(bounds, k0, valid_len, x_rel, n_x_window):
    """Exact closed-form per-window-bin counts on host: f8 [C, W, n_r].

    Copied from the JAX package (its module imports jax).  Mirrors the
    device count math (diff of clip(bounds, k0, valid_len) reduced over
    window bins) without materializing [C, P, n_r]: per channel a histogram
    of valid lengths per window bin gives
    S(v) = sum_p min(v, L_p) = v * #{L >= v} + sum_{L < v} L in O(W * R),
    and counts = diff(S at the clamped bounds)."""
    valid_len = np.asarray(valid_len)
    C, P = valid_len.shape
    n_r = bounds.shape[1] - 1
    bl = np.maximum(bounds, k0[:, None])  # [C, n_r+1], integral floats
    ids = np.asarray(x_rel, dtype="i8")
    inb = (ids >= 0) & (ids < n_x_window)
    idc = ids[inb]
    counts = np.zeros((C, n_x_window, n_r), dtype="f8")
    if idc.size == 0:
        return counts
    R = int(valid_len.max(initial=0))
    nv = R + 2
    v_ids = np.arange(nv, dtype="f8")
    nb = None
    for c in range(C):
        Lc_all = valid_len[c, inb]
        u = np.unique(Lc_all)
        if u.size == 1:
            # constant valid length (the instrument norm): counts factor as
            # per-ping bin sizes x pings-per-window-bin
            per_ping = np.diff(np.minimum(bl[c], float(u[0])))  # [n_r]
            if nb is None:
                nb = np.bincount(idc, minlength=n_x_window).astype("f8")
            counts[c] = nb[:, None] * per_ping[None, :]
            continue
        Lc = np.clip(Lc_all.astype("i8"), 0, nv - 1)
        H = np.zeros((n_x_window, nv), dtype="f8")
        np.add.at(H, (idc, Lc), 1.0)
        cnt_ge = np.cumsum(H[:, ::-1], axis=1)[:, ::-1]  # #{L >= v}
        sum_lt = np.concatenate(
            [np.zeros((n_x_window, 1)), np.cumsum(H * v_ids, axis=1)[:, :-1]],
            axis=1,
        )  # sum_{L < v} L
        b = np.clip(bl[c].astype("i8"), 0, nv - 1)  # [n_r+1]
        S = b.astype("f8") * cnt_ge[:, b] + sum_lt[:, b]
        counts[c] = np.diff(S, axis=1)
    return counts


def kernel_inputs_from_numpy(power, dr, tvg_shift, absorption, offset, valid_len,
                             x_rel, r_edges, n_x_window: int, *, uniform: bool, device):
    """Host arrays of one chunk -> the operands of K1 (``uniform``) or K2.

    Takes the arrays the JAX survey streamer hands its device step: power
    [C, P, R] int16 indices; dr, tvg_shift, absorption, offset [C, P];
    valid_len [C, P]; x_rel [P] sorted window-relative ping-bin ids (padding
    parked at ``n_x_window``); r_edges [n_r+1] metres.  Builds on the host
    the window ping bounds ``xb``, the range-bin bounds and ``k0``, and for
    K1 the per-channel rows ``sprd_row`` (-inf below k0) and ``rt2_row``;
    returns a dict of tensors on ``device`` keyed by the kernel's argument
    names.  The host-to-device copies are synchronous.
    """
    power = np.asarray(power)
    if power.dtype != np.int16:
        raise TypeError(f"power must be int16 sample indices, got {power.dtype}")
    C, P, R = power.shape
    valid_len = np.asarray(valid_len).astype("i4")
    if valid_len.shape != (C, P) or valid_len.min(initial=0) < 0 or valid_len.max(initial=0) > R:
        raise ValueError("valid_len must be [C, P] within [0, R]")
    x_rel = np.asarray(x_rel)
    if x_rel.shape != (P,) or np.any(np.diff(x_rel) < 0):
        raise ValueError("x_rel must be [P] and non-decreasing")
    xb = np.searchsorted(x_rel, np.arange(n_x_window + 1), side="left").astype("i4")
    dr = np.asarray(dr, dtype="f4")
    tvg_shift = np.asarray(tvg_shift, dtype="f4")

    def dev(a, dtype="f4"):
        return torch.from_numpy(np.ascontiguousarray(a, dtype=dtype)).to(device)

    bounds, k0 = closed_bounds_k0_np(dr[:, 0], tvg_shift[:, 0], r_edges, R)
    ops = {
        "power": dev(power, "i2"),
        "absorption": dev(absorption),
        "offset": dev(offset),
        "valid_len": dev(valid_len, "i4"),
        "xb": dev(xb, "i4"),
    }
    if uniform:
        bounds = np.clip(bounds, k0[:, None], np.float32(R))
        k = np.arange(R, dtype="f4")[None, :]
        rt = k * dr[:, :1] - tvg_shift[:, :1]  # [C, R] f32
        with np.errstate(divide="ignore"):
            sprd = np.float32(20.0) * np.log10(np.maximum(rt, np.float32(1e-20)))
        ops["sprd_row"] = dev(np.where(k >= k0[:, None], sprd, -np.inf))
        ops["rt2_row"] = dev(np.float32(2.0) * rt)
    else:
        ops["dr"] = dev(dr)
        ops["tvg_shift"] = dev(tvg_shift)
        ops["k0"] = dev(closed_k0_np(dr, tvg_shift), "i4")
    ops["bounds"] = dev(bounds, "i4")
    return ops


def sv_mvbs_window_partials_uniform(
    power, dr, tvg_shift, absorption, offset, valid_len, x_rel, r_edges,
    n_x_window: int, n_r: int, with_counts: bool = True, device="cuda",
):
    """Window partials for per-channel uniform ``dr`` and TVG shift (K1).

    Same arguments as the JAX function (host arrays; int16 power).  Returns
    (sums, counts) [C, n_x_window, n_r] float32 tensors on ``device``, or
    sums alone with ``with_counts=False`` (the survey takes its counts from
    :func:`closed_window_counts_np`).  Callers check uniformity.
    """
    ops = kernel_inputs_from_numpy(
        power, dr, tvg_shift, absorption, offset, valid_len, x_rel, r_edges,
        n_x_window, uniform=True, device=resolve_device(device),
    )
    _check_n_r(ops, n_r)
    return window_partials_uniform(**ops, with_counts=with_counts)


def sv_mvbs_window_partials(
    power, dr, tvg_shift, absorption, offset, valid_len, x_rel, r_edges,
    n_x_window: int, n_r: int, device="cuda",
):
    """Window partials with per-ping ``dr`` and TVG shift (K2), EK case.

    Range bins follow each channel's first-ping ``dr`` as in the JAX
    function.  Returns (sums, counts) [C, n_x_window, n_r] float32 tensors
    on ``device``.
    """
    ops = kernel_inputs_from_numpy(
        power, dr, tvg_shift, absorption, offset, valid_len, x_rel, r_edges,
        n_x_window, uniform=False, device=resolve_device(device),
    )
    _check_n_r(ops, n_r)
    return window_partials(**ops)


def _check_n_r(ops, n_r):
    if ops["bounds"].shape[1] != n_r + 1:
        raise ValueError(f"n_r={n_r} disagrees with {ops['bounds'].shape[1]} range edges")
