"""Survey device steps: power -> Sv -> bin partials, on one device.

Counterpart of the single-device parts of
``echopype_tpu/parallel/pipeline.py``:

* the raw->MVBS survey's window step: ``sv_mvbs_window_partials_uniform``
  (per-channel uniform ``dr``, the instrument norm, K1) and
  ``sv_mvbs_window_partials`` (``dr`` varying by ping, or an echo_range
  intercept ``r0``: AZFP's float32 dB power; K2), plus the host helpers
  that fix their bin bounds;
* the same step with a frequency-differencing mask fused in,
  ``sv_mvbs_window_partials_freqdiff`` (plain torch: its counts depend on
  the data, so they are summed like the values);
* the full survey-processing step ``survey_pipeline_step`` /
  ``sharded_sv_mvbs_step``: float32 dB power -> Sv and its MVBS in one
  pass, on K3 (with Sv) or K4 (MVBS only) for uniform ``dr``, and the plain
  cores ``sv_mvbs_core`` (per-ping ``dr``) and ``sv_mvbs_core_mxu``.
  Multi-device meshes wait for ROADMAP Queue 1 item 10.

On the kernels' paths nothing is divided on the device.  The range-bin
sample bounds and the first valid sample ``k0`` come from the host in float32, refined against
exact float32 products (``_refine_bounds`` / ``_refine_k0``), so they are
the ones the JAX package computes, bit for bit.  The window counts of the
uniform path come from the host in closed form (``closed_window_counts_np``)
and the kernel returns sums only.
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import no_tf32, resolve_device
from ..ops.binning import _prefix_gather_diff, banded_x_reduce
from ..ops.sv_bin_partials import (
    _as_f32,
    _bin_matrix,
    _sv_db,
    fused_operands,
    mvbs_core_fused,
    sv_mvbs_core_fused,
)
from ..ops.window_partials import (
    INDEX2POWER,
    _range_bin_matrix,
    slab_plan,
    window_partials,
    window_partials_uniform,
)

__all__ = [
    "LAUNCHES",
    "_prefix_gather_diff",
    "closed_bounds_k0_np",
    "closed_k0_np",
    "closed_window_counts_np",
    "kernel_inputs_from_numpy",
    "sharded_sv_mvbs_step",
    "survey_pipeline_step",
    "sv_mvbs_core",
    "sv_mvbs_core_mxu",
    "sv_mvbs_window_partials",
    "sv_mvbs_window_partials_freqdiff",
    "sv_mvbs_window_partials_uniform",
]

_ONE = np.float32(1.0)
LAUNCHES = {"freqdiff_step": 0}


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
    refinement and to its ``closed_bounds_k0_np``.  ``r_edges`` is one
    [n_r+1] row of edges for every channel, or [C, n_r+1] per channel (the
    edges less each channel's echo_range intercept, ``edge_off`` of the JAX
    package's ``_closed_s1_n1``).
    """
    dr0 = np.asarray(dr0, dtype="f4")
    edges = np.asarray(r_edges, dtype="f4")
    if edges.ndim == 1:
        edges = edges[None, :]
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


def _edges_and_shift(r_edges, tvg_shift, r0):
    """The range-bin edges and TVG shift the kernels see, float32.

    Without ``r0`` (the EK case) they are ``r_edges`` and ``tvg_shift``.
    With an echo_range intercept ``r0`` [C, P] (AZFP: r = r0 + k dr), as in
    the JAX package's ``_closed_s1_n1``: per-channel edges
    ``edge_off = r_edges - r0[:, 0]`` (ping 0's intercept, the JAX quirk)
    and the per-ping shift ``tvg_shift - r0``, so that ``k dr - shift`` is
    the JAX ``k dr + (r0 - tvg_shift)`` exactly (IEEE negation is exact).
    """
    edges = np.asarray(r_edges, dtype="f4")
    tvg_shift = np.asarray(tvg_shift, dtype="f4")
    if r0 is None:
        return edges, tvg_shift
    r0 = np.asarray(r0, dtype="f4")
    return edges[None, :] - r0[:, :1], tvg_shift - r0


def kernel_inputs_from_numpy(power, dr, tvg_shift, absorption, offset, valid_len,
                             x_rel, r_edges, n_x_window: int, *, uniform: bool, device,
                             r0=None):
    """Host arrays of one chunk -> the operands of K1 (``uniform``) or K2.

    Takes the arrays the JAX survey streamer hands its device step: power
    [C, P, R] int16 indices (EK) or float32 dB (AZFP, NaN-padded); dr,
    tvg_shift, absorption, offset [C, P]; valid_len [C, P]; x_rel [P] sorted
    window-relative ping-bin ids (padding parked at ``n_x_window``); r_edges
    [n_r+1] metres; optionally the echo_range intercept ``r0`` [C, P]
    (:func:`_edges_and_shift`).  Builds on the host the window ping bounds
    ``xb`` and the kernels' slab ``plan``
    (``ops/window_partials.py::slab_plan``), the range-bin bounds and
    ``k0``, and for K1 the per-channel rows ``sprd_row`` (-inf below k0) and
    ``rt2_row``; returns a dict of tensors on ``device`` keyed by the
    kernel's argument names.  The host-to-device copies are synchronous.
    """
    power = np.asarray(power)
    if power.dtype not in (np.int16, np.float32):
        raise TypeError(f"power must be int16 sample indices or float32 dB, got {power.dtype}")
    C, P, R = power.shape
    valid_len = np.asarray(valid_len).astype("i4")
    if valid_len.shape != (C, P) or valid_len.min(initial=0) < 0 or valid_len.max(initial=0) > R:
        raise ValueError("valid_len must be [C, P] within [0, R]")
    x_rel = np.asarray(x_rel)
    if x_rel.shape != (P,) or np.any(np.diff(x_rel) < 0):
        raise ValueError("x_rel must be [P] and non-decreasing")
    xb = np.searchsorted(x_rel, np.arange(n_x_window + 1), side="left").astype("i4")
    dr = np.asarray(dr, dtype="f4")
    r_edges, tvg_shift = _edges_and_shift(r_edges, tvg_shift, r0)

    def dev(a, dtype="f4"):
        return torch.from_numpy(np.ascontiguousarray(a, dtype=dtype)).to(device)

    bounds, k0 = closed_bounds_k0_np(dr[:, 0], tvg_shift[:, 0], r_edges, R)
    ops = {
        "power": dev(power, power.dtype),
        "absorption": dev(absorption),
        "offset": dev(offset),
        "valid_len": dev(valid_len, "i4"),
        "xb": dev(xb, "i4"),
        "plan": dev(slab_plan(xb), "i4"),
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

    Same arguments as the JAX function (host arrays; int16 or float32 dB
    power, under the rule of ``ops/window_partials.py``).  Returns
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
    n_x_window: int, n_r: int, r0=None, device="cuda",
):
    """Window partials with per-ping ``dr`` and TVG shift (K2).

    The JAX function's arguments: int16 power (EK, ``r0`` None) or float32
    dB power with the echo_range intercept ``r0`` [C, P] (AZFP).  Range
    bins follow each channel's first-ping ``dr`` and ``r0`` as in the JAX
    function.  Returns (sums, counts) [C, n_x_window, n_r] float32 tensors
    on ``device``.
    """
    ops = kernel_inputs_from_numpy(
        power, dr, tvg_shift, absorption, offset, valid_len, x_rel, r_edges,
        n_x_window, uniform=False, device=resolve_device(device), r0=r0,
    )
    _check_n_r(ops, n_r)
    return window_partials(**ops)


_CMP = {
    ">": torch.gt,
    "<": torch.lt,
    ">=": torch.ge,
    "<=": torch.le,
    "==": torch.eq,
}


def sv_mvbs_window_partials_freqdiff(
    power, dr, tvg_shift, absorption, offset, valid_len, x_rel, r_edges,
    n_x_window: int, n_r: int, ia: int, ib: int, op: str, diff_db, r0=None, device="cuda",
):
    """Window partials of Sv masked by frequency differencing.

    Counterpart of the JAX function (an XLA program; ``r0`` [C, P] the
    echo_range intercept of AZFP, None for EK).
    Per sample ``keep = Sv[ia] - Sv[ib] <op> diff_db`` (NaN -> False, the
    reference's frequency_differencing applied to every channel as
    apply_mask does); a masked sample joins no bin.  power [C, P, R] int16
    indices (samples past ``valid_len`` are NaN) or float dB; dr,
    tvg_shift, absorption, offset [C, P]; x_rel [P] sorted window-relative
    ping-bin ids.  The range-bin sample bounds come from the host
    (:func:`closed_bounds_k0_np` on each channel's first-ping ``dr``); sums
    and the data-dependent counts reduce by one float32 matmul against the
    0/1 bin matrix with TF32 off, then over the ping window.  Returns
    (sums, counts) [C, n_x_window, n_r] float32 tensors on ``device``.
    """
    dev = resolve_device(device)
    power = np.asarray(power)
    C, P, R = power.shape
    dr = np.asarray(dr, dtype="f4")
    edges, _ = _edges_and_shift(r_edges, tvg_shift, r0)
    bounds, _ = closed_bounds_k0_np(dr[:, 0], np.asarray(tvg_shift, dtype="f4")[:, 0],
                                    edges, R)
    if bounds.shape[1] != n_r + 1:
        raise ValueError(f"n_r={n_r} disagrees with {bounds.shape[1]} range edges")

    def on(a, dtype=torch.float32):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev, dtype)

    lane = torch.arange(R, device=dev)
    if power.dtype.kind in "iu":
        pw = torch.where(lane < on(valid_len, torch.int64)[:, :, None],
                         on(power, torch.int16).to(torch.float32) * INDEX2POWER, torch.nan)
    else:
        pw = on(power)
    if r0 is None:
        r_tvg = lane.to(torch.float32) * on(dr)[:, :, None] - on(tvg_shift)[:, :, None]
    else:
        r_tvg = (lane.to(torch.float32) * on(dr)[:, :, None]
                 + (on(r0) - on(tvg_shift))[:, :, None])
    pos = r_tvg > 0
    sv = torch.where(
        pos,
        pw + 20.0 * torch.log10(torch.where(pos, r_tvg, 1.0))
        + 2.0 * on(absorption)[:, :, None] * r_tvg + on(offset)[:, :, None],
        torch.nan,
    )
    keep = _CMP[op](sv[ia] - sv[ib], float(diff_db))  # [P, R]; NaN -> False
    ok = ~torch.isnan(sv) & keep[None]
    lin = torch.where(ok, torch.pow(10.0, sv / 10.0), 0.0)
    m = _range_bin_matrix(on(bounds, torch.int64), R)
    x_rel = on(x_rel, torch.int64)
    xb = torch.searchsorted(x_rel, torch.arange(n_x_window + 1, device=dev), side="left")
    with no_tf32():
        s1 = torch.bmm(torch.cat([lin, ok.to(torch.float32)], dim=1), m)  # [C, 2P, n_r]
        both = banded_x_reduce(torch.cat([s1[:, :P], s1[:, P:]], dim=2), xb)
    if dev.type == "cuda":
        LAUNCHES["freqdiff_step"] += 1
    return both[:, :, :n_r], both[:, :, n_r:]


def _check_n_r(ops, n_r):
    if ops["bounds"].shape[1] != n_r + 1:
        raise ValueError(f"n_r={n_r} disagrees with {ops['bounds'].shape[1]} range edges")


# ---------------------------------------------- full survey-processing step
def _ping_sums(s1, n1, xb):
    xb = xb.long()[None, :, None].expand(s1.shape[0], xb.shape[0], s1.shape[2])
    return _prefix_gather_diff(s1, xb, 1), _prefix_gather_diff(n1, xb, 1)


def sv_mvbs_core(power, dr, tvg_shift, absorption, offset, x_idx, r_edges, n_x, n_r,
                 device="cuda"):
    """Single-shard fused pipeline for per-ping ``dr``: power -> Sv -> partials.

    Plain torch, as the JAX package runs it in XLA: per-ping range-bin
    bounds ``ceil(r_edges / dr)`` on the device, range and ping sums by
    cumsum-gather-diff.  x_idx: sorted int [P] ping-bin ids (-1 = outside);
    r_edges: f32 [n_r + 1] left-closed range-bin edges.  Returns (Sv
    [C, P, R], sums [C, n_x, n_r], counts) float32 tensors on ``device``.
    """
    ops, xb = fused_operands(power, dr, tvg_shift, absorption, offset, x_idx, r_edges, n_x,
                             n_r, device)
    ops.pop("bounds")  # the host's first-ping bounds; this core bins each ping by its own dr
    sv = _sv_db(**ops)
    edges = _as_f32(r_edges, sv.device)
    rb = torch.clamp(torch.ceil(edges[None, None, :] / ops["dr"][:, :, None]), 0, sv.shape[2])
    ok = ~torch.isnan(sv)
    lin = torch.where(ok, torch.pow(10.0, sv / 10.0), 0.0)
    s1 = _prefix_gather_diff(lin, rb, 2)
    n1 = _prefix_gather_diff(ok.to(torch.float32), rb, 2)
    return (sv, *_ping_sums(s1, n1, xb))


def sv_mvbs_core_mxu(power, dr, tvg_shift, absorption, offset, x_idx, r_edges, n_x, n_r,
                     device="cuda"):
    """The fused pipeline for per-channel-constant ``dr``, in plain torch.

    The reference K3 and K4 are held to (``sv_mvbs_core_mxu`` in the JAX
    package): range-bin sums as a batched matmul against each channel's 0/1
    band matrix built from ``dr[:, 0]`` (host bounds, :func:`core_bounds_np`),
    ping sums by cumsum-gather-diff.  Same arguments and returns as
    :func:`sv_mvbs_core`.
    """
    ops, xb = fused_operands(power, dr, tvg_shift, absorption, offset, x_idx, r_edges, n_x,
                             n_r, device)
    bounds = ops.pop("bounds")
    sv = _sv_db(**ops)
    m = _bin_matrix(bounds, sv.shape[2])
    ok = ~torch.isnan(sv)
    lin = torch.where(ok, torch.pow(10.0, sv / 10.0), 0.0)
    return (sv, *_ping_sums(torch.bmm(lin, m), torch.bmm(ok.to(torch.float32), m), xb))


def _single_device(mesh):
    """Accept ``None`` or a one-device, two-axis layout; raise otherwise."""
    if mesh is None:
        return
    if getattr(mesh, "size", None) == 1 and "range" not in getattr(mesh, "axis_names", ()):
        return
    raise NotImplementedError(
        "echopype_torch runs the survey step on one device (mesh=None); multi-device "
        "meshes and the (ping, channel, range) step are ROADMAP Queue 1 item 10"
    )


def sharded_sv_mvbs_step(mesh, n_x: int, n_r: int, uniform_dr: bool = True,
                         with_sv: bool = True, device="cuda"):
    """Build the survey step for one device.

    Returns fn(power, dr, tvg_shift, absorption, offset, x_idx, r_edges) ->
    (Sv [C, P, R], MVBS [C, n_x, n_r]), or MVBS alone when ``with_sv`` is
    False; MVBS is ``10 log10(sums / counts)``, NaN where a bin is empty.
    ``uniform_dr=True`` (each channel's ``dr`` ping-invariant, the
    instrument norm) runs K3 (:func:`sv_mvbs_core_fused`) with Sv and K4
    (:func:`mvbs_core_fused`) without, the drop-ins of the JAX package's
    ``sv_mvbs_core_mxu``; ``uniform_dr=False`` runs :func:`sv_mvbs_core`.
    ``mesh`` must be ``None`` or a one-device layout (the JAX signature);
    inputs are host arrays or tensors, outputs float32 tensors on ``device``.
    """
    _single_device(mesh)
    dev = resolve_device(device)

    def step(power, dr, tvg_shift, absorption, offset, x_idx, r_edges):
        args = (power, dr, tvg_shift, absorption, offset, x_idx, r_edges, n_x, n_r)
        sv = None
        if not uniform_dr:
            sv, sums, counts = sv_mvbs_core(*args, device=dev)
        elif with_sv:
            sv, sums, counts = sv_mvbs_core_fused(*args, device=dev)
        else:
            sums, counts = mvbs_core_fused(*args, device=dev)
        mean = sums / torch.where(counts > 0, counts, 1.0)
        mvbs = torch.where(counts > 0, 10.0 * torch.log10(mean), torch.nan)
        return (sv, mvbs) if with_sv else mvbs

    return step


def survey_pipeline_step(mesh, n_x: int, n_r: int, with_sv: bool = True, device="cuda"):
    """One full survey-processing step on one device (``mesh=None``).

    Counterpart of ``echopype_tpu.parallel.survey_pipeline_step``: float32
    dB power -> Sv and its MVBS on K3 (``with_sv``) or K4.
    """
    return sharded_sv_mvbs_step(mesh, n_x, n_r, with_sv=with_sv, device=device)
