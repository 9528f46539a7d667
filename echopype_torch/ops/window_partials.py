"""Fused survey window partials: the two hand-written CUDA kernels.

Counterpart of ``echopype_tpu/ops/pallas_window.py``:

* K1 :func:`window_partials_uniform` replaces ``window_partials_pallas_uniform``
  (per-channel uniform ``dr``; the spreading log is one [C, R] row);
* K2 :func:`window_partials` replaces ``window_partials_pallas`` (per-ping
  ``dr``, TVG shift and first valid sample).

Each computes, for every (channel, ping-window bin, range bin) cell, the sum
of ``10^(Sv/10)`` over its samples, with
``Sv = power*INDEX2POWER + 20 log10(r_tvg) + 2 alpha r_tvg + offset``, and
the number of samples (K1 on request, K2 always).  ``power`` is int16
sample indices (EK60/EK80) or, as the Pallas kernels also take it, float32
dB (AZFP: no INDEX2POWER); the dtype picks the kernel's instance, each with
its own :data:`LAUNCHES` key.  float32 power follows the XLA step the JAX
survey runs for it (``parallel/pipeline.py::_closed_s1_n1``): a sample
whose Sv is NaN adds 0 to its bin, every other sample from ``k0`` on is
added whatever ``valid_len`` says, and counts stay closed form from
``valid_len`` (the Pallas bodies would spread the NaN instead).  The kernels live in
``csrc/window_partials.cu`` (the design and what bounds it are noted
there): one block per (channel, ping slab), a slab being at most
:data:`SLAB_PINGS` pings of one window bin, cut on the host by
:func:`slab_plan`.  The operands are the ones
``parallel/pipeline.py::kernel_inputs_from_numpy`` builds: int16 or float32
power, int32 valid lengths / window ping bounds ``xb`` / range-bin sample bounds,
and the slab ``plan``.

Dispatch is by the device of ``power``: a CUDA tensor launches the kernel
(or raises), a CPU tensor runs the plain PyTorch twin beside it.  The twins
are transcribed from the XLA functions the JAX survey path runs
(``parallel/pipeline.py::sv_mvbs_window_partials_uniform`` /
``sv_mvbs_window_partials``); ``chip_smoke.py`` also runs them on the card
to check the kernels.  :data:`LAUNCHES` counts kernel launches only.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..utils.profiling import launch_span
from .binning import _banded_x_reduce_xb

__all__ = [
    "LAUNCHES",
    "SLAB_PINGS",
    "reset_launches",
    "slab_plan",
    "window_partials",
    "window_partials_plain",
    "window_partials_uniform",
    "window_partials_uniform_plain",
]

INDEX2POWER = 0.011758984205624481  # 10*log10(2)/256
LN10_OVER_10 = 0.23025850929940458

#: kernel name -> launches since the last :func:`reset_launches`
LAUNCHES = {"window_partials_uniform": 0, "window_partials": 0,
            "window_partials_uniform_f32": 0, "window_partials_f32": 0}

#: power dtype -> the suffix of its instance's C entry point and LAUNCHES key
_INSTANCES = {torch.int16: "", torch.float32: "_f32"}

#: most pings one block of K1 / K2 walks: windows longer than this are cut
#: into several slabs, so a survey of few, long windows still fills the card
SLAB_PINGS = 32


def reset_launches():
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def slab_plan(xb):
    """The kernels' work split of window ping bounds ``xb`` [W + 1].

    Window w (pings ``[xb[w], xb[w+1])``) is cut into
    ``n = max(1, ceil(len / SLAB_PINGS))`` slabs, so no slab crosses a
    window and an empty window keeps one empty slab (its output cells are
    written as zeros).  Returns int32 ``[n_slabs + W + 1]``: each slab's
    window ``sw``, then each window's first slab ``wf`` (window w owns slabs
    ``[wf[w], wf[w+1])``, ``wf[W] = n_slabs``).  The kernels take slab
    ``wf[w] + i`` to be pings ``[xb[w] + i*len // n, xb[w] + (i+1)*len // n)``
    of the ``xb`` they are given, so the plan only splits the work: any plan
    of W windows gives the same windows' sums.
    """
    xb = np.asarray(xb, dtype="i8")
    if xb.ndim != 1 or xb.size == 0 or np.any(np.diff(xb) < 0):
        raise ValueError("xb must be a non-empty, non-decreasing 1-D array")
    n_per = np.maximum(1, -(-np.diff(xb) // SLAB_PINGS))
    wf = np.concatenate([[0], np.cumsum(n_per)])
    plan = np.concatenate([np.repeat(np.arange(n_per.size), n_per), wf])
    if plan.max(initial=0) > np.iinfo(np.int32).max:
        raise ValueError("slab plan does not fit int32")
    return plan.astype("i4")


def _range_bin_matrix(bounds, R):
    """[C, R, n_r] 0/1 float32: sample k lies in [bounds[b], bounds[b+1])."""
    k = torch.arange(R, device=bounds.device)[None, :, None]
    return ((k >= bounds[:, None, :-1]) & (k < bounds[:, None, 1:])).to(torch.float32)


def _power_db(power):
    """Power in dB: int16 indices scaled by INDEX2POWER, float32 as it is."""
    if power.dtype == torch.int16:
        return power.to(torch.float32) * INDEX2POWER
    if power.dtype == torch.float32:
        return power
    raise TypeError(f"power must be int16 indices or float32 dB, got {power.dtype}")


def _lin_kept(e, power, lane, valid_len):
    """``e`` where a sample is added: below ``valid_len`` for int16 power,
    where ``e`` is not NaN for float32 dB."""
    if power.dtype == torch.int16:
        return torch.where(lane < valid_len[:, :, None], e, 0.0)
    return torch.where(torch.isnan(e), 0.0, e)


def window_partials_uniform_plain(power, sprd_row, rt2_row, absorption, offset,
                                  valid_len, xb, bounds, with_counts=True):
    """Plain PyTorch K1 (see :func:`window_partials_uniform`)."""
    C, P, R = power.shape
    n_r = bounds.shape[1] - 1
    sv = (
        _power_db(power)
        + sprd_row[:, None, :]
        + absorption[:, :, None] * rt2_row[:, None, :]
        + offset[:, :, None]
    )
    lane = torch.arange(R, device=power.device)
    lin = _lin_kept(torch.exp(sv * LN10_OVER_10), power, lane, valid_len)
    s1 = torch.bmm(lin, _range_bin_matrix(bounds, R))  # [C, P, n_r]
    if not with_counts:
        return _banded_x_reduce_xb(s1, xb)
    # bounds are clipped to [k0, R], so only the valid length clips here
    n1 = torch.diff(torch.minimum(bounds[:, None, :], valid_len[:, :, None]), dim=2)
    both = _banded_x_reduce_xb(torch.cat([s1, n1.to(torch.float32)], dim=2), xb)
    return both[:, :, :n_r], both[:, :, n_r:]


def window_partials_plain(power, dr, tvg_shift, absorption, offset, k0, valid_len,
                          xb, bounds):
    """Plain PyTorch K2 (see :func:`window_partials`)."""
    C, P, R = power.shape
    n_r = bounds.shape[1] - 1
    lane = torch.arange(R, device=power.device)
    r_tvg = lane.to(torch.float32) * dr[:, :, None] - tvg_shift[:, :, None]
    sv = (
        _power_db(power)
        + 20.0 * torch.log10(torch.clamp_min(r_tvg, 1e-20))
        + 2.0 * absorption[:, :, None] * r_tvg
        + offset[:, :, None]
    )
    e = torch.where(lane >= k0[:, :, None], torch.exp(sv * LN10_OVER_10), 0.0)
    lin = _lin_kept(e, power, lane, valid_len)
    s1 = torch.bmm(lin, _range_bin_matrix(bounds, R))
    clipped = torch.minimum(
        torch.maximum(bounds[:, None, :], k0[:, :, None]), valid_len[:, :, None]
    )
    n1 = torch.diff(clipped, dim=2).to(torch.float32)
    both = _banded_x_reduce_xb(torch.cat([s1, n1], dim=2), xb)
    return both[:, :, :n_r], both[:, :, n_r:]


def _check(name, t, dtype, shape, device):
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, power on {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _launch(entry, name, power, operands, W, n_r, with_counts):
    """Check the operands, allocate the outputs (and the slab partials when
    some window has several slabs) and launch ``entry`` on the current
    stream.  ``operands``: C argument order, name -> (tensor, dtype, shape),
    starting with power; the slab ``plan``'s shape is checked here.  The
    instance follows power's dtype: int16 launches ``entry``, float32
    ``entry + "_f32"`` (counted under ``name + "_f32"``)."""
    if power.dtype not in _INSTANCES:
        raise TypeError(f"power must be int16 indices or float32 dB, got {power.dtype}")
    entry, name = entry + _INSTANCES[power.dtype], name + _INSTANCES[power.dtype]
    if W < 0 or n_r < 0:
        raise ValueError("xb and bounds need at least one entry each")
    dev = power.device
    for key, (t, dtype, shape) in operands.items():
        _check(key, t, dtype, shape, dev)
    plan = operands["plan"][0]
    n_slabs = plan.shape[0] - W - 1
    if plan.dim() != 1 or n_slabs < W:
        raise ValueError(f"plan must be slab_plan(xb) of {W} windows, got shape {tuple(plan.shape)}")
    C, P, R = power.shape
    sums = torch.empty((C, W, n_r), dtype=torch.float32, device=dev)
    counts = torch.empty_like(sums) if with_counts else None
    scratch = [None, None]
    if n_slabs != W:  # some window has several slabs: per-slab partials, then their sums
        scratch = [torch.empty((C, n_slabs, n_r), dtype=torch.float32, device=dev),
                   torch.empty((C, n_slabs, n_r), dtype=torch.float32, device=dev)
                   if with_counts else None]
    from ._build import load_library

    fn = getattr(load_library("window_partials"), entry)
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * (len(operands) + 4) + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    ptrs = [t.data_ptr() for t, _, _ in operands.values()]
    ptrs += [None if t is None else t.data_ptr() for t in (*scratch, sums, counts)]
    with torch.cuda.device(dev), launch_span(entry):
        status = fn(*ptrs, C, P, R, W, n_r, n_slabs, torch.cuda.current_stream(dev).cuda_stream)
    if status != 0:
        raise RuntimeError(f"{entry} launch failed with CUDA error {status}")
    LAUNCHES[name] += 1
    return (sums, counts) if with_counts else sums


def window_partials_uniform(power, sprd_row, rt2_row, absorption, offset, valid_len,
                            xb, bounds, with_counts=True, *, plan):
    """K1: fused window partials for per-channel uniform ``dr``.

    power [C, P, R] int16 indices or float32 dB; sprd_row [C, R] f32
    ``20 log10(k dr - shift)`` with -inf below the first valid sample k0;
    rt2_row [C, R] f32 ``2 (k dr - shift)``; absorption, offset [C, P] f32;
    valid_len [C, P] int32; xb [W + 1] int32 window ping bounds; bounds
    [C, n_r + 1] int32 range-bin sample bounds clipped to [k0, R]; plan
    int32 ``slab_plan(xb)`` on power's device (the kernel's work split; the
    CPU twin has no use for it).
    Returns sums [C, W, n_r] f32, and counts [C, W, n_r] f32 when
    ``with_counts``.
    """
    if power.device.type == "cpu":
        return window_partials_uniform_plain(power, sprd_row, rt2_row, absorption, offset,
                                             valid_len, xb, bounds, with_counts)
    if power.device.type != "cuda":
        raise ValueError(f"window_partials_uniform runs on cuda or cpu, not {power.device}")
    C, P, R = power.shape
    W, n_r = xb.shape[0] - 1, bounds.shape[1] - 1
    f32, i32 = torch.float32, torch.int32
    return _launch("ep_window_partials_uniform", "window_partials_uniform", power, {
        "power": (power, power.dtype, (C, P, R)),
        "sprd_row": (sprd_row, f32, (C, R)),
        "rt2_row": (rt2_row, f32, (C, R)),
        "absorption": (absorption, f32, (C, P)),
        "offset": (offset, f32, (C, P)),
        "valid_len": (valid_len, i32, (C, P)),
        "xb": (xb, i32, (W + 1,)),
        "plan": (plan, i32, tuple(plan.shape)),
        "bounds": (bounds, i32, (C, n_r + 1)),
    }, W, n_r, with_counts)


def window_partials(power, dr, tvg_shift, absorption, offset, k0, valid_len, xb, bounds,
                    *, plan):
    """K2: fused window partials with per-ping ``dr``, TVG shift and ``k0``.

    power [C, P, R] int16 indices or float32 dB; dr, tvg_shift, absorption,
    offset [C, P] f32; k0 [C, P] int32 first sample with ``k dr > shift``;
    valid_len [C, P] int32; xb [W + 1] int32; bounds [C, n_r + 1] int32 range-bin
    sample bounds clipped to [0, R]; plan as for K1.  Returns (sums, counts)
    [C, W, n_r] f32.
    """
    if power.device.type == "cpu":
        return window_partials_plain(power, dr, tvg_shift, absorption, offset, k0,
                                     valid_len, xb, bounds)
    if power.device.type != "cuda":
        raise ValueError(f"window_partials runs on cuda or cpu, not {power.device}")
    C, P, R = power.shape
    W, n_r = xb.shape[0] - 1, bounds.shape[1] - 1
    f32, i32 = torch.float32, torch.int32
    return _launch("ep_window_partials", "window_partials", power, {
        "power": (power, power.dtype, (C, P, R)),
        "dr": (dr, f32, (C, P)),
        "tvg_shift": (tvg_shift, f32, (C, P)),
        "absorption": (absorption, f32, (C, P)),
        "offset": (offset, f32, (C, P)),
        "k0": (k0, i32, (C, P)),
        "valid_len": (valid_len, i32, (C, P)),
        "xb": (xb, i32, (W + 1,)),
        "plan": (plan, i32, tuple(plan.shape)),
        "bounds": (bounds, i32, (C, n_r + 1)),
    }, W, n_r, True)
