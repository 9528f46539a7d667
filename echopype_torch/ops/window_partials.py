"""Fused survey window partials: the two hand-written CUDA kernels.

Counterpart of ``echopype_tpu/ops/pallas_window.py``:

* K1 :func:`window_partials_uniform` replaces ``window_partials_pallas_uniform``
  (per-channel uniform ``dr``; the spreading log is one [C, R] row);
* K2 :func:`window_partials` replaces ``window_partials_pallas`` (per-ping
  ``dr``, TVG shift and first valid sample).

Each computes, for every (channel, ping-window bin, range bin) cell, the sum
of ``10^(Sv/10)`` over its samples, with
``Sv = power*INDEX2POWER + 20 log10(r_tvg) + 2 alpha r_tvg + offset``, and
the number of samples (K1 on request, K2 always).  The kernels live in
``csrc/window_partials.cu`` (the design and what bounds it are noted
there).  The operands are the ones
``parallel/pipeline.py::kernel_inputs_from_numpy`` builds: int16 power,
int32 valid lengths / window ping bounds ``xb`` / range-bin sample bounds.

Dispatch is by the device of ``power``: a CUDA tensor launches the kernel
(or raises), a CPU tensor runs the plain PyTorch twin beside it.  The twins
are transcribed from the XLA functions the JAX survey path runs
(``parallel/pipeline.py::sv_mvbs_window_partials_uniform`` /
``sv_mvbs_window_partials``); ``chip_smoke.py`` also runs them on the card
to check the kernels.  :data:`LAUNCHES` counts kernel launches only.
"""

from __future__ import annotations

import ctypes

import torch

from .binning import banded_x_reduce

__all__ = [
    "LAUNCHES",
    "reset_launches",
    "window_partials",
    "window_partials_plain",
    "window_partials_uniform",
    "window_partials_uniform_plain",
]

INDEX2POWER = 0.011758984205624481  # 10*log10(2)/256
LN10_OVER_10 = 0.23025850929940458

#: kernel name -> launches since the last :func:`reset_launches`
LAUNCHES = {"window_partials_uniform": 0, "window_partials": 0}


def reset_launches():
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _range_bin_matrix(bounds, R):
    """[C, R, n_r] 0/1 float32: sample k lies in [bounds[b], bounds[b+1])."""
    k = torch.arange(R, device=bounds.device)[None, :, None]
    return ((k >= bounds[:, None, :-1]) & (k < bounds[:, None, 1:])).to(torch.float32)


def window_partials_uniform_plain(power, sprd_row, rt2_row, absorption, offset,
                                  valid_len, xb, bounds, with_counts=True):
    """Plain PyTorch K1 (see :func:`window_partials_uniform`)."""
    C, P, R = power.shape
    n_r = bounds.shape[1] - 1
    sv = (
        power.to(torch.float32) * INDEX2POWER
        + sprd_row[:, None, :]
        + absorption[:, :, None] * rt2_row[:, None, :]
        + offset[:, :, None]
    )
    lane = torch.arange(R, device=power.device)
    lin = torch.where(lane < valid_len[:, :, None], torch.exp(sv * LN10_OVER_10), 0.0)
    s1 = torch.bmm(lin, _range_bin_matrix(bounds, R))  # [C, P, n_r]
    if not with_counts:
        return banded_x_reduce(s1, xb)
    # bounds are clipped to [k0, R], so only the valid length clips here
    n1 = torch.diff(torch.minimum(bounds[:, None, :], valid_len[:, :, None]), dim=2)
    both = banded_x_reduce(torch.cat([s1, n1.to(torch.float32)], dim=2), xb)
    return both[:, :, :n_r], both[:, :, n_r:]


def window_partials_plain(power, dr, tvg_shift, absorption, offset, k0, valid_len,
                          xb, bounds):
    """Plain PyTorch K2 (see :func:`window_partials`)."""
    C, P, R = power.shape
    n_r = bounds.shape[1] - 1
    lane = torch.arange(R, device=power.device)
    r_tvg = lane.to(torch.float32) * dr[:, :, None] - tvg_shift[:, :, None]
    sv = (
        power.to(torch.float32) * INDEX2POWER
        + 20.0 * torch.log10(torch.clamp_min(r_tvg, 1e-20))
        + 2.0 * absorption[:, :, None] * r_tvg
        + offset[:, :, None]
    )
    valid = (lane >= k0[:, :, None]) & (lane < valid_len[:, :, None])
    lin = torch.where(valid, torch.exp(sv * LN10_OVER_10), 0.0)
    s1 = torch.bmm(lin, _range_bin_matrix(bounds, R))
    clipped = torch.minimum(
        torch.maximum(bounds[:, None, :], k0[:, :, None]), valid_len[:, :, None]
    )
    n1 = torch.diff(clipped, dim=2).to(torch.float32)
    both = banded_x_reduce(torch.cat([s1, n1], dim=2), xb)
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
    """Check the operands, allocate the outputs and launch ``entry`` on the
    current stream.  ``operands``: C argument order, name -> (tensor, dtype,
    shape), starting with power."""
    if W < 0 or n_r < 0:
        raise ValueError("xb and bounds need at least one entry each")
    dev = power.device
    for key, (t, dtype, shape) in operands.items():
        _check(key, t, dtype, shape, dev)
    C, P, R = power.shape
    sums = torch.empty((C, W, n_r), dtype=torch.float32, device=dev)
    counts = torch.empty_like(sums) if with_counts else None
    from ._build import load_library

    fn = getattr(load_library("window_partials"), entry)
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * (len(operands) + 2) + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    with torch.cuda.device(dev):
        status = fn(
            *[t.data_ptr() for t, _, _ in operands.values()],
            sums.data_ptr(), None if counts is None else counts.data_ptr(),
            C, P, R, W, n_r, torch.cuda.current_stream(dev).cuda_stream,
        )
    if status != 0:
        raise RuntimeError(f"{entry} launch failed with CUDA error {status}")
    LAUNCHES[name] += 1
    return (sums, counts) if with_counts else sums


def window_partials_uniform(power, sprd_row, rt2_row, absorption, offset, valid_len,
                            xb, bounds, with_counts=True):
    """K1: fused window partials for per-channel uniform ``dr``.

    power [C, P, R] int16 indices; sprd_row [C, R] f32
    ``20 log10(k dr - shift)`` with -inf below the first valid sample k0;
    rt2_row [C, R] f32 ``2 (k dr - shift)``; absorption, offset [C, P] f32;
    valid_len [C, P] int32; xb [W + 1] int32 window ping bounds; bounds
    [C, n_r + 1] int32 range-bin sample bounds clipped to [k0, R].
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
        "power": (power, torch.int16, (C, P, R)),
        "sprd_row": (sprd_row, f32, (C, R)),
        "rt2_row": (rt2_row, f32, (C, R)),
        "absorption": (absorption, f32, (C, P)),
        "offset": (offset, f32, (C, P)),
        "valid_len": (valid_len, i32, (C, P)),
        "xb": (xb, i32, (W + 1,)),
        "bounds": (bounds, i32, (C, n_r + 1)),
    }, W, n_r, with_counts)


def window_partials(power, dr, tvg_shift, absorption, offset, k0, valid_len, xb, bounds):
    """K2: fused window partials with per-ping ``dr``, TVG shift and ``k0``.

    power [C, P, R] int16 indices; dr, tvg_shift, absorption, offset [C, P]
    f32; k0 [C, P] int32 first sample with ``k dr > shift``; valid_len
    [C, P] int32; xb [W + 1] int32; bounds [C, n_r + 1] int32 range-bin
    sample bounds clipped to [0, R].  Returns (sums, counts) [C, W, n_r] f32.
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
        "power": (power, torch.int16, (C, P, R)),
        "dr": (dr, f32, (C, P)),
        "tvg_shift": (tvg_shift, f32, (C, P)),
        "absorption": (absorption, f32, (C, P)),
        "offset": (offset, f32, (C, P)),
        "k0": (k0, i32, (C, P)),
        "valid_len": (valid_len, i32, (C, P)),
        "xb": (xb, i32, (W + 1,)),
        "bounds": (bounds, i32, (C, n_r + 1)),
    }, W, n_r, True)
