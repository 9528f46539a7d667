"""Fused Sv + per-ping range-bin partials: the two hand-written CUDA kernels.

Counterpart of ``echopype_tpu/ops/pallas_pipeline.py``:

* K3 :func:`sv_bin_partials` replaces ``sv_bin_partials_pallas``: float32
  dB power -> Sv written out (NaN where ``r_tvg <= 0`` or the power is NaN)
  plus per-ping range-bin sums of ``10^(Sv/10)`` and counts of non-NaN Sv;
* K4 :func:`mvbs_partials` replaces ``mvbs_partials_pallas``: the same
  partials without Sv, ``lin = exp(ln10/10 (P + 2 alpha r_tvg + offset))
  r_tvg^2`` where ``r_tvg > 0`` and the power is not NaN.

The kernels live in ``csrc/sv_bin_partials.cu`` (the design and what bounds
it are noted there).  They take the range-bin sample bounds [C, n_r + 1]
int32 from the host (:func:`core_bounds_np`) instead of the Pallas kernels'
dense 0/1 bin matrix.  The plain PyTorch twins beside them are transcribed
from the Pallas bodies, 0/1 matrix product included, and keep each body's
formula: K3's ``exp(sv ln10/10)`` and K4's ``exp(...) r_tvg^2`` round
differently (the JAX tests bound K3 at rtol 1e-4, K4 at 5e-4).

A valid sample whose linear value is not finite (``inf`` from an absurd
Sv, NaN in K4 from a NaN offset) spreads as the Pallas kernels' band
product spreads it (``inf * 0`` is NaN): a ping's bin sum is NaN when any
such sample of the ping, anywhere in ``[0, R)``, lies outside the bin, and
otherwise the bin's own sum (``inf`` or NaN where the sample lies inside).
Counts do not change.  The kernels and the twins agree on this.

Dispatch is by the device of ``power``: a CUDA tensor launches the kernel
(or raises), a CPU tensor runs the plain twin.  :data:`LAUNCHES` counts
kernel launches only.  :func:`sv_mvbs_core_fused` and
:func:`mvbs_core_fused` are the drop-ins for the JAX wrappers
``sv_mvbs_core_pallas`` / ``mvbs_core_pallas``.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..device import resolve_device
from ..utils.profiling import launch_span
from .binning import _banded_x_reduce_xb

__all__ = [
    "LAUNCHES",
    "core_bounds_np",
    "fused_operands",
    "mvbs_core_fused",
    "mvbs_partials",
    "mvbs_partials_plain",
    "ping_bounds_np",
    "reset_launches",
    "sv_bin_partials",
    "sv_bin_partials_plain",
    "sv_mvbs_core_fused",
]

LN10_OVER_10 = 0.23025850929940458

#: kernel name -> launches since the last :func:`reset_launches`
LAUNCHES = {"sv_bin_partials": 0, "mvbs_partials": 0}


def reset_launches():
    for name in LAUNCHES:
        LAUNCHES[name] = 0


# ------------------------------------------------------------------ host side
def core_bounds_np(dr0, r_edges, R):
    """Range-bin sample bounds [C, n_r + 1] int32 of the fused cores.

    ``clip(ceil(r_edges / dr0), 0, R)`` in float32, as
    ``sv_mvbs_core_mxu`` / ``sv_mvbs_core_pallas`` compute them: the
    *unrefined* bounds (numpy's float32 division is IEEE, like XLA's on the
    CPU).  Sample k lies in bin b when ``bounds[b] <= k < bounds[b + 1]``.
    """
    dr0 = np.asarray(dr0, dtype="f4")
    edges = np.asarray(r_edges, dtype="f4")
    with np.errstate(divide="ignore", invalid="ignore"):
        q = np.ceil(edges[None, :] / dr0[:, None])
    return np.clip(np.nan_to_num(q, nan=0.0), 0, R).astype("i4")


def ping_bounds_np(x_idx, n_x):
    """Ping bounds [n_x + 1] int32 of the ping-bin runs of sorted ``x_idx``.

    ``searchsorted(x_idx, arange(n_x + 1), side="left")``: ids below 0 or
    at least ``n_x`` fall outside every bin.
    """
    x_idx = np.asarray(x_idx)
    if x_idx.ndim != 1 or np.any(np.diff(x_idx) < 0):
        raise ValueError("x_idx must be a 1-D non-decreasing array of ping-bin ids")
    return np.searchsorted(x_idx, np.arange(n_x + 1), side="left").astype("i4")


# ----------------------------------------------------------------- plain twins
def _bin_matrix(bounds, R):
    """[C, R, n_r] 0/1 float32: sample k lies in [bounds[b], bounds[b+1])."""
    k = torch.arange(R, device=bounds.device)[None, :, None]
    return ((k >= bounds[:, None, :-1]) & (k < bounds[:, None, 1:])).to(torch.float32)


def _r_tvg(power, dr, tvg_shift):
    R = power.shape[2]
    r = torch.arange(R, dtype=torch.float32, device=power.device)[None, None, :] * dr[:, :, None]
    return r - tvg_shift[:, :, None]


def _sv_db(power, dr, tvg_shift, absorption, offset):
    """Sv [C, P, R] from float32 dB power (NaN where r_tvg <= 0 or power is NaN)."""
    r_tvg = _r_tvg(power, dr, tvg_shift)
    pos = r_tvg > 0
    return torch.where(
        pos,
        power
        + 20.0 * torch.log10(torch.where(pos, r_tvg, 1.0))
        + 2.0 * absorption[:, :, None] * r_tvg
        + offset[:, :, None],
        torch.nan,
    )


def sv_bin_partials_plain(power, dr, tvg_shift, absorption, offset, bounds):
    """Plain PyTorch K3 (see :func:`sv_bin_partials`)."""
    sv = _sv_db(power, dr, tvg_shift, absorption, offset)
    ok = ~torch.isnan(sv)
    lin = torch.where(ok, torch.exp(sv * LN10_OVER_10), 0.0)
    m = _bin_matrix(bounds, power.shape[2])
    return sv, torch.bmm(lin, m), torch.bmm(ok.to(torch.float32), m)


def mvbs_partials_plain(power, dr, tvg_shift, absorption, offset, bounds):
    """Plain PyTorch K4 (see :func:`mvbs_partials`)."""
    r_tvg = _r_tvg(power, dr, tvg_shift)
    ok = (r_tvg > 0) & ~torch.isnan(power)
    expo = LN10_OVER_10 * (power + 2.0 * absorption[:, :, None] * r_tvg + offset[:, :, None])
    lin = torch.where(ok, torch.exp(expo) * (r_tvg * r_tvg), 0.0)
    m = _bin_matrix(bounds, power.shape[2])
    return torch.bmm(lin, m), torch.bmm(ok.to(torch.float32), m)


# -------------------------------------------------------------------- kernels
def _check(name, t, dtype, shape, device):
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, power on {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _launch(entry, name, power, dr, tvg_shift, absorption, offset, bounds, with_sv):
    """Check the operands, allocate the outputs and launch ``entry`` on the
    current stream."""
    if power.device.type != "cuda":
        raise ValueError(f"{name} runs on cuda or cpu, not {power.device}")
    if power.dim() != 3 or bounds.dim() != 2 or bounds.shape[1] < 1:
        raise ValueError("power must be [C, P, R] and bounds [C, n_r + 1]")
    C, P, R = power.shape
    n_r = bounds.shape[1] - 1
    dev = power.device
    f32 = torch.float32
    for key, t, dtype, shape in (
        ("power", power, f32, (C, P, R)),
        ("dr", dr, f32, (C, P)),
        ("tvg_shift", tvg_shift, f32, (C, P)),
        ("absorption", absorption, f32, (C, P)),
        ("offset", offset, f32, (C, P)),
        ("bounds", bounds, torch.int32, (C, n_r + 1)),
    ):
        _check(key, t, dtype, shape, dev)
    sv = torch.empty((C, P, R), dtype=f32, device=dev) if with_sv else None
    s1 = torch.empty((C, P, n_r), dtype=f32, device=dev)
    n1 = torch.empty_like(s1)
    from ._build import load_library

    fn = getattr(load_library("sv_bin_partials"), entry)
    fn.restype = ctypes.c_int
    n_ptr = 9 if with_sv else 8
    fn.argtypes = [ctypes.c_void_p] * n_ptr + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    outs = ([sv] if with_sv else []) + [s1, n1]
    with torch.cuda.device(dev), launch_span(entry):
        status = fn(
            *[t.data_ptr() for t in (power, dr, tvg_shift, absorption, offset, bounds, *outs)],
            C, P, R, n_r, torch.cuda.current_stream(dev).cuda_stream,
        )
    if status != 0:
        raise RuntimeError(f"{entry} launch failed with CUDA error {status}")
    LAUNCHES[name] += 1
    return tuple(outs)


def sv_bin_partials(power, dr, tvg_shift, absorption, offset, bounds):
    """K3: fused Sv + per-ping range-bin partials.

    power [C, P, R] float32 dB (NaN-padded); dr, tvg_shift, absorption,
    offset [C, P] float32; bounds [C, n_r + 1] int32 range-bin sample
    bounds in [0, R] (:func:`core_bounds_np`).  Returns (Sv [C, P, R],
    s1 [C, P, n_r], n1 [C, P, n_r]) float32.
    """
    if power.device.type == "cpu":
        return sv_bin_partials_plain(power, dr, tvg_shift, absorption, offset, bounds)
    return _launch("ep_sv_bin_partials", "sv_bin_partials", power, dr, tvg_shift, absorption,
                   offset, bounds, with_sv=True)


def mvbs_partials(power, dr, tvg_shift, absorption, offset, bounds):
    """K4: per-ping range-bin partials without Sv (no log10 per sample).

    Same operands as :func:`sv_bin_partials`; returns (s1, n1)
    [C, P, n_r] float32.
    """
    if power.device.type == "cpu":
        return mvbs_partials_plain(power, dr, tvg_shift, absorption, offset, bounds)
    return _launch("ep_mvbs_partials", "mvbs_partials", power, dr, tvg_shift, absorption,
                   offset, bounds, with_sv=False)


# ------------------------------------------------------------ core drop-ins
def _as_f32(a, dev):
    if isinstance(a, torch.Tensor):
        return a.to(device=dev, dtype=torch.float32).contiguous()
    return torch.from_numpy(np.ascontiguousarray(a, dtype="f4")).to(dev)


def _host(a):
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def fused_operands(power, dr, tvg_shift, absorption, offset, x_idx, r_edges, n_x, n_r,
                   device="cuda"):
    """The JAX core arguments -> (kernel operands on ``device``, ping bounds).

    Range-bin bounds (from each channel's first-ping ``dr``) and ping bounds
    (from sorted ``x_idx``) are fixed on the host; the rest moves to the
    device as contiguous float32.
    """
    dev = resolve_device(device)
    ops = {k: _as_f32(v, dev) for k, v in (
        ("power", power), ("dr", dr), ("tvg_shift", tvg_shift),
        ("absorption", absorption), ("offset", offset))}
    bounds = core_bounds_np(_host(dr)[:, 0], _host(r_edges), ops["power"].shape[2])
    if bounds.shape[1] != n_r + 1:
        raise ValueError(f"n_r={n_r} disagrees with {bounds.shape[1]} range edges")
    ops["bounds"] = torch.from_numpy(bounds).to(dev)
    xb = torch.from_numpy(ping_bounds_np(_host(x_idx), n_x)).to(dev)
    return ops, xb


def _reduce_pings(s1, n1, xb, n_r):
    both = _banded_x_reduce_xb(torch.cat([s1, n1], dim=2), xb)
    return both[:, :, :n_r], both[:, :, n_r:]


def sv_mvbs_core_fused(power, dr, tvg_shift, absorption, offset, x_idx, r_edges, n_x, n_r,
                       device="cuda"):
    """Single-pass Sv + MVBS partials on K3 (CUDA) or its twin (CPU).

    Drop-in for ``echopype_tpu.ops.pallas_pipeline.sv_mvbs_core_pallas``
    (itself a drop-in for ``parallel/pipeline.py::sv_mvbs_core_mxu``): same
    arguments (host arrays or tensors) plus ``device``.  Range bins follow
    each channel's first-ping ``dr``.  The ping axis is reduced outside the
    kernel by :func:`~echopype_torch.ops.binning._banded_x_reduce_xb` (an
    independent float32 sum per ping bin) instead of the JAX wrapper's
    cumsum-gather-diff.  Returns (Sv [C, P, R], sums, counts [C, n_x, n_r])
    float32 tensors on ``device``.
    """
    ops, xb = fused_operands(power, dr, tvg_shift, absorption, offset, x_idx, r_edges, n_x,
                             n_r, device)
    sv, s1, n1 = sv_bin_partials(**ops)
    return (sv, *_reduce_pings(s1, n1, xb, n_r))


def mvbs_core_fused(power, dr, tvg_shift, absorption, offset, x_idx, r_edges, n_x, n_r,
                    device="cuda"):
    """MVBS-only partials on K4 (CUDA) or its twin (CPU).

    Drop-in for ``echopype_tpu.ops.pallas_pipeline.mvbs_core_pallas``; as
    :func:`sv_mvbs_core_fused` without Sv.  Any ping count works (no
    padding).  Returns (sums, counts) [C, n_x, n_r] float32 on ``device``.
    """
    ops, xb = fused_operands(power, dr, tvg_shift, absorption, offset, x_idx, r_edges, n_x,
                             n_r, device)
    return _reduce_pings(*mvbs_partials(**ops), xb, n_r)
