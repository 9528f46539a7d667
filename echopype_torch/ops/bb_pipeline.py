"""Fused EK80 complex-channel survey step: pulse compression -> prx -> Sv
-> window binning, on the device, for one channel's chunk.

Counterpart of ``echopype_tpu/ops/bb_pipeline.py`` (an XLA program there,
not a Pallas kernel; plain PyTorch here).  The complex samples go to the
device once as split float32 and only the [window, n_r] bin partials come
back, where the chunked path (compute_Sv per chunk) returns the pulse
compression to the host in float64 and ships Sv back for binning.

Physics contract: calibrate/ek80.py ``_cal_complex_samples`` (reference
calibrate_ek.py:456-659): the matched filter (``ops/matched_filter.py``),
prx from the beam-sector mean with impedance scaling, Sv from the TVG'd
affine range.  Sample validity is the contiguous [0, valid_len) run; the
first sample past the TVG shift, ``k0``, comes from the host in float64.
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import resolve_device
from .binning import binned_window_partials
from .matched_filter import _leading_zeros, _toeplitz_conv

__all__ = ["bb_chunk_sv", "bb_chunk_window_partials"]


def _on(dev, a, dtype=torch.float32):
    if isinstance(a, torch.Tensor):
        return a.to(dev, dtype)
    return torch.as_tensor(np.asarray(a), dtype=dtype).to(dev)


def _bb_chunk_sv_impl(bs_r, bs_i, hr, hi, inv_norm, z_coef, dr, shift, alpha, offset, k0,
                      valid_len, do_pc, block_t=0, device="cuda"):
    """Shared complex -> Sv body: returns (sv, er) float32 [P, R] on
    ``device``.  hr, hi: the flipped-conjugated replica (host arrays)."""
    dev = resolve_device(device)
    f = lambda a: _on(dev, a)  # noqa: E731
    bs_r, bs_i = f(bs_r), f(bs_i)
    P, R, B = bs_r.shape
    xr = torch.where(torch.isnan(bs_r), 0.0, bs_r)
    xi = torch.where(torch.isnan(bs_i), 0.0, bs_i)

    if do_pc:
        hr_h = hr.cpu().numpy() if isinstance(hr, torch.Tensor) else np.asarray(hr)
        hi_h = hi.cpu().numpy() if isinstance(hi, torch.Tensor) else np.asarray(hi)
        # the replica's exact-zero leading taps are the tail of hr + i hi
        z = _leading_zeros((hr_h + 1j * hi_h)[::-1])
        lanes_r = xr.permute(0, 2, 1).reshape(P * B, R)
        lanes_i = xi.permute(0, 2, 1).reshape(P * B, R)
        L = hr_h.shape[0]
        re, im = _toeplitz_conv(lanes_r, lanes_i, f(hr_h), f(hi_h), L - 1, R,
                                block_t=block_t, tail_zeros=z)
        inv = f(inv_norm)
        xr = re.reshape(P, B, R).permute(0, 2, 1) * inv
        xi = im.reshape(P, B, R).permute(0, 2, 1) * inv

    mean_r = xr.mean(dim=2)  # beam-sector mean [P, R]
    mean_i = xi.mean(dim=2)
    prx = (mean_r * mean_r + mean_i * mean_i) * f(z_coef)[:, None]

    k = torch.arange(R, dtype=torch.float32, device=dev)[None, :]
    r = k * f(dr)[:, None]
    r_tvg = r - f(shift)[:, None]
    in_run = k < f(valid_len)[:, None]
    past_tvg = k >= f(k0)[:, None]
    good = past_tvg & (prx > 0) & in_run
    r_tvg_safe = torch.clamp_min(r_tvg, 1e-20)
    sv = torch.where(
        good,
        10.0 * torch.log10(torch.where(prx > 0, prx, 1.0))
        + 20.0 * torch.log10(r_tvg_safe)
        + 2.0 * f(alpha)[:, None] * r_tvg
        + f(offset)[:, None],
        torch.nan,
    )
    er = torch.where(in_run, r, torch.nan)  # NaN range -> the sample joins no bin
    return sv, er


def bb_chunk_sv(bs_r, bs_i, hr, hi, inv_norm, z_coef, dr, shift, alpha, offset, k0,
                valid_len, do_pc: bool, device="cuda"):
    """One channel's chunk complex -> (Sv, echo_range) float32 [P, R] on
    ``device``, without binning (for a cross-channel mask before the bins)."""
    return _bb_chunk_sv_impl(bs_r, bs_i, hr, hi, inv_norm, z_coef, dr, shift, alpha, offset,
                             k0, valid_len, do_pc, device=device)


def bb_chunk_window_partials(
    bs_r, bs_i,          # f4 [P, R, B] one channel's chunk (suffix NaN-padded)
    hr, hi,              # f4 [L] flipped-conjugated transmit replica (host)
    inv_norm,            # f4 scalar: 1 / replica norm factor (BB only)
    z_coef,              # f4 [P]: n_beam/8 * (|z_er+z_et|/z_er)^2 / z_et
    dr, shift, alpha, offset,  # f4 [P] per-ping scalars of the Sv equation
    k0,                  # i4 [P]: first sample with r_tvg > 0, decided in
                         # float64 on the host so the boundary sample matches
                         # the float64 chunked path exactly
    valid_len,           # i4 [P]
    x_rel,               # i4 [P] window-relative ping-bin ids (sorted)
    r_edges,             # f4 [n_r+1]
    n_x_window: int,
    do_pc: bool,
    uniform_er: bool = False,  # ping-invariant dr: the 0/1 matmul over the grid row
    block_t: int = 0,          # matched-filter Toeplitz block override
    device="cuda",
):
    """Returns (sums, counts) float32 [n_x_window, n_r] on ``device``."""
    sv, er = _bb_chunk_sv_impl(bs_r, bs_i, hr, hi, inv_norm, z_coef, dr, shift, alpha, offset,
                               k0, valid_len, do_pc, block_t=block_t, device=device)
    dev = sv.device
    sums, counts, _ = binned_window_partials(
        sv[None], er[None], _on(dev, r_edges), _on(dev, x_rel, torch.int32), n_x_window,
        uniform_er=uniform_er,
    )
    return sums[0], counts[0]
