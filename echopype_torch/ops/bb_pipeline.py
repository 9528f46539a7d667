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

``precision`` takes the JAX package's values: ``None`` or ``"HIGHEST"``
(the matched filter's product in float32 with TF32 off, since no TF32 is
allowed on the data path), ``"HIGH"`` (the TPU's three-pass bf16 split
product with float32 accumulation, not TF32) or ``"DEFAULT"`` (one bf16
pass), any case, or a ``jax.lax.Precision`` of those names
(``ops/matched_filter.py`` says what each computes); any other value raises
``ValueError``.  The value applies to this call only: compute_Sv's
precision (``matched_filter.set_conv_precision``) stays as it was.

Stages (``utils.profiling.stage``, no timer, so an untraced call pays one
check each): ``bb_h2d`` (the chunk's samples to the device; counter
``bb_h2d_bytes``), ``bb_compress`` (NaN fill, the matched filter, the
norm) and ``bb_sv_bins`` (sector mean, prx, Sv and, in
:func:`bb_chunk_window_partials`, the bins).  Under a profiler the last two
end when the card has finished their work.
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import resolve_device
from ..utils.profiling import count, stage
from .binning import binned_window_partials
from .matched_filter import _leading_zeros, _parse_precision, _toeplitz_conv

__all__ = ["bb_chunk_sv", "bb_chunk_window_partials"]


def _on(dev, a, dtype=torch.float32):
    if isinstance(a, torch.Tensor):
        return a.to(dev, dtype)
    return torch.as_tensor(np.asarray(a), dtype=dtype).to(dev)


def _compressed(bs_r, bs_i, hr, hi, inv_norm, do_pc, precision, block_t, dev):
    """The chunk's complex samples on ``dev``, NaN zero-filled and, with
    ``do_pc``, pulse-compressed and normalised: (xr, xi) float32 [P, R, B].
    Stages ``bb_h2d`` (the samples to the device; counter ``bb_h2d_bytes``,
    the bytes taken from outside ``dev``) and ``bb_compress``."""
    f = lambda a: _on(dev, a)  # noqa: E731
    with stage("bb_h2d"):
        count("bb_h2d_bytes", sum(_outside_bytes(a, dev) for a in (bs_r, bs_i)))
        bs_r, bs_i = f(bs_r), f(bs_i)
    with stage("bb_compress") as held:
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
                                    block_t=block_t, tail_zeros=z, precision=precision)
            inv = f(inv_norm)
            xr = re.reshape(P, B, R).permute(0, 2, 1) * inv
            xi = im.reshape(P, B, R).permute(0, 2, 1) * inv
        if held is not None:  # traced: the stage ends when the card has compressed
            held += [xr, xi]
    return xr, xi


def _outside_bytes(a, dev):
    """Bytes of ``a`` that a copy to ``dev`` moves (0 where it is there)."""
    if isinstance(a, torch.Tensor):
        return 0 if a.device == dev else a.numel() * 4
    return int(np.size(a)) * 4


def _sv(xr, xi, z_coef, dr, shift, alpha, offset, k0, valid_len, dev):
    """(sv, er) float32 [P, R] of the compressed chunk."""
    f = lambda a: _on(dev, a)  # noqa: E731
    R = xr.shape[1]
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
                valid_len, do_pc: bool, precision=None, device="cuda"):
    """One channel's chunk complex -> (Sv, echo_range) float32 [P, R] on
    ``device``, without binning (for a cross-channel mask before the bins)."""
    dev = resolve_device(device)
    xr, xi = _compressed(bs_r, bs_i, hr, hi, inv_norm, do_pc, _parse_precision(precision), 0,
                         dev)
    with stage("bb_sv_bins"):
        return _sv(xr, xi, z_coef, dr, shift, alpha, offset, k0, valid_len, dev)


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
    precision=None,            # None, "HIGHEST", "HIGH" or "DEFAULT" (module docstring)
    uniform_er: bool = False,  # ping-invariant dr: the 0/1 matmul over the grid row
    block_t: int = 0,          # matched-filter Toeplitz block override
    device="cuda",
):
    """Returns (sums, counts) float64 [n_x_window, n_r] on ``device``
    (:func:`binned_window_partials` adds the pings' range sums in float64)."""
    dev = resolve_device(device)
    xr, xi = _compressed(bs_r, bs_i, hr, hi, inv_norm, do_pc, _parse_precision(precision),
                         block_t, dev)
    with stage("bb_sv_bins") as held:
        sv, er = _sv(xr, xi, z_coef, dr, shift, alpha, offset, k0, valid_len, dev)
        sums, counts, _ = binned_window_partials(
            sv[None], er[None], _on(dev, r_edges), _on(dev, x_rel, torch.int32), n_x_window,
            uniform_er=uniform_er,
        )
        if held is not None:  # traced: the stage ends when the bins are summed
            held += [sums, counts]
    return sums[0], counts[0]
