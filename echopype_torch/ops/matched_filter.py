"""Matched filter (pulse compression) for EK80 broadband data.

Counterpart of ``echopype_tpu/ops/matched_filter.py``.  Behavioral contract
(reference echopype/calibrate/ek80_complex.py:285-369): per channel, the
time-domain ``signal.convolve(bs, flip(conj(replica)), mode="full")``
truncated at ``[replica.size-1:]``, with NaNs zero-filled before and
restored after.

The device path is the JAX package's blocked-Toeplitz product: outputs in
blocks of T samples, each block one row of an [lanes, nblk, 2K] slab of the
zero-extended input (K = T + L - 1, built by ``unfold``) times the real
block matrix [[Hr, Hi], [-Hi, Hr]] of the flipped replica, so one
``torch.matmul`` per channel gives the real and imaginary outputs directly
(cuBLAS on the card; the JAX package computes this product outside any
Pallas kernel too).  :func:`_toeplitz_conv` runs in its inputs' dtype, with
TF32 off inside the call (TF32 keeps ~3 decimal digits, ~1e-3 dB a bin; the
JAX package runs the product at ``Precision.HIGHEST``):

* ``pulse_compress_channel(..., precision="float32")``, compute_Sv's
  default device path, ships the float32 samples and accumulates in
  float64.  A float32 accumulation loses up to 5.3e-3 dB (the JAX package's
  7.9e-3 dB) at the deep nulls of noise-like data, 75 dB under the median
  Sv (PERF.md, PR 6, with both products' times on the card).
* The fused survey step (``ops/bb_pipeline.py``) stays float32 end to end,
  as in the JAX package: its error averages out in the bins.

``precision="float64"`` is the exact host path (numpy).
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import no_tf32, resolve_device

__all__ = [
    "LAUNCHES",
    "compress_pulse_batched",
    "pulse_compress_channel",
    "reset_launches",
    "set_conv_precision",
]

#: device matmuls issued by :func:`_toeplitz_conv` on a CUDA tensor
LAUNCHES = {"toeplitz_matmul": 0}


def reset_launches() -> None:
    LAUNCHES["toeplitz_matmul"] = 0


def set_conv_precision(precision) -> None:
    """Accepts "HIGHEST", the only precision of the port's matched filter.

    The JAX package's "HIGH" is a bf16x3 product on the TPU, which has no
    PyTorch counterpart on the card but TF32 (~1e-3 dB a bin).
    """
    name = str(precision).upper()
    if name == "HIGHEST":
        return
    if name in ("HIGH", "DEFAULT"):
        raise NotImplementedError(
            f"matched-filter precision {precision!r} is not ported to echopype_torch "
            "(ROADMAP Queue 2b: the products here run without TF32)"
        )
    raise ValueError(f"unknown matched-filter precision {precision!r}")


def _block_t(L: int) -> int:
    """Output block T ~ L/2 in multiples of 128, at least 128 (the JAX
    package's choice)."""
    return max(128, 128 * int(round(L / 256.0))) if L > 192 else 128


def _toeplitz_conv(xr, xi, hr, hi, out_start: int, out_len: int, block_t: int = 0,
                   tail_zeros: int = 0):
    """Linear complex convolution of real/imaginary lanes by the
    blocked-Toeplitz matmul, in the inputs' dtype.

    xr, xi [lanes, W]; hr, hi [L] on the same device.  Returns (re, im)
    [lanes, out_len]: output n is sum_k x[n + k - (L - 1 - out_start)] *
    h[L - 1 - k].  The last ``tail_zeros`` outputs touch only exact-zero
    taps (the Hann taper's endpoint) and are set to exactly 0.
    """
    L = int(hr.shape[0])
    lanes, W = xr.shape
    hr_f, hi_f = hr.flip(0), hi.flip(0)
    T = block_t or _block_t(L)
    K = T + L - 1
    nblk = -(-out_len // T)
    pad_left = L - 1 - out_start
    if pad_left < 0:  # the window starts past the head: drop unused input
        xr, xi = xr[:, -pad_left:], xi[:, -pad_left:]
        W += pad_left
        pad_left = 0
    total = nblk * T + L - 1

    def expand(x):  # [lanes, nblk, K]: block b holds x_padded[b*T : b*T + K]
        xp = torch.nn.functional.pad(x, (pad_left, max(0, total - pad_left - W)))[:, :total]
        return xp.unfold(1, K, T)

    tp = (torch.arange(K, device=hr.device)[:, None]
          - torch.arange(T, device=hr.device)[None, :])
    band = (tp >= 0) & (tp < L)
    idx = tp.clamp(0, L - 1)
    Hr = torch.where(band, hr_f[idx], 0.0)
    Hi = torch.where(band, hi_f[idx], 0.0)
    Hc = torch.cat([torch.cat([Hr, Hi], dim=1), torch.cat([-Hi, Hr], dim=1)], dim=0)
    X = torch.cat([expand(xr), expand(xi)], dim=-1)  # [lanes, nblk, 2K]
    with no_tf32():
        Y = torch.matmul(X, Hc)  # [lanes, nblk, 2T]
    if X.is_cuda:
        LAUNCHES["toeplitz_matmul"] += 1
    re = Y[:, :, :T].reshape(lanes, nblk * T)[:, :out_len]
    im = Y[:, :, T:].reshape(lanes, nblk * T)[:, :out_len]
    if tail_zeros and out_len >= tail_zeros:
        re, im = re.clone(), im.clone()
        re[:, out_len - tail_zeros:] = 0.0
        im[:, out_len - tail_zeros:] = 0.0
    return re, im


def _leading_zeros(replica) -> int:
    """Exact-zero leading taps of the raw replica (the Hann taper's zero
    endpoint): the last that many outputs touch only those taps."""
    nz = np.flatnonzero(np.asarray(replica) != 0)
    return int(nz[0]) if nz.size else len(replica)


def _host_conv_f64(lanes: np.ndarray, rep: np.ndarray) -> np.ndarray:
    """Exact float64 direct convolution, truncated to [L-1 : L-1+R].

    Vectorized sliding-window dot product: y[n] = sum_j x[n+j] * rep[::-1][j]
    with x zero-extended on the right.  Samples whose only contributions
    multiply exact-zero replica coefficients come out exactly 0, which the
    reference's prx>0 masking turns into NaN (calibrate_ek.py:581).
    """
    L = len(rep)
    R = lanes.shape[-1]
    rep_rev = rep[::-1].astype("complex128")
    out = np.empty((lanes.shape[0], R), dtype="complex128")
    pad = np.zeros((lanes.shape[0], L - 1), dtype="complex128") if L > 1 else None
    x = np.concatenate([lanes.astype("complex128"), pad], axis=-1) if L > 1 else lanes.astype(
        "complex128"
    )
    win = np.lib.stride_tricks.sliding_window_view(x, L, axis=-1)  # [lanes, R, L]
    # block over lanes to bound the matmul workspace
    step = max(1, int(2**24 // max(1, R * L)))
    for i in range(0, lanes.shape[0], step):
        out[i : i + step] = win[i : i + step] @ rep_rev
    return out


def pulse_compress_channel(bs: np.ndarray, replica: np.ndarray, precision: str = "float64",
                           device="cuda") -> np.ndarray:
    """Pulse-compress one channel's complex samples.

    bs: complex [ping, range, beam] (NaN-padded); replica: complex [L] (the
    raw transmit replica; the conjugate flip happens here).  Returns complex
    [ping, range, beam] with the reference's truncation.

    ``precision="float64"`` runs the exact host path; ``"float32"`` the
    blocked-Toeplitz matmul on ``device``: the samples ship as float32, the
    product accumulates in float64.
    """
    rep = np.flipud(np.conj(np.asarray(replica)))
    L = len(rep)
    P, R, B = bs.shape
    nan_mask = np.isnan(bs.real) | np.isnan(bs.imag)
    clean = np.where(nan_mask, 0.0 + 0.0j, bs)
    lanes = clean.transpose(0, 2, 1).reshape(P * B, R)  # (ping, beam) lanes
    if precision == "float64":
        out = _host_conv_f64(lanes, rep)
    else:
        dev = resolve_device(device)

        def _t(a, dtype):
            return torch.from_numpy(np.ascontiguousarray(a, dtype=dtype)).to(dev).double()

        re, im = _toeplitz_conv(_t(lanes.real, "f4"), _t(lanes.imag, "f4"), _t(rep.real, "f8"),
                                _t(rep.imag, "f8"), L - 1, R, tail_zeros=_leading_zeros(replica))
        out = re.cpu().numpy() + 1j * im.cpu().numpy()
    out = out.reshape(P, B, R).transpose(0, 2, 1)
    return np.where(nan_mask, np.nan + 1j * np.nan, out)


def compress_pulse_batched(bs_by_channel, replicas):
    """Pulse-compress a dict of per-channel [P, R, B] arrays (host float64)."""
    return {ch: pulse_compress_channel(bs_by_channel[ch], replicas[ch]) for ch in bs_by_channel}
