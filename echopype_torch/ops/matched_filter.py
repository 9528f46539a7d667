"""Matched filter (pulse compression) for EK80 broadband data.

Counterpart of ``echopype_tpu/ops/matched_filter.py``.  Behavioral contract
(reference echopype/calibrate/ek80_complex.py:285-369): per channel, the
time-domain ``signal.convolve(bs, flip(conj(replica)), mode="full")``
truncated at ``[replica.size-1:]``, with NaNs zero-filled before and
restored after.

The device path is the JAX package's blocked-Toeplitz product: outputs in
blocks of T samples, each block one row of an [lanes, nblk, 2K] slab of the
zero-extended input (K = T + L - 1, built by ``unfold``) times the real
block matrix [[Hr, Hi], [-Hi, Hr]] of the flipped replica, so one matrix
product per channel gives the real and imaginary outputs directly (the JAX
package computes this product outside any Pallas kernel too).
:func:`_toeplitz_conv` takes the JAX package's precisions, set for
compute_Sv by :func:`set_conv_precision` and passed by the fused survey
step (``ops/bb_pipeline.py``):

* ``"HIGHEST"`` (the default): one ``torch.matmul`` in the inputs' dtype,
  TF32 off inside the call (TF32 keeps ~3 decimal digits, ~1e-3 dB a bin).
  ``pulse_compress_channel(..., precision="float32")``, compute_Sv's
  default device path, ships the float32 samples and accumulates in
  float64: a float32 accumulation loses up to 5.3e-3 dB (the JAX
  package's 7.9e-3 dB) at the deep nulls of noise-like data, 75 dB under
  the median Sv (PERF.md §6).  The fused survey step stays float32 end
  to end, as in the JAX package: its error averages out in the bins.
* ``"HIGH"``: the TPU's three-pass bfloat16 product, not TF32 (no TF32 is
  allowed on the data path).  The float32 slab X and block matrix H split
  into bf16 parts, ``hi = bf16(v)`` and ``lo = bf16(v - hi)``, and
  ``lo·Hhi + hi·Hlo + hi·Hhi`` (``lo·lo`` dropped, as on the TPU) is one
  product ``[Xlo | Xhi | Xhi] @ [Hhi; Hlo; Hhi]`` with float32
  accumulation: on the card a bf16 tensor-core product with a float32
  output (``torch.mm(..., out_dtype=torch.float32)``), on the CPU its plain
  version, the same parts upcast to float32 in one float32 matmul.  Each
  bf16 × bf16 term is exact in float32, so the two differ only in how the
  float32 sums round.  The small terms come first along K: the tensor
  cores round their running sum towards zero, and after the large terms
  each of the small terms' steps lost up to an ulp of the full sum
  (``tools/split_product_probe.py`` on an H100: 5.2e-6 of the output's
  scale large-first, 7.3e-7 small-first).  The JAX package's budget: <=
  0.004 dB of the float64 matched filter within 40 dB of the peak, 0.02 dB
  at -60 dB; over 65.5 M samples of noise the bf16x3 arithmetic itself,
  float32 sums rounded to nearest or not, reads 0.003 dB within 40 dB and
  0.022 dB within 60 dB (PERF.md §6).
* ``"DEFAULT"``: the single pass ``hi·Hhi`` (0.6-2.4 dB in the JAX
  package's measurement).

Either reduced precision takes float32 in and gives float32 out; there is
no fall-back on the card: where the bf16 product does not run, it raises.
``precision="float64"`` of :func:`pulse_compress_channel` is the exact host
path (numpy).
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

_PRECISIONS = ("HIGHEST", "HIGH", "DEFAULT")
#: compute_Sv's matched-filter precision (:func:`set_conv_precision`)
_CONV_PRECISION = "HIGHEST"


def reset_launches() -> None:
    LAUNCHES["toeplitz_matmul"] = 0


def _parse_precision(precision) -> str:
    """The canonical name of a matched-filter precision.  ``None`` is
    "HIGHEST"; a name is taken in any case, from a string or from any object
    whose ``str()`` is the name (``str(jax.lax.Precision.HIGH)`` is "HIGH",
    so the JAX enum needs no import of jax).  Anything else raises."""
    if precision is None:
        return "HIGHEST"
    name = str(precision).upper()
    if name not in _PRECISIONS:
        raise ValueError(f"unknown matched-filter precision {precision!r}")
    return name


def set_conv_precision(precision) -> None:
    """Set compute_Sv's matched-filter precision: "HIGHEST" (the default),
    "HIGH" (the bf16x3 split product) or "DEFAULT" (one bf16 pass), or a
    ``jax.lax.Precision`` of those names (module docstring)."""
    global _CONV_PRECISION
    _CONV_PRECISION = _parse_precision(precision)


def _block_t(L: int) -> int:
    """Output block T ~ L/2 in multiples of 128, at least 128 (the JAX
    package's choice)."""
    return max(128, 128 * int(round(L / 256.0))) if L > 192 else 128


def _bf16_lo(v, hi):
    """The low bf16 part of ``v`` beside its high part ``hi = bf16(v)``:
    bf16(v - hi), the difference exact in float32."""
    return (v.float() - hi.float()).to(torch.bfloat16)


def _toeplitz_operands(parts, hr, hi, out_start: int, out_len: int, block_t: int = 0):
    """The blocked-Toeplitz product's operands: (X [lanes, nblk, len(parts)
    * K], the blocks of each [lanes, W] tensor of ``parts`` side by side in
    its dtype; Hc [2K, 2T], the block matrix of the flipped replica in
    ``hr``'s dtype; T; nblk)."""
    L = int(hr.shape[0])
    W = parts[0].shape[1]
    hr_f, hi_f = hr.flip(0), hi.flip(0)
    T = block_t or _block_t(L)
    K = T + L - 1
    nblk = -(-out_len // T)
    pad_left = L - 1 - out_start
    if pad_left < 0:  # the window starts past the head: drop unused input
        parts = [x[:, -pad_left:] for x in parts]
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
    X = torch.cat([expand(x) for x in parts], dim=-1)
    return X, Hc, T, nblk


def _split_operands(xr, xi, hr, hi, out_start: int, out_len: int, precision: str,
                    block_t: int = 0):
    """The bf16 operands (A, B, T, nblk) of the split product.  The lanes
    split before they are blocked (bf16 rounding commutes with the copy, and
    the blocks hold each sample K / T times).  "HIGH": the three terms along
    K, the two small ones first, ``[Xlo | Xhi | Xhi] @ [Hhi; Hlo; Hhi]``;
    "DEFAULT": ``Xhi @ Hhi``.  X and H are taken as float32."""
    rh, ih = xr.float().to(torch.bfloat16), xi.float().to(torch.bfloat16)
    parts = [rh, ih]
    if precision == "HIGH":
        parts = [_bf16_lo(xr, rh), _bf16_lo(xi, ih), rh, ih, rh, ih]
    A, Hc, T, nblk = _toeplitz_operands(parts, hr, hi, out_start, out_len, block_t)
    hh = Hc.float().to(torch.bfloat16)
    B = torch.cat([hh, _bf16_lo(Hc, hh), hh], dim=0) if precision == "HIGH" else hh
    return A, B, T, nblk


def _split_matmul_plain(A, B):
    """The split product's plain version: the bf16 parts upcast to float32,
    one float32 matmul with TF32 off."""
    with no_tf32():
        return torch.matmul(A.float(), B.float())


def _split_matmul(A, B):
    """A [..., k] @ B [k, n] of bf16 parts, float32 out.  On the card one
    tensor-core product with float32 accumulation and output (the
    ``aten::mm.dtype`` overload; where it is missing this raises); on the
    CPU the plain version."""
    if not A.is_cuda:
        return _split_matmul_plain(A, B)
    Y = torch.mm(A.reshape(-1, A.shape[-1]), B, out_dtype=torch.float32)
    return Y.reshape(*A.shape[:-1], B.shape[1])


def _toeplitz_conv(xr, xi, hr, hi, out_start: int, out_len: int, block_t: int = 0,
                   tail_zeros: int = 0, precision: str = "HIGHEST"):
    """Linear complex convolution of real/imaginary lanes by the
    blocked-Toeplitz matmul.

    xr, xi [lanes, W]; hr, hi [L] on the same device.  Returns (re, im)
    [lanes, out_len]: output n is sum_k x[n + k - (L - 1 - out_start)] *
    h[L - 1 - k].  The last ``tail_zeros`` outputs touch only exact-zero
    taps (the Hann taper's endpoint) and are set to exactly 0.
    ``precision`` "HIGHEST" computes in the inputs' dtype; "HIGH" and
    "DEFAULT" are the bf16 split products, float32 out (module docstring).
    """
    lanes = xr.shape[0]
    if precision == "HIGHEST":
        X, Hc, T, nblk = _toeplitz_operands([xr, xi], hr, hi, out_start, out_len, block_t)
        with no_tf32():
            Y = torch.matmul(X, Hc)  # [lanes, nblk, 2T]
    else:
        A, B, T, nblk = _split_operands(xr, xi, hr, hi, out_start, out_len, precision, block_t)
        Y = _split_matmul(A, B)
    if xr.is_cuda:
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
    blocked-Toeplitz matmul on ``device`` at :func:`set_conv_precision`'s
    precision: at "HIGHEST" the samples ship as float32 and the product
    accumulates in float64; at "HIGH" or "DEFAULT" samples and replica ship
    as float32 for the bf16 split product, as in the JAX package.
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
        conv = _CONV_PRECISION
        dtype, rep_dtype = (torch.float64, "f8") if conv == "HIGHEST" else (torch.float32, "f4")

        def _t(a, np_dtype):
            return torch.from_numpy(np.ascontiguousarray(a, dtype=np_dtype)).to(dev, dtype)

        re, im = _toeplitz_conv(_t(lanes.real, "f4"), _t(lanes.imag, "f4"),
                                _t(rep.real, rep_dtype), _t(rep.imag, rep_dtype), L - 1, R,
                                tail_zeros=_leading_zeros(replica), precision=conv)
        out = re.double().cpu().numpy() + 1j * im.double().cpu().numpy()
    out = out.reshape(P, B, R).transpose(0, 2, 1)
    return np.where(nan_mask, np.nan + 1j * np.nan, out)


def compress_pulse_batched(bs_by_channel, replicas):
    """Pulse-compress a dict of per-channel [P, R, B] arrays (host float64)."""
    return {ch: pulse_compress_channel(bs_by_channel[ch], replicas[ch]) for ch in bs_by_channel}
