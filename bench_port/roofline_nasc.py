"""The device work of one NASC chain call, and its bound on the card.

Counted from the traffic's shapes, whatever implements the work, so that a
later range-row route or fused kernel reads against the same bound.  One
call is one file of ``pings`` pings of ``channels`` channels of ``R``
samples, gridded to ``n_x`` distance by ``n_r`` depth bins.  The work is
``compute_Sv``'s power calibration and ``compute_NASC``'s two binning
passes (the Sv sums and counts, and the height sums):

* operations: a sample of a channel takes the Sv equation (the index to
  dB, ``r = k dr - shift``, ``20 log10 r``, ``2 alpha r``, three sums: 9,
  the ``log10`` counted as one operation, as ``roofline_fd.py`` counts
  it), the linear value ``10^(Sv / 10)`` (2), the Sv sum and the count (2),
  and its depth difference and the height sum (2): 15 in all;
* bytes: the int16 power read once, the float32 Sv written by the
  calibration and read by the binning, the per-ping operands (dr, TVG
  shift, absorption, offset a channel, and the distance-bin id: 4 bytes
  each; the depth of every sample follows from dr and is not read), and
  the [C, n_x, n_r] float64 Sv sums, counts and height sums written once;
* bound: the larger of operations over 67e12 a second (float32 off the
  tensor cores) and bytes over 3.35e12 B/s (HBM3); NVIDIA H100 SXM data
  sheet, 700 W, dense (the peaks ``roofline_fd.py`` uses).
"""

from __future__ import annotations

__all__ = ["FLOP_PER_S", "HBM_BYTES_PER_S", "call_bound_s", "call_bytes", "call_operations"]

FLOP_PER_S = 67e12
HBM_BYTES_PER_S = 3.35e12
OPS_PER_CHANNEL_SAMPLE = 15
BYTES_PER_CHANNEL_SAMPLE = 2 + 4 + 4
PER_PING_OPERANDS = 4
OUTPUTS = 3


def call_operations(pings, channels, R):
    return pings * channels * R * OPS_PER_CHANNEL_SAMPLE


def call_bytes(pings, channels, R, n_x, n_r):
    return (pings * channels * R * BYTES_PER_CHANNEL_SAMPLE
            + pings * (channels * PER_PING_OPERANDS + 1) * 4
            + OUTPUTS * channels * n_x * n_r * 8)


def call_bound_s(pings, channels, R, n_x, n_r):
    return max(call_operations(pings, channels, R) / FLOP_PER_S,
               call_bytes(pings, channels, R, n_x, n_r) / HBM_BYTES_PER_S)
