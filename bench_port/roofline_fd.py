"""The work of the frequency-differencing survey step, and its bound on the card.

Counted from the traffic's shapes, whatever implements the step, so that a
later fused kernel reads against the same bound.  One step is one chunk:
``pings`` real pings (the padding a chunk carries is not counted, as in
``roofline.py``) of ``channels`` channels of ``R`` samples, the mask
deciding each (ping, sample) from two of the channels, and the [W, n_r]
bins of every channel.

* operations: a sample of a channel takes the Sv equation (the index to
  dB, ``r = k dr - shift``, ``20 log10 r``, ``2 alpha r``, three sums: 9,
  the ``log10`` one transcendental counted as one operation), the linear
  value ``10^(Sv / 10)`` (a scale and one transcendental: 2) and two bin
  accumulations (the sum and the count: 2), 13 in all; a (ping, sample)
  also takes the difference and the comparison: 2;
* bytes: the int16 power read once, the per-ping operands (dr, TVG shift,
  absorption, offset, valid length a channel, and the ping-bin id: 4 bytes
  each), the range edges, and the [C, W, n_r] float32 sums and counts
  written once;
* bound: the larger of operations over 67e12 a second (float32 off the
  tensor cores) and bytes over 3.35e12 B/s (HBM3); NVIDIA H100 SXM data
  sheet, 700 W, dense (the peaks ``roofline_bb.py`` uses).
"""

from __future__ import annotations

__all__ = ["FLOP_PER_S", "HBM_BYTES_PER_S", "step_bound_s", "step_bytes", "step_operations"]

FLOP_PER_S = 67e12
HBM_BYTES_PER_S = 3.35e12
OPS_PER_CHANNEL_SAMPLE = 13
OPS_PER_MASK_DECISION = 2
PER_PING_OPERANDS = 5


def step_operations(pings, channels, R):
    return pings * R * (channels * OPS_PER_CHANNEL_SAMPLE + OPS_PER_MASK_DECISION)


def step_bytes(pings, channels, R, windows, n_r):
    return (pings * channels * R * 2 + pings * (channels * PER_PING_OPERANDS + 1) * 4
            + (n_r + 1) * 4 + 2 * channels * windows * n_r * 4)


def step_bound_s(pings, channels, R, windows, n_r):
    return max(step_operations(pings, channels, R) / FLOP_PER_S,
               step_bytes(pings, channels, R, windows, n_r) / HBM_BYTES_PER_S)
