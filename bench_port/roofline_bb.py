"""The work of the fused broadband survey step, and its bound on the card.

Counted from the traffic's shapes, whatever implements the step, so that a
later FFT or tensor-core implementation reads against the same bound.  One
step is one channel's chunk: ``lanes`` = pings x sectors lanes of ``R``
complex samples, correlated with a replica of ``L`` taps, then prx, Sv and
the [W, n_r] bins.

* operations: an FFT correlation's count, the fewest a known method needs:
  ``lanes x (2 x 5 N log2 N + 6 N)`` with ``N`` the smallest power of two
  at least ``R + L - 1`` (a forward and an inverse complex FFT of 5 N log2
  N real operations each, and the spectrum product's 6 N);
* bytes: the complex float32 input read once, the per-ping operands (prx's
  impedance term, dr, TVG shift, absorption, offset, first sample, valid
  length, ping-bin id: 4 bytes each), the replica, the range edges, and
  the [W, n_r] float64 sums and counts written once;
* bound: the larger of operations over 67e12 a second (float32 off the
  tensor cores) and bytes over 3.35e12 B/s (HBM3); NVIDIA H100 SXM data
  sheet, 700 W, dense.
"""

from __future__ import annotations

import math

__all__ = ["FLOP_PER_S", "HBM_BYTES_PER_S", "step_bound_s", "step_bytes", "step_operations"]

FLOP_PER_S = 67e12
HBM_BYTES_PER_S = 3.35e12
PER_PING_OPERAND_BYTES = 8 * 4


def step_operations(lanes, R, L):
    N = 1 << math.ceil(math.log2(R + L - 1))
    return lanes * (2 * 5 * N * math.log2(N) + 6 * N)


def step_bytes(pings, sectors, R, L, windows, n_r):
    return (pings * sectors * R * 8 + pings * PER_PING_OPERAND_BYTES + L * 8 + (n_r + 1) * 4
            + 2 * windows * n_r * 8)


def step_bound_s(pings, sectors, R, L, windows, n_r):
    return max(step_operations(pings * sectors, R, L) / FLOP_PER_S,
               step_bytes(pings, sectors, R, L, windows, n_r) / HBM_BYTES_PER_S)
