"""Published peaks of the card and the bytes the measured kernels need.

Peaks: NVIDIA H100 SXM data sheet, 700 W, dense: 3.35e12 B/s of HBM3.
Bytes count each input the algorithm needs read once and each output
written once, from the traffic's shapes, whatever the kernels read again or
pad: a chunk's padded pings and the samples past a ping's valid length are
not counted.
"""

from __future__ import annotations

__all__ = ["HBM_BYTES_PER_S", "WINDOW_KERNELS", "window_partials_bytes"]

HBM_BYTES_PER_S = 3.35e12

#: device kernel names (substrings) of the survey's fused window step:
#: the per-slab partials and the combine of a window's slabs, every instance
WINDOW_KERNELS = ("slab_partials_kernel", "combine_slabs_kernel")


def window_partials_bytes(channels, pings, samples, itemsize, windows, n_r, uniform):
    """Bytes one window step over ``pings`` pings needs: power (``samples``
    valid samples a ping over all channels, ``itemsize`` bytes each), the
    per-ping operands (K1: absorption, offset, valid length; K2 also dr,
    TVG shift, first sample), K1's two per-channel rows of ``samples //
    channels`` floats, the range-bin bounds, and the [C, W, n_r] float32
    sums (and K2's counts)."""
    per_ping = 12 if uniform else 24
    rows = 2 * 4 * samples if uniform else 0
    outputs = channels * windows * n_r * 4 * (1 if uniform else 2)
    bounds = channels * (n_r + 1) * 4 + (windows + 1) * 4
    return pings * samples * itemsize + channels * pings * per_ping + rows + outputs + bounds
