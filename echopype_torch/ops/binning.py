"""Ping-axis window reduction for the survey's bin partials.

Counterpart of ``echopype_tpu/ops/binning.py::banded_x_reduce``.  Ping ids
are sorted, so each window bin is a contiguous run of pings
``[xb[w], xb[w+1])``.  The JAX function searches the ids on the device; here
the host passes the bounds (``np.searchsorted(x_rel, arange(W + 1))``, see
``parallel/pipeline.py::kernel_inputs_from_numpy``), which the CUDA kernels
take as well.  The reduction is one float32 matmul against the 0/1
membership matrix (TF32 is off, see ``device.py``), so every bin is an
independent sum over its own pings.
"""

from __future__ import annotations

import torch

__all__ = ["banded_x_reduce"]


def banded_x_reduce(blocks, xb):
    """Sum the ping axis of ``blocks`` [C, P, K] over the runs of ``xb``.

    xb: int [W+1] non-decreasing ping bounds; pings past ``xb[W]`` (padding
    parked past the window) join no bin.  Returns [C, W, K] float32.
    """
    P = blocks.shape[1]
    p_ids = torch.arange(P, device=blocks.device)[:, None]
    mx = ((p_ids >= xb[None, :-1]) & (p_ids < xb[None, 1:])).to(torch.float32)
    return torch.einsum("cpk,pw->cwk", blocks, mx)
