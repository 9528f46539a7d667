"""dB <-> linear transforms on numpy arrays and torch tensors.

Counterpart of ``echopype_tpu/utils/compute.py``.
"""

import numpy as np
import torch

__all__ = ["_lin2log", "_log2lin"]


def _log2lin(data):
    """10^(x/10): dB to linear domain."""
    return 10 ** (data / 10)


def _lin2log(data):
    """10*log10(x): linear to dB domain."""
    if isinstance(data, torch.Tensor):
        return 10 * torch.log10(data)
    return 10 * np.log10(data)
