"""EK power-mode calibration: the sonar equation over a [C, P, R] block.

Counterpart of ``echopype_tpu/ops/calibration.py``::

    Sv = P + 20 log10(r_tvg) + 2 a r_tvg - CSv - 2 sa_corr
    TS = P + 40 log10(r_tvg) + 2 a r_tvg - CSp

The per-(channel, ping) algebra is folded on the host in float64 into the
[C, P] inputs; the device op is one elementwise pass in plain torch (the JAX
package runs it as an XLA program, not a Pallas kernel).
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import resolve_device
from ..utils.profiling import stage

__all__ = ["ek_power_cal", "ek_power_cal_torch"]


def ek_power_cal_torch(power, dr, tvg_shift, absorption, offset, spreading_factor: int = 20):
    """Sv or TS and echo_range from f32 tensors.

    power [C, P, R] dB (NaN-padded); dr, tvg_shift, absorption, offset [C, P].
    Returns (Sv or TS, NaN where power is NaN or r_tvg <= 0; echo_range, NaN
    where power is NaN), both [C, P, R].
    """
    R = power.shape[2]
    rs = torch.arange(R, dtype=torch.float32, device=power.device)[None, None, :]
    r = rs * dr[:, :, None]
    r_tvg = r - tvg_shift[:, :, None]
    pos = r_tvg > 0
    safe_r = torch.where(pos, r_tvg, 1.0)
    spreading = spreading_factor * torch.log10(safe_r)
    out = power + spreading + 2.0 * absorption[:, :, None] * r_tvg + offset[:, :, None]
    out = torch.where(pos, out, torch.nan)
    echo_range = torch.where(torch.isnan(power), torch.nan, r)
    return out, echo_range


def ek_power_cal(
    power, dr, tvg_shift, absorption, offset, cal_type: str = "Sv",
    precision: str = "float32", device="cuda",
):
    """Host wrapper: numpy in, numpy out.

    ``precision="float32"`` runs :func:`ek_power_cal_torch` on ``device``;
    ``"float64"`` evaluates the same expression in host float64 numpy.
    """
    spreading = 20 if cal_type == "Sv" else 40
    if precision == "float64":
        power = np.asarray(power, dtype="f8")
        dr = np.asarray(dr, dtype="f8")[:, :, None]
        tvg_shift = np.asarray(tvg_shift, dtype="f8")[:, :, None]
        absorption = np.asarray(absorption, dtype="f8")[:, :, None]
        offset = np.asarray(offset, dtype="f8")[:, :, None]
        r = np.arange(power.shape[2], dtype="f8")[None, None, :] * dr
        r_tvg = r - tvg_shift
        with np.errstate(invalid="ignore", divide="ignore"):
            r_tvg = np.where(r_tvg > 0, r_tvg, np.nan)
            out = power + spreading * np.log10(r_tvg) + 2.0 * absorption * r_tvg + offset
        echo_range = np.where(np.isnan(power), np.nan, r)
        return out, echo_range
    dev = resolve_device(device)

    def _t(a):
        return torch.from_numpy(np.ascontiguousarray(a, dtype="f4")).to(dev)

    with stage("power_cal_device"):  # H2D, the sonar equation, D2H
        out, echo_range = ek_power_cal_torch(
            _t(power), _t(dr), _t(tvg_shift), _t(absorption), _t(offset),
            spreading_factor=spreading,
        )
        return out.cpu().numpy(), echo_range.cpu().numpy()
