"""Split-beam (alongship/athwartship) physical angle computation.

Capability parity: echopype/consolidate/split_beam_angle.py:17-278 — beam-type
registry (1 = 4-sector, 17 = 3-sector, 49/65/81 = 3-sector + center),
power-mode electrical-angle conversion, complex-mode inter-sector phase.
"""

from __future__ import annotations

import numpy as np

from ..utils.log import _init_logger
from ..xrlite import DataArray

logger = _init_logger(__name__)

SUPPORTED_BEAM_TYPES = [1, 17, 49, 65, 81]

__all__ = ["get_angle_power_samples", "get_angle_complex_samples", "SUPPORTED_BEAM_TYPES"]


def get_angle_power_samples(ds_beam, angle_params):
    """CW power-mode: physical = (raw * 180/128) / sensitivity - offset."""
    conversion_const = 180.0 / 128.0
    if np.all(np.asarray(ds_beam["beam_type"].values) == 0):
        raise ValueError(
            "Computing physical split-beam angle is only available for data "
            "from split-beam transducers!"
        )

    def _e2f(angle_type):
        return (
            conversion_const
            * ds_beam[f"angle_{angle_type}"]
            / angle_params[f"angle_sensitivity_{angle_type}"]
            - angle_params[f"angle_offset_{angle_type}"]
        )

    return _e2f("alongship"), _e2f("athwartship")


def _angles_from_complex(bs: np.ndarray, beam_type: int):
    """bs: complex [ping, range, beam] for one channel -> (theta_deg, phi_deg)."""
    if beam_type == 1:
        bs_fore = (bs[..., 2] + bs[..., 3]) / 2
        bs_aft = (bs[..., 0] + bs[..., 1]) / 2
        bs_star = (bs[..., 0] + bs[..., 3]) / 2
        bs_port = (bs[..., 1] + bs[..., 2]) / 2
        bs_theta = bs_fore * np.conj(bs_aft)
        bs_phi = bs_star * np.conj(bs_port)
        theta = np.arctan2(bs_theta.imag, bs_theta.real) / np.pi * 180
        phi = np.arctan2(bs_phi.imag, bs_phi.real) / np.pi * 180
        return theta, phi
    if beam_type in (17, 49, 65, 81):
        if beam_type == 17:
            bs_star, bs_port, bs_fore = bs[..., 0], bs[..., 1], bs[..., 2]
        else:
            bs_star = (bs[..., 0] + bs[..., 3]) / 2
            bs_port = (bs[..., 1] + bs[..., 3]) / 2
            bs_fore = (bs[..., 2] + bs[..., 3]) / 2
        f1 = bs_fore * np.conj(bs_star)
        f2 = bs_fore * np.conj(bs_port)
        fac1 = np.arctan2(f1.imag, f1.real) / np.pi * 180
        fac2 = np.arctan2(f2.imag, f2.real) / np.pi * 180
        theta = (fac1 + fac2) / np.sqrt(3)
        phi = fac2 - fac1
        return theta, phi
    if beam_type == 97:
        raise NotImplementedError("EC150-3C beam type not supported")
    raise ValueError("beam_type not recognized!")


def get_angle_complex_samples(ds_beam, angle_params, pc_params=None):
    """CW/BB complex-mode split-beam angles (optionally pulse-compressed)."""
    if "backscatter_i" not in ds_beam:
        raise ValueError("Complex angle computation requires backscatter_i in the beam group")
    bs = (
        np.asarray(ds_beam["backscatter_r"].values, dtype="f8")
        + 1j * np.asarray(ds_beam["backscatter_i"].values, dtype="f8")
    )  # [channel, ping, range, beam]
    if pc_params is not None:
        from ..calibrate.ek80_complex import get_transmit_signal
        from ..ops.matched_filter import pulse_compress_channel

        coeff = {
            k: v
            for k, v in pc_params.items()
            if k not in ("receiver_sampling_frequency", "drop_last_hanning_zero")
        }
        chirp, _ = get_transmit_signal(
            ds_beam,
            coeff,
            "BB",
            pc_params["receiver_sampling_frequency"],
            pc_params.get("drop_last_hanning_zero", False),
        )
        for ci, ch in enumerate(ds_beam.coords["channel"].values):
            bs[ci] = pulse_compress_channel(bs[ci], chirp[str(ch)])

    beam_types = np.asarray(ds_beam["beam_type"].values, dtype="i8")
    n_ch = bs.shape[0]
    theta = np.full(bs.shape[:-1], np.nan)
    phi = np.full(bs.shape[:-1], np.nan)
    for c in range(n_ch):
        try:
            th, ph = _angles_from_complex(bs[c], int(beam_types[c]))
        except (ValueError, NotImplementedError):
            continue
        theta[c], phi[c] = th, ph

    dims = tuple(d for d in ds_beam["backscatter_r"].dims if d != "beam")
    coords = {k: v for k, v in ds_beam["backscatter_r"].coords.items() if "beam" not in v.dims}
    theta_da = DataArray(theta, dims, name="angle_alongship")
    phi_da = DataArray(phi, dims, name="angle_athwartship")
    theta_da.coords = dict(coords)
    phi_da.coords = dict(coords)
    theta_da = theta_da / angle_params["angle_sensitivity_alongship"] - angle_params[
        "angle_offset_alongship"
    ]
    phi_da = phi_da / angle_params["angle_sensitivity_athwartship"] - angle_params[
        "angle_offset_athwartship"
    ]
    return theta_da, phi_da
