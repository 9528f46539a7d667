"""EK depth helpers: platform offsets, pitch/roll rotation, beam direction.

Capability parity: echopype/consolidate/ek_depth_utils.py:30-112.
"""

from __future__ import annotations

import numpy as np

from ..utils.align import align_to_ping_time
from ..utils.log import _init_logger
from ..xrlite import DataArray

logger = _init_logger(__name__)

__all__ = ["ek_use_platform_vertical_offsets", "ek_use_platform_angles", "ek_use_beam_angles"]


def _warn_nans(ds, group_name, names):
    for name in names:
        if name in ds and np.any(np.isnan(np.asarray(ds[name].values, dtype="f8"))):
            logger.warning(
                f"The Echodata `{group_name}` group `{name}` variable array contains NaNs."
            )


def ek_use_platform_vertical_offsets(platform_ds, ping_time_da) -> DataArray:
    """transducer_depth = transducer_offset_z - (water_level + vertical_offset)."""
    _warn_nans(platform_ds, "Platform", ["water_level", "vertical_offset", "transducer_offset_z"])
    water_level = platform_ds["water_level"]
    vertical_offset = platform_ds["vertical_offset"]
    transducer_offset_z = platform_ds["transducer_offset_z"]
    transducer_depth = transducer_offset_z - (water_level + vertical_offset)
    return align_to_ping_time(transducer_depth, "time2", ping_time_da)


def ek_use_platform_angles(platform_ds, ping_time_da) -> DataArray:
    """Echo-range z-scaling from pitch/roll: ZYX Euler rotation's [2,2] element.

    R_z(0) R_y(pitch) R_x(roll) has M[2,2] = cos(pitch) * cos(roll).
    """
    _warn_nans(platform_ds, "Platform", ["pitch", "roll"])
    pitch = np.deg2rad(np.asarray(platform_ds["pitch"].values, dtype="f8"))
    roll = np.deg2rad(np.asarray(platform_ds["roll"].values, dtype="f8"))
    scaling = np.cos(pitch) * np.cos(roll)
    da = DataArray(
        scaling, ("time2",), coords={"time2": platform_ds.coords["time2"]}
    )
    return align_to_ping_time(da, "time2", ping_time_da)


def ek_use_beam_angles(beam_ds) -> DataArray:
    """Echo-range z-scaling = normalized beam_direction_z per channel."""
    _warn_nans(
        beam_ds, "Sonar/Beam_group1", ["beam_direction_x", "beam_direction_y", "beam_direction_z"]
    )
    bx = np.asarray(beam_ds["beam_direction_x"].values, dtype="f8")
    by = np.asarray(beam_ds["beam_direction_y"].values, dtype="f8")
    bz = np.asarray(beam_ds["beam_direction_z"].values, dtype="f8")
    norm = np.sqrt(bx**2 + by**2 + bz**2)
    tol = 1e-8
    if np.any((norm > tol) & (np.abs(norm - 1) > tol)):
        logger.warning("Beam direction vector was not normalized; applying normalization.")
    if np.any(norm < tol):
        logger.warning("Some beam direction vectors are zero. Outputting NaN for those channels.")
    out = np.where(norm < tol, np.nan, bz / np.where(norm < tol, 1.0, norm))
    return DataArray(out, ("channel",), coords={"channel": beam_ds.coords["channel"]})
