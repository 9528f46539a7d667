"""Split-beam (alongship/athwartship) physical angle computation.

Capability parity: echopype/consolidate/split_beam_angle.py:17-278.  The
CW power-mode conversion is here; the complex-mode inter-sector phase needs
pulse compression (``ops/matched_filter.py``), which is not ported yet.
"""

from __future__ import annotations

import numpy as np

from ..utils.log import _init_logger

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


def get_angle_complex_samples(ds_beam, angle_params, pc_params=None):
    """CW/BB complex-mode split-beam angles: not ported yet."""
    raise NotImplementedError(
        "complex-mode split-beam angles are not ported to echopype_torch yet "
        "(ROADMAP Queue 1 item 6: EK80 complex/BB with ops/matched_filter.py); "
        "use echopype_tpu"
    )
