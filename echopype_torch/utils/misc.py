"""Misc helpers: name conversion, pressure->depth (UNESCO 1983).

Capability parity: echopype/utils/misc.py:9,24.
"""

import re

import numpy as np

__all__ = ["camelcase2snakecase", "depth_from_pressure"]


def camelcase2snakecase(name: str) -> str:
    """Convert CamelCase names to snake_case.

    Every interior uppercase letter gets an underscore before it, matching
    the reference's key naming exactly (so e.g. ``XMLConfig`` ->
    ``x_m_l_config``) -- these strings become user-visible dict/variable
    keys for XML-config and AZFP fields.
    """
    return re.sub(r"(?<=.)([A-Z])", r"_\1", name).lower()


def depth_from_pressure(pressure, latitude=30.0, atm_pres_surf=0.0):
    """Depth [m] from pressure [dbar] via the UNESCO 1983 (Saunders) algorithm.

    Fofonoff NP, Millard RC (1983) UNESCO technical papers in marine science 44.
    """
    pressure = np.asarray(pressure, dtype="f8")
    latitude = np.asarray(latitude, dtype="f8")
    P = pressure - atm_pres_surf
    # gravity variation with latitude (international gravity formula)
    x = np.sin(np.deg2rad(latitude)) ** 2
    g = 9.780318 * (1.0 + (5.2788e-3 + 2.36e-5 * x) * x) + 1.092e-6 * P
    depth = ((((-1.82e-15 * P + 2.279e-10) * P - 2.2512e-5) * P + 9.72659) * P) / g
    return depth
