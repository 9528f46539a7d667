"""EK500 echogram colormap registration.

Capability parity: echopype/colormap/cm.py:4-27 — registers ``ep.ek500`` and
``ep.ek500_r`` with matplotlib when available; the RGB table is exposed
regardless.
"""

from __future__ import annotations

import numpy as np

#: Simrad EK500 11-step echogram palette (light grey -> light brown)
EK500_COLORS = (
    np.array(
        [
            [159, 159, 159],
            [95, 95, 95],
            [0, 0, 255],
            [0, 0, 127],
            [0, 191, 0],
            [0, 127, 0],
            [255, 255, 0],
            [255, 127, 0],
            [255, 0, 191],
            [255, 0, 0],
            [166, 83, 60],
        ]
    )
    / 255
)
EK500_UNDER = "1"  # white
EK500_OVER = np.array([120, 60, 40]) / 255  # dark brown


def ek500_cmap(reverse: bool = False):
    """Return the EK500 matplotlib colormap (requires matplotlib)."""
    import matplotlib as mpl

    rgb = EK500_COLORS[::-1] if reverse else EK500_COLORS
    cmap = mpl.colors.ListedColormap(rgb)
    if reverse:
        cmap.set_over(EK500_UNDER)
        cmap.set_under(EK500_OVER)
    else:
        cmap.set_under(EK500_UNDER)
        cmap.set_over(EK500_OVER)
    return cmap


def _register():
    try:
        import matplotlib as mpl

        for name, rev in (("ep.ek500", False), ("ep.ek500_r", True)):
            if name not in mpl.colormaps:
                mpl.colormaps.register(ek500_cmap(rev), name=name)
    except Exception:  # noqa: BLE001 - colormap registration is best-effort
        pass


_register()
