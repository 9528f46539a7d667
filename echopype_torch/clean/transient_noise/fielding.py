"""Fielding-style deep-water transient detector.

Capability parity: echopype/clean/transient_noise/transient_fielding.py
(algorithm from echopy's mask_transient.fielding, A. Ariza 2020): flag pings
whose deep-window median exceeds the neighbourhood median, then propagate the
mask upward in fixed vertical steps until the excess drops below thr[1].
Returned mask: True = VALID (keep).
"""

from __future__ import annotations

import warnings

import numpy as np

from ...utils.compute import _lin2log, _log2lin
from ...xrlite import DataArray

__all__ = ["transient_noise_fielding"]


def _fielding_core(sv_pr, r, r0, r1, n, thr, roff, jumps=5, maxts=-35, start=0):
    """sv_pr: [ping, range]; returns bad-mask [ping, range] (True = BAD)."""
    sv = np.asarray(sv_pr, dtype="f8").T  # (range, ping)
    r = np.asarray(r, dtype="f8")
    if r0 > r1 or (r0 > r[-1]) or (r1 < r[0]):
        return np.zeros_like(sv.T, dtype=bool)

    up = int(np.argmin(np.abs(r - r0)))
    lw = int(np.argmin(np.abs(r - r1)))
    rmin = int(np.argmin(np.abs(r - roff)))
    dr = float(np.nanmedian(np.diff(r)))
    sf = max(1, int(round(jumps / dr)))

    mask = np.zeros_like(sv, dtype=bool)
    n_pings = sv.shape[1]
    lin = _log2lin(sv)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", category=RuntimeWarning)
        for j in range(start, n_pings):
            if (j - n < 0) or (j + n > n_pings - 1) or np.all(np.isnan(sv[up:lw, j])):
                continue
            pingmedian = _lin2log(np.nanmedian(lin[up:lw, j]))
            pingp75 = _lin2log(np.nanpercentile(lin[up:lw, j], 75))
            blockmedian = _lin2log(np.nanmedian(lin[up:lw, j - n : j + n]))
            if (pingp75 < maxts) and ((pingmedian - blockmedian) > thr[0]):
                r0_, r1_ = up - sf, up
                while r0_ > rmin:
                    pingmedian = _lin2log(np.nanmedian(lin[r0_:r1_, j]))
                    blockmedian = _lin2log(np.nanmedian(lin[r0_:r1_, j - n : j + n]))
                    r0_, r1_ = r0_ - sf, r1_ - sf
                    if (pingmedian - blockmedian) < thr[1]:
                        break
                mask[r0_:, j] = True
    return mask.T


def transient_noise_fielding(
    ds_Sv,
    var_name: str = "Sv",
    range_var: str = "depth",
    r0: float = 900,
    r1: float = 1000,
    n: int = 30,
    thr=(3, 1),
    roff: float = 20,
    jumps: float = 5,
    maxts: float = -35,
    start: int = 0,
) -> DataArray:
    """Per-channel Fielding detector; True = VALID (keep)."""
    sv_da = ds_Sv[var_name]
    sv = np.asarray(sv_da.values, dtype="f8")
    rv = ds_Sv[range_var]
    # reduce range var to 1-D per channel (first ping)
    rvals = np.asarray(rv.values, dtype="f8")
    if rvals.ndim == 3:
        rvals = rvals[:, 0, :]
    elif rvals.ndim == 1:
        rvals = np.broadcast_to(rvals, (sv.shape[0], len(rvals)))
    bad = np.stack(
        [
            _fielding_core(sv[c], rvals[c], r0, r1, n, thr, roff, jumps, maxts, start)
            for c in range(sv.shape[0])
        ]
    )
    out = DataArray(
        ~bad,
        sv_da.dims,
        attrs={"meaning": "True = VALID (False = transient noise)"},
        name="fielding_mask_valid",
    )
    out.coords = dict(sv_da.coords)
    return out
