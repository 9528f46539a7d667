"""WGS-84 geodesic distance (vectorized Vincenty inverse).

The reference uses geopy's Karney geodesic for ping-to-ping distance
(echopype/commongrid/utils.py:210-231).  geopy is not available here;
Vincenty's inverse formula on WGS-84 agrees with Karney to sub-millimeter
for non-antipodal points, and this implementation is vectorized over point
pairs (the reference loops per row in pandas — a serial hot spot).
"""

from __future__ import annotations

import numpy as np

WGS84_A = 6378137.0
WGS84_F = 1 / 298.257223563
WGS84_B = WGS84_A * (1 - WGS84_F)

M_PER_NMI = 1852.0

__all__ = ["vincenty_inverse_m", "pairwise_distance_nmi"]


def vincenty_inverse_m(lat1, lon1, lat2, lon2, max_iter=200, tol=1e-12):
    """Geodesic distance in meters between (lat1,lon1) and (lat2,lon2), vectorized."""
    lat1, lon1, lat2, lon2 = (np.asarray(x, dtype="f8") for x in (lat1, lon1, lat2, lon2))
    phi1, phi2 = np.deg2rad(lat1), np.deg2rad(lat2)
    L = np.deg2rad(lon2 - lon1)
    U1 = np.arctan((1 - WGS84_F) * np.tan(phi1))
    U2 = np.arctan((1 - WGS84_F) * np.tan(phi2))
    sinU1, cosU1 = np.sin(U1), np.cos(U1)
    sinU2, cosU2 = np.sin(U2), np.cos(U2)

    lam = L.copy()
    active = np.ones(np.broadcast(phi1, phi2).shape, dtype=bool)
    sin_sigma = np.zeros_like(lam)
    cos_sigma = np.ones_like(lam)
    sigma = np.zeros_like(lam)
    cos_sq_alpha = np.ones_like(lam)
    cos2sm = np.zeros_like(lam)

    for _ in range(max_iter):
        sin_lam, cos_lam = np.sin(lam), np.cos(lam)
        t1 = cosU2 * sin_lam
        t2 = cosU1 * sinU2 - sinU1 * cosU2 * cos_lam
        ss = np.sqrt(t1**2 + t2**2)
        cs = sinU1 * sinU2 + cosU1 * cosU2 * cos_lam
        sig = np.arctan2(ss, cs)
        with np.errstate(divide="ignore", invalid="ignore"):
            sin_alpha = np.where(ss != 0, cosU1 * cosU2 * sin_lam / np.where(ss == 0, 1, ss), 0.0)
        csa = 1 - sin_alpha**2
        with np.errstate(divide="ignore", invalid="ignore"):
            c2sm = np.where(csa != 0, cs - 2 * sinU1 * sinU2 / np.where(csa == 0, 1, csa), 0.0)
        C = WGS84_F / 16 * csa * (4 + WGS84_F * (4 - 3 * csa))
        lam_new = L + (1 - C) * WGS84_F * sin_alpha * (
            sig + C * ss * (c2sm + C * cs * (-1 + 2 * c2sm**2))
        )
        delta = np.abs(lam_new - lam)
        upd = active
        lam = np.where(upd, lam_new, lam)
        sin_sigma = np.where(upd, ss, sin_sigma)
        cos_sigma = np.where(upd, cs, cos_sigma)
        sigma = np.where(upd, sig, sigma)
        cos_sq_alpha = np.where(upd, csa, cos_sq_alpha)
        cos2sm = np.where(upd, c2sm, cos2sm)
        active = active & (delta > tol)
        if not active.any():
            break

    u_sq = cos_sq_alpha * (WGS84_A**2 - WGS84_B**2) / WGS84_B**2
    A = 1 + u_sq / 16384 * (4096 + u_sq * (-768 + u_sq * (320 - 175 * u_sq)))
    B = u_sq / 1024 * (256 + u_sq * (-128 + u_sq * (74 - 47 * u_sq)))
    delta_sigma = (
        B
        * sin_sigma
        * (
            cos2sm
            + B
            / 4
            * (
                cos_sigma * (-1 + 2 * cos2sm**2)
                - B / 6 * cos2sm * (-3 + 4 * sin_sigma**2) * (-3 + 4 * cos2sm**2)
            )
        )
    )
    s = WGS84_B * A * (sigma - delta_sigma)
    # coincident points
    s = np.where((np.abs(phi1 - phi2) < 1e-15) & (np.abs(L) < 1e-15), 0.0, s)
    return s


def pairwise_distance_nmi(lat, lon):
    """Consecutive-point distances in nautical miles; NaN rows yield NaN."""
    lat, lon = np.asarray(lat, dtype="f8"), np.asarray(lon, dtype="f8")
    d = np.full(len(lat), np.nan)
    if len(lat) >= 2:
        d[:-1] = vincenty_inverse_m(lat[:-1], lon[:-1], lat[1:], lon[1:]) / M_PER_NMI
    return d
