"""Plain reference for NASC of EK60 power data, from the writer's truth.

Imports neither JAX nor anything of the measured package.  One file at a
time, as ``open_raw`` -> ``compute_Sv`` -> ``add_depth`` -> ``add_location``
-> ``compute_NASC`` define it, in float64 (NumPy, and plain PyTorch with
TF32 off):

* Sv by ``reference/ek60.py``'s sonar equation, NaN where ``k dr`` does not
  exceed the TVG shift on the float32 sample grid;
* depth: the float32 sample grid ``fl32(k * fl32(dr))`` widened to float64,
  plus the transducer depth (``depth_offset``), in float64;
* positions: the GGA fixes the writer logs (one every other ping, at the
  even ping's time: :func:`fixes`), decoded from their ``ddmm.mmmm`` text
  and linearly interpolated to every ping time;
* distance: the WGS-84 geodesic between consecutive pings by Vincenty's
  inverse formula (Vincenty 1975, Survey Review 23:88-93; written here from
  the published formulas), in nautical miles of 1,852 m.  As echopype's
  ``get_distance_from_latlon`` (a pandas ``shift(-1)`` before the cumulative
  sum), ping ``i`` carries the track length from ping 0 to ping ``i + 1``
  and the last ping repeats its predecessor's;
* bins: distance edges ``[0, b, 2b, ...]`` up to the largest distance and
  depth edges ``[0, 10 m, ...]`` up to the largest depth, both closed on
  the left; each sample joins the depth bin of its own float64 depth;
* NASC of each (channel, distance, depth) bin: the mean linear Sv of its
  samples whose Sv is not NaN, times the mean height, times
  ``4 pi 1852^2`` (MacLennan, Fernandes & Dalen 2002; Echoview's
  PRC_NASC).  The mean height is the sum of the bin's depth first
  differences, each labelled with its lower sample (the last sample of a
  ping has none), over the pings of the distance bin;
* per distance bin, the mean ping time, exact in integer nanoseconds
  (floored), and the mean latitude and longitude.

Departures from echopype's published code (``commongrid/api.py``,
``commongrid/utils.py``): the distance is Vincenty's, where echopype calls
geopy's Karney geodesic (the two agree to well under a millimetre at these
spacings); the mean ping time is exact, where echopype takes xarray's mean
of the bin's times; the depth differences and the height sums run on
NumPy in float64 rather than through flox.

``dtype`` is the precision of the per-sample and per-ping arithmetic:
float64 for the reference; ``torch.bfloat16`` makes the lower-precision
control (Sv, the linear values, the depth differences and the interpolated
positions in bfloat16, their bin sums in float32); the distance and the
bin edges stay float64 there, so that the grid compares.
"""

from __future__ import annotations

import numpy as np
import torch

from . import ek60 as ref60
from ..synth import ek60 as writer

__all__ = ["M_PER_NMI", "along_track_nmi", "edge_margin_nmi", "fixes", "nasc_file",
           "ping_positions", "vincenty_m"]

M_PER_NMI = 1852.0
NASC_FACTOR = 4 * np.pi * M_PER_NMI**2
WGS84_A = 6378137.0
WGS84_F = 1 / 298.257223563
#: where each file's track starts, and the step of latitude and of
#: longitude (degrees, west) between consecutive GGA fixes
TRACK_START = (45.0, 124.0)
TRACK_STEP_DEG = 1e-4


def fixes(t_ns):
    """(times ns, latitude, longitude) of the GGA fixes of a file whose ping
    times are ``t_ns``: one at every even ping, decoded from the text the
    writer logs (``ddmm.mmmm``, N / W)."""
    t_ns = np.asarray(t_ns, dtype="i8")
    j = np.arange((len(t_ns) + 1) // 2, dtype="f8")
    text = writer._gga(TRACK_START[0] + j * TRACK_STEP_DEG, TRACK_START[1] + j * TRACK_STEP_DEG)
    lat, lon = [], []
    for s in text:
        f = s.decode().split(",")
        lat.append((1 if f[3] == "N" else -1) * (int(f[2][:2]) + float(f[2][2:]) / 60.0))
        lon.append((1 if f[5] == "E" else -1) * (int(f[4][:3]) + float(f[4][3:]) / 60.0))
    return t_ns[::2], np.asarray(lat), np.asarray(lon)


def ping_positions(t_ns):
    """Latitude and longitude [P] float64 of every ping, linear in time
    between the fixes and past the last one (a file of an even number of
    pings ends one ping after its last fix)."""
    t_fix, lat, lon = fixes(t_ns)
    t = (np.asarray(t_ns, dtype="i8") - t_fix[0]).astype("f8")
    tf = (t_fix - t_fix[0]).astype("f8")
    out = []
    for v in (lat, lon):
        w = np.interp(t, tf, v)
        if len(tf) > 1:
            past = t > tf[-1]
            w[past] = v[-1] + (t[past] - tf[-1]) * (v[-1] - v[-2]) / (tf[-1] - tf[-2])
        out.append(w)
    return tuple(out)


def vincenty_m(lat1, lon1, lat2, lon2, iterations=100, tol=1e-13):
    """WGS-84 geodesic length (m) of each pair of points, Vincenty's inverse
    formula iterated on the auxiliary longitude until it moves less than
    ``tol`` radians; 0 for a point and itself.  Not for antipodal points."""
    a, f = WGS84_A, WGS84_F
    b = a * (1 - f)
    u1 = np.arctan((1 - f) * np.tan(np.radians(lat1)))
    u2 = np.arctan((1 - f) * np.tan(np.radians(lat2)))
    big_l = np.radians(np.asarray(lon2, dtype="f8") - np.asarray(lon1, dtype="f8"))
    lam = big_l.copy()
    same = (np.asarray(lat1) == np.asarray(lat2)) & (big_l == 0)  # length 0
    for _ in range(iterations):
        sin_sigma = np.hypot(np.cos(u2) * np.sin(lam),
                             np.cos(u1) * np.sin(u2) - np.sin(u1) * np.cos(u2) * np.cos(lam))
        cos_sigma = np.sin(u1) * np.sin(u2) + np.cos(u1) * np.cos(u2) * np.cos(lam)
        sigma = np.arctan2(sin_sigma, cos_sigma)
        sin_alpha = np.cos(u1) * np.cos(u2) * np.sin(lam) / np.where(same, 1.0, sin_sigma)
        cos2_alpha = 1 - sin_alpha**2
        cos_2sm = cos_sigma - 2 * np.sin(u1) * np.sin(u2) / cos2_alpha
        c = f / 16 * cos2_alpha * (4 + f * (4 - 3 * cos2_alpha))
        prev = lam
        lam = big_l + (1 - c) * f * sin_alpha * (
            sigma + c * sin_sigma * (cos_2sm + c * cos_sigma * (2 * cos_2sm**2 - 1)))
        if np.all(np.abs(lam - prev) < tol):
            break
    else:
        raise ValueError("Vincenty's inverse formula did not converge")
    u_sq = cos2_alpha * (a**2 - b**2) / b**2
    big_a = 1 + u_sq / 16384 * (4096 + u_sq * (-768 + u_sq * (320 - 175 * u_sq)))
    big_b = u_sq / 1024 * (256 + u_sq * (-128 + u_sq * (74 - 47 * u_sq)))
    d_sigma = big_b * sin_sigma * (cos_2sm + big_b / 4 * (
        cos_sigma * (2 * cos_2sm**2 - 1)
        - big_b / 6 * cos_2sm * (4 * sin_sigma**2 - 3) * (4 * cos_2sm**2 - 3)))
    return np.where(same, 0.0, b * big_a * (sigma - d_sigma))


def along_track_nmi(lat, lon):
    """[P] cumulative distance (nmi) a ping, echopype's rule: ping ``i``
    carries the track length to ping ``i + 1``, the last its predecessor's."""
    seg = vincenty_m(lat[:-1], lon[:-1], lat[1:], lon[1:]) / M_PER_NMI
    dist = np.cumsum(seg)
    return np.append(dist, dist[-1])


def edge_margin_nmi(dist, dist_bin_nmi):
    """The smallest distance (nmi) from any ping to a distance-bin edge."""
    edges = np.arange(0, dist.max() + dist_bin_nmi, dist_bin_nmi)
    return float(np.min(np.abs(dist[:, None] - edges[None, :])))


def _bin_ids(values, edges):
    """Bin of each value, closed on the left; -1 outside every bin."""
    ids = np.searchsorted(edges, values, side="right") - 1
    return np.where((ids >= 0) & (ids < len(edges) - 1), ids, -1)


def nasc_file(config, truth, range_bin_m, dist_bin_nmi, depth_offset, dtype=torch.float64,
              device="cpu"):
    """NASC [C, n_x, n_r] of one file and its grid: distance and depth edges
    (left edges), each ping's distance bin, and per distance bin the mean
    ping time (int64 ns, NaT where empty) and position."""
    torch.backends.cuda.matmul.allow_tf32 = False
    k = ref60.channel_constants(config)
    C, P, R = truth["power"].shape
    dr, shift, offset = ref60._ping_terms(k, truth["sound_speed"])
    t_ns = np.asarray(truth["ping_time_ns"], dtype="i8")

    lat, lon = ping_positions(t_ns)
    dist = along_track_nmi(lat, lon)
    dist_edges = np.arange(0, dist.max() + dist_bin_nmi, dist_bin_nmi)
    n_x = len(dist_edges) - 1
    x = _bin_ids(dist, dist_edges)
    in_x = x >= 0
    pings_x = np.bincount(x[in_x], minlength=n_x)

    lane = np.arange(R, dtype="f4")
    dr32 = dr.astype("f4")
    rows = {}  # (channel, dr32) -> float64 depth row
    for c in range(C):
        for d in np.unique(dr32[c]):
            rows[c, d] = depth_offset + (lane * d).astype("f8")
    depth_max = max(float(r[-1]) for r in rows.values())
    depth_edges = np.arange(0, depth_max + range_bin_m, range_bin_m)
    n_r = len(depth_edges) - 1

    sums = torch.zeros((C, n_x, n_r), dtype=torch.float64, device=device)
    counts = torch.zeros_like(sums)
    heights = np.zeros((C, n_x, n_r))
    x_t = torch.from_numpy(x).to(device)
    for c in range(C):
        sv, valid = ref60._sv_rows(truth["power"][c], dr[c], shift[c],
                                   np.full(P, k["absorption_coefficient"][c]), offset[c],
                                   dtype, device)
        lin = torch.where(valid, torch.pow(10.0, sv / 10), 0)
        for d in np.unique(dr32[c]):
            row = rows[c, d]
            ids = _bin_ids(row, depth_edges)
            onehot = torch.zeros((R, n_r), dtype=torch.float64, device=device)
            ok = np.flatnonzero(ids >= 0)
            onehot[torch.from_numpy(ok).to(device), torch.from_numpy(ids[ok]).to(device)] = 1.0
            mine = np.flatnonzero((dr32[c] == d) & in_x)
            sel = torch.from_numpy(mine).to(device)
            s, n = ref60._binned(lin[sel], valid[sel], onehot, dtype)
            sums[c].index_add_(0, x_t[sel], s)
            counts[c].index_add_(0, x_t[sel], n)
            diffs = np.diff(row)
            if dtype != torch.float64:
                diffs = torch.from_numpy(diffs).to(dtype).float().double().numpy()
            lower = ids[:-1]
            h_row = np.bincount(lower[lower >= 0], weights=diffs[lower >= 0], minlength=n_r)
            heights[c] += np.bincount(x[mine], minlength=n_x)[:, None] * h_row[None, :]
    sums, counts = sums.cpu().numpy(), counts.cpu().numpy()
    with np.errstate(invalid="ignore", divide="ignore"):
        sv_mean = np.where(counts > 0, sums / np.maximum(counts, 1), np.nan)
        h_mean = heights / np.where(pings_x > 0, pings_x, np.nan)[None, :, None]
    nasc = sv_mean * h_mean * NASC_FACTOR

    rel = t_ns - t_ns[0]
    t_sum = np.zeros(n_x, dtype=object)
    for b in range(n_x):  # exact integer sums
        t_sum[b] = int(rel[x == b].sum())
    nat = np.datetime64("NaT", "ns").astype("i8")
    ping_time = np.asarray([t_ns[0] + t_sum[b] // int(pings_x[b]) if pings_x[b] else nat
                            for b in range(n_x)], dtype="i8")
    if dtype != torch.float64:  # the control's positions
        lat, lon = (torch.from_numpy(v).to(dtype).double().numpy() for v in (lat, lon))
    with np.errstate(invalid="ignore", divide="ignore"):
        mean_lat = np.bincount(x[in_x], weights=lat[in_x], minlength=n_x) / np.where(
            pings_x > 0, pings_x, np.nan)
        mean_lon = np.bincount(x[in_x], weights=lon[in_x], minlength=n_x) / np.where(
            pings_x > 0, pings_x, np.nan)
    return {"NASC": nasc, "distance": dist_edges[:-1], "depth": depth_edges[:-1],
            "channel": k["channel_id"], "x": x, "dist": dist, "ping_time": ping_time,
            "latitude": mean_lat, "longitude": mean_lon}
