"""Plain reference for AZFP counts: Sv and MVBS from the writer's truth.

Imports neither JAX nor anything of the measured package.  From the
counts and thermistor counts the writer drew and the configuration's XML
coefficients and header fields, by echopype's published AZFP equations
(the ASL operator's manual, GU-100-AZFP-01-R50, Appendix G):

* temperature ``T = 1 / (A + B ln R + C ln^3 R) - 273`` with
  ``R = (ka + kb v) / (kc - v)``, ``v = 2.5 counts / 65535``;
* sound speed and absorption by the manual's formulas (salinity and
  pressure from the cell's ``env_params``);
* range ``r = c L / (2 f) + (c / 4) (((2 (k + 1) - 1) N - 1) / f + tau)``;
* ``Sv = EL - 2.5 / DS + N_k / (26214 DS) - (TVR + 20 log10 VTX)
  + 20 log10 r + 2 alpha r - 10 log10(0.5 c tau psi) + Sv_offset``, with
  ``psi`` the XML's BP and ``Sv_offset`` the manual's table by frequency
  and pulse length.

MVBS bins as ``reference/ek60.py`` says, with the survey streamer's rule:
range-bin bounds on the float32 sample grid of each chunk's first ping,
``fl32(k * fl32(dr)) >= fl32(e_j - fl32(r0))`` (``r0`` the range of sample
0, ``dr`` the range step).  A channel's samples past its bin count add to
no bin.  ``dtype`` and ``per_sample`` as in ``reference/ek60.py``.
"""

from __future__ import annotations

import numpy as np
import torch

from .ek60 import _binned, _to_db, ping_bins, same_grid_rows

__all__ = ["SV_OFFSET", "kernel_layout", "ping_terms", "survey_mvbs"]

#: the manual's Sv offset (dB) by frequency (Hz) and pulse length (us)
_HF = {300: 1.1, 500: 0.8, 700: 0.5, 900: 0.3, 1000: 0.3}
SV_OFFSET = {38000.0: {500: 1.1, 1000: 0.7}, 125000.0: {150: 1.4, 250: 1.3, **_HF},
             200000.0: {150: 1.4, 250: 1.3, **_HF}, 455000.0: {250: 1.3, **_HF}}


def kernel_layout(config, truth):
    """(uniform dr, samples a ping over all channels, bytes a staged
    sample): float32 dB power; never uniform (the range has an intercept)."""
    return False, sum(int(c["bins"]) for c in config["channels"]), 4


def ping_terms(config, env, t_counts):
    """[C, P] float64: r0, dr, alpha, K (Sv less power and range terms),
    and the per-channel power scale 1 / (26214 DS) [C]."""
    x, h, chans = config["xml"], config["header"], config["channels"]
    v = 2.5 * (np.asarray(t_counts, dtype="f8") / 65535)
    R = (x["ka"] + x["kb"] * v) / (x["kc"] - v)
    T = 1 / (x["A"] + x["B"] * np.log(R) + x["C"] * np.log(R) ** 3) - 273
    S, P = float(env["salinity"]), float(env["pressure"])
    z = T / 10
    c = (1449.05 + z * (45.7 + z * (-5.21 + 0.23 * z)) + (1.333 + z * (-0.126 + z * 0.009))
         * (S - 35.0) + (P / 1000) * (16.3 + 0.18 * (P / 1000)))[None, :]
    freq = np.asarray([ch["frequency_khz"] * 1000.0 for ch in chans])[:, None]
    tau = np.asarray([ch["pulse_us"] * 1e-6 for ch in chans])[:, None]
    f, L, N = float(h["dig_rate"]), float(h["lockout"]), float(h["samples_per_bin"])
    r0 = c * L / (2 * f) + (c / 4) * ((N - 1) / f + tau)
    dr = c * N / (2 * f) + 0 * tau
    tk = T[None, :] + 273.0
    f1 = 1320.0 * tk * np.exp(-1700 / tk)
    f2 = 1.55e7 * tk * np.exp(-3052 / tk)
    kp = 1 + P / 10.0
    a = 8.95e-8 * (1 + T * (2.29e-2 - 5.08e-4 * T))[None, :]
    b = ((S / 35.0) * 4.88e-7 * (1 + 0.0134 * T) * (1 - 0.00103 * kp + 3.7e-7 * kp**2))[None, :]
    cc = (4.86e-13 * (1 + T * (-0.042 + T * (8.53e-4 - T * 6.23e-6)))
          * (1 + kp * (-3.84e-4 + kp * 7.57e-8)))[None, :]
    alpha = a * f1 * freq**2 / (f1**2 + freq**2) + b * f2 * freq**2 / (f2**2 + freq**2) \
        + cc * freq**2
    ds = np.asarray(x["DS"], dtype="f8")[:, None]
    sl = np.asarray(x["TVR"], dtype="f8")[:, None] + 20 * np.log10(np.asarray(x["VTX0"]))[:, None]
    psi = np.asarray(x["BP"], dtype="f8")[:, None]
    off = np.asarray([SV_OFFSET[ch["frequency_khz"] * 1000.0][int(ch["pulse_us"])]
                      for ch in chans])[:, None]
    K = np.asarray(x["EL"], dtype="f8")[:, None] - 2.5 / ds - sl \
        - 10 * np.log10(0.5 * c * tau * psi) + off
    return r0, dr, alpha, K, 1.0 / (26214.0 * ds[:, 0])


def _sv_rows(counts, scale, r0, dr, alpha, K, dtype, device):
    """Sv [P, bins] of one channel in ``dtype``."""
    def t(a):
        return torch.from_numpy(np.asarray(a, dtype="f8")).to(device)

    k = torch.arange(counts.shape[1], dtype=torch.float64, device=device)
    r = (t(r0)[:, None] + k[None, :] * t(dr)[:, None]).to(dtype)
    p = (torch.from_numpy(counts).to(device).double() * scale).to(dtype)
    return p + 20 * torch.log10(r) + 2 * t(alpha).to(dtype)[:, None] * r + t(K).to(dtype)[:, None]


def survey_mvbs(config, made, range_bin_m, ping_bin_s, chunk_pings, env, dtype=torch.float64,
                device="cpu", per_sample=False):
    """MVBS [C, n_x, n_r] of the survey over ``made``, as in ``ek60``."""
    torch.backends.cuda.matmul.allow_tf32 = False
    chans = config["channels"]
    C, R = len(chans), max(int(c["bins"]) for c in chans)
    bin_ns = int(ping_bin_s) * 1_000_000_000
    start, n_x, _ = ping_bins(np.concatenate([tr["ping_time_ns"] for _, tr in made]), bin_ns)
    terms = [ping_terms(config, env, tr["temperature_counts"]) for _, tr in made]
    r_max = max(float(r0.max()) + float(dr.max()) * (R - 1) for r0, dr, *_ in terms)
    n_r = len(np.arange(0, r_max + range_bin_m, range_bin_m)) - 1
    edges32 = (range_bin_m * np.arange(n_r + 1, dtype="f8")).astype("f4")
    sums = torch.zeros((C, n_x, n_r), dtype=torch.float64, device=device)
    counts = torch.zeros_like(sums)
    for (_, tr), (r0, dr, alpha, K, scale) in zip(made, terms):
        x = torch.from_numpy((tr["ping_time_ns"] - start) // bin_ns).to(device)
        P = len(x)
        for lo in range(0, P, chunk_pings):
            sl = slice(lo, min(lo + chunk_pings, P))
            for c in range(C):
                n_b = int(chans[c]["bins"])
                sv = _sv_rows(tr["counts"][c][sl], scale[c], r0[c, sl], dr[c, sl],
                              alpha[c, sl], K[c, sl], dtype, device)
                lin = torch.pow(10.0, sv / 10)
                valid = torch.ones(sv.shape, dtype=torch.bool, device=device)
                keys = np.stack([r0[c, sl], dr[c, sl]], axis=1).astype("f4")
                for first, rows in same_grid_rows(keys, per_sample):
                    p0 = lo + first
                    e_off = torch.from_numpy(edges32 - np.float32(r0[c, p0])).to(device)
                    pos = (torch.arange(n_b, dtype=torch.float32, device=device)
                           * np.float32(dr[c, p0]))
                    ids = torch.searchsorted(e_off, pos, right=True) - 1
                    onehot = torch.zeros((n_b, n_r), dtype=torch.float64, device=device)
                    inside = torch.nonzero((ids >= 0) & (ids < n_r)).squeeze(1)
                    onehot[inside, ids[inside]] = 1.0
                    rows = slice(None) if rows.all() else torch.from_numpy(rows).to(device)
                    s, n = _binned(lin[rows], valid[rows], onehot, dtype)
                    sums[c].index_add_(0, x[sl][rows], s)
                    counts[c].index_add_(0, x[sl][rows], n)
    ping_edges = start + bin_ns * np.arange(n_x + 1, dtype="i8")
    return {"Sv": _to_db(sums.cpu().numpy(), counts.cpu().numpy()),
            "ping_time": ping_edges[:-1], "echo_range": range_bin_m * np.arange(n_r, dtype="f8"),
            "channel": [ch["channel_id"] for ch in chans]}
