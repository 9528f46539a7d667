"""Plain reference for EK60 power data: Sv and MVBS from the writer's truth.

Imports neither JAX nor anything of the measured package.  It reads the
power indices, ping times and sound speeds the benchmark's writer drew, and
the configuration's calibration constants as the files store them (float32
datagram fields, widened to float64), and works out:

* Sv by echopype's power-mode sonar equation (Simrad EK60 CW, GPT):
  ``Sv = P + 20 log10(r') + 2 alpha r' - 10 log10(pt) - 2 G - psi
  - 10 log10(lambda^2 tau c / (32 pi^2)) - 2 Sa`` with ``P`` the power
  index times ``10 log10(2) / 256``, ``r' = k dr - 2 dr`` (the Ex60 TVG
  shift of two samples), ``dr = c T / 2``, ``lambda = c / f``, and ``G``
  and ``Sa`` the entries of the CON0 gain and Sa tables at the ping's
  pulse length;
* MVBS as the linear-domain mean over (ping-time bin, range bin) cells,
  ping-time bins ``[origin + k T, origin + (k + 1) T)`` from midnight of
  the first ping's day, range bins ``[j b, (j + 1) b)``.

Range-bin membership is decided on the float32 sample grid, as the measured
program documents it: a sample ``k`` lies at ``fl32(k * fl32(dr))``, and a
sample counts only where that exceeds ``fl32(2 dr)``.  The survey streamer
takes each 5,000-ping chunk's bin bounds from the chunk's first ping
(``run_survey_mvbs_from_raw``'s rule where the sound speed varies by ping);
``survey_mvbs`` follows that rule, or with ``per_sample`` bins every sample
by its own range, as ``compute_MVBS`` does and as ``chain_file`` always
does.

``dtype`` is the precision of the per-sample arithmetic: float64 for the
reference; ``torch.bfloat16`` makes the lower-precision control (per-ping
bin sums then in float32, with TF32 off).
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["INDEX2POWER", "channel_constants", "chain_file", "kernel_layout", "ping_bins",
           "same_grid_rows", "survey_mvbs"]

INDEX2POWER = 10.0 * np.log10(2.0) / 256.0
DAY_NS = 86_400 * 1_000_000_000


def _f32(v):
    return np.asarray(v, dtype="f4").astype("f8")


def channel_constants(config):
    """Per-channel float64 constants, each as stored (float32) in the file."""
    out = {}
    chans = config["channels"]
    for key in ("frequency", "transmit_power", "pulse_length", "sample_interval",
                "absorption_coefficient", "equivalent_beam_angle"):
        out[key] = _f32([ch[key] for ch in chans])
    gain, sa = [], []
    for ch in chans:
        table = _f32(ch["pulse_length_table"])
        i = int(np.flatnonzero(table == _f32(ch["pulse_length"]))[0])
        gain.append(_f32(ch["gain_table"])[i])
        sa.append(_f32(ch["sa_correction_table"])[i])
    out["gain"], out["sa"] = np.asarray(gain), np.asarray(sa)
    out["channel_id"] = [ch["channel_id"] for ch in chans]
    return out


def _ping_terms(k, c):
    """[C, P] float64: dr, the TVG shift and the Sv offset at sound speed
    ``c`` [P] (float32 as recorded)."""
    c = _f32(c)[None, :]
    dr = k["sample_interval"][:, None] * c / 2.0
    shift = 2.0 * dr
    wavelength = c / k["frequency"][:, None]
    tau = k["pulse_length"][:, None]
    csv = (10 * np.log10(k["transmit_power"])[:, None] + 2 * k["gain"][:, None]
           + k["equivalent_beam_angle"][:, None]
           + 10 * np.log10(wavelength**2 * tau * c / (32 * np.pi**2)))
    offset = -(csv + 2 * k["sa"][:, None])
    return dr, shift, offset


def kernel_layout(config, truth):
    """(uniform dr, samples a ping over all channels, bytes a staged sample)
    of one file: int16 power indices; uniform where the sound speed is."""
    C, _, R = truth["power"].shape
    c = truth["sound_speed"]
    return bool(np.all(c == c[0])), C * R, 2


def ping_bins(t_ns, bin_ns):
    """(start, n_x, x ids) of ping-time bins over int64 ns times ``t_ns``."""
    first, last = int(t_ns.min()), int(t_ns.max())
    origin = first - first % DAY_NS
    start = first - (first - origin) % bin_ns
    return start, (last - start) // bin_ns + 1, (t_ns - start) // bin_ns


def _sv_rows(power, dr, shift, alpha, offset, dtype, device):
    """Sv [P, R] of one channel and its valid mask (``k dr > shift`` on the
    float32 grid), in ``dtype``; NaN where not valid."""
    P, R = power.shape
    k = torch.arange(R, dtype=torch.float64, device=device)
    dr32 = torch.from_numpy(np.asarray(dr, dtype="f4")).to(device)
    pos32 = torch.arange(R, dtype=torch.float32, device=device)[None, :] * dr32[:, None]
    sh32 = torch.from_numpy(np.asarray(shift, dtype="f4")).to(device)
    valid = pos32 > sh32[:, None]

    def t(a):
        return torch.from_numpy(np.asarray(a, dtype="f8")).to(device).to(dtype)

    p_db = torch.from_numpy(power).to(device).to(torch.float64) * INDEX2POWER
    r_tvg = (k[None, :] * t(dr).double()[:, None] - t(shift).double()[:, None]).to(dtype)
    r_safe = torch.where(valid, r_tvg, torch.ones((), dtype=dtype, device=device))
    sv = (p_db.to(dtype) + 20 * torch.log10(r_safe) + 2 * t(alpha)[:, None] * r_tvg
          + t(offset)[:, None])
    return torch.where(valid, sv, torch.full((), float("nan"), dtype=dtype, device=device)), valid


def _bin_onehot(pos32, edges32, n_r):
    """[R, n_r] float64 0/1: float32 position ``pos32`` [R] in [e_j, e_j+1)."""
    ids = torch.searchsorted(edges32, pos32, right=True) - 1
    inside = (ids >= 0) & (ids < n_r)
    m = torch.zeros((pos32.shape[0], n_r), dtype=torch.float64, device=pos32.device)
    rows = torch.nonzero(inside).squeeze(1)
    m[rows, ids[rows]] = 1.0
    return m


def _binned(lin, valid, onehot, dtype):
    """Per-ping bin sums and counts [P, n_r] float64."""
    if dtype == torch.float64:
        return lin @ onehot, valid.double() @ onehot
    sums = (lin.float() @ onehot.float()).double()
    return sums, valid.double() @ onehot


def _to_db(sums, counts):
    with np.errstate(invalid="ignore", divide="ignore"):
        return np.where(counts > 0, 10 * np.log10(sums / np.maximum(counts, 1)), np.nan)


def same_grid_rows(keys, per_sample):
    """[(first row, rows)] of a chunk: the rows binned on the grid of the
    row ``first``; ``keys`` [P, n] the values the grid depends on.  One
    group (the chunk's first ping) unless ``per_sample``."""
    if not per_sample:
        return [(0, np.ones(len(keys), dtype=bool))]
    _, first, inverse = np.unique(keys, axis=0, return_index=True, return_inverse=True)
    return [(int(f), inverse.reshape(-1) == g) for g, f in enumerate(first)]


def survey_mvbs(config, made, range_bin_m, ping_bin_s, chunk_pings, env=None,
                dtype=torch.float64, device="cpu", per_sample=False):
    """MVBS [C, n_x, n_r] of the survey over ``made`` ([(path, truth)]),
    with its ping-time edges (int64 ns) and range edges (m).  ``env`` is
    unused: EK60 files record their sound speed and absorption."""
    torch.backends.cuda.matmul.allow_tf32 = False
    k = channel_constants(config)
    C = len(k["channel_id"])
    R = made[0][1]["power"].shape[2]
    bin_ns = int(ping_bin_s) * 1_000_000_000
    t_all = np.concatenate([tr["ping_time_ns"] for _, tr in made])
    start, n_x, _ = ping_bins(t_all, bin_ns)
    terms = [_ping_terms(k, tr["sound_speed"]) for _, tr in made]
    r_max = max(float(dr.max()) * (R - 1) for dr, _, _ in terms)
    n_r = len(np.arange(0, r_max + range_bin_m, range_bin_m)) - 1
    edges = range_bin_m * np.arange(n_r + 1, dtype="f8")
    edges32 = torch.from_numpy(edges.astype("f4")).to(device)
    sums = torch.zeros((C, n_x, n_r), dtype=torch.float64, device=device)
    counts = torch.zeros_like(sums)
    lane = torch.arange(R, dtype=torch.float32, device=device)
    for (_, tr), (dr, shift, offset) in zip(made, terms):
        x = torch.from_numpy((tr["ping_time_ns"] - start) // bin_ns).to(device)
        P = tr["power"].shape[1]
        for lo in range(0, P, chunk_pings):
            sl = slice(lo, min(lo + chunk_pings, P))
            for c in range(C):
                sv, valid = _sv_rows(tr["power"][c, sl], dr[c, sl], shift[c, sl],
                                     np.full(sl.stop - lo, k["absorption_coefficient"][c]),
                                     offset[c, sl], dtype, device)
                lin = torch.where(valid, torch.pow(10.0, sv / 10), 0)
                for first, rows in same_grid_rows(dr[c, sl, None], per_sample):
                    onehot = _bin_onehot(lane * np.float32(dr[c, lo + first]), edges32, n_r)
                    rows = slice(None) if rows.all() else torch.from_numpy(rows).to(device)
                    s, n = _binned(lin[rows], valid[rows], onehot, dtype)
                    sums[c].index_add_(0, x[sl][rows], s)
                    counts[c].index_add_(0, x[sl][rows], n)
    mvbs = _to_db(sums.cpu().numpy(), counts.cpu().numpy())
    ping_edges = start + bin_ns * np.arange(n_x + 1, dtype="i8")
    return {"Sv": mvbs, "ping_time": ping_edges[:-1], "echo_range": edges[:-1],
            "channel": k["channel_id"]}


def chain_file(config, truth, range_bin_m, ping_bin_s, dtype=torch.float64, device="cpu",
               with_sv=True):
    """Sv [C, P, R] (when ``with_sv``) and MVBS of one file, as
    ``compute_Sv`` then ``compute_MVBS`` define them: every sample binned
    by its own float32 echo_range ``fl32(k * fl32(dr))`` against float64
    edges ``[0, b, 2b, ...]`` up to the largest range, closed on the left;
    samples whose Sv is NaN join no mean."""
    torch.backends.cuda.matmul.allow_tf32 = False
    k = channel_constants(config)
    C, P, R = truth["power"].shape
    dr, shift, offset = _ping_terms(k, truth["sound_speed"])
    bin_ns = int(ping_bin_s) * 1_000_000_000
    start, n_x, x = ping_bins(truth["ping_time_ns"], bin_ns)
    lane = np.arange(R, dtype="f4")
    er_max = max(float((lane[-1] * dr[c].astype("f4")).max()) for c in range(C))
    edges = np.arange(0, er_max + range_bin_m, range_bin_m)
    n_r = len(edges) - 1
    edges_t = torch.from_numpy(edges).to(device)
    x_t = torch.from_numpy(x).to(device)
    sums = torch.zeros((C, n_x, n_r), dtype=torch.float64, device=device)
    counts = torch.zeros_like(sums)
    sv_out = np.empty((C, P, R), dtype="f8") if with_sv else None
    uniform = bool(np.all(dr == dr[:, :1]))
    for c in range(C):
        sv, valid = _sv_rows(truth["power"][c], dr[c], shift[c],
                             np.full(P, k["absorption_coefficient"][c]), offset[c], dtype,
                             device)
        if with_sv:
            sv_out[c] = sv.double().cpu().numpy()
        lin = torch.where(valid, torch.pow(10.0, sv / 10), 0)
        if not uniform:
            raise ValueError("chain_file bins files of one sound speed a channel")
        er32 = torch.from_numpy(lane * np.float32(dr[c, 0])).to(device).double()
        onehot = _bin_onehot(er32, edges_t, n_r)
        s, n = _binned(lin, valid, onehot, dtype)
        sums[c].index_add_(0, x_t, s)
        counts[c].index_add_(0, x_t, n)
    mvbs = _to_db(sums.cpu().numpy(), counts.cpu().numpy())
    ping_edges = start + bin_ns * np.arange(n_x + 1, dtype="i8")
    return {"Sv": mvbs, "ping_time": ping_edges[:-1], "echo_range": edges[:-1],
            "channel": k["channel_id"], "Sv_samples": sv_out}
