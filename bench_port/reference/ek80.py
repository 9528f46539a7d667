"""Plain reference for EK80 broadband (FM) complex data: MVBS from the writer's truth.

Plain PyTorch and NumPy in float64, TF32 off; imports neither JAX nor
anything of the measured package.  From the complex samples and ping times
the writer drew, the FIL1 taps it stored (complex64, as in the file) and
the configuration, it works out echopype's broadband Sv (``calibrate/calibrate_ek.py``,
``calibrate/ek80_complex.py``):

* each channel's replica: the Hann-tapered linear chirp at the receiver's
  rate (``tapered_chirp``: its sample count ``floor(tau * float32(fs))``,
  taper ``round(2 tau fs slope)`` samples), convolved with the WBT taps and
  decimated, convolved with the PC taps and decimated; the matched filter
  is its flipped conjugate, normalised by its energy ``||tx||^2``; the
  effective pulse length ``tau_eff = sum |a|^2 / (max |a|^2 fs_deci)`` of
  its normalised autocorrelation ``a``;
* pulse compression ``y[n] = sum_k x[n + k] conj(tx[k])``, as echopype's
  ``signal.convolve(x, flip(conj(tx)), mode="full")[L - 1:]``;
* ``prx = n_sectors |mean_sectors(y)|^2 / (2 sqrt 2)^2 (|z_er + z_et| /
  z_er)^2 / z_et``;
* ``Sv = 10 log10(prx) + 20 log10(r') + 2 alpha r' - 10 log10(lambda^2 pt
  c / (32 pi^2)) - 2 (G(fc) - B) - 10 log10(tau_eff) - psi(fc)`` with
  ``r' = k dr - c tau / 4`` (the WBT's TVG shift), ``dr = c T / 2``,
  ``fc`` the sweep's centre, ``lambda = c / fc``, ``G`` and the beam
  pattern's angle offsets and beamwidths interpolated on the broadband
  calibration curve at ``fc``, ``B = 0.5 x 6.0206 (a + b - 0.18 a b)``
  with ``a``, ``b`` the squared offsets over half-beamwidths, ``psi(fc) =
  psi + 20 log10(f_nominal / fc)``; ``c`` the environment's sound speed,
  ``alpha`` Francois and Garrison's absorption at ``fc`` from its
  temperature, salinity, depth and acidity;
* MVBS as the linear-domain mean over (ping-time bin, range bin) cells,
  ping-time bins from midnight of the first ping's day, then dB.

It bins as the fused survey step states its rule: sample ``k`` lies at
``fl32(k) * fl32(dr)`` against float32 edges ``[j b, (j + 1) b)``, the first
sample of Sv is ``k0 = floor(shift / dr) + 1`` decided in float64, and a
sample counts where its prx is above 0 and it lies in the ping's
contiguous run of samples (every sample, here).  The grid is the survey's:
edges from 0 to the largest ``dr (R - 1)`` over channels in steps of
``b``.

Departures from echopype's published equations, each where the exact sum
and echopype's arithmetic part:

* the compression runs as an FFT correlation, and its last ``z`` outputs,
  where ``z`` is the replica's count of exact-zero leading taps, are set to
  0: they touch only those taps, so the direct sum is exactly 0 there (the
  FFT leaves ~1e-17) and such samples join no mean;
* the sweep's centre, the gain and the beam-pattern terms are taken once a
  channel, since every ping of a file records the same parameters.

``dtype=torch.bfloat16`` makes the lower-precision control: samples and
replica rounded to bfloat16, the correlation summed in float32 (no FFT
runs in bfloat16), prx and Sv in bfloat16, the bin sums in float32.
``mf="bf16x3"`` instead reads the matched filter as three bfloat16 products
with float32 sums (``lo x hi + hi x lo + hi x hi`` of each operand's high
and low bfloat16 parts), the rest in float64: a reading beside the limits.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["channel_terms", "ping_bins", "replica", "sv_samples", "survey_mvbs"]

DAY_NS = 86_400 * 1_000_000_000


def ping_bins(t_ns, bin_ns):
    """(start, n_x, x ids) of ping-time bins over int64 ns times ``t_ns``,
    from midnight of the first ping's day."""
    first, last = int(t_ns.min()), int(t_ns.max())
    origin = first - first % DAY_NS
    start = first - (first - origin) % bin_ns
    return start, (last - start) // bin_ns + 1, (t_ns - start) // bin_ns


def replica(config, ch, taps):
    """(tx complex128 [L], fs_deci) of one channel: the filtered and
    decimated transmit signal, and its sample rate as echopype derives it
    from the replica's time axis.  ``taps``: the channel's (WBT, PC) FIL1
    taps."""
    fs = float(config["receiver_sampling_frequency"])
    tau, sl = float(ch["pulse_duration"]), float(ch["slope"])
    f0, f1 = float(ch["frequency_start"]), float(ch["frequency_end"])
    n = int(np.floor(tau * np.float32(fs)))
    t = np.linspace(0, n - 1, num=n) * 1 / fs
    y = np.cos(np.pi * (f1 - f0) / tau * t * t + 2 * np.pi * f0 * t)
    m = int(np.round(tau * fs * sl * 2.0))
    w = 0.5 * (1.0 - np.cos(2.0 * np.pi * np.arange(0, m, 1) / (m - 1)))
    w1, w2 = w[: int(m / 2)], w[int(m / 2):]
    y[: len(w1)] *= w1
    y[n - len(w2):] *= w2
    y = y / np.max(y)
    d1, d2 = int(ch["wbt_filter"]["decimation"]), int(ch["pc_filter"]["decimation"])
    wbt, pc = (np.asarray(t, dtype="c16") for t in taps)
    tx = np.convolve(np.convolve(y, wbt)[::d1], pc)[::d2]
    return tx, 1.0 / (1.0 / fs * d1 * d2)


def _interp(cal, key, f):
    xs, ys = np.asarray(cal["frequency"], dtype="f8"), np.asarray(cal[key], dtype="f8")
    return float(np.interp(f, xs, ys)) if xs[0] <= f <= xs[-1] else float("nan")


def _absorption(f, env, c):
    """Francois and Garrison (1982) seawater absorption, dB/m, at ``f`` Hz;
    the depth (m) stands for the pressure term."""
    t, s, d, ph = (float(env[k]) for k in ("temperature", "salinity", "depth", "acidity"))
    fk = f / 1000.0
    a1 = 8.86 / c * 10 ** (0.78 * ph - 5)
    f1 = 2.8 * np.sqrt(s / 35) * 10 ** (4 - 1245 / (t + 273))
    a2 = 21.44 * s / c * (1 + 0.025 * t)
    p2 = 1.0 - 1.37e-4 * d + 6.2e-9 * d**2
    f2 = 8.17 * 10 ** (8 - 1990 / (t + 273)) / (1 + 0.0018 * (s - 35))
    p3 = 1.0 - 3.83e-5 * d + 4.9e-10 * d**2
    if t < 20:
        a3 = 4.937e-4 - 2.59e-5 * t + 9.11e-7 * t**2 - 1.5e-8 * t**3
    else:
        a3 = 3.964e-4 - 1.146e-5 * t + 1.45e-7 * t**2 - 6.5e-10 * t**3
    return (a1 * f1 * fk**2 / (fk**2 + f1**2) + a2 * p2 * f2 * fk**2 / (fk**2 + f2**2)
            + a3 * p3 * fk**2) / 1000.0


def channel_terms(config, ch, taps):
    """float64 constants of one channel's Sv (module docstring); ``taps``
    its (WBT, PC) FIL1 taps."""
    env, cal = config["environment"], ch["calibration"]
    c = float(env["sound_speed"])
    fc = (float(ch["frequency_start"]) + float(ch["frequency_end"])) / 2
    tx, fs_deci = replica(config, ch, taps)
    norm = float(np.sum(np.abs(tx) ** 2))
    auto = np.convolve(tx, np.flip(np.conj(tx))) / norm
    pa = np.abs(auto) ** 2
    tau_eff = pa.sum() / (pa.max() * fs_deci)
    fa = (abs(_interp(cal, "angle_offset_alongship", fc))
          / (_interp(cal, "beamwidth_alongship", fc) / 2)) ** 2
    ft = (abs(_interp(cal, "angle_offset_athwartship", fc))
          / (_interp(cal, "beamwidth_athwartship", fc) / 2)) ** 2
    gain = _interp(cal, "gain", fc) - 0.5 * 6.0206 * (fa + ft - 0.18 * fa * ft)
    psi = float(ch["equivalent_beam_angle"]) + 20 * np.log10(float(ch["frequency"]) / fc)
    lam = c / fc
    offset = -(10 * np.log10(lam**2 * float(ch["transmit_power"]) * c / (32 * np.pi**2))
               + 2 * gain + 10 * np.log10(tau_eff) + psi)
    z_er, z_et = float(config["transceiver_impedance"]), _interp(cal, "impedance", fc)
    n_sec = int(config["sectors"])
    dr = float(ch["sample_interval"]) * c / 2.0
    shift = c * float(ch["pulse_duration"]) / 4
    nz = np.flatnonzero(tx != 0)
    return {"tx": tx, "norm": norm, "zeros": int(nz[0]) if nz.size else len(tx),
            "dr": dr, "shift": shift, "k0": max(int(np.floor(shift / max(dr, 1e-30))) + 1, 0),
            "alpha": _absorption(fc, env, c), "offset": offset, "tau_eff": tau_eff,
            "z_coef": n_sec / 8.0 * (abs(z_er + z_et) / z_er) ** 2 / z_et}


def _bf16_parts(v):
    hi = v.to(torch.bfloat16)
    return hi.float(), (v - hi.double()).to(torch.bfloat16).float()


def _compress_bf16x3(lanes, tx, block=16):
    """y [n, R] of complex128 ``lanes`` [n, R] by three bfloat16 products
    with float32 sums: each real product ``a b`` as ``lo(a) hi(b) + hi(a)
    lo(b) + hi(a) hi(b)``, one float32 matmul of the exact bf16 parts."""
    n, R = lanes.shape
    L = tx.shape[0]
    tr, ti = _bf16_parts(tx.real), _bf16_parts(tx.imag)
    # y = (xr tr + xi ti) + i (xi tr - xr ti), each product split in three
    h_re = torch.cat([tr[0], tr[1], tr[0], ti[0], ti[1], ti[0]])
    h_im = torch.cat([-ti[0], -ti[1], -ti[0], tr[0], tr[1], tr[0]])
    H = torch.stack([h_re, h_im], dim=1)  # [6L, 2]
    out = torch.empty((n, R), dtype=torch.complex128, device=lanes.device)
    for lo in range(0, n, block):
        x = torch.nn.functional.pad(lanes[lo:lo + block], (0, L - 1))
        xr, xi = _bf16_parts(x.real), _bf16_parts(x.imag)

        def win(a):
            return a.unfold(1, L, 1)  # [b, R, L]: a[n + k]

        X = torch.cat([win(xr[1]), win(xr[0]), win(xr[0]),
                       win(xi[1]), win(xi[0]), win(xi[0])], dim=2)
        Y = torch.matmul(X, H).double()
        out[lo:lo + block] = torch.complex(Y[..., 0], Y[..., 1])
    return out


def _compress(x, t, dtype, mf):
    """Pulse compression of one channel's [P, R, B] complex samples
    (complex128 on the device) by replica terms ``t``: [P, R, B]."""
    P, R, B = x.shape
    lanes = x.permute(0, 2, 1).reshape(P * B, R)
    tx = torch.from_numpy(t["tx"]).to(x.device)
    if mf == "bf16x3":
        y = _compress_bf16x3(lanes, tx)
    else:
        if dtype != torch.float64:
            def bf(v):
                return torch.complex(v.real.to(torch.bfloat16).float(),
                                     v.imag.to(torch.bfloat16).float())

            lanes, tx = bf(lanes), bf(tx)
        N = 1 << int(np.ceil(np.log2(R + tx.shape[0] - 1)))
        y = torch.fft.ifft(torch.fft.fft(lanes, N) * torch.conj(torch.fft.fft(tx, N)))[:, :R]
        y = y.to(torch.complex128)
    if t["zeros"]:
        y[:, R - t["zeros"]:] = 0
    return y.reshape(P, B, R).permute(0, 2, 1) / t["norm"]


def _sv_rows(x, t, dtype, mf):
    """Sv [P, R] in ``dtype`` (NaN where no sample of Sv) and its mask."""
    y = _compress(x, t, dtype, mf)
    mean = y.mean(dim=2)
    prx = (mean.real**2 + mean.imag**2) * t["z_coef"]
    R = x.shape[1]
    k = torch.arange(R, dtype=torch.float64, device=x.device)
    valid = (k >= t["k0"])[None, :] & (prx > 0)
    r_tvg = k * t["dr"] - t["shift"]
    r_safe = torch.where(r_tvg > 0, r_tvg, 1.0).to(dtype)
    sv = (10 * torch.log10(torch.where(prx > 0, prx, 1.0).to(dtype))
          + 20 * torch.log10(r_safe)[None, :] + (2 * t["alpha"] * r_tvg).to(dtype)[None, :]
          + torch.tensor(t["offset"], dtype=dtype, device=x.device))
    return torch.where(valid, sv, torch.full((), float("nan"), dtype=dtype, device=x.device)), valid


def sv_samples(config, truth, ch_index, dtype=torch.float64, device="cpu", mf="fft64"):
    """Sv [P, R] float64 of channel ``ch_index`` of one file (NaN where the
    sample has no Sv)."""
    ch = config["channels"][ch_index]
    x = torch.from_numpy(np.ascontiguousarray(truth["complex"][ch_index])).to(device)
    terms = channel_terms(config, ch, truth["filters"][ch["channel_id"]])
    sv, _ = _sv_rows(x.to(torch.complex128), terms, dtype, mf)
    return sv.double().cpu().numpy()


def _bin_onehot(pos32, edges32, n_r):
    ids = torch.searchsorted(edges32, pos32, right=True) - 1
    inside = (ids >= 0) & (ids < n_r)
    m = torch.zeros((pos32.shape[0], n_r), dtype=torch.float64, device=pos32.device)
    rows = torch.nonzero(inside).squeeze(1)
    m[rows, ids[rows]] = 1.0
    return m


def survey_mvbs(config, made, range_bin_m, ping_bin_s, dtype=torch.float64, device="cpu",
                mf="fft64"):
    """MVBS [C, n_x, n_r] of the survey over ``made`` ([(path, truth)]),
    with its ping-time edges (int64 ns) and range edges (m), channels in
    the order the files sort them; one (channel, file) block at a time."""
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    order = sorted(range(len(config["channels"])),
                   key=lambda i: config["channels"][i]["channel_id"])
    filters = made[0][1]["filters"]  # one set of filters for the survey
    terms = [channel_terms(config, config["channels"][i],
                           filters[config["channels"][i]["channel_id"]]) for i in order]
    R = int(config["samples_per_ping"])
    bin_ns = int(ping_bin_s) * 1_000_000_000
    t_all = np.concatenate([tr["ping_time_ns"] for _, tr in made])
    start, n_x, _ = ping_bins(t_all, bin_ns)
    r_max = max(t["dr"] for t in terms) * (R - 1)
    edges = np.arange(0, r_max + range_bin_m, range_bin_m)
    n_r = len(edges) - 1
    edges32 = torch.from_numpy(edges.astype("f4")).to(device)
    sums = torch.zeros((len(order), n_x, n_r), dtype=torch.float64, device=device)
    counts = torch.zeros_like(sums)
    lane = torch.arange(R, dtype=torch.float32, device=device)
    for _, tr in made:
        x_ids = torch.from_numpy((tr["ping_time_ns"] - start) // bin_ns).to(device)
        for c, (i, t) in enumerate(zip(order, terms)):
            x = torch.from_numpy(np.ascontiguousarray(tr["complex"][i])).to(device)
            sv, valid = _sv_rows(x.to(torch.complex128), t, dtype, mf)
            lin = torch.where(valid, torch.pow(10.0, sv / 10), 0)
            onehot = _bin_onehot(lane * np.float32(t["dr"]), edges32, n_r)
            if dtype == torch.float64:
                s = lin @ onehot
            else:
                s = (lin.float() @ onehot.float()).double()
            sums[c].index_add_(0, x_ids, s)
            counts[c].index_add_(0, x_ids, valid.double() @ onehot)
            del x, sv, valid, lin
    s, n = sums.cpu().numpy(), counts.cpu().numpy()
    with np.errstate(invalid="ignore", divide="ignore"):
        mvbs = np.where(n > 0, 10 * np.log10(s / np.maximum(n, 1)), np.nan)
    ping_edges = start + bin_ns * np.arange(n_x + 1, dtype="i8")
    return {"Sv": mvbs, "ping_time": ping_edges[:-1], "echo_range": edges[:-1],
            "channel": [config["channels"][i]["channel_id"] for i in order]}
