"""Plain reference for the frequency-differenced EK60 survey: masked MVBS from the writer's truth.

Imports neither JAX nor anything of the measured package; Sv comes from
``ek60.py``'s functions as they are (float64, the power indices, ping times
and sound speeds the writer drew).  The criterion is echopype's
``mask.frequency_differencing(freqABEq="<fA>kHz - <fB>kHz <op> <x>dB")``
followed by ``apply_mask`` on every channel: per (ping, sample) the sample
is kept iff ``Sv[fA] - Sv[fB] <op> x``; a NaN difference fails, and a
sample that fails joins no bin on any channel.  Bins follow the survey
streamer's chunk rule, as ``ek60.survey_mvbs`` does: each chunk's range
bins from its first ping's ``dr``, every sample's Sv from its own ping's.

**Boundary samples.**  The program decides the mask in float32, so a sample
whose float64 difference lies within ``eps`` of the threshold may go
either way.  :func:`eps_db` bounds the float32 error of the program's
``Sv_A - Sv_B`` (``parallel/pipeline.py::_sv_chunk``: ``((P + 20 log10 r)
+ 2 alpha r) + offset`` in float32, ``r = k dr - shift``), in units of
``u = 2**-24``, summed over both channels:

* ``P``: the index times float32 ``10 log10(2) / 256``, two roundings:
  ``2 u |P|``;
* ``r``: ``dr`` and ``shift`` rounded to float32, ``k dr`` and the
  subtraction rounded: relative ``rho = u ((2k + 2) / (k - 2) + 1)``, at
  most ``9 u`` (``k = 3``, the first sample past the TVG shift);
* ``20 log10 r``: ``log10f`` within 2 ulp (CUDA's documented bound; ulp
  ``<= 2 u |y|``), the product by 20 one rounding, and ``r``'s error
  through ``20 / ln 10``: ``5 u |L| + 8.686 rho``;
* ``2 alpha r``: alpha is the file's float32, so ``|A| (rho + u)``;
* the offset rounded to float32: ``u |O|``;
* three additions, each within ``u`` of a partial sum no larger than
  ``M = |P| + |L| + |A| + |O|``: ``3 u M``;
* the difference itself: ``u |x|`` at the threshold.

Each magnitude is taken at its largest over the traffic (the power index
range, the farthest sample at the fastest sound speed); ``rho`` at its
largest, ``9 u``.  For ``ek60_5freq_freqdiff`` at 120 - 38 kHz that is
3,495 to 3,507 ``u``, 2.08e-4 to 2.09e-4 dB by the drawn sound speeds.  The judge (:func:`boundary_readings`)
accepts a bin holding boundary samples iff some choice of keeping or
dropping them gives a reference MVBS within the limit, and holds every
other bin to the limit directly.

``dtype`` is the precision of the per-sample arithmetic: float64 for the
reference; ``torch.bfloat16`` makes the lower-precision control (Sv, the
difference, the comparison and the linear values in bfloat16, per-ping
bin sums in float32, TF32 off), which decides every sample itself.
"""

from __future__ import annotations

import numpy as np
import torch

from .ek60 import (_bin_onehot, _binned, _ping_terms, _sv_rows, _to_db, channel_constants,
                   ping_bins)

__all__ = ["U", "boundary_readings", "criterion", "eps_db", "survey_mvbs"]

U = 2.0**-24
#: the most boundary samples one group of bins may hold: 2**12 choices
MAX_ENUMERATED = 12

_OPS = {">=": torch.ge, "<=": torch.le, ">": torch.gt, "<": torch.lt}


def criterion(config, eq):
    """``"120kHz - 38kHz > 6dB"`` -> (channel index A, channel index B,
    operator, threshold dB) over the configuration's channels."""
    op = next(o for o in _OPS if o in eq)  # the two-letter operators first
    lhs, rhs = eq.split(op)
    fa, fb = (float(f.strip().removesuffix("kHz")) * 1e3 for f in lhs.split("-"))
    freqs = [float(ch["frequency"]) for ch in config["channels"]]
    return freqs.index(fa), freqs.index(fb), op, float(rhs.strip().removesuffix("dB"))


def eps_db(config, made, ia, ib, diff):
    """The bound on the program's float32 ``Sv_A - Sv_B`` error (dB), as
    the module's docstring derives it."""
    k = channel_constants(config)
    R = made[0][1]["power"].shape[2]
    c = np.concatenate([tr["sound_speed"] for _, tr in made])
    dr, shift, offset = _ping_terms(k, np.asarray([c.min(), c.max()], dtype="f4"))
    r_max = float(np.max((R - 1) * dr - shift))
    lo, hi = config["power_index_range"]
    p = max(abs(lo), abs(hi)) * 10.0 * np.log10(2.0) / 256.0
    # 20 log10 r from the first valid sample (r = dr, k = 3) to the farthest
    L = 20.0 * max(abs(np.log10(r_max)), abs(np.log10(dr.min())))
    rho = 9.0 * U
    total = U * abs(diff)
    for ch in (ia, ib):
        a = 2.0 * float(k["absorption_coefficient"][ch]) * r_max
        o = float(np.abs(offset[ch]).max())
        total += (2 * U * p + 5 * U * L + 20.0 / np.log(10.0) * rho + a * (rho + U)
                  + U * o + 3 * U * (p + L + a + o))
    return float(total)


def survey_mvbs(config, made, range_bin_m, ping_bin_s, chunk_pings, eq, dtype=torch.float64,
                device="cpu"):
    """The masked survey MVBS [C, n_x, n_r] over ``made`` ([(path, truth)])
    with its grid, as ``ek60.survey_mvbs`` returns it.  In float64 the
    boundary samples join no bin; they are returned apart for
    :func:`boundary_readings`: ``sums`` and ``counts`` [C, n_x, n_r]
    without them, and ``boundary`` {"x" [B] ping bins, "j" [B, C] range bins
    (-1 outside), "lin" [B, C] linear Sv (0 where not valid), "valid" [B, C]}."""
    torch.backends.cuda.matmul.allow_tf32 = False
    k = channel_constants(config)
    ia, ib, op, diff = criterion(config, eq)
    exact = dtype == torch.float64
    eps = eps_db(config, made, ia, ib, diff) if exact else 0.0
    C = len(k["channel_id"])
    R = made[0][1]["power"].shape[2]
    bin_ns = int(ping_bin_s) * 1_000_000_000
    start, n_x, _ = ping_bins(np.concatenate([tr["ping_time_ns"] for _, tr in made]), bin_ns)
    terms = [_ping_terms(k, tr["sound_speed"]) for _, tr in made]
    r_max = max(float(dr.max()) * (R - 1) for dr, _, _ in terms)
    n_r = len(np.arange(0, r_max + range_bin_m, range_bin_m)) - 1
    edges = range_bin_m * np.arange(n_r + 1, dtype="f8")
    edges32 = torch.from_numpy(edges.astype("f4")).to(device)
    sums = torch.zeros((C, n_x, n_r), dtype=torch.float64, device=device)
    counts = torch.zeros_like(sums)
    lane = torch.arange(R, dtype=torch.float32, device=device)
    edge = {"x": [], "j": [], "lin": [], "valid": []}
    for (_, tr), (dr, shift, offset) in zip(made, terms):
        x = torch.from_numpy((tr["ping_time_ns"] - start) // bin_ns).to(device)
        P = tr["power"].shape[1]
        for lo in range(0, P, chunk_pings):
            sl = slice(lo, min(lo + chunk_pings, P))
            rows = [_sv_rows(tr["power"][c, sl], dr[c, sl], shift[c, sl],
                             np.full(sl.stop - lo, k["absorption_coefficient"][c]),
                             offset[c, sl], dtype, device) for c in range(C)]
            sv = torch.stack([s for s, _ in rows])
            valid = torch.stack([v for _, v in rows])
            d = sv[ia] - sv[ib]
            keep = _OPS[op](d, diff)  # NaN -> False
            near = (torch.isfinite(d) & ((d.double() - diff).abs() <= eps) if exact
                    else torch.zeros_like(keep))
            take = valid & (keep & ~near)[None]
            lin = torch.where(valid, torch.pow(10.0, sv / 10), 0)
            grid = [lane * np.float32(dr[c, lo]) for c in range(C)]
            for c in range(C):
                s, n = _binned(torch.where(take[c], lin[c], 0), take[c],
                               _bin_onehot(grid[c], edges32, n_r), dtype)
                sums[c].index_add_(0, x[sl], s)
                counts[c].index_add_(0, x[sl], n)
            if near.any():
                p, q = torch.nonzero(near, as_tuple=True)
                edge["x"].append(x[sl][p].cpu().numpy())
                edge["j"].append(torch.stack(
                    [torch.searchsorted(edges32, grid[c][q], right=True) - 1 for c in range(C)],
                    dim=1).cpu().numpy())
                edge["lin"].append(lin[:, p, q].T.double().cpu().numpy())
                edge["valid"].append(valid[:, p, q].T.cpu().numpy())
    s_np, n_np = sums.cpu().numpy(), counts.cpu().numpy()
    ping_edges = start + bin_ns * np.arange(n_x + 1, dtype="i8")
    boundary = {key: (np.concatenate(v) if v else np.zeros((0,) if key == "x" else (0, C)))
                for key, v in edge.items()}
    boundary["j"] = boundary["j"].astype("i8")
    boundary["valid"] = boundary["valid"].astype(bool)
    return {"Sv": _to_db(s_np, n_np), "ping_time": ping_edges[:-1], "echo_range": edges[:-1],
            "channel": k["channel_id"], "sums": s_np, "counts": n_np, "boundary": boundary,
            "eps_db": eps}


def _groups(boundary, n_r):
    """Boundary samples joined where they share a bin: [(sample indices,
    [(c, x, j)] their bins)]."""
    cells = []
    for b in range(len(boundary["x"])):
        cells.append([(c, int(boundary["x"][b]), int(j))
                      for c, j in enumerate(boundary["j"][b])
                      if boundary["valid"][b, c] and 0 <= j < n_r])
    parent = list(range(len(cells)))

    def root(i):
        while parent[i] != i:
            parent[i] = parent[parent[i]]
            i = parent[i]
        return i

    owner = {}
    for b, cs in enumerate(cells):
        for cell in cs:
            if cell in owner:
                parent[root(b)] = root(owner[cell])
            else:
                owner[cell] = b
    out = {}
    for b in range(len(cells)):
        out.setdefault(root(b), []).append(b)
    return [(bs, sorted({cell for b in bs for cell in cells[b]})) for bs in out.values()]


def boundary_readings(got_sv, ref, limit):
    """The program's masked MVBS against the reference under the boundary
    rule: {"max_db": the widest gap over bins holding no boundary sample
    and finite on both sides, "nan_mismatch": those bins NaN on one side,
    "boundary_samples", "boundary_bins": bins holding one, "unmatched":
    those of them for which no choice of the boundary samples' decisions
    gives a reference MVBS within ``limit`` dB with the same NaN mask (a
    group of more than ``MAX_ENUMERATED`` samples counts whole)}."""
    got = np.asarray(got_sv, dtype="f8")
    want, bnd = ref["Sv"], ref["boundary"]
    B = len(bnd["x"])
    if got.shape != want.shape:
        return {"max_db": float("inf"), "nan_mismatch": float(max(got.size, want.size, 1)),
                "boundary_samples": B, "boundary_bins": 0, "unmatched": 0}
    groups = _groups(bnd, want.shape[2])
    touched = np.zeros(want.shape, dtype=bool)
    unmatched = 0
    for bs, cells in groups:
        if not cells:  # outside every bin: moves nothing
            continue
        idx = tuple(np.asarray(cells).T)
        touched[idx] = True
        if len(bs) > MAX_ENUMERATED:
            unmatched += len(cells)
            continue
        at = {cell: i for i, cell in enumerate(cells)}
        lin = np.zeros((len(bs), len(cells)))
        one = np.zeros_like(lin)
        for r, b in enumerate(bs):
            for c, j in enumerate(bnd["j"][b]):
                cell = (c, int(bnd["x"][b]), int(j))
                if cell in at and bnd["valid"][b, c]:
                    lin[r, at[cell]], one[r, at[cell]] = bnd["lin"][b, c], 1.0
        # every choice: bit r of row i keeps boundary sample bs[r]
        choice = ((np.arange(2 ** len(bs))[:, None] >> np.arange(len(bs))) & 1).astype("f8")
        mvbs = _to_db(ref["sums"][idx] + choice @ lin, ref["counts"][idx] + choice @ one)
        g = got[idx][None, :]
        same_nan = np.isnan(mvbs) == np.isnan(g)
        with np.errstate(invalid="ignore"):
            close = np.isnan(mvbs) | (np.abs(mvbs - g) <= limit)
        if not (same_nan & close).all(axis=1).any():
            unmatched += len(cells)
    a, b = got.copy(), want.copy()
    a[touched] = b[touched] = np.nan
    both = np.isfinite(a) & np.isfinite(b)
    return {"max_db": float(np.max(np.abs(a[both] - b[both]))) if both.any() else float("inf"),
            "nan_mismatch": int(np.count_nonzero(np.isnan(a) != np.isnan(b))),
            "boundary_samples": B, "boundary_bins": int(touched.sum()), "unmatched": unmatched}
