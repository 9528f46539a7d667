"""Rolling-window noise statistics for ``clean``: the device programs.

Counterpart of ``echopype_tpu/ops/windows.py`` (XLA programs there, no
Pallas kernel; plain PyTorch here).  The public names and arguments are the
JAX package's, plus ``device=`` ("cuda" by default, "cpu" for the tests);
inputs are host arrays or tensors, outputs tensors on ``device``.

* Pooled nanmean (the transient mask): linear Sv and its valid counts sum
  over a depth window, then over a ping window.  Each stage is a float32
  matmul against a 0/1 band with TF32 off (:func:`_run_sums`), blocked into
  T-centre tiles with a halo where the window extent is known, so every
  output is the sum of exactly its members: a quiet sample after loud ones
  keeps its precision.  Membership comes from the host in float64 as
  integer runs (:func:`grid_window_members`), or, for a non-monotone grid,
  from float32 value bands with the JAX package's 4-ulp inclusive margin
  (:func:`_win_tol`).  A depth grid that varies by ping takes the JAX
  package's float64 path (:func:`pool_sv_nanmean_host_exact`), its per-row
  searches and prefix-sum differences on the device in exact float64
  (:func:`pool_sv_nanmean_exact_device`, bit-identical).
* Depth-bin down/up-sampling (the impulse mask): bin sums by a one-hot
  matmul on a shared grid, by an accumulating ``index_put_`` of each sample
  into its (channel, ping, bin) id otherwise; the upsampled value is the
  bin's own, gathered back.
* Block medians (the attenuated-signal mask): by sorting, counting the
  finite values and averaging the two middle ones (:func:`_nanmedian`), as
  numpy and JAX do; ``torch.nanmedian`` returns the lower middle value and
  ``torch.quantile`` refuses inputs past 2^24 elements.

The JAX package's own prefix-sum programs (``pool_sv_nanmean_device``,
``downsample_upsample_depth_device``) take window sums as differences of a
float32 cumsum; the port sums each window's members directly (ROADMAP
Queue 3).  :data:`LAUNCHES` counts the calls of each public program that
ran on a CUDA device.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..device import no_tf32, resolve_device

__all__ = [
    "LAUNCHES",
    "attenuated_ping_mask_grid_device",
    "downsample_upsample_depth_device",
    "downsample_upsample_grid_device",
    "grid_window_halo",
    "grid_window_members",
    "impulse_mask_grid_device",
    "impulse_mask_grid_packed",
    "pack_mask_device",
    "pool_sv_nanmean_device",
    "pool_sv_nanmean_exact_device",
    "pool_sv_nanmean_grid_device",
    "pool_sv_nanmean_grid_idx_device",
    "pool_sv_nanmean_host_exact",
    "reset_launches",
    "transient_mask_grid_device",
    "transient_mask_grid_idx_device",
    "transient_mask_grid_idx_packed",
    "transient_mask_grid_packed",
]

LAUNCHES = {
    "pool_sv_nanmean": 0,
    "pool_sv_nanmean_exact": 0,
    "transient_mask": 0,
    "downsample_upsample": 0,
    "impulse_mask": 0,
    "attenuated_mask": 0,
}

_EPS32 = float(np.finfo(np.float32).eps)
_TILE = 128
_BAND_ELEMS = 1 << 27  # rows of one blocked band product: ~0.5 GB of tiles


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _count(name, t):
    if t.is_cuda:
        LAUNCHES[name] += 1


def _on(a, dev, dtype=torch.float32):
    if isinstance(a, torch.Tensor):
        return a.to(dev, dtype)
    return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype).to(dev)


def _matmul(a, b):
    """float32 matmul with TF32 off for this call."""
    with no_tf32():
        return torch.matmul(a, b)


def _lin_cnt(sv):
    """Linear Sv with NaN -> 0, and the valid-sample indicator."""
    nan = torch.isnan(sv)
    return torch.where(nan, 0.0, torch.pow(10.0, sv / 10.0)), (~nan).to(sv.dtype)


def _pooled_db(sw, nw):
    return torch.where(nw > 0, 10.0 * torch.log10(sw / torch.clamp_min(nw, 1.0)), torch.nan)


def _win_tol(center, depth_bin):
    """The JAX package's inclusive window margin for float32 depth compares:
    4 ulp of ``|center| + depth_bin`` (members exactly on ``d +- depth_bin``
    of a round-number grid stay members)."""
    return 4.0 * _EPS32 * (center.abs() + depth_bin)


# --------------------------------------------------------------- band sums
def _run_sums(x, attr, lo, hi, halo):
    """Window sums along the last axis.

    out[c, m, n] = sum of x[c, m, j] over the sources j with
    lo[c, n] <= attr[c, j] <= hi[c, n].  x [C, M, N] float32 without NaN;
    attr, lo, hi [Ca, N] float32 with Ca = C or 1 (NaN: no member).  With
    ``halo`` (an int) every member lies within ``halo`` positions of its
    centre, and the band is blocked: T-centre tiles against T + 2*halo
    sources; ``halo=None`` takes the dense [N, N] band.  Each output is a
    float32 matmul of x against 0/1 with TF32 off.
    """
    C, M, N = x.shape
    Ca = attr.shape[0]
    if halo is None or 2 * halo >= N:
        band = (attr[:, :, None] >= lo[:, None, :]) & (attr[:, :, None] <= hi[:, None, :])
        return _matmul(x, band.to(x.dtype))
    T = min(_TILE, N)
    nT = -(-N // T)
    K = T + 2 * halo
    tail = nT * T - N

    def centres(a):
        return F.pad(a, (0, tail), value=float("nan")).reshape(Ca, nT, T)

    src = F.pad(attr, (halo, tail + halo), value=float("nan")).unfold(-1, K, T)  # [Ca, nT, K]
    band = ((src[..., :, None] >= centres(lo)[..., None, :])
            & (src[..., :, None] <= centres(hi)[..., None, :])).to(x.dtype)
    band = band.expand(C, nT, K, T)
    rows = max(1, _BAND_ELEMS // max(1, C * nT * K))
    out = []
    for m0 in range(0, M, rows):
        xt = F.pad(x[:, m0 : m0 + rows], (halo, tail + halo)).unfold(-1, K, T)  # [C, m, nT, K]
        y = _matmul(xt.transpose(1, 2), band)  # [C, nT, m, T]
        out.append(y.transpose(1, 2).reshape(C, -1, nT * T)[..., :N])
    return out[0] if len(out) == 1 else torch.cat(out, dim=1)


def _ping_window_sums(x, W: int):
    """Sums over |p' - p| <= W along axis 1 of x [C, P, K] (pings outside
    [0, P) contribute nothing)."""
    C, P, K = x.shape
    p = torch.arange(P, dtype=x.dtype, device=x.device)[None, :]
    out = _run_sums(x.transpose(1, 2), p, p - W, p + W, W)  # [C, K, P]
    return out.transpose(1, 2)


def _pool_windows(sv, attr, lo, hi, W: int, halo):
    """(sw, nw) [C, P, R]: linear-Sv sums and valid counts over the depth
    members (``_run_sums`` membership) times the ping window."""
    C, P, R = sv.shape
    lin, cnt = _lin_cnt(sv)
    s_n = _run_sums(torch.cat([lin, cnt], dim=1), attr, lo, hi, halo)  # [C, 2P, R]
    both = _ping_window_sums(torch.cat([s_n[:, :P], s_n[:, P:]], dim=2), W)  # [C, P, 2R]
    return both[..., :R], both[..., R:]


def _ping_validity(P: int, W: int, dev):
    p = torch.arange(P, device=dev)
    return (p - W >= 0) & (p + W <= P)


# ------------------------------------------------------- pooled nanmean
def _pool_grid_idx(sv, gmask, lo, hi, v_r, W, range_halo):
    C, P, R = sv.shape
    dev = sv.device
    gm = gmask[:, None, :]
    sv = torch.where(gm > 0, sv, torch.nan)  # NaN-grid positions join no window
    attr = torch.arange(R, dtype=torch.float32, device=dev).expand(C, R)
    lo_f = lo.to(torch.float32)
    hi_f = hi.to(torch.float32) - 1.0  # [lo, hi) as an inclusive run
    sw, nw = _pool_windows(sv, attr, lo_f, hi_f, W, range_halo or None)
    valid = v_r[:, None, :] & _ping_validity(P, W, dev)[None, :, None]
    return torch.where(valid, _pooled_db(sw, nw), torch.nan)


def pool_sv_nanmean_grid_idx_device(sv, gmask, lo, hi, v_r, num_side_pings: int,
                                    range_halo: int = 0, device="cuda"):
    """Pooled nanmean on a ping-invariant grid with host float64 membership.

    sv f32 [C, P, R]; gmask [C, R] (0 at NaN grid positions); lo/hi int
    [C, R], each centre's member run [lo, hi); v_r bool [C, R] the
    reference's validity (:func:`grid_window_members`); ``range_halo`` the
    run extent (0: dense band).  Output NaN where invalid or the ping window
    leaves [0, P).
    """
    dev = resolve_device(device)
    out = _pool_grid_idx(_on(sv, dev), _on(gmask, dev), _on(lo, dev, torch.int64),
                         _on(hi, dev, torch.int64), _on(v_r, dev, torch.bool),
                         int(num_side_pings), int(range_halo))
    _count("pool_sv_nanmean", out)
    return out


def transient_mask_grid_idx_device(sv, gmask, lo, hi, v_r, num_side_pings: int, threshold,
                                   range_halo: int = 0, device="cuda"):
    """Transient mask on the host-membership path: ``Sv - pooled > threshold``
    (NaN pooled -> False)."""
    dev = resolve_device(device)
    sv = _on(sv, dev)
    pooled = _pool_grid_idx(sv, _on(gmask, dev), _on(lo, dev, torch.int64),
                            _on(hi, dev, torch.int64), _on(v_r, dev, torch.bool),
                            int(num_side_pings), int(range_halo))
    out = (sv - pooled) > float(threshold)
    _count("transient_mask", out)
    return out


def transient_mask_grid_idx_packed(sv, gmask, lo, hi, v_r, num_side_pings: int, threshold,
                                   range_halo: int = 0, device="cuda"):
    """:func:`transient_mask_grid_idx_device`, bit-packed (np.packbits order)."""
    return pack_mask_device(transient_mask_grid_idx_device(
        sv, gmask, lo, hi, v_r, num_side_pings, threshold, range_halo, device=device))


def _pool_grid_values(sv, grid, depth_bin, W, exclude_above, range_halo):
    """Order-free value-band pooling on a ping-invariant float32 grid."""
    C, P, R = sv.shape
    tol = _win_tol(grid, depth_bin)
    sw, nw = _pool_windows(sv, grid, grid - depth_bin - tol, grid + depth_bin + tol, W,
                           range_halo or None)
    fin = grid[~torch.isnan(grid)]
    d_min, d_max = fin.min(), fin.max()
    v_r = ((grid - depth_bin >= d_min - tol) & (grid + depth_bin <= d_max + tol)
           & (grid - depth_bin >= exclude_above - tol))
    valid = v_r[:, None, :] & _ping_validity(P, W, sv.device)[None, :, None]
    return torch.where(valid, _pooled_db(sw, nw), torch.nan)


def pool_sv_nanmean_grid_device(sv, grid, depth_bin, num_side_pings: int, exclude_above,
                                range_halo: int = 0, device="cuda"):
    """Pooled nanmean on a ping-invariant grid [C, R] (any order), window
    members by float32 value bands with the 4-ulp inclusive margin; the
    validity bounds are global across channels.  ``range_halo``:
    :func:`grid_window_halo` (0: dense band)."""
    dev = resolve_device(device)
    out = _pool_grid_values(_on(sv, dev), _on(grid, dev), float(depth_bin),
                            int(num_side_pings), float(exclude_above), int(range_halo))
    _count("pool_sv_nanmean", out)
    return out


def transient_mask_grid_device(sv, grid, depth_bin, num_side_pings: int, exclude_above,
                               threshold, range_halo: int = 0, device="cuda"):
    """Transient mask on the value-band path (NaN pooled -> False)."""
    dev = resolve_device(device)
    sv = _on(sv, dev)
    pooled = _pool_grid_values(sv, _on(grid, dev), float(depth_bin), int(num_side_pings),
                               float(exclude_above), int(range_halo))
    out = (sv - pooled) > float(threshold)
    _count("transient_mask", out)
    return out


def transient_mask_grid_packed(sv, grid, depth_bin, num_side_pings: int, exclude_above,
                               threshold, range_halo: int = 0, device="cuda"):
    """:func:`transient_mask_grid_device`, bit-packed."""
    return pack_mask_device(transient_mask_grid_device(
        sv, grid, depth_bin, num_side_pings, exclude_above, threshold, range_halo,
        device=device))


def _band_sum_rows(x, lo, hi, halo):
    """sum of x[..., j] over lo <= j < hi per element; x, lo, hi [..., R];
    every run within ``halo`` of its centre.  Ping chunks keep the
    [..., R, 2*halo+1] window view small."""
    C, P, R = x.shape
    k = torch.arange(-halo, halo + 1, device=x.device)
    j = torch.arange(R, device=x.device)[:, None] + k[None, :]  # [R, 2h+1]
    rows = max(1, _BAND_ELEMS // max(1, C * R * (2 * halo + 1)))
    out = []
    for p0 in range(0, P, rows):
        win = F.pad(x[:, p0 : p0 + rows], (halo, halo)).unfold(-1, 2 * halo + 1, 1)
        lo_c, hi_c = lo[:, p0 : p0 + rows, :, None], hi[:, p0 : p0 + rows, :, None]
        out.append(torch.where((j >= lo_c) & (j < hi_c), win, 0.0).sum(dim=-1))
    return torch.cat(out, dim=1)


def pool_sv_nanmean_device(sv, depth, depth_bin, num_side_pings: int, exclude_above,
                           device="cuda"):
    """Pooled nanmean for any depth [C, P, R] (each row nondecreasing, NaN
    suffix allowed): every ping of the window is searched against the
    CENTRE ping's depths, as the reference selects members.  Each window's
    members sum directly (the JAX program differences a float32 cumsum)."""
    dev = resolve_device(device)
    sv, depth = _on(sv, dev), _on(depth, dev)
    C, P, R = sv.shape
    W = int(num_side_pings)
    depth_bin = float(depth_bin)
    lin, cnt = _lin_cnt(sv)
    d_search = torch.where(torch.isnan(depth), torch.inf, depth)
    tol = _win_tol(d_search, depth_bin)
    lo_q = (d_search - depth_bin - tol).contiguous()
    hi_q = (d_search + depth_bin + tol).contiguous()
    sw = torch.zeros_like(sv)
    nw = torch.zeros_like(sv)
    pad3 = (0, 0, W, W)
    lin_p, cnt_p = F.pad(lin, pad3), F.pad(cnt, pad3)
    d_p = F.pad(d_search, pad3, value=float("inf"))
    r_ids = torch.arange(R, device=dev)
    for delta in range(2 * W + 1):
        d_s = d_p[:, delta : delta + P].contiguous()
        lo = torch.searchsorted(d_s, lo_q, side="left")
        hi = torch.searchsorted(d_s, hi_q, side="right")
        nonempty = hi > lo
        ext = torch.maximum(torch.where(nonempty, hi - 1 - r_ids, 0),
                            torch.where(nonempty, r_ids - lo, 0))
        halo = int(ext.max().item()) if ext.numel() else 0
        both = _band_sum_rows(torch.cat([lin_p[:, delta : delta + P],
                                         cnt_p[:, delta : delta + P]], dim=0),
                              torch.cat([lo, lo]), torch.cat([hi, hi]), halo)
        sw = sw + both[:C]
        nw = nw + both[C:]
    fin = depth[~torch.isnan(depth)]
    d_min, d_max = fin.min(), fin.max()
    vtol = _win_tol(depth, depth_bin)
    valid = ((depth - depth_bin >= d_min - vtol) & (depth + depth_bin <= d_max + vtol)
             & (depth - depth_bin >= float(exclude_above) - vtol)
             & _ping_validity(P, W, dev)[None, :, None])
    out = torch.where(valid, _pooled_db(sw, nw), torch.nan)
    _count("pool_sv_nanmean", out)
    return out


# ------------------------------------------------- depth down/up-sampling
def _down_db(sums, counts):
    return torch.where(counts > 0, 10.0 * torch.log10(sums / torch.clamp_min(counts, 1.0)),
                       torch.nan)


def _down_up_grid(sv, bin_idx_grid, n_bins):
    C, P, R = sv.shape
    lin, cnt = _lin_cnt(sv)
    onehot = (bin_idx_grid[:, :, None]
              == torch.arange(n_bins, device=sv.device)[None, None, :]).to(sv.dtype)
    s_n = _matmul(torch.cat([lin, cnt], dim=1), onehot)  # [C, 2P, B]
    down = _down_db(s_n[:, :P], s_n[:, P:])
    up = torch.gather(down, 2, bin_idx_grid[:, None, :].expand(C, P, R))
    return down, up


def downsample_upsample_grid_device(sv, bin_idx_grid, n_bins: int, device="cuda"):
    """Depth-bin linear mean and its per-sample broadcast-back on a
    ping-invariant grid: bin_idx_grid int [C, R].  Returns (down [C, P,
    n_bins] dB, up [C, P, R] dB)."""
    dev = resolve_device(device)
    down, up = _down_up_grid(_on(sv, dev), _on(bin_idx_grid, dev, torch.int64), int(n_bins))
    _count("downsample_upsample", up)
    return down, up


def downsample_upsample_depth_device(sv, bin_idx, n_bins: int, device="cuda"):
    """Depth-bin linear mean and broadcast-back for a per-ping bin index
    [C, P, R] (int, in [0, n_bins)): each sample adds into its own (channel,
    ping, bin) by an accumulating ``index_put_``."""
    dev = resolve_device(device)
    sv = _on(sv, dev)
    bin_idx = _on(bin_idx, dev, torch.int64)
    n_bins = int(n_bins)
    C, P, R = sv.shape
    lin, cnt = _lin_cnt(sv)
    rows = torch.arange(C * P, device=dev).view(C, P, 1) * n_bins
    flat = (rows + bin_idx).reshape(-1)
    sums = sv.new_zeros(C * P * n_bins).index_put_((flat,), lin.reshape(-1), accumulate=True)
    counts = sv.new_zeros(C * P * n_bins).index_put_((flat,), cnt.reshape(-1), accumulate=True)
    down = _down_db(sums.view(C, P, n_bins), counts.view(C, P, n_bins))
    up = torch.gather(down, 2, bin_idx)
    _count("downsample_upsample", up)
    return down, up


# ------------------------------------------------------------ impulse mask
def impulse_mask_grid_device(sv, bin_idx_grid, n_bins: int, num_side_pings: int, threshold,
                             device="cuda"):
    """Impulse mask on a ping-invariant grid: the upsampled Sv against the
    pings ``num_side_pings`` before and after; lags outside the array and
    NaN differences count as +inf.  Needs P > num_side_pings."""
    dev = resolve_device(device)
    _, up = _down_up_grid(_on(sv, dev), _on(bin_idx_grid, dev, torch.int64), int(n_bins))
    C, P, R = up.shape
    m = int(num_side_pings)
    inf_pad = torch.full((C, m, R), torch.inf, dtype=up.dtype, device=dev)
    fwd = torch.cat([up[:, : P - m] - up[:, m:], inf_pad], dim=1)
    bwd = torch.cat([inf_pad, up[:, m:] - up[:, : P - m]], dim=1)
    fwd = torch.where(torch.isnan(fwd), torch.inf, fwd)
    bwd = torch.where(torch.isnan(bwd), torch.inf, bwd)
    thr = float(threshold)
    out = (fwd > thr) & (bwd > thr)
    _count("impulse_mask", out)
    return out


def impulse_mask_grid_packed(sv, bin_idx_grid, n_bins: int, num_side_pings: int, threshold,
                             device="cuda"):
    """:func:`impulse_mask_grid_device`, bit-packed."""
    return pack_mask_device(impulse_mask_grid_device(sv, bin_idx_grid, n_bins, num_side_pings,
                                                     threshold, device=device))


def pack_mask_device(m):
    """bool [..., R] -> uint8 [..., ceil(R / 8)] in np.packbits order, on
    m's device (a tensor) or the CPU; unpack with ``np.unpackbits(packed,
    axis=-1, count=R)``."""
    m = m if isinstance(m, torch.Tensor) else torch.as_tensor(np.asarray(m, dtype=bool))
    pad = (-m.shape[-1]) % 8
    mb = F.pad(m.to(torch.uint8), (0, pad)).reshape(*m.shape[:-1], -1, 8)
    w = torch.tensor([128, 64, 32, 16, 8, 4, 2, 1], dtype=torch.uint8, device=m.device)
    return (mb * w).sum(dim=-1, dtype=torch.uint8)


# -------------------------------------------------------- attenuated mask
def _nanmedian(x, dim=-1):
    """numpy's nanmedian along ``dim``: sort (NaN last), count the non-NaN
    values, average the two middle ones; NaN where none."""
    s, _ = torch.sort(x, dim=dim)
    n = (~torch.isnan(x)).sum(dim=dim, keepdim=True)
    lo = torch.clamp_min((n - 1) // 2, 0)
    hi = n // 2
    last = x.shape[dim] - 1
    a = torch.gather(s, dim, lo.clamp_max(last))
    b = torch.gather(s, dim, hi.clamp_max(last))
    med = torch.where(lo == hi, a, (a + b) / 2.0)
    return torch.where(n > 0, med, torch.nan).squeeze(dim)


def attenuated_ping_mask_grid_device(sv, start_idx, widths, s_max: int, num_side_pings: int,
                                     threshold, chunk: int = 256, device="cuda"):
    """Per-ping attenuated-signal flags on a ping-invariant grid.

    sv f32 [C, P, R]; start_idx / widths int [C]: each channel's layer slab
    [start, start + width) (width <= s_max).  A ping is flagged when its
    slab median is more than ``threshold`` dB under the median of the block
    of pings p-W .. p+W-1; pings whose block leaves [0, P) and all-NaN
    slabs stay False.  Block medians run ``chunk`` pings at a time.
    Returns bool [C, P].
    """
    dev = resolve_device(device)
    sv = _on(sv, dev)
    start_idx = _on(start_idx, dev, torch.int64)
    widths = _on(widths, dev, torch.int64)
    C, P, R = sv.shape
    W, s_max = int(num_side_pings), int(s_max)
    lin = torch.pow(10.0, sv / 10.0)
    cols = torch.arange(s_max, device=dev)
    idx = (start_idx[:, None] + cols[None, :])[:, None, :].expand(C, P, s_max)
    slab = torch.gather(F.pad(lin, (0, s_max), value=float("nan")), 2, idx)
    slab = torch.where((cols[None, :] < widths[:, None])[:, None, :], slab, torch.nan)
    ping_med = 10.0 * torch.log10(_nanmedian(slab))  # [C, P]

    block_med = torch.full((C, P), torch.nan, device=dev)
    if W > 0:
        padded = F.pad(slab, (0, 0, W, W), value=float("nan"))  # ping p - W at row p
        blocks = padded.unfold(1, 2 * W, 1)  # [C, P + 1, s_max, 2W]
        for p0 in range(0, P, chunk):
            win = blocks[:, p0 : min(p0 + chunk, P)]
            block_med[:, p0 : p0 + win.shape[1]] = _nanmedian(win.reshape(C, win.shape[1], -1))
        block_med = 10.0 * torch.log10(block_med)
    p = torch.arange(P, device=dev)
    valid = (p - W >= 0) & (p + W <= P - 1)
    out = ((ping_med - block_med) < float(threshold)) & valid[None, :]
    _count("attenuated_mask", out)
    return out


# ------------------------------------------------------------ host helpers
def grid_window_members(grid, depth_bin, exclude_above):
    """Host float64 window membership for a ping-invariant grid.

    Returns ``(lo, hi, v_r, halo)``: lo/hi int32 [C, R] each centre's member
    run [lo, hi) (0, 0 at NaN centres; runs may span interior NaN positions,
    which the programs zero out), v_r bool [C, R] the reference's validity
    (global min/max across channels, exclude_above), halo the power-of-two
    run extent; or ``None`` when a finite row is not nondecreasing (the
    float32 value-band path then).  The JAX package's, unchanged.
    """
    g2 = np.atleast_2d(np.asarray(grid, dtype="f8"))
    C, R = g2.shape
    lo = np.zeros((C, R), dtype="i4")
    hi = np.zeros((C, R), dtype="i4")
    extent = 0
    for c in range(C):
        row = g2[c]
        raw = np.nonzero(np.isfinite(row))[0]
        fin = row[raw]
        if fin.size and (np.diff(fin) < 0).any():
            return None
        if not fin.size:
            continue
        l_f = np.searchsorted(fin, fin - float(depth_bin), side="left")
        h_f = np.searchsorted(fin, fin + float(depth_bin), side="right")
        lo[c, raw] = raw[l_f]
        hi[c, raw] = raw[h_f - 1] + 1
        extent = max(
            extent,
            int((raw[h_f - 1] - raw).max()),
            int((raw - raw[l_f]).max()),
        )
    halo = int(2 ** np.ceil(np.log2(extent + 1))) if extent else 0
    d_min = np.nanmin(g2) if np.isfinite(g2).any() else np.nan
    d_max = np.nanmax(g2) if np.isfinite(g2).any() else np.nan
    with np.errstate(invalid="ignore"):
        v_r = (
            (g2 - float(depth_bin) >= d_min)
            & (g2 + float(depth_bin) <= d_max)
            & (g2 - float(depth_bin) >= float(exclude_above))
        )
    return lo, hi, v_r, halo


def grid_window_halo(grid, depth_bin) -> int:
    """Range-window extent in raw samples for a ping-invariant grid, with the
    programs' 4-ulp inclusive margin, rounded up to a power of two; 0 (the
    dense band) when a channel's finite values are not nondecreasing.  The
    JAX package's, unchanged."""
    g2 = np.atleast_2d(np.asarray(grid, dtype="f8"))
    extent = 0
    for row in g2:
        raw_idx = np.nonzero(np.isfinite(row))[0]
        finite = row[raw_idx]
        if finite.size < 2:
            continue
        if (np.diff(finite) < 0).any():
            return 0
        tol = 4.0 * np.finfo(np.float32).eps * (np.abs(finite) + float(depth_bin))
        hi = np.searchsorted(finite, finite + float(depth_bin) + tol, side="right")
        lo = np.searchsorted(finite, finite - float(depth_bin) - tol, side="left")
        extent = max(
            extent,
            int((raw_idx[hi - 1] - raw_idx).max()),
            int((raw_idx - raw_idx[lo]).max()),
        )
    if extent == 0:
        return 0
    return int(2 ** np.ceil(np.log2(extent + 1)))


def _exact_rows_ok(depth):
    """Every row finite and nondecreasing: the cumsum-difference branch of
    :func:`pool_sv_nanmean_host_exact` for every (centre, member) row pair."""
    return bool(np.isfinite(depth).all() and (np.diff(depth, axis=2) >= 0).all())


def pool_sv_nanmean_exact_device(sv, depth, depth_bin, num_side_pings: int, exclude_above,
                                 device="cuda"):
    """:func:`pool_sv_nanmean_host_exact`, bit for bit, with its per-row work
    on ``device`` in float64.

    The host makes linear Sv and the row prefix sums in numpy (the reference's
    arithmetic and summation order); the device searches each member row
    for the centre row's window, gathers the two prefix sums and adds the
    differences into each centre in the host loop's member order, all exact
    float64 operations; the host takes the log.  Needs every depth row
    finite and nondecreasing (:func:`_exact_rows_ok`); ``pool_Sv_nanmean``
    sends other grids to the host function.
    """
    dev = resolve_device(device)
    sv = np.asarray(sv, dtype="f8")
    depth = np.asarray(depth, dtype="f8")
    C, P, R = sv.shape
    W = int(num_side_pings)
    bin_f = float(depth_bin)
    lin = np.where(np.isnan(sv), 0.0, 10.0 ** (sv / 10.0))

    def ping_major(a):  # [C, P, X] -> [P, C, X]: a ping range is one contiguous block
        return torch.from_numpy(np.ascontiguousarray(np.moveaxis(a, 1, 0))).to(dev)

    zeros = np.zeros((C, P, 1))
    cs = [ping_major(np.concatenate([zeros, np.cumsum(v, axis=2)], axis=2))
          for v in (lin, (~np.isnan(sv)).astype("f8"))]  # linear and count prefix sums
    d = ping_major(depth)
    lo_q, hi_q = d - bin_f, d + bin_f
    sums = [torch.zeros((P, C, R), dtype=torch.float64, device=dev) for _ in cs]
    p0, p1 = W, P - W  # centres of the reference's validity: p - W >= 0, p + W <= P
    for delta in range(-W, W + 1):  # the host loop's member order
        a, b = max(p0, -delta), min(p1, P - 1 - delta)
        if a > b:
            continue
        rows = d[a + delta : b + 1 + delta].reshape(-1, R)
        lo, hi = (torch.searchsorted(rows, q[a : b + 1].reshape(-1, R), side=side)
                  .view(b + 1 - a, C, R) for q, side in ((lo_q, "left"), (hi_q, "right")))
        for acc, c in zip(sums, cs):
            src = c[a + delta : b + 1 + delta]
            acc[a : b + 1] += torch.gather(src, 2, hi) - torch.gather(src, 2, lo)
    sw, nw = (np.moveaxis(acc.cpu().numpy(), 0, 1) for acc in sums)
    out = np.full((C, P, R), np.nan)
    d_min, d_max = np.nanmin(depth), np.nanmax(depth)
    if p1 >= p0:
        dv = depth[:, p0 : p1 + 1]
        with np.errstate(divide="ignore", invalid="ignore"):
            valid = ((dv - bin_f >= d_min) & (dv + bin_f <= d_max)
                     & (dv - bin_f >= float(exclude_above)))
            s, n = sw[:, p0 : p1 + 1], nw[:, p0 : p1 + 1]
            pooled = np.where(n > 0, 10.0 * np.log10(s / np.maximum(n, 1.0)), np.nan)
        out[:, p0 : p1 + 1] = np.where(valid, pooled, np.nan)
    _count("pool_sv_nanmean_exact", d)
    return out


def pool_sv_nanmean_host_exact(sv, depth, depth_bin, num_side_pings: int, exclude_above):
    """Pooled nanmean for a depth grid that varies by ping, on the host in
    float64 with the reference's membership (every ping of the window
    against the centre ping's depths).  The JAX package's, unchanged."""
    sv = np.asarray(sv, dtype="f8")
    depth = np.asarray(depth, dtype="f8")
    C, P, R = sv.shape
    W = int(num_side_pings)
    lin = np.where(np.isnan(sv), 0.0, 10.0 ** (sv / 10.0))
    cnt = (~np.isnan(sv)).astype("f8")
    lin_cs = np.concatenate([np.zeros((C, P, 1)), np.cumsum(lin, axis=2)], axis=2)
    cnt_cs = np.concatenate([np.zeros((C, P, 1)), np.cumsum(cnt, axis=2)], axis=2)
    out = np.full((C, P, R), np.nan)
    d_min = np.nanmin(depth)
    d_max = np.nanmax(depth)
    bin_f = float(depth_bin)
    for c in range(C):
        rows_sorted = [
            bool(np.all(np.diff(depth[c, p][np.isfinite(depth[c, p])]) >= 0))
            for p in range(P)
        ]
        for p in range(W, P):
            if p + W > P:
                continue
            d0 = depth[c, p]
            lo_q = d0 - bin_f
            hi_q = d0 + bin_f
            with np.errstate(invalid="ignore"):
                valid = (lo_q >= d_min) & (d0 + bin_f <= d_max) & (lo_q >= float(exclude_above))
            sw = np.zeros(R)
            nw = np.zeros(R)
            for pp in range(max(0, p - W), min(P, p + W + 1)):
                drow = depth[c, pp]
                if rows_sorted[pp] and not np.isnan(drow).any():
                    lo = np.searchsorted(drow, lo_q, side="left")
                    hi = np.searchsorted(drow, hi_q, side="right")
                    sw += lin_cs[c, pp][hi] - lin_cs[c, pp][lo]
                    nw += cnt_cs[c, pp][hi] - cnt_cs[c, pp][lo]
                else:
                    with np.errstate(invalid="ignore"):
                        m = (drow[None, :] >= lo_q[:, None]) & (drow[None, :] <= hi_q[:, None])
                    sw += m @ lin[c, pp]
                    nw += m @ cnt[c, pp]
            with np.errstate(divide="ignore", invalid="ignore"):
                pooled = np.where(nw > 0, 10.0 * np.log10(sw / np.maximum(nw, 1.0)), np.nan)
            out[c, p] = np.where(valid, pooled, np.nan)
    return out
