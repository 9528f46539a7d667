"""Echoview-style shoal detector with candidate linking.

Capability parity: echopype/mask/shoal_detection/shoal_echoview.py:7 (echopy):
threshold -> drop small candidates -> link components within a search box ->
drop small linked shoals.

Component extents come from labeled min/max reductions (one C pass each,
no per-label full-image scans); linking is a union-find over slice-local
bounding-box neighbourhoods, so total work is O(n_pixels + sum of
search-box areas), not O(n_label * n_pixels).
"""

from __future__ import annotations

import numpy as np
from scipy import ndimage as ndi

from ...xrlite import DataArray
from .shoal_weill import component_extent_filter

__all__ = ["shoal_echoview"]


def _nearest_idx(grid: np.ndarray, vals: np.ndarray) -> np.ndarray:
    """Vectorized argmin(|grid - v|), keeping the first-minimum
    (lower-index) tie-break of np.argmin.

    Sorted grids (the norm for idim/jdim edge vectors) use searchsorted;
    unsorted grids fall back to a broadcast argmin, which keeps np.argmin's
    exact behavior."""
    vals = np.asarray(vals, dtype="f8")
    if len(grid) > 1 and not np.all(grid[1:] >= grid[:-1]):
        return np.argmin(np.abs(grid[None, :] - vals[:, None]), axis=1).astype(int)
    pos = np.searchsorted(grid, vals)
    lo = np.clip(pos - 1, 0, len(grid) - 1)
    hi = np.clip(pos, 0, len(grid) - 1)
    pick_hi = np.abs(grid[hi] - vals) < np.abs(grid[lo] - vals)
    return np.where(pick_hi, hi, lo).astype(int)


def _component_boxes(labeled: np.ndarray):
    """Per-label inclusive bbox (i0, i1, j0, j1), vectorized C reductions."""
    lab_max = int(labeled.max())
    index = np.arange(1, lab_max + 1)
    rows = np.broadcast_to(np.arange(labeled.shape[0])[:, None], labeled.shape)
    cols = np.broadcast_to(np.arange(labeled.shape[1])[None, :], labeled.shape)
    i0 = ndi.minimum(rows, labels=labeled, index=index).astype(int)
    i1 = ndi.maximum(rows, labels=labeled, index=index).astype(int)
    j0 = ndi.minimum(cols, labels=labeled, index=index).astype(int)
    j1 = ndi.maximum(cols, labels=labeled, index=index).astype(int)
    return i0, i1, j0, j1


class _UnionFind:
    def __init__(self, n):
        self.parent = np.arange(n)

    def find(self, a):
        p = self.parent
        root = a
        while p[root] != root:
            root = p[root]
        while p[a] != root:
            p[a], a = root, p[a]
        return root

    def union(self, a, b):
        ra, rb = self.find(a), self.find(b)
        if ra != rb:
            # keep the smaller root (matches the reference's min-label merge)
            if ra < rb:
                self.parent[rb] = ra
            else:
                self.parent[ra] = rb


def shoal_echoview(
    ds,
    var_name: str = "Sv",
    channel: str = None,
    idim: np.ndarray = None,
    jdim: np.ndarray = None,
    thr: float = -70.0,
    mincan=(3.0, 10.0),
    maxlink=(3.0, 15.0),
    minsho=(3.0, 15.0),
) -> DataArray:
    if var_name not in ds:
        raise ValueError(f"Variable '{var_name}' not found in dataset")
    var = ds[var_name]
    if "channel" in var.dims:
        if channel is None:
            raise ValueError("Please specify channel for multi-channel data")
        var = var.sel(channel=channel)

    sv = np.asarray(var.transpose("range_sample", "ping_time").values, dtype="f8")
    n_range, n_ping = sv.shape
    if idim is None:
        idim = np.arange(n_range + 1, dtype="f8")
    if jdim is None:
        jdim = np.arange(n_ping + 1, dtype="f8")
    idim, jdim = np.asarray(idim, dtype="f8"), np.asarray(jdim, dtype="f8")
    if np.isnan(idim).any() or np.isnan(jdim).any():
        raise ValueError("idim and jdim must not contain NaN")

    mask = sv > thr

    # 2. remove candidates smaller than mincan (vectorized extent filter in
    #    physical units from the idim/jdim edge vectors)
    labeled = ndi.label(mask, np.ones((3, 3)))[0]
    if labeled.max():
        mask = component_extent_filter(
            mask, labeled, mincan[0], mincan[1], idim=idim, jdim=jdim
        )

    # 3. link components with PIXELS inside another's expanded bbox.
    #    Vectorized: expanded windows for all labels at once, a
    #    blocked broadcasted bbox-interval test proposes candidate pairs
    #    (O(n_label^2) bools in bounded blocks), and only candidates get the
    #    exact pixel-in-window check — work is O(n_label^2 / 64 + pixels of
    #    candidate pairs) instead of a per-label full-subimage np.unique.
    labeled = ndi.label(mask, np.ones((3, 3)))[0]
    lab_max = int(labeled.max())
    if lab_max:
        i0, i1, j0, j1 = _component_boxes(labeled)
        i00 = _nearest_idx(idim, idim[i0] - (maxlink[0] + 1))
        i11 = _nearest_idx(idim, idim[i1] + (maxlink[0] + 1)) + 1
        j00 = _nearest_idx(jdim, jdim[j0] - (maxlink[1] + 1))
        j11 = _nearest_idx(jdim, jdim[j1] + (maxlink[1] + 1)) + 1

        # per-label pixel lists (one stable argsort of the label image)
        flat = labeled.ravel()
        order = np.argsort(flat, kind="stable")
        sorted_labs = flat[order]
        starts = np.searchsorted(sorted_labs, np.arange(1, lab_max + 2))
        px_r = order // labeled.shape[1]
        px_c = order % labeled.shape[1]

        uf = _UnionFind(lab_max + 1)
        block = max(1, min(lab_max, 2**22 // max(lab_max, 1)))
        for a_lo in range(0, lab_max, block):
            a_hi = min(a_lo + block, lab_max)
            # candidate pairs: B's bbox intersects A's expanded window
            cand = (
                (i0[None, :] < i11[a_lo:a_hi, None])
                & (i1[None, :] >= i00[a_lo:a_hi, None])
                & (j0[None, :] < j11[a_lo:a_hi, None])
                & (j1[None, :] >= j00[a_lo:a_hi, None])
            )
            np.fill_diagonal(cand[:, a_lo:a_hi], False)
            for ak, bk in zip(*np.nonzero(cand)):
                a = a_lo + ak  # 0-based label ids
                if uf.find(a + 1) == uf.find(bk + 1):
                    continue
                rb = px_r[starts[bk] : starts[bk + 1]]
                cb = px_c[starts[bk] : starts[bk + 1]]
                hit = (
                    (rb >= i00[a]) & (rb < i11[a]) & (cb >= j00[a]) & (cb < j11[a])
                ).any()
                if hit:
                    uf.union(a + 1, bk + 1)
        roots = np.array([uf.find(lab) for lab in range(lab_max + 1)])
        linked = roots[labeled]

        # 4. remove linked shoals smaller than minsho
        mask = component_extent_filter(
            mask, linked, minsho[0], minsho[1], idim=idim, jdim=jdim
        )

    out = DataArray(
        mask.T.astype(bool),
        ("ping_time", "range_sample"),
        coords={
            "ping_time": ds.coords["ping_time"],
            "range_sample": ds.coords["range_sample"],
        },
        attrs={"description": f"Shoal mask using Echoview algorithm on {var_name}"},
        name="shoal_mask",
    )
    return out
