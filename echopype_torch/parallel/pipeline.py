"""Survey device steps: power -> Sv -> bin partials, on one device or a mesh.

Counterpart of ``echopype_tpu/parallel/pipeline.py``:

* the raw->MVBS survey's window step: ``sv_mvbs_window_partials_uniform``
  (per-channel uniform ``dr``, the instrument norm, K1) and
  ``sv_mvbs_window_partials`` (``dr`` varying by ping, or an echo_range
  intercept ``r0``: AZFP's float32 dB power; K2), plus the host helpers
  that fix their bin bounds; their mesh form ``sharded_mvbs_partials_closed``;
* the same step with a frequency-differencing mask fused in,
  ``sv_mvbs_window_partials_freqdiff`` / ``sharded_mvbs_partials_freqdiff``
  (plain torch: its counts depend on the data, so they are summed like the
  values);
* the full survey-processing step ``survey_pipeline_step`` /
  ``sharded_sv_mvbs_step``: float32 dB power -> Sv and its MVBS in one
  pass, on K3 (with Sv) or K4 (MVBS only) for uniform ``dr``, and the plain
  cores ``sv_mvbs_core`` (per-ping ``dr``), ``sv_mvbs_core_mxu``,
  ``sv_mvbs_core_ex60`` and ``sv_mvbs_core_mxu_closed``; the range-sharded
  ``sharded_sv_mvbs_step_3d`` and ``sharded_mvbs_step_closed``;
* the Sv-store streamers' mesh steps ``sharded_binned_*`` over the plain
  torch binning of ``ops/binning.py``.

A mesh (``mesh.py``) is a grid of ``torch.device`` driven from this one
process, as the JAX package drives its mesh.  A ``sharded_*`` step cuts
each operand into the grid's blocks (``channel`` x ``ping`` [x ``range``];
every dimension must divide evenly, as under ``shard_map``), runs each
block on its device, launching every block before reading any result, and
adds the partial sums in shard order on the first device of each channel
block, then joins the channel blocks on ``mesh.devices.flat[0]`` (the
port's ``psum``).  Full-resolution outputs the JAX package leaves
sharded (Sv) are joined there too.  ``mesh=None`` is one block on
``device``.

On the kernels' paths nothing is divided on the device.  The range-bin
sample bounds and the first valid sample ``k0`` come from the host in float32, refined against
exact float32 products (``_refine_bounds`` / ``_refine_k0``), so they are
the ones the JAX package computes, bit for bit.  The window counts of the
uniform path come from the host in closed form (``closed_window_counts_np``)
and the kernel returns sums only.
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import no_tf32, resolve_device
from ..ops import binning
from ..ops.binning import _banded_x_reduce_xb, _prefix_gather_diff
from ..ops.sv_bin_partials import (
    LN10_OVER_10,
    _as_f32,
    _reduce_pings,
    _bin_matrix,
    _host,
    _sv_db,
    core_bounds_np,
    fused_operands,
    mvbs_core_fused,
    ping_bounds_np,
    sv_mvbs_core_fused,
)
from ..ops.window_partials import (
    INDEX2POWER,
    _range_bin_matrix,
    slab_plan,
    window_partials,
    window_partials_uniform,
)
from ..utils.profiling import count
from .mesh import Mesh, check_mesh

__all__ = [
    "LAUNCHES",
    "_prefix_gather_diff",
    "closed_bounds_k0_np",
    "closed_k0_np",
    "closed_window_counts_np",
    "kernel_inputs_from_numpy",
    "sharded_binned_partials",
    "sharded_binned_partials_grid",
    "sharded_binned_row_sum",
    "sharded_binned_sum_raw",
    "sharded_mvbs_partials_closed",
    "sharded_mvbs_partials_freqdiff",
    "sharded_mvbs_step_closed",
    "sharded_sv_mvbs_step",
    "sharded_sv_mvbs_step_3d",
    "survey_pipeline_step",
    "sv_mvbs_core",
    "sv_mvbs_core_ex60",
    "sv_mvbs_core_mxu",
    "sv_mvbs_core_mxu_closed",
    "sv_mvbs_window_partials",
    "sv_mvbs_window_partials_freqdiff",
    "sv_mvbs_window_partials_uniform",
    "sv_mvbs_window_partials_uniform_t",
]

_ONE = np.float32(1.0)
LAUNCHES = {"freqdiff_step": 0}


def _refine_bounds(bounds, dr0, edges):
    """Smallest q with q*dr0 >= edge on the float32 sample grid.

    ``bounds`` is ``ceil(edges / dr0)``; a quotient off by one ULP at an
    exactly integral edge/dr ratio would shift a bin boundary by one sample
    against the sums' own ``k*dr`` grid, so two exact multiplications pin it.
    """
    q = bounds
    q = np.where((q - _ONE) * dr0[:, None] >= edges, q - _ONE, q)
    return np.where(q * dr0[:, None] < edges, q + _ONE, q)


def _refine_k0(k0, dr, shift):
    """Pin k0 (smallest k with k*dr > shift) to the float32 sample grid —
    the same knife edge as :func:`_refine_bounds`, strict inequality."""
    k0 = np.where((k0 - _ONE) * dr > shift, k0 - _ONE, k0)
    k0 = np.where(k0 * dr <= shift, k0 + _ONE, k0)
    return np.maximum(k0, np.float32(0.0))


def closed_k0_np(dr, shift):
    """First sample with ``k*dr > shift``, elementwise, float32."""
    dr = np.asarray(dr, dtype="f4")
    shift = np.asarray(shift, dtype="f4")
    return _refine_k0((np.floor(shift / dr) + _ONE).astype("f4"), dr, shift)


def closed_bounds_k0_np(dr0, sh0, r_edges, R):
    """Range-bin sample bounds [C, n_r+1] (clipped to [0, R]) and k0 [C].

    Float32 host values, bit-identical to the JAX package's device
    refinement and to its ``closed_bounds_k0_np``.  ``r_edges`` is one
    [n_r+1] row of edges for every channel, or [C, n_r+1] per channel (the
    edges less each channel's echo_range intercept, ``edge_off`` of the JAX
    package's ``_closed_s1_n1``).
    """
    dr0 = np.asarray(dr0, dtype="f4")
    edges = np.asarray(r_edges, dtype="f4")
    if edges.ndim == 1:
        edges = edges[None, :]
    q = np.ceil(edges / dr0[:, None]).astype("f4")
    bounds = np.clip(_refine_bounds(q, dr0, edges), np.float32(0.0), np.float32(R))
    return bounds, closed_k0_np(dr0, sh0)


def closed_window_counts_np(bounds, k0, valid_len, x_rel, n_x_window):
    """Exact closed-form per-window-bin counts on host: f8 [C, W, n_r].

    Copied from the JAX package (its module imports jax).  Mirrors the
    device count math (diff of clip(bounds, k0, valid_len) reduced over
    window bins) without materializing [C, P, n_r]: per channel a histogram
    of valid lengths per window bin gives
    S(v) = sum_p min(v, L_p) = v * #{L >= v} + sum_{L < v} L in O(W * R),
    and counts = diff(S at the clamped bounds)."""
    valid_len = np.asarray(valid_len)
    C, P = valid_len.shape
    n_r = bounds.shape[1] - 1
    bl = np.maximum(bounds, k0[:, None])  # [C, n_r+1], integral floats
    ids = np.asarray(x_rel, dtype="i8")
    inb = (ids >= 0) & (ids < n_x_window)
    idc = ids[inb]
    counts = np.zeros((C, n_x_window, n_r), dtype="f8")
    if idc.size == 0:
        return counts
    R = int(valid_len.max(initial=0))
    nv = R + 2
    v_ids = np.arange(nv, dtype="f8")
    nb = None
    for c in range(C):
        Lc_all = valid_len[c, inb]
        u = np.unique(Lc_all)
        if u.size == 1:
            # constant valid length (the instrument norm): counts factor as
            # per-ping bin sizes x pings-per-window-bin
            per_ping = np.diff(np.minimum(bl[c], float(u[0])))  # [n_r]
            if nb is None:
                nb = np.bincount(idc, minlength=n_x_window).astype("f8")
            counts[c] = nb[:, None] * per_ping[None, :]
            continue
        Lc = np.clip(Lc_all.astype("i8"), 0, nv - 1)
        H = np.zeros((n_x_window, nv), dtype="f8")
        np.add.at(H, (idc, Lc), 1.0)
        cnt_ge = np.cumsum(H[:, ::-1], axis=1)[:, ::-1]  # #{L >= v}
        sum_lt = np.concatenate(
            [np.zeros((n_x_window, 1)), np.cumsum(H * v_ids, axis=1)[:, :-1]],
            axis=1,
        )  # sum_{L < v} L
        b = np.clip(bl[c].astype("i8"), 0, nv - 1)  # [n_r+1]
        S = b.astype("f8") * cnt_ge[:, b] + sum_lt[:, b]
        counts[c] = np.diff(S, axis=1)
    return counts


def _edges_and_shift(r_edges, tvg_shift, r0):
    """The range-bin edges and TVG shift the kernels see, float32.

    Without ``r0`` (the EK case) they are ``r_edges`` and ``tvg_shift``.
    With an echo_range intercept ``r0`` [C, P] (AZFP: r = r0 + k dr), as in
    the JAX package's ``_closed_s1_n1``: per-channel edges
    ``edge_off = r_edges - r0[:, 0]`` (ping 0's intercept, the JAX quirk)
    and the per-ping shift ``tvg_shift - r0``, so that ``k dr - shift`` is
    the JAX ``k dr + (r0 - tvg_shift)`` exactly (IEEE negation is exact).
    """
    edges = np.asarray(r_edges, dtype="f4")
    tvg_shift = np.asarray(tvg_shift, dtype="f4")
    if r0 is None:
        return edges, tvg_shift
    r0 = np.asarray(r0, dtype="f4")
    return edges[None, :] - r0[:, :1], tvg_shift - r0



# ------------------------------------------------------------ mesh blocks
_CPR = ("channel", "ping", None)
_CP = ("channel", "ping")
_PING = ("ping",)
_ROW = ("channel", None)


def _resolve_mesh(mesh, device):
    """``mesh`` checked (the port's :class:`Mesh` only), or for None a
    one-block mesh on ``device``."""
    if mesh is None:
        grid = np.empty((1, 1), dtype=object)
        grid[0, 0] = resolve_device(device)
        return Mesh(grid, ("ping", "channel"))
    return check_mesh(mesh)


def _positions(mesh, axes=("ping", "channel")):
    """(index, {axis: position}, device) of every block a step sharded over
    ``axes`` runs, in ``mesh.devices`` order; an axis the step does not
    shard (a 2-axis step on a 3-axis mesh) stays at position 0, since its
    other positions would only repeat the work."""
    for idx in np.ndindex(mesh.devices.shape):
        pos = dict(zip(mesh.axis_names, idx))
        if not any(i and ax not in axes for ax, i in pos.items()):
            yield idx, pos, mesh.devices[idx]


def _block(a, spec, pos, mesh):
    """The block of ``a`` at mesh position ``pos``: dimension d is cut over
    mesh axis ``spec[d]`` (None: whole); ``spec`` None passes ``a`` whole
    (replicated).  Works on numpy arrays and tensors (a view either way)."""
    if spec is None or a is None:
        return a
    index = []
    for dim, ax in enumerate(spec):
        n = mesh.shape.get(ax, 1) if ax else 1
        if n == 1:
            index.append(slice(None))
            continue
        size = a.shape[dim]
        if size % n:
            raise ValueError(f"dimension {dim} of size {size} does not divide over the "
                             f"mesh's {ax!r} axis of {n}")
        k = size // n
        index.append(slice(pos[ax] * k, (pos[ax] + 1) * k))
    return a[tuple(index)]


def _on(a, dev):
    """A host array or tensor as a contiguous tensor on ``dev`` (dtype kept)."""
    if isinstance(a, torch.Tensor):
        return a.to(dev).contiguous()
    return torch.from_numpy(np.ascontiguousarray(a)).to(dev)


def _map_shards(mesh, specs, fn, args, axes=("ping", "channel")):
    """Run ``fn(device, pos, *blocks)`` on every block: {index: outputs}.

    Every block is launched before any result is read (CUDA launches
    return at once; the host copies into each block are synchronous)."""
    parts = {}
    for idx, pos, dev in _positions(mesh, axes):
        out = fn(dev, pos, *[_block(a, s, pos, mesh) for a, s in zip(args, specs)])
        parts[idx] = out if isinstance(out, tuple) else (out,)
    return parts


def _mesh_psum(mesh, parts, i=0):
    """Output ``i`` of the blocks summed over every axis but ``channel``.

    In the partials' dtype (float32 from the kernels' steps, float64 from
    the Sv binning's window sums) and in shard order on the first device
    of each channel block, so reruns are bit-identical; the channel blocks are then joined
    along dimension 0 on ``mesh.devices.flat[0]``.  One block is returned
    as it is."""
    ci = mesh.axis_names.index("channel")
    by_channel = {}
    for idx in sorted(parts):
        t = parts[idx][i]
        c = idx[ci]
        by_channel[c] = t if c not in by_channel else by_channel[c] + t.to(by_channel[c].device)
    dev0 = mesh.devices.flat[0]
    blocks = [by_channel[c].to(dev0) for c in sorted(by_channel)]
    return blocks[0] if len(blocks) == 1 else torch.cat(blocks, dim=0)


def _assemble(mesh, parts, i, spec):
    """Output ``i`` of the blocks joined back along ``spec``'s sharded
    dimensions, on ``mesh.devices.flat[0]`` (inverse of :func:`_block`)."""
    dev0 = mesh.devices.flat[0]

    def join(dim, fixed):
        if dim == len(spec):
            return parts[tuple(fixed.get(ax, 0) for ax in mesh.axis_names)][i].to(dev0)
        ax = spec[dim]
        n = mesh.shape.get(ax, 1) if ax else 1
        if n == 1:
            return join(dim + 1, fixed)
        return torch.cat([join(dim + 1, {**fixed, ax: j}) for j in range(n)], dim=dim)

    return join(0, {})


# ------------------------------------------------- window step operands (K1/K2)
#: how each kernel operand is cut over a mesh (the window plan is made per block)
_KERNEL_SPECS = {"power": _CPR, "dr": _CP, "tvg_shift": _CP, "absorption": _CP,
                 "offset": _CP, "k0": _CP, "valid_len": _CP, "sprd_row": _ROW,
                 "rt2_row": _ROW, "bounds": _ROW}


def _kernel_inputs_np(power, dr, tvg_shift, absorption, offset, valid_len, r_edges, *,
                      uniform, r0=None):
    """Host operands of K1 (``uniform``) or K2 for one chunk, without the
    window plan: numpy arrays keyed by the kernel's argument names, in the
    kernel's dtypes.  Bounds, ``k0`` and K1's rows follow each channel's
    first ping of the chunk."""
    power = np.asarray(power)
    if power.dtype not in (np.int16, np.float32):
        raise TypeError(f"power must be int16 sample indices or float32 dB, got {power.dtype}")
    C, P, R = power.shape
    valid_len = np.asarray(valid_len).astype("i4")
    if valid_len.shape != (C, P) or valid_len.min(initial=0) < 0 or valid_len.max(initial=0) > R:
        raise ValueError("valid_len must be [C, P] within [0, R]")
    dr = np.asarray(dr, dtype="f4")
    r_edges, tvg_shift = _edges_and_shift(r_edges, tvg_shift, r0)
    bounds, k0 = closed_bounds_k0_np(dr[:, 0], tvg_shift[:, 0], r_edges, R)
    ops = {"power": power, "absorption": np.asarray(absorption, dtype="f4"),
           "offset": np.asarray(offset, dtype="f4"), "valid_len": valid_len}
    if uniform:
        bounds = np.clip(bounds, k0[:, None], np.float32(R))
        k = np.arange(R, dtype="f4")[None, :]
        rt = k * dr[:, :1] - tvg_shift[:, :1]  # [C, R] f32
        with np.errstate(divide="ignore"):
            sprd = np.float32(20.0) * np.log10(np.maximum(rt, np.float32(1e-20)))
        ops["sprd_row"] = np.where(k >= k0[:, None], sprd, -np.inf).astype("f4")
        ops["rt2_row"] = np.float32(2.0) * rt
    else:
        ops["dr"] = dr
        ops["tvg_shift"] = tvg_shift
        ops["k0"] = closed_k0_np(dr, tvg_shift).astype("i4")
    ops["bounds"] = bounds.astype("i4")
    return ops


def _window_ops(x_rel, n_x_window):
    """The window ping bounds ``xb`` and the kernels' slab ``plan`` of sorted
    window-relative ids ``x_rel`` (ids at ``n_x_window`` park past it)."""
    xb = np.searchsorted(x_rel, np.arange(n_x_window + 1), side="left").astype("i4")
    return {"xb": xb, "plan": slab_plan(xb)}


def _x_rel_np(x_rel, P):
    x_rel = np.asarray(_host(x_rel))
    if x_rel.shape != (P,) or np.any(np.diff(x_rel) < 0):
        raise ValueError("x_rel must be [P] and non-decreasing")
    return x_rel


def _to_device(ops, dev):
    """The window step's host operands as tensors on ``dev``; their bytes
    count as ``h2d_bytes``."""
    host = {k: np.ascontiguousarray(v) for k, v in ops.items()}
    count("h2d_bytes", sum(v.nbytes for v in host.values()))
    return {k: torch.from_numpy(v).to(dev) for k, v in host.items()}


def kernel_inputs_from_numpy(power, dr, tvg_shift, absorption, offset, valid_len,
                             x_rel, r_edges, n_x_window: int, *, uniform: bool, device,
                             r0=None):
    """Host arrays of one chunk -> the operands of K1 (``uniform``) or K2.

    Takes the arrays the JAX survey streamer hands its device step: power
    [C, P, R] int16 indices (EK) or float32 dB (AZFP, NaN-padded); dr,
    tvg_shift, absorption, offset [C, P]; valid_len [C, P]; x_rel [P] sorted
    window-relative ping-bin ids (padding parked at ``n_x_window``); r_edges
    [n_r+1] metres; optionally the echo_range intercept ``r0`` [C, P]
    (:func:`_edges_and_shift`).  Builds on the host the window ping bounds
    ``xb`` and the kernels' slab ``plan``
    (``ops/window_partials.py::slab_plan``), the range-bin bounds and
    ``k0``, and for K1 the per-channel rows ``sprd_row`` (-inf below k0) and
    ``rt2_row``; returns a dict of tensors on ``device`` keyed by the
    kernel's argument names.  The host-to-device copies are synchronous.
    """
    ops = _kernel_inputs_np(power, dr, tvg_shift, absorption, offset, valid_len, r_edges,
                            uniform=uniform, r0=r0)
    ops.update(_window_ops(_x_rel_np(x_rel, ops["power"].shape[1]), n_x_window))
    return _to_device(ops, device)


def _check_n_r(bounds, n_r):
    if bounds.shape[1] != n_r + 1:
        raise ValueError(f"n_r={n_r} disagrees with {bounds.shape[1]} range edges")


def sharded_mvbs_partials_closed(mesh, n_x_window: int, n_r: int, uniform: bool = False,
                                 with_counts: bool = True, device="cuda"):
    """The raw survey's window step on a mesh: K1 (``uniform``) or K2 per block.

    fn(power, dr, tvg_shift, absorption, offset, valid_len, x_rel, r_edges,
    r0=None) -> (sums, counts) [C, n_x_window, n_r] float32 on
    ``mesh.devices.flat[0]``, summed over the ping shards; with
    ``uniform`` and ``with_counts=False`` sums alone (the survey takes its
    counts from :func:`closed_window_counts_np`; K2 always counts).  The
    arguments are the JAX step's (host arrays; ``r0`` [C, P] only for K2).
    Range bounds, ``k0`` and K1's rows are fixed on the host once for the
    chunk, from each channel's first ping, and each block takes its
    channels' rows; each ping block takes its slice of ``x_rel`` with its
    own window plan (a block of parked pings, or one that misses some
    windows, gets zeros there).  So the sums equal the one-device step's up
    to float32 order, and the counts exactly.  (Under the JAX package's
    ``shard_map`` each block reads its own first ping's ``dr``; with ``dr``
    varying by ping that moves bin edges between the mesh and one device.)
    ``mesh=None`` runs the one block on ``device``.
    """
    mesh = _resolve_mesh(mesh, device)

    def step(power, dr, tvg_shift, absorption, offset, valid_len, x_rel, r_edges, r0=None):
        ops = _kernel_inputs_np(power, dr, tvg_shift, absorption, offset, valid_len, r_edges,
                                uniform=uniform, r0=None if uniform else r0)
        _check_n_r(ops["bounds"], n_r)
        x_rel = _x_rel_np(x_rel, ops["power"].shape[1])
        parts = {}
        for idx, pos, dev in _positions(mesh):
            block = {k: _block(v, _KERNEL_SPECS[k], pos, mesh) for k, v in ops.items()}
            block.update(_window_ops(_block(x_rel, _PING, pos, mesh), n_x_window))
            t = _to_device(block, dev)
            out = (window_partials_uniform(**t, with_counts=with_counts) if uniform
                   else window_partials(**t))
            parts[idx] = out if isinstance(out, tuple) else (out,)
        if uniform and not with_counts:
            return _mesh_psum(mesh, parts)
        return _mesh_psum(mesh, parts, 0), _mesh_psum(mesh, parts, 1)

    return step


def sv_mvbs_window_partials_uniform(
    power, dr, tvg_shift, absorption, offset, valid_len, x_rel, r_edges,
    n_x_window: int, n_r: int, block_g: int = 0, with_counts: bool = True, device="cuda",
):
    """Window partials for per-channel uniform ``dr`` and TVG shift (K1).

    Same arguments as the JAX function (host arrays; int16 or float32 dB
    power, under the rule of ``ops/window_partials.py``).  Returns
    (sums, counts) [C, n_x_window, n_r] float32 tensors on ``device``, or
    sums alone with ``with_counts=False`` (the survey takes its counts from
    :func:`closed_window_counts_np`).  Callers check uniformity.

    ``block_g`` is the JAX package's positional parameter: there a
    ``block_g > 0`` (``ops.binning.choose_block_g`` of the host's bin
    bounds) swapped the TPU's band matmul for exact float32 block sums.
    Here K1, or its plain twin on ``device="cpu"``, runs whatever
    ``block_g`` is: it already sums each range bin on its own over the
    host's bounds, so every value gives the same bits.
    """
    return sharded_mvbs_partials_closed(None, n_x_window, n_r, uniform=True,
                                        with_counts=with_counts, device=device)(
        power, dr, tvg_shift, absorption, offset, valid_len, x_rel, r_edges)


def sv_mvbs_window_partials(
    power, dr, tvg_shift, absorption, offset, valid_len, x_rel, r_edges,
    n_x_window: int, n_r: int, r0=None, device="cuda",
):
    """Window partials with per-ping ``dr`` and TVG shift (K2).

    The JAX function's arguments: int16 power (EK, ``r0`` None) or float32
    dB power with the echo_range intercept ``r0`` [C, P] (AZFP).  Range
    bins follow each channel's first-ping ``dr`` and ``r0`` as in the JAX
    function.  Returns (sums, counts) [C, n_x_window, n_r] float32 tensors
    on ``device``.
    """
    return sharded_mvbs_partials_closed(None, n_x_window, n_r, device=device)(
        power, dr, tvg_shift, absorption, offset, valid_len, x_rel, r_edges, r0)


# ------------------------------------------------------ frequency differencing
_CMP = {
    ">": torch.gt,
    "<": torch.lt,
    ">=": torch.ge,
    "<=": torch.le,
    "==": torch.eq,
}


def _sv_chunk(power_db, dr, tvg_shift, absorption, offset, r0=None, first_sample=0):
    """Sv [C, P, R] of float32 dB power on the sample grid ``k dr`` (plus the
    echo_range intercept ``r0``), NaN where ``r_tvg <= 0``: the XLA steps'
    formula.  ``k`` starts at ``first_sample`` (a range block's offset)."""
    lane = torch.arange(power_db.shape[2], device=power_db.device).to(torch.float32)
    if first_sample:
        lane = lane + float(first_sample)
    if r0 is None:
        r_tvg = lane * dr[:, :, None] - tvg_shift[:, :, None]
    else:
        r_tvg = lane * dr[:, :, None] + (r0 - tvg_shift)[:, :, None]
    pos = r_tvg > 0
    return torch.where(
        pos,
        power_db + 20.0 * torch.log10(torch.where(pos, r_tvg, 1.0))
        + 2.0 * absorption[:, :, None] * r_tvg + offset[:, :, None],
        torch.nan,
    )


def sharded_mvbs_partials_freqdiff(mesh, window: int, n_r: int, ia: int, ib: int, op: str,
                                   device="cuda"):
    """Masked-MVBS window partials on a mesh of ping shards.

    fn(power, dr, tvg_shift, absorption, offset, valid_len, x_rel, r_edges,
    r0, diff_db) -> (sums, counts) [C, window, n_r]; per sample the mask is
    ``Sv[ia] - Sv[ib] <op> diff_db`` (NaN -> False, the reference's
    frequency_differencing applied to every channel as apply_mask does) and
    a masked sample joins no bin.  The mask reads two channels per sample,
    so the channels stay whole on each device: a ``channel`` axis other
    than 1 raises ``ValueError``, as in the JAX package.  power [C, P, R]
    int16 indices (samples past ``valid_len`` are NaN) or float dB; ``r0``
    [C, P] the echo_range intercept of AZFP, None for EK.  The range-bin
    sample bounds come from the host once for the chunk
    (:func:`closed_bounds_k0_np` on each channel's first-ping ``dr``); per
    block sums and the data-dependent counts reduce by one float32 matmul
    against the 0/1 bin matrix with TF32 off, then over the ping window.
    ``mesh=None`` runs one block on ``device``.
    """
    mesh = _resolve_mesh(mesh, device)
    if mesh.shape.get("channel", 1) != 1:
        raise ValueError(
            "freq_diff-masked survey streaming needs channel mesh axis 1 "
            "(the mask compares two channels per sample)"
        )

    def shard(dev, pos, power, dr, tvg_shift, absorption, offset, valid_len, x_rel, r0, bounds,
              diff_db):
        def on(a, dtype=torch.float32):
            # a blocking copy converts on the host: ``dtype``'s bytes cross, as h2d_bytes
            host = torch.from_numpy(np.ascontiguousarray(a))
            count("h2d_bytes", host.numel() * dtype.itemsize)
            return host.to(dev, dtype)

        R = power.shape[2]
        lane = torch.arange(R, device=dev)
        if power.dtype.kind in "iu":
            pw = torch.where(lane < on(valid_len, torch.int64)[:, :, None],
                             on(power, torch.int16).to(torch.float32) * INDEX2POWER, torch.nan)
        else:
            pw = on(power)
        sv = _sv_chunk(pw, on(dr), on(tvg_shift), on(absorption), on(offset),
                       None if r0 is None else on(r0))
        keep = _CMP[op](sv[ia] - sv[ib], float(diff_db))  # [P, R]; NaN -> False
        ok = ~torch.isnan(sv) & keep[None]
        lin = torch.where(ok, torch.pow(10.0, sv / 10.0), 0.0)
        m = _range_bin_matrix(on(bounds, torch.int64), R)
        x_rel = on(x_rel, torch.int64)
        xb = torch.searchsorted(x_rel, torch.arange(window + 1, device=dev), side="left")
        P = power.shape[1]
        with no_tf32():
            s1 = torch.bmm(torch.cat([lin, ok.to(torch.float32)], dim=1), m)  # [C, 2P, n_r]
            both = _banded_x_reduce_xb(torch.cat([s1[:, :P], s1[:, P:]], dim=2), xb)
        if dev.type == "cuda":
            LAUNCHES["freqdiff_step"] += 1
        return both[:, :, :n_r], both[:, :, n_r:]

    def step(power, dr, tvg_shift, absorption, offset, valid_len, x_rel, r_edges, r0, diff_db):
        power = np.asarray(power)
        dr = np.asarray(dr, dtype="f4")
        edges, _ = _edges_and_shift(r_edges, tvg_shift, r0)
        bounds, _ = closed_bounds_k0_np(dr[:, 0], np.asarray(tvg_shift, dtype="f4")[:, 0],
                                        edges, power.shape[2])
        _check_n_r(bounds, n_r)
        parts = _map_shards(mesh, (_CPR, _CP, _CP, _CP, _CP, _CP, _PING, _CP, None, None), shard,
                            (power, dr, tvg_shift, absorption, offset, valid_len, x_rel, r0,
                             bounds, diff_db))
        return _mesh_psum(mesh, parts, 0), _mesh_psum(mesh, parts, 1)

    return step


def sv_mvbs_window_partials_freqdiff(
    power, dr, tvg_shift, absorption, offset, valid_len, x_rel, r_edges,
    n_x_window: int, n_r: int, ia: int, ib: int, op: str, diff_db, r0=None, device="cuda",
):
    """Window partials of Sv masked by frequency differencing, on one device.

    Counterpart of the JAX function (an XLA program); the arguments and
    rule of :func:`sharded_mvbs_partials_freqdiff`, whose one block this
    is.  Returns (sums, counts) [C, n_x_window, n_r] float32 tensors on
    ``device``.
    """
    return sharded_mvbs_partials_freqdiff(None, n_x_window, n_r, ia, ib, op, device=device)(
        power, dr, tvg_shift, absorption, offset, valid_len, x_rel, r_edges, r0, diff_db)


# ---------------------------------------------- full survey-processing step
def _ping_sums(s1, n1, xb):
    xb = xb.long()[None, :, None].expand(s1.shape[0], xb.shape[0], s1.shape[2])
    return _prefix_gather_diff(s1, xb, 1), _prefix_gather_diff(n1, xb, 1)


def _ping_bounds_on(x_idx, n_x, dev):
    return torch.from_numpy(ping_bounds_np(_host(x_idx), n_x)).to(dev)


def sv_mvbs_core(power, dr, tvg_shift, absorption, offset, x_idx, r_edges, n_x, n_r,
                 device="cuda"):
    """Single-shard fused pipeline for per-ping ``dr``: power -> Sv -> partials.

    Plain torch, as the JAX package runs it in XLA: per-ping range-bin
    bounds ``ceil(r_edges / dr)`` on the device, range and ping sums by
    cumsum-gather-diff.  x_idx: sorted int [P] ping-bin ids (-1 = outside);
    r_edges: f32 [n_r + 1] left-closed range-bin edges.  Returns (Sv
    [C, P, R], sums [C, n_x, n_r], counts) float32 tensors on ``device``.
    """
    ops, xb = fused_operands(power, dr, tvg_shift, absorption, offset, x_idx, r_edges, n_x,
                             n_r, device)
    ops.pop("bounds")  # the host's first-ping bounds; this core bins each ping by its own dr
    sv = _sv_db(**ops)
    edges = _as_f32(r_edges, sv.device)
    rb = torch.clamp(torch.ceil(edges[None, None, :] / ops["dr"][:, :, None]), 0, sv.shape[2])
    ok = ~torch.isnan(sv)
    lin = torch.where(ok, torch.pow(10.0, sv / 10.0), 0.0)
    s1 = _prefix_gather_diff(lin, rb, 2)
    n1 = _prefix_gather_diff(ok.to(torch.float32), rb, 2)
    return (sv, *_ping_sums(s1, n1, xb))


def sv_mvbs_core_mxu(power, dr, tvg_shift, absorption, offset, x_idx, r_edges, n_x, n_r,
                     device="cuda"):
    """The fused pipeline for per-channel-constant ``dr``, in plain torch.

    The reference K3 and K4 are held to (``sv_mvbs_core_mxu`` in the JAX
    package): range-bin sums as a batched matmul against each channel's 0/1
    band matrix built from ``dr[:, 0]`` (host bounds, :func:`core_bounds_np`),
    ping sums by cumsum-gather-diff.  Same arguments and returns as
    :func:`sv_mvbs_core`.
    """
    ops, xb = fused_operands(power, dr, tvg_shift, absorption, offset, x_idx, r_edges, n_x,
                             n_r, device)
    bounds = ops.pop("bounds")
    sv = _sv_db(**ops)
    m = _bin_matrix(bounds, sv.shape[2])
    ok = ~torch.isnan(sv)
    lin = torch.where(ok, torch.pow(10.0, sv / 10.0), 0.0)
    return (sv, *_ping_sums(torch.bmm(lin, m), torch.bmm(ok.to(torch.float32), m), xb))


def sv_mvbs_core_ex60(power, dr, absorption, offset, x_idx, r_edges, n_x, n_r,
                      shift_samples: int = 2, device="cuda"):
    """The fused pipeline for an integer-sample TVG shift (Ex60 hardware).

    Plain torch, the JAX function's formula: with ``r_tvg = (k - n) dr`` the
    spreading term factors into ``20 log10(k - n)`` (one [R] row) plus
    ``20 log10(dr)`` ([C, P] scalars), and the linear value is one
    ``exp(Sv ln10/10)`` a sample.  Range bins from each channel's first-ping
    ``dr`` (host bounds, :func:`core_bounds_np`), ping sums by
    cumsum-gather-diff.  Returns (Sv [C, P, R], sums, counts
    [C, n_x, n_r]) float32 tensors on ``device``.
    """
    dev = resolve_device(device)
    pw, dr_t, ab, off = (_as_f32(a, dev) for a in (power, dr, absorption, offset))
    R = pw.shape[2]
    k_shift = torch.arange(R, dtype=torch.float32, device=dev)[None, None, :] - float(
        shift_samples)
    valid_k = k_shift > 0
    spread_row = 20.0 * torch.log10(torch.where(valid_k, k_shift, 1.0))
    spread_cp = 20.0 * torch.log10(dr_t)
    sv = torch.where(
        valid_k,
        pw + spread_row + (spread_cp + off)[:, :, None] + (2.0 * ab * dr_t)[:, :, None] * k_shift,
        torch.nan,
    )
    m = _bin_matrix(torch.from_numpy(core_bounds_np(_host(dr)[:, 0], _host(r_edges), R)).to(dev),
                    R)
    ok = ~torch.isnan(sv)
    lin = torch.where(ok, torch.exp(sv * LN10_OVER_10), 0.0)
    with no_tf32():
        s1, n1 = torch.bmm(lin, m), torch.bmm(ok.to(torch.float32), m)
    return (sv, *_ping_sums(s1, n1, _ping_bounds_on(x_idx, n_x, dev)))


def _closed_s1_n1(power, dr, tvg_shift, absorption, offset, valid_len, r_edges, r0, dev):
    """Per-ping range-bin sums of linear Sv and exact closed-form counts
    [C, P, n_r] (the JAX package's ``_closed_s1_n1``).

    The bin bounds (each channel's first-ping ``dr``, edges less its
    intercept ``r0``) and each ping's first valid sample ``k0`` come from
    the host (:func:`closed_bounds_k0_np`, :func:`closed_k0_np`): no float32
    division on the device.  Counts are ``diff(clip(bounds, k0,
    valid_len))``; int16 power is masked by ``valid_len``, float dB power
    carries NaN padding.
    """
    power = np.asarray(_host(power))
    R = power.shape[2]
    dr = np.asarray(_host(dr), dtype="f4")
    tvg_shift = np.asarray(_host(tvg_shift), dtype="f4")
    r0 = None if r0 is None else np.asarray(_host(r0), dtype="f4")
    edges, shift_eff = _edges_and_shift(_host(r_edges), tvg_shift, r0)
    bounds, _ = closed_bounds_k0_np(dr[:, 0], shift_eff[:, 0], edges, R)

    def on(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    int_power = power.dtype.kind in "iu"
    pw = on(power).to(torch.float32)
    sv = _sv_chunk(pw * INDEX2POWER if int_power else pw, on(dr), on(tvg_shift),
                   _as_f32(absorption, dev), _as_f32(offset, dev), None if r0 is None else on(r0))
    lin = torch.where(torch.isnan(sv), 0.0, torch.pow(10.0, sv / 10.0))
    vl = on(np.asarray(_host(valid_len), dtype="f4"))
    if int_power:  # integer input has no NaN padding: mask the invalid sample tail
        lin = torch.where(torch.arange(R, device=dev) < vl[:, :, None], lin, 0.0)
    b = on(bounds)
    with no_tf32():
        s1 = torch.bmm(lin, _bin_matrix(b.long(), R))
    k0 = on(closed_k0_np(dr, shift_eff))
    n1 = torch.diff(torch.clamp(b[:, None, :], min=k0[:, :, None], max=vl[:, :, None]), dim=2)
    return s1, n1


def _window_sums(s1, n1, x_idx, n_x, dev):
    """Ping-bin sums of per-ping partials [C, P, n_r]: an independent float32
    sum per ping bin (``_banded_x_reduce_xb``), as the port's fused cores take
    them.  The JAX package's cumsum-gather-diff here loses a quiet bin
    after loud pings at the survey's depth: its error moved MVBS by up to
    8.6e-4 dB between a mesh and one device at 5 x 5,000 x 4,000."""
    with no_tf32():
        return _reduce_pings(s1, n1, _ping_bounds_on(x_idx, n_x, dev), s1.shape[2])


def sv_mvbs_core_mxu_closed(
    power, dr, tvg_shift, absorption, offset, valid_len, x_idx, r_edges, n_x, n_r,
    r0=None, device="cuda",
):
    """MVBS-only core with closed-form counts (plain torch).

    echo_range is affine in the sample index, ``r = r0 + k dr`` (``r0``
    [C, P] None for EK), and each ping's valid samples form the run
    ``[k0, valid_len)``, so a bin's count is that run's overlap with the
    bin's sample bounds: no counts matmul.  NaNs may appear only as suffix
    padding beyond ``valid_len`` (use :func:`sv_mvbs_core_mxu` for interior
    NaN masking).  The ping axis reduces by :func:`_window_sums`.  Returns
    (sums, counts) [C, n_x, n_r] float32 tensors on ``device``.
    """
    dev = resolve_device(device)
    s1, n1 = _closed_s1_n1(power, dr, tvg_shift, absorption, offset, valid_len, r_edges, r0,
                           dev)
    if s1.shape[2] != n_r:
        raise ValueError(f"n_r={n_r} disagrees with {s1.shape[2] + 1} range edges")
    return _window_sums(s1, n1, x_idx, n_x, dev)


def sv_mvbs_window_partials_uniform_t(
    powerT, dr, tvg_shift, absorption, offset, valid_len, x_rel, r_edges,
    n_x_window: int, n_r: int, device="cuda",
):
    """Ping-minor twin of :func:`sv_mvbs_window_partials_uniform` (plain torch).

    powerT [C, R, P]: the ping axis last.  The JAX package keeps its
    version as the record of a layout experiment (equal speed on its
    hardware) with a parity test, and wires it into no streamer; so does
    the port.  Same math and contract as the uniform window step (``r0 =
    0``, per-channel constant ``dr`` / shift, host bounds and ``k0``):
    returns (sums, counts) [C, n_x_window, n_r] float32 tensors on
    ``device``.
    """
    dev = resolve_device(device)
    powerT = np.asarray(_host(powerT))
    R = powerT.shape[1]
    dr0 = np.asarray(_host(dr), dtype="f4")[:, 0]
    sh0 = np.asarray(_host(tvg_shift), dtype="f4")[:, 0]
    bounds, k0 = closed_bounds_k0_np(dr0, sh0, _host(r_edges), R)
    _check_n_r(bounds, n_r)

    def on(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    k_col = torch.arange(R, dtype=torch.float32, device=dev)[None, :, None]
    r_tvg_col = k_col * on(dr0)[:, None, None] - on(sh0)[:, None, None]  # [C, R, 1]
    sprd_col = 20.0 * torch.log10(torch.clamp_min(r_tvg_col, 1e-20))
    pw = on(powerT).to(torch.float32)
    if powerT.dtype.kind in "iu":
        pw = pw * INDEX2POWER
    ab, off = _as_f32(absorption, dev), _as_f32(offset, dev)
    lin = torch.exp((pw + sprd_col + 2.0 * ab[:, None, :] * r_tvg_col + off[:, None, :])
                    * LN10_OVER_10)
    vl = on(np.asarray(_host(valid_len), dtype="f4"))
    k0_t, b = on(k0), on(bounds)
    lin = torch.where((k_col >= k0_t[:, None, None]) & (k_col < vl[:, None, :]), lin, 0.0)
    r_ids = torch.arange(R, dtype=torch.float32, device=dev)[None, None, :]
    mt = ((r_ids >= b[:, :-1, None]) & (r_ids < b[:, 1:, None])).to(torch.float32)  # [C, n_r, R]
    n1t = torch.diff(torch.clamp(b[:, :, None], min=k0_t[:, None, None], max=vl[:, None, :]),
                     dim=1)  # [C, n_r, P]
    x_rel = on(_host(x_rel))
    xb = torch.searchsorted(x_rel, torch.arange(n_x_window + 1, dtype=x_rel.dtype, device=dev),
                            side="left")
    p_ids = torch.arange(pw.shape[2], device=dev)[:, None]
    mx = ((p_ids >= xb[None, :-1]) & (p_ids < xb[None, 1:])).to(torch.float32)  # [P, W]
    with no_tf32():
        s1t = torch.bmm(mt, lin)  # [C, n_r, P]
        out = torch.einsum("ckp,pw->cwk", torch.cat([s1t, n1t], dim=1), mx)
    return out[:, :, :n_r], out[:, :, n_r:]


def _mvbs(sums, counts):
    mean = sums / torch.where(counts > 0, counts, 1.0)
    return torch.where(counts > 0, 10.0 * torch.log10(mean), torch.nan)


_CORE_SPECS = (_CPR, _CP, _CP, _CP, _CP, _PING, None)


def sharded_sv_mvbs_step(mesh, n_x: int, n_r: int, uniform_dr: bool = True,
                         with_sv: bool = True, device="cuda"):
    """Build the survey step on a mesh (or on ``device`` for ``mesh=None``).

    Returns fn(power, dr, tvg_shift, absorption, offset, x_idx, r_edges) ->
    (Sv [C, P, R], MVBS [C, n_x, n_r]), or MVBS alone when ``with_sv`` is
    False; MVBS is ``10 log10(sums / counts)``, NaN where a bin is empty.
    Each (ping, channel) block runs ``uniform_dr=True`` (each channel's
    ``dr`` ping-invariant, the instrument norm) on K3
    (:func:`sv_mvbs_core_fused`) with Sv and K4 (:func:`mvbs_core_fused`)
    without, the drop-ins of the JAX package's ``sv_mvbs_core_mxu``;
    ``uniform_dr=False`` runs :func:`sv_mvbs_core`.  Sums and counts add
    over the ping blocks (the port's ``psum``); Sv and MVBS come back on
    ``mesh.devices.flat[0]``.  Inputs are host arrays or tensors; x_idx
    [P] sorted global ping-bin ids.
    """
    mesh = _resolve_mesh(mesh, device)

    def shard(dev, pos, power, dr, tvg_shift, absorption, offset, x_idx, r_edges):
        args = (power, dr, tvg_shift, absorption, offset, x_idx, r_edges, n_x, n_r)
        if not uniform_dr:
            return sv_mvbs_core(*args, device=dev)
        if with_sv:
            return sv_mvbs_core_fused(*args, device=dev)
        return (None, *mvbs_core_fused(*args, device=dev))

    def step(power, dr, tvg_shift, absorption, offset, x_idx, r_edges):
        parts = _map_shards(mesh, _CORE_SPECS, shard,
                            (power, dr, tvg_shift, absorption, offset, x_idx, r_edges))
        mvbs = _mvbs(_mesh_psum(mesh, parts, 1), _mesh_psum(mesh, parts, 2))
        return (_assemble(mesh, parts, 0, _CPR), mvbs) if with_sv else mvbs

    return step


def sharded_sv_mvbs_step_3d(mesh, n_x: int, n_r: int):
    """The survey step over a (ping, channel, range) mesh, in plain torch.

    Each block holds a contiguous range segment; its global sample index is
    ``r_pos * R_local + k``, so Sv and the bin matrix (bounds ``ceil(r_edges
    / dr0)`` clipped to the global ``R``) are the one-device step's, and
    the bin sums add over both the ping and the range blocks (ping bins by
    :func:`_window_sums`).  K3 / K4 take no sample offset, and the JAX step
    is plain XLA here too.  Returns
    fn(power, dr, tvg_shift, absorption, offset, x_idx, r_edges) -> (Sv
    [C, P, R], MVBS [C, n_x, n_r]) on ``mesh.devices.flat[0]``.
    """
    mesh = check_mesh(mesh)
    n_range = mesh.shape.get("range", 1)

    def shard(dev, pos, power, dr, tvg_shift, absorption, offset, x_idx, r_edges):
        power, dr, tvg_shift, absorption, offset, r_edges = (
            _as_f32(a, dev) for a in (power, dr, tvg_shift, absorption, offset, r_edges))
        r_local = power.shape[2]
        first = pos.get("range", 0) * r_local
        sv = _sv_chunk(power, dr, tvg_shift, absorption, offset, first_sample=first)
        k = torch.arange(r_local, dtype=torch.float32, device=dev) + float(first)
        bounds = torch.clamp(torch.ceil(r_edges[None, :] / dr[:, :1]), 0, r_local * n_range)
        kk = k[None, :, None]
        m = ((kk >= bounds[:, None, :-1]) & (kk < bounds[:, None, 1:])).to(torch.float32)
        ok = ~torch.isnan(sv)
        lin = torch.where(ok, torch.pow(10.0, sv / 10.0), 0.0)
        with no_tf32():
            s1, n1 = torch.bmm(lin, m), torch.bmm(ok.to(torch.float32), m)
        return (sv, *_window_sums(s1, n1, x_idx, n_x, dev))

    def step(power, dr, tvg_shift, absorption, offset, x_idx, r_edges):
        parts = _map_shards(mesh, ((*_CP, "range"), *_CORE_SPECS[1:]), shard,
                            (power, dr, tvg_shift, absorption, offset, x_idx, r_edges),
                            axes=("ping", "channel", "range"))
        mvbs = _mvbs(_mesh_psum(mesh, parts, 1), _mesh_psum(mesh, parts, 2))
        return _assemble(mesh, parts, 0, (*_CP, "range")), mvbs

    return step


def sharded_mvbs_step_closed(mesh, n_x: int, n_r: int, device="cuda"):
    """MVBS-only step on the closed-counts core, per (ping, channel) block.

    fn(power, dr, tvg_shift, absorption, offset, valid_len, x_idx, r_edges)
    -> MVBS [C, n_x, n_r] on ``mesh.devices.flat[0]``: each block runs
    :func:`sv_mvbs_core_mxu_closed` and the sums and counts add over the
    ping blocks.
    """
    mesh = _resolve_mesh(mesh, device)

    def shard(dev, pos, power, dr, tvg_shift, absorption, offset, valid_len, x_idx, r_edges):
        return sv_mvbs_core_mxu_closed(power, dr, tvg_shift, absorption, offset, valid_len,
                                       x_idx, r_edges, n_x, n_r, device=dev)

    def step(power, dr, tvg_shift, absorption, offset, valid_len, x_idx, r_edges):
        parts = _map_shards(mesh, (_CPR, _CP, _CP, _CP, _CP, _CP, _PING, None), shard,
                            (power, dr, tvg_shift, absorption, offset, valid_len, x_idx, r_edges))
        return _mvbs(_mesh_psum(mesh, parts, 0), _mesh_psum(mesh, parts, 1))

    return step


def survey_pipeline_step(mesh, n_x: int, n_r: int, with_sv: bool = True, device="cuda"):
    """One full survey-processing step on a 2- or 3-axis mesh, or on
    ``device`` for ``mesh=None``.

    Counterpart of ``echopype_tpu.parallel.survey_pipeline_step``: float32
    dB power -> Sv and its MVBS on K3 (``with_sv``) or K4 per block; a mesh
    with a ``range`` axis takes :func:`sharded_sv_mvbs_step_3d` (Sv and
    MVBS, as in the JAX package).
    """
    if mesh is not None and "range" in check_mesh(mesh).axis_names:
        return sharded_sv_mvbs_step_3d(mesh, n_x, n_r)
    return sharded_sv_mvbs_step(mesh, n_x, n_r, with_sv=with_sv, device=device)


# --------------------------------------------- Sv-store streamers' mesh steps
def _binned_step(mesh, specs, fn, n_out):
    """A binning function of ``ops/binning.py`` per block, its partials
    summed over the ping blocks."""

    def step(*args):
        parts = _map_shards(mesh, specs, lambda dev, pos, *blocks: fn(*(_on(b, dev)
                                                                        for b in blocks)), args)
        out = tuple(_mesh_psum(mesh, parts, i) for i in range(n_out))
        return out if n_out > 1 else out[0]

    return step


def sharded_binned_partials(mesh, n_x_window: int, skipna: bool = True, closed: str = "left",
                            uniform_er: bool = False, device="cuda"):
    """Partial bin sums of calibrated Sv blocks on a mesh.

    fn(sv_db, er, r_edges, x_rel) -> (sums, counts, nan_counts)
    [C, n_x_window, n_r] on ``mesh.devices.flat[0]``:
    ``binning.binned_window_partials`` per block (sv_db, er [C, P, R];
    x_rel [P] window-relative ids), summed over the ping blocks.  The
    per-ping route's accumulating ``index_put_`` stays deterministic on
    each block, and the blocks add in a fixed order.
    """
    return _binned_step(
        _resolve_mesh(mesh, device), (_CPR, _CPR, None, _PING),
        lambda sv, er, re, xr: binning.binned_window_partials(
            sv, er, re, xr, n_x_window, skipna=skipna, closed=closed, uniform_er=uniform_er),
        3)


def sharded_binned_sum_raw(mesh, n_x_window: int, closed: str = "left",
                           uniform_er: bool = False, device="cuda"):
    """NaN-skipping raw window sums on a mesh (the NASC height numerator):
    fn(values, er, r_edges, x_rel) -> [C, n_x_window, n_r], the layout of
    :func:`sharded_binned_partials`."""
    return _binned_step(
        _resolve_mesh(mesh, device), (_CPR, _CPR, None, _PING),
        lambda v, er, re, xr: binning.binned_window_sum_raw(
            v, er, re, xr, n_x_window, closed=closed, uniform_er=uniform_er),
        1)


def sharded_binned_partials_grid(mesh, n_x_window: int, skipna: bool = True,
                                 closed: str = "left", device="cuda"):
    """Partial bin sums with a ping-invariant [C, R] range row on a mesh.

    fn(sv_db, er_row, r_edges, x_rel): the row is cut by channel and given
    whole to every ping block, so no [C, P, R] range operand moves
    (``binning.binned_window_partials_grid`` per block).
    """
    return _binned_step(
        _resolve_mesh(mesh, device), (_CPR, _ROW, None, _PING),
        lambda sv, row, re, xr: binning.binned_window_partials_grid(
            sv, row, re, xr, n_x_window, skipna=skipna, closed=closed),
        3)


def sharded_binned_row_sum(mesh, n_x_window: int, closed: str = "left", device="cuda"):
    """Ping-invariant raw bin sums on a mesh (the NASC height numerator).

    fn(values_row, er_row, r_edges, x_rel) -> [C, n_x_window, n_r]: each
    ping block scales the shared [C, n_r] row sums by its own per-bin ping
    counts (its slice of x_rel); their sum over the ping blocks scales it
    by the global counts.
    """
    return _binned_step(
        _resolve_mesh(mesh, device), (_ROW, _ROW, None, _PING),
        lambda v, row, re, xr: binning.binned_window_row_sum(v, row, re, xr, n_x_window,
                                                             closed=closed),
        1)
