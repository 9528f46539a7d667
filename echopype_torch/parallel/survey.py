"""Survey streamers: raw files or Sv stores -> survey-global bins.

Counterpart of ``echopype_tpu/parallel/survey.py``.  Two families:

* Sv stores -> MVBS / NASC (:func:`run_survey_mvbs`,
  :func:`run_survey_nasc`): each source's Sv streams to the device in
  float32 ping chunks; bin membership resolves on the host in float64 and
  ships encoded (``ops/binning.py::exact_bin_encode_np``); the window
  partials come back one chunk late into host float64 sums.  A file whose
  range (or depth) grid is the same for every ping ships one encoded [C, R]
  row instead of a [C, P, R] operand a chunk (the "grid" route); the
  others take the per-ping route.  No CUDA kernel of the port runs here:
  the bin sums are plain torch (``binned_window_partials*``).
* Raw files -> MVBS (:func:`run_survey_mvbs_from_raw`).  Power mode
  (EK60/ES70, and the power channels of EK80/ES80/EA640): one file loop
  streams the decoded files on a survey plan, which comes either from a
  header-only extent scan, each file then decoding on a background thread
  while the one before streams (``prefetch=True``, local EK60/ES70 files),
  or from every file decoded first, in process or in a spawned process
  pool (``workers=``).  Per file, calibration parameters
  resolve on the host; each ping chunk ships as int16 to the device, where
  one fused kernel (K1 for per-channel uniform ``dr``, K2 otherwise)
  returns its [C, window, n_r] bin partials; Sv is never materialized.
  AZFP/AZFP6 decode first: their power ships as NaN-padded float32
  dB (their counts are no int16 indices) and every chunk runs K2's float32
  instance with the echo_range intercept ``r0``.
  EK80 complex / broadband channels: either each ping chunk calibrates
  through ``compute_Sv`` (the matched filter on the device) and its Sv bins
  on the device, or, with ``device_fused``, one device pass per (channel,
  chunk) runs pulse compression, Sv and the bins
  (``ops/bb_pipeline.py``).  Partials are read back one chunk late, so the
  device computes chunk k+1 while the host adds chunk k into float64 sums.

Both families take the JAX package's masking options.  ``freq_diff`` (a
frequency-differencing criterion) masks Sv on the device before the bins:
on the Sv stores and the complex chunks a cross-channel mask of the chunk's
Sv, in power mode a step that fuses the mask into the calibration
(``pipeline.sv_mvbs_window_partials_freqdiff``, on decoded-first files,
instead of K1/K2).  ``noise_masks`` runs the ``clean`` masks on each whole file
(their windows need the file's context) and NaNs the flagged samples; the
raw streamer then calibrates every file to Sv first and streams those.

Every route follows one :class:`_SurveyPlan`: the survey's global bins,
each unit's chunks and the window they span.  All three take ``mesh=``
(``parallel.make_mesh``): each chunk, rounded up to a multiple of the ping
shards (``_mesh_layout``), splits over the mesh's
(ping, channel) blocks and every block runs the chunk's step on its device
(``pipeline.sharded_*``: K1 / K2 once a block in power mode, the freq-diff
step, the Sv binning); the blocks' partials add up on the mesh's first
device, which also runs the unsharded work (decode-side calibration, the
masks, ``compute_Sv`` of the complex chunks).

The host-to-device copies are plain synchronous ``.to(device)``; the two
int16 staging buffers alternate, so pinned asynchronous copies can replace
them later without a buffer being overwritten while a copy reads it.  The
fused complex path opens its files without the complex groups' float64
samples and stages each (channel, chunk) from the parser's float32 planes
into one float32 buffer pair, page-locked on a card
(:class:`_ComplexChunkStage`).
"""

from __future__ import annotations

import contextlib
import os
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

from .. import native
from ..calibrate.ek import CalibrateEK60
from ..commongrid.api import _conform_range, _orient_range_axis
from ..commongrid.utils import _parse_x_bin, get_distance_from_latlon, ping_time_bin_edges
from ..convert.api import _open_raw_unfilled, open_raw
from ..convert.simrad.decode import INDEX2POWER
from ..convert.set_groups_ek80 import ComplexLayout
from ..convert.simrad.framing import CorruptDatagramError, scan_ek_extent
from ..device import device_name, resolve_device
from ..ops import binning
from ..utils.compute import _lin2log
from ..utils.geodesy import pairwise_distance_nmi
from ..utils.io import is_remote_path, open_source
from ..utils.log import _init_logger
from ..utils.profiling import StageTimer, count, stage
from ..utils.prov import echopype_prov_attrs
from ..xrlite import Dataset
from .mesh import Mesh, check_mesh
from .pipeline import (
    _CMP,
    closed_bounds_k0_np,
    closed_window_counts_np,
    sharded_binned_partials,
    sharded_binned_partials_grid,
    sharded_binned_row_sum,
    sharded_binned_sum_raw,
    sharded_mvbs_partials_closed,
    sharded_mvbs_partials_freqdiff,
)

logger = _init_logger(__name__)

__all__ = ["run_survey_mvbs", "run_survey_mvbs_from_raw", "run_survey_nasc"]


class _PartialAccumulator:
    """Host float64 accumulator over window partials with one chunk of lag.

    CUDA launches return at once: by deferring each chunk's readback until
    the next chunk has been launched, the device computes chunk k+1 while
    the host waits on chunk k's result.  ``n_out`` partials a chunk (sums
    and counts by default; the NASC streamer adds nan counts and heights).
    """

    def __init__(self, n_ch, n_x, n_r, window, timer, n_out=2, counts_counter=None):
        self.parts = [np.zeros((n_ch, n_x, n_r), dtype="f8") for _ in range(n_out)]
        self.sums, self.counts = self.parts[:2]
        self.window = window
        self.n_x = n_x
        self.timer = timer
        self.counts_counter = counts_counter
        self._pending = None

    def push(self, *item, ch=None):
        """Queue one chunk's ``(*partials, x_base)``; add the chunk before.
        With ``ch``, the partials are one channel's [window, n_r]."""
        prev, self._pending = self._pending, (item, ch)
        if prev is not None:
            self._drain(prev)

    def _drain(self, pending):
        (*partials, x_base), ch = pending
        rows = slice(None) if ch is None else ch
        with self.timer.stage("accumulate"):
            w_eff = min(self.window, self.n_x - x_base)
            partials = [p.cpu().numpy() if isinstance(p, torch.Tensor) else p for p in partials]
            for acc, p in zip(self.parts, partials):
                acc[rows, x_base : x_base + w_eff] += p[..., :w_eff, :]
            if self.counts_counter is not None and torch.autograd._profiler_enabled():
                # while traced: the samples the chunk's bins took, over every channel
                count(self.counts_counter, int(partials[1][..., :w_eff, :].sum(dtype="f8")))

    def finish(self):
        if self._pending is not None:
            self._drain(self._pending)
            self._pending = None
        return tuple(self.parts)


def _global_ping_bins(pt_i8, ping_edges_i8, n_x):
    """Clip ping timestamps into global ping-bin ids (non-decreasing)."""
    pt_i8 = np.asarray(pt_i8, dtype="i8")
    if pt_i8.size > 1 and np.any(np.diff(pt_i8) < 0):
        raise ValueError(
            "ping_time must be non-decreasing for survey streaming; repair "
            "reversed timestamps first (qc.coerce_increasing_time)"
        )
    return np.clip(
        np.searchsorted(ping_edges_i8, pt_i8, side="right") - 1, 0, n_x - 1
    ).astype("i4")


_EK60_MODELS = ("EK60", "ES70")
_EK80_MODELS = ("EK80", "ES80", "EA640")
_AZFP_MODELS = ("AZFP", "AZFP6")


def _mesh_and_device(mesh, device):
    """(mesh checked, or None; the device of the streamer's unsharded work):
    with a mesh, its first device (where the partials are summed)."""
    if mesh is None:
        return None, resolve_device(device)
    mesh = check_mesh(mesh)
    return mesh, mesh.devices.flat[0]


def _mesh_layout(mesh, chunk_pings: int, n_channels: int) -> int:
    """Check the mesh's axes against the workload; return the chunk rounded
    up to a multiple of the ping shards (``chunk_pings`` without a mesh)."""
    if mesh is None:
        return chunk_pings
    if "ping" not in mesh.axis_names or "channel" not in mesh.axis_names:
        raise ValueError("survey mesh needs 'ping' and 'channel' axes (make_mesh)")
    if "range" in mesh.axis_names and mesh.shape["range"] != 1:
        raise ValueError("survey streaming shards ping/channel only; use range_axis=1")
    ch_shards = mesh.shape["channel"]
    if n_channels % ch_shards != 0:
        raise ValueError(
            f"{n_channels} channels not divisible by mesh channel axis {ch_shards}"
        )
    ping_shards = mesh.shape["ping"]
    return -(-chunk_pings // ping_shards) * ping_shards


class _SurveyPlan:
    """The survey's bin grid and chunk rule, which every streamer follows.

    ``x_ids[u]`` holds the global x bin (a ping-time or a distance bin) of
    every ping of streamed unit ``u`` (a file, or a (channel, filter epoch)
    unit), in ping order, and ``times[u]`` its ping times where the plan
    has them.  The x bins are ``x_edges``; the range bins step by
    ``range_bin_m`` from 0 past ``r_max``, and cover echo ranges up to
    ``r_bound``.  A unit streams in chunks of ``chunk_pings`` pings,
    rounded up to a multiple of the mesh's ping shards; the widest chunk of
    any unit spans ``window`` x bins (the kernels' static W), and a padded
    ping parks at ``window``, past every bin of its chunk.
    """

    def __init__(self, x_ids, x_edges, r_max, range_bin_m, chunk_pings, n_channels, mesh=None,
                 times=None):
        self.x_ids, self.x_edges, self.times, self.mesh = x_ids, x_edges, times, mesh
        self.range_edges = np.arange(0, r_max + range_bin_m, range_bin_m)
        self.r_bound = max(r_max, self.range_edges[-1])
        self.n_x, self.n_r = len(x_edges) - 1, len(self.range_edges) - 1
        self.chunk_pings = _mesh_layout(mesh, chunk_pings, n_channels)
        spans = (int(x_rel[-1]) + 1 for x in x_ids for *_, x_rel in self.chunks(x))
        self.window = max([1, *spans])

    @classmethod
    def over_ping_time(cls, ping_times, ping_time_bin, r_max, range_bin_m, chunk_pings,
                       n_channels, mesh=None, unit_times=None):
        """The plan of files whose pings are at ``ping_times``: ping-time bins
        of ``ping_time_bin`` over the survey's span, and the units' x bins
        from their pings' times, ``unit_times`` (the files themselves by
        default)."""
        span = [min(pt.min() for pt in ping_times), max(pt.max() for pt in ping_times)]
        ping_edges = ping_time_bin_edges(np.array(span, dtype="datetime64[ns]"), ping_time_bin)
        edges_i8 = ping_edges.astype("i8")
        unit_times = ping_times if unit_times is None else unit_times
        x_ids = [_global_ping_bins(pt.astype("i8"), edges_i8, len(ping_edges) - 1)
                 for pt in unit_times]
        return cls(x_ids, ping_edges, r_max, range_bin_m, chunk_pings, n_channels, mesh,
                   unit_times)

    def accumulator(self, n_channels, timer, n_out=2, counts_counter=None):
        """The survey's host float64 sums over the plan's bins; with
        ``counts_counter``, a traced window counts the samples binned
        under that name as each chunk's counts are read back."""
        return _PartialAccumulator(n_channels, self.n_x, self.n_r, self.window, timer, n_out,
                                   counts_counter)

    def chunks(self, x_ids):
        """Each chunk of a unit whose pings have x bins ``x_ids``: (its ping
        slice, its first ping's bin ``x_base``, its bins relative to it)."""
        for lo in range(0, len(x_ids), self.chunk_pings):
            sl = slice(lo, min(lo + self.chunk_pings, len(x_ids)))
            x_base = int(x_ids[lo])
            yield sl, x_base, x_ids[sl] - x_base

    def mesh_pad(self, n):
        """Pings to add to a chunk of ``n`` so that it splits over the mesh's
        ping shards (0 without a mesh)."""
        return 0 if self.mesh is None else -n % self.mesh.shape["ping"]

    def park(self, x_rel, pad):
        """``x_rel`` with ``pad`` padded pings parked at ``window``."""
        return np.pad(x_rel, (0, pad), constant_values=self.window)


def _pad_pings(a, pad, fill=np.nan):
    """Pad axis 1 (pings) of ``a`` with ``pad`` entries of ``fill``."""
    if not pad:
        return a
    widths = [(0, 0)] * a.ndim
    widths[1] = (0, pad)
    return np.pad(a, widths, constant_values=fill)


def _channel_mesh(mesh, n_channels):
    """``mesh``, or its first channel column for a work unit of fewer
    channels than the channel axis (a single-channel EK80 epoch)."""
    if mesh is None or n_channels % mesh.shape["channel"] == 0:
        return mesh
    return Mesh(mesh.devices[:, :1], mesh.axis_names)


class _ScanUnavailable(Exception):
    """Extent scan could not cover this survey; plan from the decoded files."""


def _resolve_freq_diff(freq_diff, chans, freq_nominal=None):
    """Resolve a frequency-differencing criterion to (ia, ib, op, diff_dB).

    Accepts the reference's equation strings ('"chA" - "chB" > 3dB' /
    '38kHz - 18kHz >= 10dB', mask/freq_diff.py) or a dict with
    chanA/chanB (or freqA/freqB), operator, diff.
    """
    if freq_diff is None:
        return None
    from ..mask.freq_diff import _parse_freq_diff_eq

    if isinstance(freq_diff, str):
        if '"' in freq_diff:
            freqAB, chanAB, op, diff = _parse_freq_diff_eq(chanABEq=freq_diff)
        else:
            freqAB, chanAB, op, diff = _parse_freq_diff_eq(freqABEq=freq_diff)
    elif isinstance(freq_diff, dict):
        chanAB = [freq_diff["chanA"], freq_diff["chanB"]] if "chanA" in freq_diff else None
        freqAB = [freq_diff["freqA"], freq_diff["freqB"]] if "freqA" in freq_diff else None
        op = freq_diff.get("operator", ">")
        diff = float(freq_diff["diff"])
    else:
        raise TypeError("freq_diff must be an equation string or a dict")

    chan_list = [str(c) for c in chans]
    if chanAB is not None:
        missing = [c for c in chanAB if c not in chan_list]
        if missing:
            raise ValueError(f"freq_diff channels not in survey: {missing}")
        ia, ib = chan_list.index(chanAB[0]), chan_list.index(chanAB[1])
    else:
        if freq_nominal is None:
            raise ValueError("frequency-based freq_diff needs frequency_nominal")
        fn = np.asarray(getattr(freq_nominal, "values", freq_nominal), dtype="f8")
        hitsA = np.nonzero(fn == freqAB[0])[0]
        hitsB = np.nonzero(fn == freqAB[1])[0]
        if len(hitsA) != 1 or len(hitsB) != 1:
            raise ValueError(
                f"freq_diff frequencies {freqAB} must match exactly one channel each"
            )
        ia, ib = int(hitsA[0]), int(hitsB[0])
    return ia, ib, op, float(diff)


def _fd_mask(fd):
    """The cross-channel frequency-differencing mask as a function of a Sv
    tensor [C, P, R]: samples failing the criterion become NaN on every
    channel (apply_mask semantics; a NaN difference fails)."""
    ia, ib, opr, diff = fd

    def masked(sv):
        keep = _CMP[opr](sv[ia] - sv[ib], float(diff))
        return torch.where(keep[None], sv, torch.nan)

    return masked


_NOISE_MASKS = ("impulse", "transient", "attenuated")


def _check_noise_masks(noise_masks):
    """Refuse a ``noise_masks`` that is not a dict of known mask kinds."""
    if noise_masks is None:
        return
    if not isinstance(noise_masks, dict):
        raise TypeError("noise_masks must be a dict of clean mask kind -> keyword dict")
    for kind in noise_masks:
        if kind not in _NOISE_MASKS:
            raise ValueError(f"unknown noise mask {kind!r}; options: {_NOISE_MASKS}")


def _apply_noise_masks(ds, sv_all, noise_masks, timer, dev):
    """NaN the samples any requested ``clean`` mask flags, on one whole file.

    ``noise_masks`` maps "impulse" / "transient" / "attenuated" to the
    keyword dict of the matching ``clean.mask_*`` function, which runs on
    ``dev``; the masks combine with OR, so the stream equals clean.mask_* ->
    apply_mask -> the binning, file by file.
    """
    from .. import clean

    fns = {
        "impulse": clean.mask_impulse_noise,
        "transient": clean.mask_transient_noise,
        "attenuated": clean.mask_attenuated_signal,
    }
    flagged = None
    with timer.stage("noise_masks"):
        for kind, params in noise_masks.items():
            m = np.asarray(fns[kind](ds, **dict(params or {}), device=dev).values, dtype=bool)
            flagged = m if flagged is None else (flagged | m)
    if flagged is not None:
        sv_all = np.where(flagged, np.nan, sv_all)
    return sv_all


def _sanitize_power_cal_inputs(power, *params):
    """Make kernel inputs NaN-safe with compute_Sv's exact semantics.

    Every (channel, ping) with a NaN parameter gets its power row forced to
    NaN (so its valid length is 0 and it joins no bin), and the parameter
    NaNs are replaced by a finite per-channel value (1.0 when a channel has
    none) purely to keep the bin bounds and k0 finite.
    """
    power = np.asarray(power)
    params = [np.asarray(a) for a in params]
    bad = None
    for a in params:
        nan = np.isnan(a)
        if nan.any():
            bad = nan if bad is None else (bad | nan)
    if bad is None:
        return (power, *params)
    with np.errstate(invalid="ignore"):
        present = ~np.isnan(power).all(axis=-1)
    kill = bad & present
    if kill.any():
        power = power.astype("f4", copy=True) if power.dtype.kind != "f" else power.copy()
        power[kill] = np.nan
    out = []
    for a in params:
        nan = np.isnan(a)
        if nan.any():
            a = a.copy()
            for c in range(a.shape[0]):
                if nan[c].any():
                    finite = a[c][~nan[c]]
                    a[c][nan[c]] = finite[0] if finite.size else 1.0
        out.append(a)
    return (power, *out)


def _resolve_bin_m(range_bin, range_bin_m, name="range_bin") -> float:
    """'20m' strings are the primary spelling; a bare float in metres and
    ``range_bin_m=`` are the deprecated aliases of the JAX package."""
    if range_bin_m is not None:
        return float(range_bin_m)
    if isinstance(range_bin, str):
        return _parse_x_bin(range_bin, name)
    return float(range_bin)


class _PowerChunkStreamer:
    """Per-file chunk loop of the power-mode streamer, on ``plan``.

    With ``ship_i16`` (EK power) converts dB power back to its int16 sample
    indices in two alternating reusable buffers of ``R_max`` samples a
    ping; otherwise (AZFP) ships the float32 dB power, its padded pings
    NaN.  Pads every chunk to the plan's full chunk (padded pings have
    valid length 0 and park past the window) and launches the chunk's
    kernel, on each block of the plan's mesh when there is one.
    """

    def __init__(self, plan, n_ch, R_max, acc, timer, device, ship_i16=True):
        self.plan = plan
        self.r_edges_f4 = np.asarray(plan.range_edges, dtype="f4")
        self.acc = acc
        self.timer = timer
        self.device = device
        self.ship_i16 = ship_i16
        self.chunk_no = 0
        if ship_i16:
            self.inv_scale = np.float32(1.0) / np.float32(INDEX2POWER)
            self.buf_f = np.empty((n_ch, plan.chunk_pings, R_max), dtype="f4")
            self.bufs_i = [np.empty((n_ch, plan.chunk_pings, R_max), dtype="<i2")
                           for _ in range(2)]

    def _to_i16(self, power, sl, n):
        """Rows ``sl`` of dB power -> int16 indices in the next staging buffer
        (NaN -> 0; masked by the valid length)."""
        bi = self.bufs_i[self.chunk_no % 2][:, :, : power.shape[2]]
        self.chunk_no += 1
        done = isinstance(power, np.ndarray) and all(
            native.f32_to_i16_scaled(np.asarray(power[c, sl]), bi[c, :n], float(self.inv_scale))
            for c in range(power.shape[0])
        )
        if not done:  # numpy chain, bit-identical to the native one-pass
            bf = self.buf_f[:, :n, : power.shape[2]]
            np.multiply(power[:, sl], self.inv_scale, out=bf)
            np.rint(bf, out=bf)
            np.nan_to_num(bf, copy=False)
            bi[:, :n] = bf
        bi[:, n:] = 0
        return bi

    def stream_file(self, power, dr, shift, alpha, offset, x_idx_all, uniform, fd=None,
                    r0=None):
        """Stream one file's chunks.  Uniform files run K1 with host
        closed-form counts; the others run K2, which also counts.  With
        ``fd`` (a resolved frequency-differencing criterion) every chunk
        runs the masked step (stage ``freqdiff_step``), whose counts depend
        on the data; a traced window then counts the chunks' valid samples
        (``fd_valid_samples``) and, as the accumulator reads the counts
        back, those the mask kept (``fd_kept_samples``).  ``r0``
        [C, P] is the echo_range intercept (AZFP), None for EK."""
        timer, acc, plan = self.timer, self.acc, self.plan
        chunk_pings, window = plan.chunk_pings, plan.window
        # the device stage's own name: the masked step, or K1/K2 on int16 or float32 samples
        dev_stage = ("freqdiff_step" if fd is not None
                     else "device_mvbs" if self.ship_i16 else "device_mvbs_f32")
        with timer.stage("valid_len"):  # a pass over the file's power, and K1's bounds
            host_counts = (
                closed_bounds_k0_np(dr[:, 0], shift[:, 0], self.r_edges_f4, power.shape[2])
                if uniform and fd is None else None
            )
            # ragged pings pad with a NaN suffix, so finite-count == valid length
            valid_len = (~np.isnan(power)).sum(axis=2).astype("i4")
        for sl, x_base, x_rel in plan.chunks(x_idx_all):
            n = sl.stop - sl.start
            pad = chunk_pings - n
            timer.count("staged_pings", chunk_pings)
            timer.count("padded_pings", pad)

            def _pad2(a, fill=0.0):
                a = np.asarray(a[:, sl], dtype="f4")
                return np.pad(a, ((0, 0), (0, pad)), constant_values=fill) if pad else a

            if self.ship_i16:
                with timer.stage("to_int16"):
                    p_chunk = self._to_i16(power, sl, n)
            else:
                with timer.stage("pad_float32"):
                    p_chunk = np.asarray(power[:, sl], dtype="f4")
                    if pad:  # NaN power adds nothing to any bin
                        p_chunk = np.pad(p_chunk, ((0, 0), (0, pad), (0, 0)),
                                         constant_values=np.nan)
            x_rel = plan.park(x_rel, pad)
            vl_chunk = np.pad(valid_len[:, sl], ((0, 0), (0, pad)))
            if fd is not None and torch.autograd._profiler_enabled():
                # while traced: the samples the mask decides on, over every channel
                count("fd_valid_samples", int(valid_len[:, sl].sum(dtype="i8")))
            args = (p_chunk, _pad2(dr, 1.0), _pad2(shift), _pad2(alpha), _pad2(offset),
                    vl_chunk, x_rel.astype("i4"), self.r_edges_f4)
            r0_chunk = None if r0 is None else _pad2(r0)
            with timer.stage(dev_stage):
                s, c = self._step(args, r0_chunk, uniform, fd)
                if c is None:
                    c = closed_window_counts_np(
                        host_counts[0], host_counts[1], vl_chunk, x_rel, window
                    )
            acc.push(s, c, x_base)

    def _step(self, base, r0, uniform, fd):
        """One chunk on the mesh (``mesh=None``: one block on ``device``):
        (sums, counts), counts None where the host's closed form gives them
        (uniform files, no mask)."""
        mesh, window, n_r, dev = self.plan.mesh, self.plan.window, self.plan.n_r, self.device
        if fd is not None:
            ia, ib, op, diff = fd
            return sharded_mvbs_partials_freqdiff(mesh, window, n_r, ia, ib, op, device=dev)(
                *base, r0, diff)
        if uniform:
            return sharded_mvbs_partials_closed(mesh, window, n_r, uniform=True,
                                                with_counts=False, device=dev)(*base), None
        return sharded_mvbs_partials_closed(mesh, window, n_r, device=dev)(*base, r0)


def _is_uniform(dr, shift, r0=None):
    """Per-channel uniform ``dr`` and shift, and no echo_range intercept:
    the K1 path."""
    return bool(np.all(dr == dr[:, :1]) and np.all(shift == shift[:, :1])
                and (r0 is None or not np.any(r0)))


def _finalize(sums, counts, chans, plan, timer, dev, range_var="echo_range", routes=None):
    """The MVBS Dataset of the survey's sums and counts, on the plan's
    ping-time bins and its first ``sums.shape[2]`` range bins."""
    with timer.stage("finalize"):
        with np.errstate(invalid="ignore", divide="ignore"):
            mvbs = np.where(counts > 0, _lin2log(sums / np.maximum(counts, 1)), np.nan)
        out = Dataset(
            coords={
                "channel": np.asarray(chans, dtype=object),
                "ping_time": plan.x_edges[:-1],
                range_var: plan.range_edges[: sums.shape[2]],
            }
        )
        out["Sv"] = (("channel", "ping_time", range_var), mvbs)
        out.attrs["stage_timing"] = str(timer.report(log=False))
        out.attrs["device"] = device_name(dev)
        if routes is not None:
            out.attrs["routes"] = routes
    return out


def run_survey_mvbs_from_raw(
    raw_files,
    sonar_model: str = "EK60",
    range_bin="20m",
    ping_time_bin: str = "20s",
    chunk_pings: int = 5000,
    env_params=None,
    cal_params=None,
    use_swap="auto",
    xml_path=None,
    timer: StageTimer = None,
    mesh=None,
    waveform_mode=None,
    encode_mode=None,
    device_fused: bool = False,
    prefetch: bool = True,
    freq_diff=None,
    workers: int = 0,
    noise_masks=None,
    range_bin_m: float = None,
    device="cuda",
):
    """Stream raw EK60/ES70, EK80/ES80/EA640 or AZFP/AZFP6 files into
    survey-global MVBS bins.

    The arguments are the JAX package's; ``device`` ("cuda" by default,
    "cpu" for the plain PyTorch path) is where the device work runs.
    Power mode (EK60/ES70; EK80-family files without ``waveform_mode`` /
    ``encode_mode``, whose power channels calibrate as CW power): one file
    loop streams the files on the survey's bin grid.  On local EK60/ES70
    files ``prefetch=True`` plans that grid from a header-only extent scan
    and decodes each file on a background thread while the previous one
    streams; otherwise, or when the scan cannot cover the survey, every
    file decodes first and the grid comes from the decoded inputs.  Both
    give the same bins.  AZFP/AZFP6 (``xml_path`` for AZFP; salinity and
    pressure in ``env_params``) decode first: power ships as float32
    dB and each chunk runs K2's float32 instance with the echo_range
    intercept ``r0`` (AZFP echo_range is ``r0 + k dr``), as the JAX
    package's XLA step does.
    ``waveform_mode`` / ``encode_mode`` ("BB"|"FM"|"CW", "complex") stream
    EK80 complex channels: each ping chunk calibrates through compute_Sv
    (the matched filter on ``device``, the rest host float64) and bins on
    ``device``; ``device_fused=True`` instead runs pulse compression,
    received power, Sv and the bins as one device pass per (channel, chunk)
    (``ops/bb_pipeline.py``, float32 end to end).  Multi-``filter_time``
    files stream per (channel, filter epoch), as compute_Sv partitions them.

    ``freq_diff`` ('"chA" - "chB" > 3dB', '120kHz - 38kHz > 6dB', or a dict
    with chanA/chanB or freqA/freqB, operator, diff): masked samples join
    no bin on any channel.  Power mode then decodes first and takes the
    masked step (``pipeline.sv_mvbs_window_partials_freqdiff``) instead of
    K1/K2; complex chunks mask their Sv on the device before the bins; the
    fused path stacks each chunk's per-channel Sv, masks it and bins it.
    Multi-``filter_time`` files calibrate whole (all channels aligned) and
    stream chunked, also under ``device_fused``.
    ``noise_masks`` ({"impulse": {...}, "transient": {...}, "attenuated":
    {...}}, each value the keywords of the ``clean.mask_*`` function): the
    stream runs two-pass, each file calibrated to a full Sv dataset (any
    mode) that :func:`run_survey_mvbs` masks and bins, one file in memory
    at a time.

    ``workers=N`` (N > 0, two files or more) decodes the files in N spawned
    processes, one file a task, as the JAX package does: the extent scan
    is then off and the file loop consumes the decoded inputs in file
    order, so the bins equal ``workers=0, prefetch=False`` bit for bit.
    The workers resolve parameters on the CPU and never touch the card; a
    worker that fails makes the survey raise.  The ``noise_masks`` and
    complex routes ignore ``workers``, as in the JAX package.

    ``mesh`` (``parallel.make_mesh``, a (ping, channel) grid of devices; a
    mesh of another kind raises ``TypeError``): each chunk, rounded up to a
    multiple of the ping shards, splits over the mesh and each block runs
    the chunk's step on its device (K1 / K2, one launch a block; the
    freq-diff step, which needs channel axis 1; the Sv binning of the
    complex and noise-mask routes); the partials add up on the mesh's first
    device, which also runs the unsharded work (``device`` is then unused).
    ``device_fused`` with a mesh takes the chunked complex path, with a
    warning, as in the JAX package.

    Returns an MVBS Dataset on the global (ping_time bin, range bin) grid;
    ``attrs["device"]`` names the device and ``attrs["stage_timing"]`` holds
    the host wall time per stage.
    """
    if sonar_model not in _EK60_MODELS + _EK80_MODELS + _AZFP_MODELS:
        raise ValueError(
            "run_survey_mvbs_from_raw supports EK60/ES70/EK80/ES80/EA640/AZFP/AZFP6 "
            f"power mode, not {sonar_model!r}"
        )
    mesh, dev = _mesh_and_device(mesh, device)
    _check_noise_masks(noise_masks)
    complex_mode = encode_mode == "complex" or waveform_mode in ("BB", "FM")
    if sonar_model in _EK60_MODELS and complex_mode:
        raise ValueError("EK60-style data can only be streamed in CW power mode")
    range_bin_m = _resolve_bin_m(range_bin, range_bin_m)
    timer = timer or StageTimer()
    raw_files = list(raw_files)
    if not raw_files:
        raise ValueError("no raw files provided")
    if noise_masks is not None:
        return _run_noise_masked(raw_files, sonar_model, range_bin_m, ping_time_bin,
                                 chunk_pings, env_params, cal_params, use_swap, xml_path,
                                 timer, waveform_mode, encode_mode, freq_diff, noise_masks, dev,
                                 mesh)
    if complex_mode:
        return _run_survey_mvbs_complex(
            raw_files, sonar_model, waveform_mode, encode_mode, range_bin_m, ping_time_bin,
            chunk_pings, env_params, cal_params, use_swap, xml_path, timer, device_fused, dev,
            freq_diff, mesh,
        )

    make_cal = _power_calibrator(sonar_model, env_params, cal_params, dev)

    def load(f):
        return _load_inputs(f, sonar_model, use_swap, xml_path, make_cal)

    source = None
    if prefetch and freq_diff is None and not workers and sonar_model in _EK60_MODELS:
        try:
            source = _plan_from_scan(raw_files, ping_time_bin, range_bin_m, chunk_pings,
                                     env_params, mesh, timer, load)
        except _ScanUnavailable as e:
            logger.warning(f"extent scan unavailable ({e}); using eager two-pass ingest")
    if source is None:
        pool = None
        if workers and len(raw_files) > 1:
            pool = (workers, (sonar_model, use_swap, xml_path, env_params, cal_params))
        source = _plan_from_decoded(raw_files, ping_time_bin, range_bin_m, chunk_pings, mesh,
                                    timer, load, pool)
    return _stream_power(raw_files, *source, sonar_model, range_bin_m, freq_diff, timer, dev)


def _power_calibrator(sonar_model, env_params, cal_params, dev):
    """The power-mode calibrator factory of ``sonar_model``: EchoData ->
    calibrator whose ``_power_cal_inputs`` resolve the sonar equation."""
    if sonar_model in _EK60_MODELS:
        def make_cal(ed):
            return CalibrateEK60(ed, env_params, cal_params)
    elif sonar_model in _AZFP_MODELS:
        from ..calibrate.azfp import CalibrateAZFP

        def make_cal(ed):
            return CalibrateAZFP(ed, env_params, cal_params, device=dev)
    else:
        from ..calibrate.ek80 import CalibrateEK80

        def make_cal(ed):
            return CalibrateEK80(ed, env_params, cal_params, waveform_mode="CW",
                                 encode_mode="power")
    return make_cal


def _run_noise_masked(raw_files, sonar_model, range_bin_m, ping_time_bin, chunk_pings,
                      env_params, cal_params, use_swap, xml_path, timer, waveform_mode,
                      encode_mode, freq_diff, noise_masks, dev, mesh=None):
    """Two-pass raw stream for ``noise_masks``: the clean masks need each
    file's whole Sv, so every file calibrates to a full Sv dataset (any
    mode) on demand and :func:`run_survey_mvbs` masks and bins it,
    re-decoding in its binning pass (one file in host memory)."""
    from ..calibrate.api import compute_Sv

    def provider(f):
        def open_sv():
            ed = open_raw(f, sonar_model=sonar_model, use_swap=use_swap, xml_path=xml_path)
            kw = dict(env_params=env_params, cal_params=cal_params, device=dev)
            if waveform_mode or encode_mode:
                kw.update(waveform_mode=waveform_mode, encode_mode=encode_mode)
            return compute_Sv(ed, **kw)
        return open_sv

    return run_survey_mvbs([provider(f) for f in raw_files], range_bin_m=range_bin_m,
                           ping_time_bin=ping_time_bin, chunk_pings=chunk_pings, timer=timer,
                           freq_diff=freq_diff, noise_masks=noise_masks, reopen=True,
                           mesh=mesh, device=dev)


def _load_inputs(f, sonar_model, use_swap, xml_path, make_cal):
    """Decode one file and resolve its sonar-equation inputs (host): power,
    dr, shift, alpha, offset, r0 (the echo_range intercept of AZFP, None for
    EK), ping_time, channels, frequency_nominal."""
    ed = open_raw(f, sonar_model=sonar_model, use_swap=use_swap, xml_path=xml_path)
    try:
        cal = make_cal(ed)
    except Exception as e:  # noqa: BLE001 - surface actionable guidance
        raise ValueError(f"{f}: could not set up power-mode calibration ({e!r}).") from e
    pt = np.asarray(cal.beam.coords["ping_time"].values, dtype="datetime64[ns]")
    chans = list(cal.beam.coords["channel"].values)
    power, dr, shift, alpha, offset, last = cal._power_cal_inputs("Sv")
    if sonar_model in _AZFP_MODELS:  # the last input is r0 (EK: tau_effective)
        power, dr, shift, alpha, offset, r0 = _sanitize_power_cal_inputs(
            power, dr, shift, alpha, offset, last)
    else:
        power, dr, shift, alpha, offset = _sanitize_power_cal_inputs(
            power, dr, shift, alpha, offset)
        r0 = None
    freq = np.asarray(cal.beam["frequency_nominal"].values, dtype="f8")
    return power, dr, shift, alpha, offset, r0, pt, chans, freq


def _pool_decode_one(args):
    """Worker-process body of ``workers=``: decode one raw file and resolve
    its sonar-equation inputs, returning what :func:`_load_inputs` returns
    (numpy arrays, lists, None).

    ``args`` is ``(path, sonar_model, use_swap, xml_path, env_params,
    cal_params)``.  The worker builds its own calibrator (the caller's
    factory is a closure, which does not pickle) on the CPU: decode and
    parameter resolution are host work, and a worker never touches the card.
    """
    path, sonar_model, use_swap, xml_path, env_params, cal_params = args
    make_cal = _power_calibrator(sonar_model, env_params, cal_params, torch.device("cpu"))
    out = _load_inputs(path, sonar_model, use_swap, xml_path, make_cal)
    if torch.cuda.is_initialized():
        raise RuntimeError(f"decoding {path} initialised CUDA in a worker process")
    return out


def _pool_load(raw_files, workers, args):
    """Decode ``raw_files`` in a spawned pool of ``workers`` processes, one
    file a task; results in file order.  A failed worker raises here."""
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor

    ctx = multiprocessing.get_context("spawn")
    with ProcessPoolExecutor(max_workers=min(workers, len(raw_files)), mp_context=ctx) as ex:
        return list(ex.map(_pool_decode_one, [(f, *args) for f in raw_files]))


def _last_range(power, dr, r0):
    """The echo range of a file's farthest sample, the largest r0 + (R - 1) * dr."""
    return ((0.0 if r0 is None else float(np.nanmax(r0)))
            + float(np.nanmax(dr)) * (power.shape[2] - 1))


def _plan_from_decoded(raw_files, ping_time_bin, range_bin_m, chunk_pings, mesh, timer, load,
                       pool=None):
    """Decode every file (in a process pool when ``pool`` is ``(workers,
    args)``) and plan the survey's exact grid from the decoded inputs.
    Returns (plan, most samples a ping, the decoded inputs in file order)."""
    with timer.stage("ingest"):
        if pool is not None:
            loaded = _pool_load(raw_files, *pool)
        else:
            loaded = [load(f) for f in raw_files]
    r_max = max(_last_range(item[0], item[1], item[5]) for item in loaded)
    plan = _SurveyPlan.over_ping_time([item[6] for item in loaded], ping_time_bin, r_max,
                                      range_bin_m, chunk_pings, len(loaded[0][7]), mesh)
    # a generator, which the file loop closes as it does the decode-ahead one
    return plan, max(item[0].shape[2] for item in loaded), (item for item in loaded)


def _warm(f):
    """Ask the kernel to read file ``f`` ahead (costs no host CPU)."""
    try:
        fd = os.open(str(f), os.O_RDONLY)
        try:
            os.posix_fadvise(fd, 0, 0, os.POSIX_FADV_WILLNEED)
        finally:
            os.close(fd)
    except (OSError, AttributeError):
        pass


def _plan_from_scan(raw_files, ping_time_bin, range_bin_m, chunk_pings, env_params, mesh,
                    timer, load):
    """Plan the survey from a header-only extent scan, and decode each file
    on a background thread while the one before streams.

    The unique RAW0 timestamps are the decoded ping_time union, so the
    global ping bins are exact, and the recorded sample counts / intervals
    / sound speeds bound the range grid (the file loop trims it to the
    decoded ranges).  Raises _ScanUnavailable when any file is remote,
    corrupt or has no RAW0 data.  Returns what :func:`_plan_from_decoded`
    returns.
    """
    if any(is_remote_path(f) for f in raw_files):
        raise _ScanUnavailable("remote raw files")
    with timer.stage("scan"):
        try:
            scans = [scan_ek_extent(f) for f in raw_files]
        except (CorruptDatagramError, OSError) as e:
            raise _ScanUnavailable(str(e)) from e
    if any(len(s.times) == 0 for s in scans):
        raise _ScanUnavailable("file with no RAW0 datagrams")

    # range-grid bound covering any resolved sound speed (user/env/measured)
    c_bound = max(1700.0, *(s.max_sound_velocity for s in scans))
    if env_params and isinstance(env_params.get("sound_speed"), (int, float)):
        c_bound = max(c_bound, float(env_params["sound_speed"]))
    r_bound = (
        max(s.max_count for s in scans) * max(s.max_interval for s in scans) * c_bound / 2.0
    )
    plan = _SurveyPlan.over_ping_time([s.times for s in scans], ping_time_bin, r_bound,
                                      range_bin_m, chunk_pings, scans[0].n_channels, mesh)
    return plan, max(s.max_count for s in scans), _decode_ahead(raw_files, load, timer)


def _decode_ahead(raw_files, load, timer):
    """``load(f)`` of each file in order, decoded on a background thread one
    file ahead of the caller, with the file after it read ahead.  The
    "ingest" stage is timed on the worker thread and overlaps the other
    stages; "wait_decode" is the caller's wait for it, left before each
    file is handed over."""
    def ingest(f):
        with timer.stage("ingest"):
            return load(f)

    with ThreadPoolExecutor(max_workers=1) as ex, ThreadPoolExecutor(max_workers=1) as warm_ex:
        fut = ex.submit(ingest, raw_files[0])
        if len(raw_files) > 1:
            warm_ex.submit(_warm, raw_files[1])
        for i in range(len(raw_files)):
            with timer.stage("wait_decode"):
                item = fut.result()
            if i + 1 < len(raw_files):
                fut = ex.submit(ingest, raw_files[i + 1])
            if i + 2 < len(raw_files):
                warm_ex.submit(_warm, raw_files[i + 2])
            yield item


def _stream_power(raw_files, plan, max_samples, decoded, sonar_model, range_bin_m, freq_diff,
                  timer, dev):
    """The power-mode file loop: stream each decoded file's chunks on
    ``plan`` (every chunk through the masked step when ``freq_diff`` is set;
    over the plan's mesh when it has one).

    ``decoded`` yields :func:`_load_inputs`'s tuple of each file in order.
    Every file must have the first file's channels, the plan's ping times
    and no sample past the plan's range bound: a plan from the decoded
    inputs holds them by construction, a scanned one is checked.  The range
    bins end at the survey's last sample (all of a decoded plan's grid, a
    prefix of a scanned one).
    """
    acc = streamer = chans0 = fd = None
    r_max = 0.0
    with contextlib.closing(decoded):
        for f, x_ids, times, (power, dr, shift, alpha, offset, r0, pt, chans, freq) in zip(
                raw_files, plan.x_ids, plan.times, decoded):
            if not np.array_equal(pt, times):
                raise RuntimeError(
                    f"{f}: decoded ping_time disagrees with the extent scan; "
                    "rerun with prefetch=False"
                )
            if chans0 is None:
                chans0 = chans
                fd = _resolve_freq_diff(freq_diff, chans, freq)
                acc = plan.accumulator(len(chans), timer,
                                       counts_counter=None if fd is None else "fd_kept_samples")
                streamer = _PowerChunkStreamer(plan, len(chans), max_samples, acc, timer, dev,
                                               ship_i16=sonar_model not in _AZFP_MODELS)
            elif chans != chans0:
                raise ValueError("all raw files must share the same channels")
            r_max = max(r_max, _last_range(power, dr, r0))
            if r_max > plan.r_bound:
                raise RuntimeError(
                    f"{f}: resolved echo range {r_max:.1f} m exceeds the scanned bound "
                    f"{plan.r_bound:.1f} m; rerun with prefetch=False"
                )
            streamer.stream_file(power, dr, shift, alpha, offset, x_ids,
                                 _is_uniform(dr, shift, r0), fd, r0=r0)
    sums, counts = acc.finish()
    n_r = min(plan.n_r, max(1, len(np.arange(0, r_max + range_bin_m, range_bin_m)) - 1))
    return _finalize(sums[:, :, :n_r], counts[:, :, :n_r], chans0, plan, timer, dev)


# ------------------------------------------- EK80 complex channels -> MVBS
def _slice_echodata_pings(ed, beam_path, sl):
    """Shallow EchoData whose beam group is ping-sliced (chunked calibration)."""
    from ..echodata.echodata import EchoData

    tree = dict(ed._tree)
    tree[beam_path] = tree[beam_path].isel(ping_time=sl)
    return EchoData(tree=tree, source_file=ed.source_file, sonar_model=ed.sonar_model)


def _n_filter_times(ed):
    vend = ed["Vendor_specific"]
    return vend.sizes["filter_time"] if "filter_time" in vend.sizes else 1


def _run_survey_mvbs_complex(raw_files, sonar_model, waveform_mode, encode_mode, range_bin_m,
                             ping_time_bin, chunk_pings, env_params, cal_params, use_swap,
                             xml_path, timer, device_fused, dev, freq_diff=None, mesh=None):
    """EK80 complex / broadband raw -> MVBS.

    Per chunk of pings the beam group is ping-sliced and ``compute_Sv`` runs
    the complex calibration (float32 matched filter on ``dev``, the rest in
    host float64); membership of the chunk's echo_range resolves on the
    host in float64 and ships encoded, and the bins sum on ``dev``.
    Multi-``filter_time`` files stream per (channel, filter epoch) work unit
    (``calibrate.api.epoch_slice_dicts``): each chunk calibrates through
    CalibrateEK80's slice_dict (one channel, one filter set, the chunk's
    ping range), so the filter epoch is the one governing those pings
    wherever the chunks fall.  ``device_fused`` hands over to
    :func:`_run_complex_fused`.

    With ``freq_diff`` each chunk's Sv is masked across channels on the
    device before the bins; a multi-``filter_time`` file then calibrates
    whole (compute_Sv's epoch merge keeps the channels sample-aligned) and
    streams in chunks of that Sv, also when ``device_fused`` asked for the
    fused path, which cannot see another channel's epoch (a warning says
    so).

    With ``mesh`` each chunk's bins run on the mesh's blocks (a
    single-channel epoch unit on its first channel column), and
    ``device_fused`` takes this chunked path, with a warning, as in the JAX
    package.
    """
    from ..calibrate.api import compute_Sv, epoch_slice_dicts
    from ..calibrate.ek80 import CalibrateEK80
    from ..echodata.simrad import retrieve_correct_beam_group

    sv_kw = dict(env_params=env_params, cal_params=cal_params, waveform_mode=waveform_mode,
                 encode_mode=encode_mode, precision="float32", device=dev)
    # the fused route stages its samples from the parser's float32 planes
    fused = device_fused and mesh is None
    eds, beam_paths, ping_times, layouts = [], [], [], []
    with timer.stage("ingest"):
        for f in raw_files:
            if fused:
                ed, unfilled = _open_raw_unfilled(f, sonar_model, xml_path, use_swap)
            else:
                ed, unfilled = open_raw(f, sonar_model=sonar_model, use_swap=use_swap,
                                        xml_path=xml_path), {}
            bp = retrieve_correct_beam_group(ed, waveform_mode, encode_mode)
            eds.append(ed)
            beam_paths.append(bp)
            layouts.append(unfilled.get(bp))
            ping_times.append(np.asarray(ed[bp].coords["ping_time"].values,
                                         dtype="datetime64[ns]"))
    chans = list(eds[0][beam_paths[0]].coords["channel"].values)
    for ed, bp in zip(eds[1:], beam_paths[1:]):
        if list(ed[bp].coords["channel"].values) != chans:
            raise ValueError("all raw files must share the same channels")
    fd = None
    if freq_diff is not None:
        fd = _resolve_freq_diff(freq_diff, chans,
                                eds[0][beam_paths[0]].get("frequency_nominal"))
    multi_epoch = [_n_filter_times(ed) > 1 for ed in eds]
    if device_fused and mesh is not None:
        logger.warning("device_fused complex streaming has no mesh path; using the "
                       "chunked compute_Sv path")
    elif device_fused:
        if fd is None or not any(multi_epoch):
            return _run_complex_fused(eds, beam_paths, layouts, chans, ping_times,
                                      ping_time_bin, range_bin_m, chunk_pings, sv_kw, timer,
                                      dev, fd=fd)
        logger.warning("device_fused freq_diff with multi-filter_time files uses the "
                       "chunked compute_Sv path")
        for ed, bp, layout in zip(eds, beam_paths, layouts):
            if layout is not None:
                layout.fill(ed[bp])

    # global range extent: calibrate one probe ping per file, scaled by the
    # file's worst sample-interval ratio
    r_max = 0.0
    with timer.stage("range_probe"):
        for ed, bp in zip(eds, beam_paths):
            probe = compute_Sv(_slice_echodata_pings(ed, bp, slice(0, 1)), **sv_kw)
            er1 = np.asarray(probe["echo_range"].values, dtype="f8")  # [C, 1, R]
            si = np.asarray(ed[bp]["sample_interval"].values, dtype="f8")
            ratio = np.nanmax(np.nanmax(si, axis=-1) / np.maximum(si[..., 0], 1e-30))
            r_max = max(r_max, float(np.nanmax(er1[:, 0, -1]) * max(ratio, 1.0)))

    # work units: (file, its epoch slice dict or None, the unit's ping indices)
    units, unit_times = [], []
    for ed, bp, pt, multi in zip(eds, beam_paths, ping_times, multi_epoch):
        if multi and fd is None:
            for sd in epoch_slice_dicts(ed[bp], ed["Vendor_specific"]):
                keep = pt >= np.datetime64(sd["beam_group_start_time"], "ns")
                if sd["beam_group_end_time"] is not None:
                    keep &= pt <= np.datetime64(sd["beam_group_end_time"], "ns")
                idxs = np.nonzero(keep)[0]
                if len(idxs):
                    units.append((ed, bp, pt, multi, sd, idxs))
                    unit_times.append(pt[idxs])
        else:
            units.append((ed, bp, pt, multi, None, None))
            unit_times.append(pt)
    plan = _SurveyPlan.over_ping_time(ping_times, ping_time_bin, r_max, range_bin_m, chunk_pings,
                                      len(chans), mesh, unit_times)
    # complex-channel echo_range is affine in the sample index: ping-invariant
    # wherever the file's sample interval is
    uniform = all(
        bool(np.all(si == si[..., :1]))
        for si in (np.asarray(ed[bp]["sample_interval"].values, dtype="f8")
                   for ed, bp in zip(eds, beam_paths))
    )
    acc = plan.accumulator(len(chans), timer)
    ch_pos = {str(c): i for i, c in enumerate(chans)}
    enc_edges = binning._to_dev(np.arange(plan.n_r + 1), dev)
    masked = _fd_mask(fd) if fd is not None else (lambda sv: sv)

    def bin_chunk(sv, er, x_rel):
        """Bin one calibrated chunk (Sv [C, P, R], its echo_range):
        membership on the host in float64, the mask and sums on the device
        (on the mesh's blocks, padded pings NaN and parked past the
        window)."""
        sv = np.asarray(sv, dtype="f4")
        er = np.asarray(er, dtype="f8")
        er = binning.exact_bin_encode_np(np.broadcast_to(er, sv.shape), plan.range_edges)[0]
        pad = plan.mesh_pad(sv.shape[1])
        step = sharded_binned_partials(_channel_mesh(mesh, sv.shape[0]), plan.window,
                                       uniform_er=uniform, device=dev)
        s, c, _ = step(masked(binning._to_dev(_pad_pings(sv, pad), dev)),
                       binning._to_dev(_pad_pings(er, pad), dev), enc_edges,
                       binning._to_dev(plan.park(x_rel, pad), dev, "i4"))
        return s, c

    def chunk_sv(ds):
        return ds["Sv"].values, ds["echo_range"].values

    for (ed, bp, pt, multi, sd, idxs), x_ids in zip(units, plan.x_ids):
        if multi and sd is None:  # freq_diff: the whole file's Sv, every channel on one grid
            with timer.stage("chunk_calibrate"):
                sv_full, er_full = chunk_sv(compute_Sv(ed, **sv_kw))
                er_full = np.broadcast_to(er_full, sv_full.shape)
        for sl, x_base, x_rel in plan.chunks(x_ids):
            with timer.stage("chunk_calibrate"):
                if sd is not None:
                    sd_chunk = dict(sd, beam_group_start_time=pt[idxs[sl.start]],
                                    beam_group_end_time=pt[idxs[sl.stop - 1]])
                    sv, er = chunk_sv(CalibrateEK80(
                        ed, env_params, cal_params, waveform_mode=waveform_mode,
                        encode_mode=encode_mode, precision="float32", device=dev,
                        slice_dict=sd_chunk,
                    ).compute_Sv())
                elif multi:
                    sv, er = sv_full[:, sl], er_full[:, sl]
                else:
                    sv, er = chunk_sv(compute_Sv(_slice_echodata_pings(ed, bp, sl), **sv_kw))
            with timer.stage("device_binning"):
                s, c = bin_chunk(sv, er, x_rel)
            if sd is None:
                acc.push(s, c, x_base)
            else:  # one channel's partials
                acc.push(s[0], c[0], x_base, ch=ch_pos[sd["channel"]])
    sums, counts = acc.finish()
    return _finalize(sums, counts, chans, plan, timer, dev)


class _ComplexChunkStage:
    """Each (channel, chunk) of a complex beam group as float32 [n, R, B]
    samples and its valid lengths, staged for the fused step.

    One buffer pair of ``rows`` x R x B float32 serves every chunk of the
    call, made again only for a file of another R or B.  The group's
    ``ComplexLayout`` writes each chunk into it (``copy_pings``: torch's
    ``copy_`` on its intra-op threads): from the parser's float32 planes,
    ``np.asarray(group, "f4")`` of the filled float64 group bit for bit (a
    signalling NaN excepted, which the round trip through float64 would
    quiet); from a group's own samples, narrowed with round to nearest
    even.  On a card the pair is page-locked, so the step's copy to the
    card reads pinned memory, and that copy is blocking: the pair is free
    for the next chunk when the step returns.  The step keeps no reference
    to what it is handed, so each chunk may overwrite the last.  On the CPU
    the chunk goes out as a NumPy view, which the step counts as bytes
    taken from outside the device, as it counts the card's copy.
    """

    def __init__(self, rows, dev):
        self.rows = rows
        self.pinned = dev.type == "cuda"
        self.bufs = ()
        self.layout = None

    def file(self, layout):
        """Take one file's group layout for :meth:`chunk`."""
        shape = (self.rows, layout.max_r, layout.n_beam)
        if not self.bufs or self.bufs[0].shape != shape:
            self.bufs = tuple(torch.empty(shape, dtype=torch.float32, pin_memory=self.pinned)
                              for _ in range(2))
        self.layout = layout

    def chunk(self, ci, sl):
        """(bs_r, bs_i, valid_len) of channel ``ci``'s pings ``sl``:
        float32 [n, R, B] in the buffer pair, and the non-NaN samples of
        sector 0 along R (int32 [n]; a count, not the end of the first
        run, so an interior NaN shortens it by one).  Counters
        ``bb_pinned_bytes``: the bytes staged in page-locked memory;
        ``bb_plane_pings``: the pings staged from the parser's planes."""
        with stage("bb_host_stage"):
            n = sl.stop - sl.start
            r, i = (b[:n] for b in self.bufs)
            self.layout.copy_pings(ci, sl, r, i)
            valid_len = (~torch.isnan(r[..., 0])).sum(dim=1, dtype=torch.int32).numpy()
            if self.layout.planes:
                count("bb_plane_pings", n)
            if self.pinned:
                count("bb_pinned_bytes", 2 * r.numel() * r.element_size())
                return r, i, valid_len
            return r.numpy(), i.numpy(), valid_len


def _run_complex_fused(eds, beam_paths, layouts, chans, ping_times, ping_time_bin,
                       range_bin_m, chunk_pings, sv_kw, timer, dev, fd=None):
    """Fused complex-channel streaming: one device pass per (channel, chunk)
    does pulse compression, received power, Sv and the window bins
    (``ops/bb_pipeline.bb_chunk_window_partials``), float32 end to end.

    Calibration resolves per file, or per (channel, filter epoch) for
    multi-``filter_time`` files with the chunked path's partition: each
    work item owns one parameter set and one replica per channel.
    With ``fd`` (single-``filter_time`` files) each channel's chunk runs to
    Sv alone (``bb_chunk_sv``), the chunk's channels stack on the device in
    survey order, the cross-channel mask applies, and one binning pass
    takes the stack.

    ``layouts`` holds each file's group layout, or None where the group
    holds its samples: each (channel, chunk) is staged from it.
    """
    from ..calibrate.api import epoch_slice_dicts
    from ..calibrate.ek80 import CalibrateEK80
    from ..calibrate.ek80_complex import get_norm_fac
    from ..ops.bb_pipeline import bb_chunk_sv, bb_chunk_window_partials

    waveform_mode = sv_kw["waveform_mode"]
    do_pc = waveform_mode in ("BB", "FM")
    cals, scals, file_layouts, r_max = [], [], [], 0.0
    with timer.stage("param_resolution"):
        for ed, bp, layout in zip(eds, beam_paths, layouts):
            slice_dicts = (epoch_slice_dicts(ed[bp], ed["Vendor_specific"])
                           if _n_filter_times(ed) > 1 else [{}])
            for sd in slice_dicts:
                with stage("bb_params"):
                    cal = CalibrateEK80(ed, sv_kw["env_params"], sv_kw["cal_params"],
                                        waveform_mode=waveform_mode,
                                        encode_mode=sv_kw["encode_mode"], slice_dict=sd)
                    if cal.beam.sizes["ping_time"] == 0:
                        continue
                    scal = cal._complex_sv_scalars()
                cals.append(cal)
                scals.append(scal)
                file_layouts.append(layout)
                # the last sample sits at (R - 1) * dr
                r_max = max(r_max, float(np.nanmax(scal["dr"])) * (cal.beam.sizes["range_sample"]
                                                                   - 1))
    plan = _SurveyPlan.over_ping_time(
        ping_times, ping_time_bin, r_max, range_bin_m, chunk_pings, len(chans),
        unit_times=[np.asarray(cal.beam.coords["ping_time"].values, dtype="datetime64[ns]")
                    for cal in cals])
    r_edges_f4 = plan.range_edges.astype("f4")
    acc = plan.accumulator(len(chans), timer)
    ch_pos = {str(c): i for i, c in enumerate(chans)}
    staged = _ComplexChunkStage(min(plan.chunk_pings, max(map(len, plan.x_ids), default=0)),
                                dev)

    for cal, scal, layout, x_ids in zip(cals, scals, file_layouts, plan.x_ids):
        with timer.stage("param_resolution"):
            beam = cal.beam
            n_ch, n_ping = beam.sizes["channel"], beam.sizes["ping_time"]
            ch_ids = [str(c) for c in beam.coords["channel"].values]
            with stage("bb_params"):  # prx's impedance term, the replicas and their norms
                n_beam = beam.sizes.get("beam", 1)
                # per-ping impedance coefficient of prx (calibrate_ek.py:456-505)
                z_er = cal._to_cp(scal["z_er"], n_ch, n_ping)
                z_et = cal._to_cp(scal["z_et"], n_ch, n_ping)
                z_coef = (n_beam / 8.0 * (np.abs(z_er + z_et) / z_er) ** 2 / z_et).astype("f4")
                norm = get_norm_fac(scal["tx"])
                dr, shift, alpha, offset = (scal[k].astype("f4")
                                            for k in ("dr", "shift", "alpha", "offset"))
                uniform_er = bool(np.all(dr == dr[:, :1]))
                reps = []
                for cid in ch_ids:
                    rep = np.flipud(np.conj(np.asarray(scal["tx"][cid])))
                    reps.append((
                        *(np.ascontiguousarray(a, dtype="f4") for a in (rep.real, rep.imag)),
                        np.float32(1.0 / float(norm.sel(channel=cid).values)) if do_pc else 1.0,
                    ))
            with stage("bb_host_stage"):  # the samples' source, the TVG boundary
                if layout is None:
                    layout = ComplexLayout.of_group(beam["backscatter_r"].values,
                                                    beam["backscatter_i"].values)
                else:  # the epoch's channel and pings
                    layout = layout.select(ch_ids, beam.coords["ping_time"].values)
                staged.file(layout)
                # the first sample with r_tvg > 0, decided in float64 (the
                # chunked path's boundary sample)
                k0 = np.maximum(np.floor(scal["shift"] / np.maximum(scal["dr"], 1e-30)) + 1,
                                0).astype("i4")
        if fd is not None:
            masked = _fd_mask(fd)
            r_edges_t = binning._to_dev(r_edges_f4, dev)
            for sl, x_base, x_rel in plan.chunks(x_ids):
                with timer.stage("device_fused"):
                    by_pos = {}
                    for ci, cid in enumerate(ch_ids):
                        hr, hi, inv_norm = reps[ci]
                        bs_r, bs_i, valid_len = staged.chunk(ci, sl)
                        by_pos[ch_pos[cid]] = bb_chunk_sv(
                            bs_r, bs_i, hr, hi, inv_norm,
                            z_coef[ci, sl], dr[ci, sl], shift[ci, sl], alpha[ci, sl],
                            offset[ci, sl], k0[ci, sl], valid_len, do_pc, device=dev)
                    sv = masked(torch.stack([by_pos[i][0] for i in range(len(chans))]))
                    er = torch.stack([by_pos[i][1] for i in range(len(chans))])
                    s, c, _ = binning.binned_window_partials(
                        sv, er, r_edges_t, binning._to_dev(x_rel, dev, "i4"), plan.window,
                        uniform_er=uniform_er)
                acc.push(s, c, x_base)
            continue
        for ci, cid in enumerate(ch_ids):
            hr, hi, inv_norm = reps[ci]
            for sl, x_base, x_rel in plan.chunks(x_ids):
                with timer.stage("device_fused"):
                    bs_r, bs_i, valid_len = staged.chunk(ci, sl)
                    s, c = bb_chunk_window_partials(
                        bs_r, bs_i, hr, hi, inv_norm, z_coef[ci, sl],
                        dr[ci, sl], shift[ci, sl], alpha[ci, sl], offset[ci, sl], k0[ci, sl],
                        valid_len, x_rel, r_edges_f4, plan.window, do_pc,
                        uniform_er=uniform_er, device=dev,
                    )
                acc.push(s, c, x_base, ch=ch_pos[cid])
    sums, counts = acc.finish()
    return _finalize(sums, counts, chans, plan, timer, dev)


# ------------------------------------------------------- Sv stores -> grids


def _sv_providers(sv_sources, reopen):
    """Zero-argument providers of the sources' Datasets, and ``reopen``
    resolved as the JAX package does: True by default only when every
    source is a path (reopening a path is cheap and has no side effect; a
    caller's callable is not invoked twice unless asked)."""
    sv_sources = list(sv_sources)
    if not sv_sources:
        raise ValueError("no Sv sources provided")
    if reopen is None:
        reopen = all(isinstance(s, (str, Path)) for s in sv_sources)
    providers = [src if callable(src) else (lambda s=src: open_source(s, "dataset"))
                 for src in sv_sources]
    return providers, reopen


def _check_channels(chans, ds):
    got = list(ds.coords["channel"].values)
    if chans is not None and got != chans:
        raise ValueError("all Sv sources must share the same channels")
    return got


def run_survey_mvbs(
    sv_sources,
    range_bin="20m",
    ping_time_bin: str = "20s",
    range_var: str = "echo_range",
    chunk_pings: int = 5000,
    timer: StageTimer = None,
    mesh=None,
    freq_diff=None,
    noise_masks=None,
    reopen=None,
    range_bin_m: float = None,
    device="cuda",
):
    """Stream Sv stores/datasets into survey-global MVBS bins.

    The arguments are the JAX package's; ``device`` ("cuda" by default,
    "cpu" for the plain PyTorch path) is where the bin sums run.

    sv_sources : Datasets, store paths, or zero-argument callables returning
        a Dataset (calibrated Sv, chronologically ordered).
    range_bin : '20m'-style string, or a bare float in metres
        (``range_bin_m=`` is the deprecated alias).
    reopen : re-acquire each source in the binning pass instead of keeping
        every dataset from the extent scan (one file in host memory at a
        time).  None resolves to True only when every source is a path.

    Each file takes the grid route when its range grid is the same for
    every ping (NaN holes included), decided per file (the JAX package
    decides once for the survey, a static argument of its jitted step);
    the others take the per-ping route, where each sample adds into the bin
    the host's float64 membership gives it (``binned_window_partials``; the
    JAX package's prefix sums there lose quiet bins).
    freq_diff : frequency-differencing criterion ('"chA" - "chB" > 3dB',
        '120kHz - 38kHz > 6dB', or a dict); each chunk's Sv is masked
        across channels on the device before the bins (apply_mask
        semantics: a masked sample joins no bin on any channel).
    noise_masks : {"impulse": {...}, "transient": {...}, "attenuated":
        {...}}, each value the keywords of the matching ``clean.mask_*``
        function, run on ``device`` over each whole file; a sample any
        mask flags joins no bin (the composition clean.mask_* ->
        apply_mask -> binning, per file).
    mesh : ``parallel.make_mesh`` grid of devices (a mesh of another kind
        raises ``TypeError``); each chunk, rounded up to a multiple of the
        ping shards and padded with NaN pings parked past the window,
        splits over the mesh (``pipeline.sharded_binned_partials`` /
        ``sharded_binned_partials_grid``); the mask and the partials' sums
        run on the mesh's first device.

    Returns an MVBS Dataset on the union (ping_time bin, range bin) grid;
    ``attrs`` carry ``device``, ``routes`` (one per source, "grid" or
    "per_ping") and ``stage_timing``.
    """
    mesh, dev = _mesh_and_device(mesh, device)
    _check_noise_masks(noise_masks)
    timer = timer or StageTimer()
    range_bin_m = _resolve_bin_m(range_bin, range_bin_m)
    providers, reopen = _sv_providers(sv_sources, reopen)

    # pass 1: global extents and channels
    datasets = [None] * len(providers)
    ping_times = []
    chans = freq_nom = None
    r_max = 0.0
    with timer.stage("scan_extents"):
        for i, provider in enumerate(providers):
            ds = provider()
            if chans is None:
                freq_nom = ds.get("frequency_nominal")
            chans = _check_channels(chans, ds)
            ping_times.append(np.asarray(ds.coords["ping_time"].values, dtype="datetime64[ns]"))
            r_max = max(r_max, float(np.nanmax(np.asarray(ds[range_var].values, dtype="f8"))))
            if not reopen:
                datasets[i] = ds

    plan = _SurveyPlan.over_ping_time(ping_times, ping_time_bin, r_max, range_bin_m, chunk_pings,
                                      len(chans), mesh)
    grid_step = sharded_binned_partials_grid(mesh, plan.window, device=dev)
    step = sharded_binned_partials(mesh, plan.window, device=dev)

    fd = _resolve_freq_diff(freq_diff, chans, freq_nom)
    masked = _fd_mask(fd) if fd is not None else (lambda sv: sv)
    acc = plan.accumulator(len(chans), timer)
    enc_edges = binning._to_dev(np.arange(plan.n_r + 1), dev)
    routes = []
    for i, x_ids in enumerate(plan.x_ids):
        ds, datasets[i] = datasets[i], None
        if ds is None:  # reopen: one file in host memory at a time
            with timer.stage("reopen"):
                ds = providers[i]()
        sv_all = np.asarray(ds["Sv"].values, dtype="f4")
        if noise_masks:
            sv_all = _apply_noise_masks(ds, sv_all, noise_masks, timer, dev)
        with timer.stage("host_prep"):
            er_all = np.asarray(ds[range_var].values, dtype="f8")
            if er_all.shape != sv_all.shape:
                er_all = np.broadcast_to(er_all, sv_all.shape)
            row, use_grid = binning.ping_invariant_row(er_all)
            if use_grid:
                row = binning._to_dev(binning.exact_bin_encode_np(row, plan.range_edges)[0], dev)
        routes.append("grid" if use_grid else "per_ping")
        for sl, x_base, x_rel in plan.chunks(x_ids):
            pad = plan.mesh_pad(sl.stop - sl.start)  # padded pings: NaN, parked past the window
            if not use_grid:
                with timer.stage("encode"):
                    er_enc = binning.exact_bin_encode_np(er_all[:, sl], plan.range_edges)[0]
            with timer.stage("device_binning"):
                sv = masked(binning._to_dev(_pad_pings(sv_all[:, sl], pad), dev))
                x_rel = binning._to_dev(plan.park(x_rel, pad), dev, "i4")
                if use_grid:
                    s, c, _ = grid_step(sv, row, enc_edges, x_rel)
                else:
                    s, c, _ = step(sv, binning._to_dev(_pad_pings(er_enc, pad), dev), enc_edges,
                                   x_rel)
            acc.push(s, c, x_base)
        del ds, sv_all, er_all
    sums, counts = acc.finish()
    return _finalize(sums, counts, chans, plan, timer, dev, range_var, routes)


def run_survey_nasc(
    sv_sources,
    range_bin: str = "10m",
    dist_bin: str = "0.5nmi",
    chunk_pings: int = 5000,
    timer: StageTimer = None,
    mesh=None,
    skipna: bool = True,
    closed: str = "left",
    noise_masks=None,
    device="cuda",
):
    """Stream Sv stores/datasets into survey-global NASC (distance x depth).

    The arguments are the JAX package's, plus ``device`` ("cuda" by
    default, "cpu" for the plain PyTorch path).  Store paths are read twice
    with one file in host memory at a time, as :func:`run_survey_mvbs` does
    by default (the JAX package keeps every dataset).
    Cumulative along-track distance continues across files, the geodesic
    gap between one file's last fix and the next file's first included;
    each ping chunk reduces on ``device`` through the window partials; the
    mean ping time and positions of each distance bin add up on the host
    in float64.  Bin-exact with ``commongrid.compute_NASC`` on one dataset
    (reference commongrid/api.py:270-416, utils.py:97-207).

    sv_sources : Datasets, store paths, or zero-argument callables, in
        chronological order, each with Sv, ``depth`` and latitude/longitude
        (``consolidate.add_depth`` / ``add_location``).

    Files on a ping-invariant depth grid take the grid route (one encoded
    depth row, and the height sums as that row times each bin's ping
    count); the others the per-ping route, as in :func:`run_survey_mvbs`.
    ``noise_masks`` as in :func:`run_survey_mvbs`: the ``clean`` masks run
    on each whole file and a flagged sample joins no bin.  ``mesh`` as in
    :func:`run_survey_mvbs` (the height sums through
    ``pipeline.sharded_binned_sum_raw`` / ``sharded_binned_row_sum``).
    ``attrs`` carry ``device`` and ``routes`` as in
    :func:`run_survey_mvbs`.
    """
    mesh, dev = _mesh_and_device(mesh, device)
    _check_noise_masks(noise_masks)
    timer = timer or StageTimer()
    range_bin_m = _parse_x_bin(range_bin, "range_bin")
    dist_bin_nmi = _parse_x_bin(dist_bin, "dist_bin")
    providers, reopen = _sv_providers(sv_sources, None)

    # pass 1: per-file cumulative distance (global, gap-linked), depth extent
    datasets = [None] * len(providers)
    dists = []
    chans = t0_ns = prev_fix = None
    offset = depth_max = 0.0
    with timer.stage("scan_extents"):
        for i, provider in enumerate(providers):
            ds = provider()
            if "depth" not in ds:
                raise ValueError(
                    "Input Sv dataset must contain 'depth' (use consolidate.add_depth)"
                )
            chans = _check_channels(chans, ds)
            if t0_ns is None:  # t0-relative ns keep the f8 time sums exact
                t0_ns = int(np.asarray(ds.coords["ping_time"].values[0],
                                       dtype="datetime64[ns]").astype("i8"))
            d = get_distance_from_latlon(ds)
            lat = np.asarray(ds["latitude"].values, dtype="f8")
            lon = np.asarray(ds["longitude"].values, dtype="f8")
            good = np.nonzero(~(np.isnan(lat) | np.isnan(lon)))[0]
            if prev_fix is not None and len(good):
                gap = pairwise_distance_nmi(
                    np.array([prev_fix[0], lat[good[0]]]),
                    np.array([prev_fix[1], lon[good[0]]]),
                )[0]
                if np.isfinite(gap):
                    offset += float(gap)
            dists.append(d + offset)
            offset = float(dists[-1][-1])
            if len(good):
                prev_fix = (lat[good[-1]], lon[good[-1]])
            depth_max = max(depth_max, float(np.nanmax(np.asarray(ds["depth"].values,
                                                                   dtype="f8"))))
            if not reopen:
                datasets[i] = ds

    dist_max = max(float(np.nanmax(d)) for d in dists)
    dist_edges = np.arange(0, dist_max + dist_bin_nmi, dist_bin_nmi)
    n_x = len(dist_edges) - 1
    side = "right" if closed == "left" else "left"
    # distance-bin ids per file (cumulative distance is non-decreasing)
    x_ids = [np.clip(np.searchsorted(dist_edges, d, side=side) - 1, 0, n_x - 1).astype("i4")
             for d in dists]
    plan = _SurveyPlan(x_ids, dist_edges, depth_max, range_bin_m, chunk_pings, len(chans), mesh)
    window, depth_edges = plan.window, plan.range_edges
    # depth membership is encoded (idx + 0.5 against integer edges): the
    # per-ping route needs no ``closed``
    step_sv = sharded_binned_partials(mesh, window, skipna=bool(skipna), device=dev)
    step_h = sharded_binned_sum_raw(mesh, window, device=dev)
    grid_sv = sharded_binned_partials_grid(mesh, window, skipna=bool(skipna), closed=closed,
                                           device=dev)
    grid_h = sharded_binned_row_sum(mesh, window, closed=closed, device=dev)

    acc = plan.accumulator(len(chans), timer, n_out=4)
    denom = np.zeros(n_x, dtype="f8")
    pt_sum = np.zeros(n_x, dtype="f8")
    pos_sum = np.zeros((2, n_x), dtype="f8")
    pos_cnt = np.zeros((2, n_x), dtype="f8")
    # membership (depth vs depth_edges) resolves on the host in f64 and ships
    # encoded; ddep stays physical depth differences (the height integrand)
    enc_edges = binning._to_dev(np.arange(plan.n_r + 1), dev)
    routes = []
    for i, x_ids in enumerate(plan.x_ids):
        ds, datasets[i] = datasets[i], None
        if ds is None:
            with timer.stage("reopen"):
                ds = providers[i]()
        sv_all = np.asarray(ds["Sv"].values, dtype="f4")
        if noise_masks:
            sv_all = _apply_noise_masks(ds, sv_all, noise_masks, timer, dev)
        with timer.stage("host_prep"):
            depth = np.asarray(ds["depth"].values, dtype="f8")
            depth_b = np.broadcast_to(
                _conform_range(depth, ds, "depth", sv_all.shape), sv_all.shape)
            sv_all, depth_b = _orient_range_axis(sv_all, depth_b)
            row, use_grid = binning.ping_invariant_row(depth_b)
            if use_grid:
                ddep_row = binning._to_dev(np.diff(row, axis=1), dev)
                lower_row = binning._to_dev(
                    binning.exact_bin_encode_np(row[:, :-1], depth_edges, closed)[0], dev)
                row = binning._to_dev(
                    binning.exact_bin_encode_np(row, depth_edges, closed)[0], dev)
            pt_rel = (np.asarray(ds.coords["ping_time"].values, dtype="datetime64[ns]")
                      .astype("i8") - t0_ns).astype("f8")
            pos = [np.asarray(ds[v].values, dtype="f8") for v in ("latitude", "longitude")]
        routes.append("grid" if use_grid else "per_ping")
        for sl, x_base, x_rel in plan.chunks(x_ids):
            pad = plan.mesh_pad(sl.stop - sl.start)  # padded pings: NaN, parked past the window
            if not use_grid:
                with timer.stage("encode"):
                    dep_phys = depth_b[:, sl]
                    ddep = _pad_pings(np.diff(dep_phys, axis=2), pad)
                    dep_enc = _pad_pings(
                        binning.exact_bin_encode_np(dep_phys, depth_edges, closed)[0], pad)
            with timer.stage("device_binning"):
                sv = binning._to_dev(_pad_pings(sv_all[:, sl], pad), dev)
                x_rel = binning._to_dev(plan.park(x_rel, pad), dev, "i4")
                if use_grid:
                    s, c, nc = grid_sv(sv, row, enc_edges, x_rel)
                    h = grid_h(ddep_row, lower_row, enc_edges, x_rel)
                else:
                    dep_t = binning._to_dev(dep_enc, dev)
                    s, c, nc = step_sv(sv, dep_t, enc_edges, x_rel)
                    h = step_h(binning._to_dev(ddep, dev), dep_t[:, :, :-1], enc_edges, x_rel)
            acc.push(s, c, nc, h, x_base)
            with timer.stage("host_sums"):
                ids = x_ids[sl]
                denom += np.bincount(ids, minlength=n_x)
                pt_sum += np.bincount(ids, weights=pt_rel[sl], minlength=n_x)
                for k, v in enumerate(pos):
                    ok = np.isfinite(v[sl])
                    pos_sum[k] += np.bincount(ids[ok], weights=v[sl][ok], minlength=n_x)
                    pos_cnt[k] += np.bincount(ids[ok], minlength=n_x)
        del ds, sv_all, depth, depth_b
    sums, counts, nan_counts, h_num = acc.finish()

    with timer.stage("finalize"):
        with np.errstate(invalid="ignore", divide="ignore"):
            good = (counts > 0) & (nan_counts == 0)
            sv_mean = np.where(good, sums / np.where(counts > 0, counts, 1), np.nan)
            h_mean = h_num / np.where(denom > 0, denom, np.nan)[None, :, None]
            nasc = sv_mean * h_mean * 4 * np.pi * 1852**2
            pt_mean = t0_ns + pt_sum / np.where(denom > 0, denom, np.nan)
            positions = pos_sum / np.where(pos_cnt > 0, pos_cnt, np.nan)
        out = Dataset(
            coords={
                "channel": np.asarray(chans, dtype=object),
                "distance": dist_edges[:-1],
                "depth": depth_edges[:-1],
            }
        )
        out["NASC"] = (
            ("channel", "distance", "depth"),
            nasc,
            {
                "long_name": "Nautical Areal Scattering Coefficient (NASC, m2 nmi-2)",
                "units": "m2 nmi-2",
            },
        )
        pt_out = np.where(np.isfinite(pt_mean), pt_mean,
                          np.datetime64("NaT", "ns").astype("i8"))
        out["ping_time"] = (
            ("distance",),
            pt_out.astype("i8").astype("datetime64[ns]"),
            {"long_name": "Mean ping time in distance bin"},
        )
        for k, var in enumerate(("latitude", "longitude")):
            out[var] = (("distance",), positions[k])
        out.coords["distance"].attrs = {"long_name": "Cumulative distance", "units": "nmi"}
        out.coords["depth"].attrs = {"long_name": "Cell depth", "units": "m"}
        prov = echopype_prov_attrs("processing")
        prov["processing_function"] = "parallel.run_survey_nasc"
        out.attrs.update(prov)
        out.attrs["stage_timing"] = str(timer.report(log=False))
        out.attrs["device"] = device_name(dev)
        out.attrs["routes"] = routes
    return out
