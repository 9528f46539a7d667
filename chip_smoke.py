#!/usr/bin/env python3
"""Drive echopype_torch's survey, Sv-grid, masking and EK80 paths once on a CUDA card.

Run from the root of a checkout, with no arguments, on a machine with one
NVIDIA card (H100), nvcc and PyTorch built for CUDA:

    python3 chip_smoke.py

Phases (each prints one line; any failure raises, so the exit code is not 0):

1. start: the card's name and power limit (nvidia-smi), torch / CUDA /
   scipy versions, ``torch.backends.cuda.matmul.allow_tf32``, and whether
   the port's native ingest scanner (g++, built into
   ``echopype_torch/native/``) loaded; fails at once where
   ``torch.cuda.is_available()`` is false;
2. build the CUDA kernels from ``echopype_torch/csrc/`` (one nvcc per
   source, all started together), timed;
3. K1 (``window_partials_uniform``) at the survey's chunk shape (5 channels x
   5,000 pings x 4,000 int16 samples, 20 m range bins at dr ~0.19 m, 251
   twenty-second ping bins) against its plain PyTorch twin on the card:
   counts exact, sums within rtol 1e-5, two kernel runs bit-identical, both
   timed with CUDA events (median of 20), with the kernel's bound (bytes,
   or the instructions the function needs, at the H100's published peaks)
   and its share; then the same
   at two coarse windows (W = 2, most of the chunk in one window, so the
   windows' slab partials are combined);
4. K2 (``window_partials``) the same two ways, with dr varying by ping;
5. K3 (``sv_bin_partials``) at the full width, 5 x 5,000 x 4,000 float32
   dB power with a NaN suffix on every 97th ping and scattered interior
   NaNs, dr 0.18944 m, 20 m range bins, against its plain twin on the card:
   Sv within rtol 1e-5 / atol 1e-5 with identical NaN masks, counts exact,
   sums within rtol 1e-5, two runs bit-identical, both timed, and its
   share of the bound (bound ms / ms) at least 0.5;
6. K4 (``mvbs_partials``) the same way for the partials;
7. the survey end to end: three synthetic EK60 files (5 channels,
   18-200 kHz, 4,000 samples a ping; two of 10,000 pings, one of 5,000 whose
   sound speed varies by ping, so it takes K2) through
   ``run_survey_mvbs_from_raw`` on the card; the K1/K2 launch counters must
   equal the chunks each path took, and the MVBS must agree with the same
   call on the CPU (plain twins) within 1e-4 dB with identical NaN masks
   and coordinates;
8. the Sv grids end to end on file A: ``open_raw`` -> ``compute_Sv`` on the
   card -> ``compute_MVBS`` (20 m x 20 s) and ``compute_NASC`` (depth from
   ``consolidate.add_depth`` with the Platform vertical offsets, and a
   synthetic track), each against the same call on the CPU (1e-4 dB, NASC
   rtol 1e-5, identical NaN masks); and
   ``survey_pipeline_step`` with and without Sv (K3, K4) on the same file's
   calibration inputs and compute_MVBS's grid: K3's Sv equals compute_Sv's
   (rtol/atol 1e-5, same NaN mask), its MVBS equals compute_MVBS's within
   1e-4 dB, K4's MVBS equals K3's within 1e-3 dB, one launch each;
9. the Sv-store surveys: files A, B and C through open_raw -> compute_Sv
   (card) -> add_depth -> track -> an uncompressed zarr store each, then
   ``run_survey_mvbs`` (20 m x 20 s) and ``run_survey_nasc`` (10 m x 0.5
   nmi) over the three stores on the card and on the CPU: MVBS within 1e-4
   dB, NASC rtol 1e-5, identical NaN masks, coordinates and mean ping
   times, finite share above 0.9; A and B take the grid route and C (sound
   speed by ping) the per-ping route; no CUDA kernel launches; and each
   streamer on A's store alone equals the Sv-grid phase's compute_MVBS /
   compute_NASC on A (1e-4 dB, rtol 1e-5); ``run_survey_mvbs`` on C's store
   alone (per-ping route, float32) and ``compute_MVBS`` on C (its per-ping
   route sums in float64) on the card each equal a host float64 numpy
   bincount of C's Sv (1e-4 dB, identical NaN masks); stage seconds of every
   run;
10. masks (``masks``): noise injected into A's and C's stores as
   tests/test_survey_clean.py does (impulse pings, transient blobs,
   attenuated runs); ``clean.mask_impulse_noise`` / ``mask_transient_noise``
   / ``mask_attenuated_signal`` at the JAX package's defaults on all of A on
   the card (walls, flagged counts > 0, peak memory under 20 GB), then each
   device program alone (CUDA events, median of 5, against its bound); the
   three masks on the card twice (bit-identical) and on the CPU over heads
   of A and C, with pooled and upsampled Sv within 1e-4 dB; masks may differ
   only where a sample's margin to the threshold is under 1e-4 dB;
   ``frequency_differencing`` -> ``apply_mask`` on A's card and CPU Sv;
   ``run_survey_mvbs`` (20 m x 20 s) with ``noise_masks`` and with
   ``freq_diff`` and ``run_survey_nasc`` (10 m x 0.5 nmi) with
   ``noise_masks`` over heads of A and C on cuda and cpu (1e-4 dB, NASC rtol
   1e-5, except bins holding a sample whose mask differs between the runs),
   and over all of A fused against the composed chain (equal);
   ``run_survey_mvbs_from_raw`` with ``freq_diff`` over A, B, C (no K1/K2
   launch, one freq-diff step per chunk; bins over 1e-4 dB only where a
   sample sits within 1e-4 dB of the criterion) and with ``noise_masks`` on
   an extra 2,000-ping file; and the broadband freq-diff leg, chunked and
   fused, on a two-FM-channel EK80 file of 1,000 pings at the ek80 phase's
   width;
11. EK80 (``ek80``): two files of tests/synth_ek80.py (70 kHz FM, 120 kHz
   CW complex, 38 kHz GPT power; 2,000 pings x 8,192 samples x 4 sectors
   each, consecutive in time): ``open_raw`` (seconds, each complex
   channel's replica length); ``compute_Sv`` on file A in BB, CW complex
   and CW power on the card, each against the same call on the CPU over
   the first 200 pings (1e-3 dB BB, 1e-4 dB otherwise, identical NaN
   masks) and BB against ``precision="float64"`` there (1e-3 dB, no NaN-mask
   mismatch; p50 / p99 / max printed); the matched filter's matmul alone
   per complex channel, float64 (compute_Sv's) and float32 (the fused
   step's), CUDA events, median of 20, against its bound, with one
   ``conv1d`` computing the same correlation timed beside it; then
   ``run_survey_mvbs_from_raw`` (5 m x 20 s, chunks of 1,000 pings) over
   both files in power mode, BB chunked and BB fused, and CW complex fused
   and chunked on A, each on cuda and cpu: within 1e-4 dB with identical
   NaN masks and coordinates, fused vs chunked within 5e-3 dB (0.2 dB in
   the last range bin, tests/test_survey.py:536-538), K1 + K2 launched
   once per power-mode chunk, nothing launched on cpu; walls, stage
   seconds and pings/s of every run;
12. print the matched filter's and the masks' device programs (plain
   PyTorch, not a Pallas kernel's port) with launches and timings, then the
   kernel table as one JSON line
   (launches on the main paths, the survey's and the ek80 power leg's for
   K1 / K2; error, kernel / plain twin ms, bound ms and what sets it; no
   single PyTorch call computes any of the four functions, so
   ``library_ms`` is null), then the result line ``{"ok": true, "device":
   {...}}`` last.

Imports nothing of JAX.  The synthetic files are written under ``build/``
in the checkout and removed at the end.
"""

import json
import shutil
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
DATA_DIR = ROOT / "build" / "chip_smoke"
CHANNELS = tuple(
    f"GPT {f:3d} kHz 00907203{i:04x} {i + 1}-1 ES{f}" for i, f in enumerate((18, 38, 70, 120, 200))
)
FREQS = (18000.0, 38000.0, 70000.0, 120000.0, 200000.0)
C, P, R = 5, 5000, 4000
RANGE_BIN_M, PING_BIN_S = 20.0, 20
SUM_RTOL, MVBS_ATOL_DB = 1e-5, 1e-4
SV_RTOL = SV_ATOL = 1e-5  # tests/test_parallel.py:63; one f32 ulp at -90 dB is 7.6e-6
K4_VS_K3_DB, NASC_RTOL = 1e-3, 1e-5
MIN_SHARE_OF_BOUND = 0.5  # K3 / K4: bound_ms / ms at the full width
E2E_PINGS = (10_000, 10_000, 5_000)  # files A, B (uniform dr) and C (dr by ping)
KERNEL_SOURCES = ("window_partials", "sv_bin_partials")
COARSE_PING_BIN_S = 4000  # two ping windows over a chunk's 5,000 pings
# the ek80 phase: two files of tests/synth_ek80.py's three channels (70 kHz
# FM, 120 kHz CW complex, 38 kHz GPT power), 4 sectors, the JAX package's
# broadband measurement shape (ops/matched_filter.py:25-29)
EK80_PINGS, EK80_R, EK80_SECTORS = 2000, 8192, 4
EK80_HEAD = 200  # pings of the cpu and float64 compute_Sv checks
EK80_GRID = dict(range_bin="5m", ping_time_bin="20s", chunk_pings=1000)
EK80_CPU_DB = {"BB": 1e-3, "CW_complex": 1e-4, "CW_power": 1e-4}
BB_F64_DB = 1e-3
FUSED_VS_CHUNKED_DB, FUSED_LAST_BIN_DB = 5e-3, 0.2  # tests/test_survey.py:536-538
# the masks phase: noise injected as tests/test_survey_clean.py:35-49 does
# pings of A (grid route) and C (grid by ping) for the masks' card-vs-CPU
# checks and the masked Sv-store surveys: C's pooling runs in float64 and
# its CPU reference takes tens of ms a ping of 5 x 4,000 samples, so C
# takes a shorter head
MASK_HEAD = {"A": 1000, "C": 300}
MASK_SURVEY_PINGS = {"A": 2000, "C": 300}
MASK_RAW_PINGS = 2000  # file D, the raw noise-mask route
FD_BB_PINGS = 1000  # file E, two FM channels, the broadband freq-diff leg
FD_EQ = "38kHz - 18kHz > 3.0dB"  # tests/test_survey_freqdiff.py:64
MASK_MARGIN_DB = 1e-4  # a mask may differ between the card and the CPU under this margin
BB_FD_MARGIN_DB = 1e-3  # broadband Sv, card vs CPU: EK80_CPU_DB["BB"]
# the clean masks of the masked surveys: the JAX package's defaults, with the
# attenuated mask at -8 dB (its default +8 dB flags nearly every ping, where
# the echopy criterion ping - block < threshold takes a negative one to
# isolate attenuation, tests/test_clean.py:130-131)
SURVEY_MASKS = {"impulse": {}, "transient": {},
                "attenuated": {"attenuation_signal_threshold": "-8.0dB"}}
RAW_MASKS = {k: dict(v, range_var="echo_range") for k, v in SURVEY_MASKS.items()}
# H100 SXM peaks at the full 700 W (NVIDIA's data sheet): HBM3 bytes/s and
# float32 operations/s outside the tensor cores.  The latter counts an FMA
# as two: the card issues half as many instructions, 128 lanes a clock per
# SM, and every instruction, whatever its unit, takes one of those slots.
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
INSTR_PER_S = F32_OPS_PER_S / 2
# instructions of the library expf / log10f on sm_90a inside a loop (SASS,
# counted by tools/window_probe.py: 10 and 28, less the constant moves a
# loop hoists)
EXPF_INSTR, LOG10F_INSTR = 8, 25
# instructions a sample needs (what the function computes, not what the
# kernel issues): the int16 -> float conversion (K1, K2) or the sample's
# range k dr - shift (K3, K4: 3), the sonar equation's rounded multiplies
# and adds, the library calls, the adds into the bin sum (and count, K3/K4)
INSTR_PER_SAMPLE = {
    "K1": 1 + 6 + EXPF_INSTR + 1,
    "K2": 1 + 10 + LOG10F_INSTR + EXPF_INSTR + 1,
    "K3": 3 + 5 + LOG10F_INSTR + 1 + EXPF_INSTR + 2,
    "K4": 3 + 3 + 1 + EXPF_INSTR + 2 + 2,
}
K3_SV_INSTR = 3 + 5 + LOG10F_INSTR  # K3 writes Sv for every sample, binned or not


def say(phase, **fields):
    print(f"[{phase}] " + " ".join(f"{k}={v}" for k, v in fields.items()), flush=True)


def cuda_ms(fn, reps=20, warmup=3):
    """Median per-call device time of ``fn`` (CUDA events), in ms."""
    for _ in range(warmup):
        fn()
    events = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
              for _ in range(reps)]
    for start, end in events:
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in events)


def bound_ms(nbytes, instr):
    """Least time for ``nbytes`` of memory traffic and ``instr`` instructions
    at the card's peaks, in ms, and which of the two sets it."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, instr / INSTR_PER_S * 1e3
    return {"bound_ms": max(t_bytes, t_ops), "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


def chunk_inputs(seed, vary_dr, ping_bin_s=PING_BIN_S):
    """One survey chunk at the main path's shape, made from ``seed``."""
    rng = np.random.default_rng(seed)
    power = rng.integers(-12000, -2000, (C, P, R), dtype=np.int16)
    dr = np.full((C, P), 256e-6 * 1480.0 / 2.0, "f4")  # 0.18944 m
    if vary_dr:
        dr = (dr * rng.uniform(0.97, 1.03, (C, P))).astype("f4")
    shift = (2.0 * dr).astype("f4")
    ab = np.tile(rng.uniform(0.002, 0.05, (C, 1)), (1, P)).astype("f4")
    off = rng.normal(-30.0, 2.0, (C, P)).astype("f4")
    vl = np.full((C, P), R, "i4")
    vl[:, ::97] = rng.integers(0, R, vl[:, ::97].shape)  # some short pings
    t = 7.0 + np.arange(P)  # 1 Hz pings, not aligned to the bin edges
    ids = (t // ping_bin_s).astype("i4")
    x_rel = ids - ids[0]
    W = int(x_rel[-1]) + 1
    r_bound = R * 256e-6 * 1700.0 / 2.0  # the streamer's scanned range bound
    edges = np.arange(0, r_bound + RANGE_BIN_M, RANGE_BIN_M).astype("f4")
    return power, dr, shift, ab, off, vl, x_rel, edges, W


def kernel_phase(name, uniform, seed, ping_bin_s=PING_BIN_S):
    from echopype_torch.ops import window_partials as wp
    from echopype_torch.parallel.pipeline import (
        closed_bounds_k0_np, closed_window_counts_np, kernel_inputs_from_numpy)

    args = chunk_inputs(seed, vary_dr=not uniform, ping_bin_s=ping_bin_s)
    dev = torch.device("cuda")
    t0 = time.perf_counter()
    ops = kernel_inputs_from_numpy(*args, uniform=uniform, device=dev)
    torch.cuda.synchronize()
    h2d_s = time.perf_counter() - t0
    if uniform:
        kernel, plain = wp.window_partials_uniform, wp.window_partials_uniform_plain
    else:
        kernel, plain = wp.window_partials, wp.window_partials_plain
    plain_ops = {k: v for k, v in ops.items() if k != "plan"}  # plan: the kernel's work split
    got, again, want = kernel(**ops), kernel(**ops), plain(**plain_ops)
    torch.cuda.synchronize()
    bit_identical = all(torch.equal(a, b) for a, b in zip(got, again))
    s_k, c_k = (t.double().cpu().numpy() for t in got)
    s_p, c_p = (t.double().cpu().numpy() for t in want)
    counts_exact = np.array_equal(c_k, c_p)
    if uniform:  # the survey's host closed-form counts agree too
        power, dr, shift, _, _, vl, x_rel, edges, W = args
        bounds, k0 = closed_bounds_k0_np(dr[:, 0], shift[:, 0], edges, R)
        counts_exact &= np.array_equal(c_k, closed_window_counts_np(bounds, k0, vl, x_rel, W))
    max_abs = float(np.max(np.abs(s_k - s_p)))
    rel = np.abs(s_k - s_p) / np.where(s_p != 0, np.abs(s_p), 1.0)
    max_rel = float(np.max(rel))
    if uniform:  # time the call the survey makes: sums only
        ms = cuda_ms(lambda: kernel(**ops, with_counts=False))
        plain_ms = cuda_ms(lambda: plain(**plain_ops, with_counts=False))
        out = got[0]
    else:
        ms = cuda_ms(lambda: kernel(**ops))
        plain_ms = cuda_ms(lambda: plain(**plain_ops))
        out = got
    # each binned valid sample read once (2 bytes), the small operands read
    # once, the outputs written once
    n_binned = float(c_k.sum())
    small = [t for key, t in plain_ops.items() if key != "power"]
    bound = bound_ms(2 * n_binned + nbytes(*small) + nbytes(*(out if isinstance(out, tuple) else [out])),
                     INSTR_PER_SAMPLE[name] * n_binned)
    n_slabs = ops["plan"].shape[0] - args[-1] - 1
    say(name, shape=list(ops["power"].shape), W=args[-1], slabs=n_slabs,
        n_r=ops["bounds"].shape[1] - 1, counts_exact=counts_exact, bit_identical=bit_identical,
        max_abs_err=max_abs, max_rel_err=max_rel, ms=round(ms, 4), plain_ms=round(plain_ms, 4),
        bound_ms=round(bound["bound_ms"], 4), bound_by=bound["bound_by"],
        share_of_bound=round(bound["bound_ms"] / ms, 3),
        power_GBps=round(ops["power"].numel() * 2 / 1e6 / ms, 1), h2d_s=round(h2d_s, 3))
    if not (counts_exact and bit_identical and max_rel <= SUM_RTOL):
        raise AssertionError(f"{name}: kernel disagrees with its plain twin (W={args[-1]})")
    return {"max_abs_err": max_abs, "ms": ms, "plain_ms": plain_ms, **bound, "library_ms": None}


def fused_inputs(seed):
    """K3/K4 operands at the full width: float32 dB power, NaN-padded."""
    rng = np.random.default_rng(seed)
    power = rng.normal(-90.0, 12.0, (C, P, R)).astype("f4")
    for p in range(0, P, 97):  # a NaN suffix (ragged ping) on every 97th ping
        power[:, p, int(rng.integers(0, R)):] = np.nan
    power[rng.random((C, P, R), dtype=np.float32) < 1e-3] = np.nan  # interior NaNs
    dr = np.full((C, P), 256e-6 * 1480.0 / 2.0, "f4")  # 0.18944 m
    shift = (2.0 * dr).astype("f4")
    ab = np.tile(rng.uniform(0.002, 0.05, (C, 1)), (1, P)).astype("f4")
    off = rng.normal(-30.0, 2.0, (C, P)).astype("f4")
    ids = ((7.0 + np.arange(P)) // PING_BIN_S).astype("i4")
    x_idx = ids - ids[0]
    r_edges = np.arange(0, R * float(dr[0, 0]) + RANGE_BIN_M, RANGE_BIN_M).astype("f4")
    return power, dr, shift, ab, off, x_idx, r_edges, int(x_idx[-1]) + 1, len(r_edges) - 1


def fused_phase(name, with_sv, seed):
    from echopype_torch.ops import sv_bin_partials as sbp

    ops, _ = sbp.fused_operands(*fused_inputs(seed), device="cuda")
    if with_sv:
        kernel, plain = sbp.sv_bin_partials, sbp.sv_bin_partials_plain
    else:
        kernel, plain = sbp.mvbs_partials, sbp.mvbs_partials_plain
    got, again, want = kernel(**ops), kernel(**ops), plain(**ops)
    torch.cuda.synchronize()
    # bitwise, so that NaN Sv compares equal to itself
    bit_identical = all(torch.equal(a.view(torch.int32), b.view(torch.int32))
                        for a, b in zip(got, again))
    fields = {}
    sv_ok = True
    if with_sv:
        sv_k, sv_p = got[0], want[0]
        same_nan = torch.equal(torch.isnan(sv_k), torch.isnan(sv_p))
        sv_err = float((sv_k - sv_p).abs().nan_to_num(0.0).max())
        sv_ok = same_nan and torch.allclose(sv_k, sv_p, rtol=SV_RTOL, atol=SV_ATOL,
                                            equal_nan=True)
        fields = {"sv_same_nan": same_nan, "sv_max_abs_dB": sv_err}
        del sv_k, sv_p
    s_k, c_k = (t.double().cpu().numpy() for t in got[-2:])
    s_p, c_p = (t.double().cpu().numpy() for t in want[-2:])
    del got, again, want
    counts_exact = np.array_equal(c_k, c_p)
    max_abs = float(np.max(np.abs(s_k - s_p)))
    max_rel = float(np.max(np.abs(s_k - s_p) / np.where(s_p != 0, np.abs(s_p), 1.0)))
    ms = cuda_ms(lambda: kernel(**ops))
    plain_ms = cuda_ms(lambda: plain(**ops))
    power_mb = ops["power"].numel() * 4 / 1e6
    # every float32 sample read once (and with Sv written once), the small
    # operands read once, the partials written once
    n_binned = float(c_k.sum())
    small = [t for key, t in ops.items() if key != "power"]
    out_bytes = 4 * 2 * c_k.size + (ops["power"].numel() * 4 if with_sv else 0)
    instr = INSTR_PER_SAMPLE[name] * n_binned
    if with_sv:
        instr += K3_SV_INSTR * (ops["power"].numel() - n_binned)
    bound = bound_ms(ops["power"].numel() * 4 + nbytes(*small) + out_bytes, instr)
    say(name, shape=list(ops["power"].shape), n_r=ops["bounds"].shape[1] - 1,
        counts_exact=counts_exact, bit_identical=bit_identical, **fields,
        max_abs_err=max_abs, max_rel_err=max_rel, ms=round(ms, 4), plain_ms=round(plain_ms, 4),
        bound_ms=round(bound["bound_ms"], 4), bound_by=bound["bound_by"],
        share_of_bound=round(bound["bound_ms"] / ms, 3), power_GBps=round(power_mb / ms, 1),
        moved_GBps=round(power_mb * (2 if with_sv else 1) / ms, 1))
    if not (sv_ok and counts_exact and bit_identical and max_rel <= SUM_RTOL):
        raise AssertionError(f"{name}: kernel disagrees with its plain twin")
    if bound["bound_ms"] / ms < MIN_SHARE_OF_BOUND:
        raise AssertionError(f"{name}: {ms:.4f} ms is under half its bound's speed")
    return {"max_abs_err": max_abs, "ms": ms, "plain_ms": plain_ms, **bound, "library_ms": None}


def sv_grid_step_inputs(ed, ds_Sv, range_bin_m=RANGE_BIN_M, ping_time_bin=f"{PING_BIN_S}s"):
    """The survey step's operands on compute_MVBS's grid, from one EchoData.

    Calibration inputs as compute_Sv folds them (``_power_cal_inputs``),
    float32; ping-bin ids of compute_MVBS's ping-time edges; range edges
    ``arange(0, max echo_range + bin, bin)`` in float32.  Returns
    (step arguments, n_x, n_r).
    """
    from echopype_torch.calibrate.ek import CalibrateEK60
    from echopype_torch.commongrid.utils import ping_time_bin_edges
    from echopype_torch.ops.binning import bin_index_np

    power, dr, shift, alpha, offset, _ = CalibrateEK60(ed, device="cpu")._power_cal_inputs("Sv")
    er = np.asarray(ds_Sv["echo_range"].values, dtype="f8")
    r_edges = np.arange(0, np.nanmax(er) + range_bin_m, range_bin_m).astype("f4")
    pt = np.asarray(ds_Sv.coords["ping_time"].values, dtype="datetime64[ns]")
    edges = ping_time_bin_edges(pt, ping_time_bin).astype("i8")
    x_idx = bin_index_np(pt.astype("i8"), edges)
    args = tuple(np.ascontiguousarray(a, dtype="f4") for a in (power, dr, shift, alpha, offset))
    return (*args, x_idx, r_edges), len(edges) - 1, len(r_edges) - 1


def add_depth_and_track(ed, ds_Sv, first_ping=0):
    """A synthetic track continuing from survey ping ``first_ping``, in place
    of ``consolidate.add_location`` (the synthetic files' GGA minutes run
    past 59 after 60 pings, so their own positions are no usable track; the
    JAX package's NASC dry run makes one the same way,
    __graft_entry__.py::_dryrun_mesh_nasc), then ``consolidate.add_depth``
    from the Platform vertical offsets where the file carries them, else a
    scalar 5 m transducer depth."""
    import echopype_torch as et

    n = ds_Sv.sizes["ping_time"]
    ds_Sv["latitude"] = (("ping_time",), 45.0 + (first_ping + np.arange(n)) * 3e-5)
    ds_Sv["longitude"] = (("ping_time",), np.full(n, -125.0))
    platform = ed["Platform"]
    if all(v in platform for v in ("water_level", "vertical_offset", "transducer_offset_z")):
        return et.consolidate.add_depth(ds_Sv, echodata=ed, use_platform_vertical_offsets=True)
    return et.consolidate.add_depth(ds_Sv, depth_offset=5.0)


def _max_db(a, b):
    a, b = np.asarray(a, dtype="f8"), np.asarray(b, dtype="f8")
    return float(np.nanmax(np.abs(a - b))), bool(np.array_equal(np.isnan(a), np.isnan(b)))


def sv_grid_phase(path):
    """open_raw -> compute_Sv -> compute_MVBS / compute_NASC / the survey
    step (K3, K4) on the card; returns the K3/K4 launches of the run and
    (the Sv dataset with depth and track, its card MVBS, its card NASC)."""
    import echopype_torch as et
    from echopype_torch.ops import sv_bin_partials as sbp
    from echopype_torch.ops import window_partials as wp

    stages = {}

    def timed(stage, fn):
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        stages[stage] = round(time.perf_counter() - t0, 4)
        return out

    grid = dict(range_bin=f"{RANGE_BIN_M:g}m", ping_time_bin=f"{PING_BIN_S}s")
    sbp.reset_launches()
    wp.reset_launches()
    ed = timed("open_raw", lambda: et.open_raw(path, sonar_model="EK60"))
    ds_Sv = timed("compute_Sv", lambda: et.calibrate.compute_Sv(ed, device="cuda"))
    mvbs = timed("compute_MVBS", lambda: et.compute_MVBS(ds_Sv, **grid))
    mvbs_cpu = timed("compute_MVBS_cpu", lambda: et.compute_MVBS(ds_Sv, device="cpu", **grid))
    args, n_x, n_r = timed("step_inputs", lambda: sv_grid_step_inputs(ed, ds_Sv))
    sv3, m3 = timed("step_K3", lambda: et.survey_pipeline_step(None, n_x, n_r)(*args))
    m4 = timed("step_K4", lambda: et.survey_pipeline_step(None, n_x, n_r, with_sv=False)(*args))
    ds_Sv = timed("add_depth", lambda: add_depth_and_track(ed, ds_Sv))
    nasc = timed("compute_NASC", lambda: et.compute_NASC(ds_Sv))
    launches = {**sbp.LAUNCHES, **wp.LAUNCHES}
    nasc_cpu = timed("compute_NASC_cpu", lambda: et.compute_NASC(ds_Sv, device="cpu"))

    sv_ref = torch.from_numpy(np.asarray(ds_Sv["Sv"].values, dtype="f4")).to(sv3.device)
    sv_same_nan = torch.equal(torch.isnan(sv3), torch.isnan(sv_ref))
    sv_err = float((sv3 - sv_ref).abs().nan_to_num(0.0).max())
    sv_ok = sv_same_nan and torch.allclose(sv3, sv_ref, rtol=SV_RTOL, atol=SV_ATOL,
                                           equal_nan=True)
    del sv3, sv_ref
    g_mvbs = np.asarray(mvbs["Sv"].values)
    k3_db, k3_nan = _max_db(m3.cpu().numpy(), g_mvbs)
    k4_db, k4_nan = _max_db(m4.cpu().numpy(), m3.cpu().numpy())
    mvbs_db, mvbs_nan = _max_db(g_mvbs, mvbs_cpu["Sv"].values)
    g_nasc, w_nasc = (np.asarray(d["NASC"].values, dtype="f8") for d in (nasc, nasc_cpu))
    nasc_nan = bool(np.array_equal(np.isnan(g_nasc), np.isnan(w_nasc)))
    ok_n = ~np.isnan(w_nasc)
    nasc_rel = float(np.max(np.abs(g_nasc[ok_n] - w_nasc[ok_n]) / np.abs(w_nasc[ok_n])))
    finite = float(np.isfinite(g_mvbs).mean())
    say("sv_grid", pings=ds_Sv.sizes["ping_time"], mvbs_shape=list(g_mvbs.shape),
        nasc_shape=list(g_nasc.shape), launches=json.dumps(launches),
        k3_sv_same_nan=sv_same_nan, k3_sv_max_abs_dB=sv_err,
        k3_vs_compute_MVBS_dB=k3_db, k4_vs_k3_dB=k4_db, mvbs_cuda_vs_cpu_dB=mvbs_db,
        nasc_cuda_vs_cpu_rel=nasc_rel, mvbs_finite_share=round(finite, 4),
        stages_s=json.dumps(stages))
    checks = {
        "K3 Sv vs compute_Sv": sv_ok,
        "K3 MVBS vs compute_MVBS": k3_nan and k3_db <= MVBS_ATOL_DB,
        "K4 MVBS vs K3": k4_nan and k4_db <= K4_VS_K3_DB,
        "compute_MVBS cuda vs cpu": mvbs_nan and mvbs_db <= MVBS_ATOL_DB and finite > 0.9,
        "compute_NASC cuda vs cpu": nasc_nan and nasc_rel <= NASC_RTOL and ok_n.any(),
        "launches": launches == {"sv_bin_partials": 1, "mvbs_partials": 1,
                                 "window_partials_uniform": 0, "window_partials": 0},
    }
    failed = [k for k, v in checks.items() if not v]
    if failed:
        raise AssertionError(f"sv_grid phase failed: {failed}")
    return launches, (ds_Sv, mvbs, nasc)


def _same_coords(a, b, names):
    return all(np.array_equal(np.asarray(a.coords[k].values), np.asarray(b.coords[k].values))
               for k in names)


def _nasc_rel(a, b):
    a, b = np.asarray(a, dtype="f8"), np.asarray(b, dtype="f8")
    ok = ~np.isnan(b) & (b != 0)
    same_nan = bool(np.array_equal(np.isnan(a), np.isnan(b)))
    return float(np.max(np.abs(a[ok] - b[ok]) / np.abs(b[ok]))), same_nan


def mvbs_f64(ds, mvbs):
    """MVBS of one Sv dataset on ``mvbs``'s grid by host float64 numpy
    bincounts, apart from the port's binning: bins closed left, each
    coordinate its bin's left edge, the same 20 m x 20 s widths."""
    r_left = np.asarray(mvbs.coords["echo_range"].values, dtype="f8")
    t_left = np.asarray(mvbs.coords["ping_time"].values, dtype="datetime64[ns]").astype("i8")
    r_edges = np.append(r_left, r_left[-1] + RANGE_BIN_M)
    t_edges = np.append(t_left, t_left[-1] + PING_BIN_S * 1_000_000_000)
    n_x, n_r = len(t_left), len(r_left)
    pt = np.asarray(ds.coords["ping_time"].values, dtype="datetime64[ns]").astype("i8")
    xi = np.searchsorted(t_edges, pt, side="right") - 1
    x_ok = ((xi >= 0) & (xi < n_x))[:, None]
    sv_all, er_all = ds["Sv"].values, ds["echo_range"].values
    out = np.full((sv_all.shape[0], n_x, n_r), np.nan)
    for c in range(sv_all.shape[0]):
        sv, er = np.asarray(sv_all[c], dtype="f8"), np.asarray(er_all[c], dtype="f8")
        ri = np.searchsorted(r_edges, er, side="right") - 1
        ok = x_ok & (ri >= 0) & (ri < n_r) & ~np.isnan(er) & ~np.isnan(sv)
        lab = (xi[:, None] * n_r + ri)[ok]
        sums = np.bincount(lab, weights=10.0 ** (sv[ok] / 10.0), minlength=n_x * n_r)
        counts = np.bincount(lab, minlength=n_x * n_r)
        with np.errstate(divide="ignore", invalid="ignore"):
            out[c] = np.where(counts > 0, 10 * np.log10(sums / np.maximum(counts, 1)),
                              np.nan).reshape(n_x, n_r)
    return out


def sv_survey_phase(files, grid_a):
    """Sv stores -> survey-wide MVBS and NASC (``run_survey_mvbs`` /
    ``run_survey_nasc``) on the card and on the CPU.

    Each raw file goes through open_raw -> compute_Sv (card) -> add_depth
    and a synthetic track (file A's dataset comes from the Sv-grid phase),
    and is written uncompressed to a zarr store by the port's writer; the
    streamers reopen one store at a time.  No CUDA kernel of the port runs
    here: the four launch counters must stay 0.
    """
    import echopype_torch as et
    from echopype_torch.ops import sv_bin_partials as sbp
    from echopype_torch.ops import window_partials as wp
    from echopype_torch.utils.io import open_source
    from echopype_torch.utils.profiling import StageTimer

    ds_a, mvbs_a, nasc_a = grid_a
    stores, first_ping, prep = [], 0, {}
    for tag, path in zip("ABC", files):
        t0 = time.perf_counter()
        if tag == "A":
            ds = ds_a
        else:
            ed = et.open_raw(path, sonar_model="EK60")
            ds = add_depth_and_track(ed, et.calibrate.compute_Sv(ed, device="cuda"), first_ping)
            del ed
        store = DATA_DIR / f"SMOKE{tag}_Sv.zarr"
        ds.to_zarr(store, compress=False)
        first_ping += ds.sizes["ping_time"]
        stores.append(str(store))
        prep[tag] = round(time.perf_counter() - t0, 3)
        del ds
    del ds_a, grid_a

    mvbs_kw = dict(range_bin=f"{RANGE_BIN_M:g}m", ping_time_bin=f"{PING_BIN_S}s",
                   chunk_pings=P)
    nasc_kw = dict(chunk_pings=P)  # compute_NASC's defaults: 10 m x 0.5 nmi
    runs, walls = {}, {}
    sbp.reset_launches()
    wp.reset_launches()
    for name, fn, srcs, kw in (("mvbs", et.run_survey_mvbs, stores, mvbs_kw),
                               ("nasc", et.run_survey_nasc, stores, nasc_kw),
                               ("mvbs_A", et.run_survey_mvbs, stores[:1], mvbs_kw),
                               ("nasc_A", et.run_survey_nasc, stores[:1], nasc_kw),
                               ("mvbs_C", et.run_survey_mvbs, stores[2:], mvbs_kw)):
        for device in ("cuda", "cpu") if name in ("mvbs", "nasc") else ("cuda",):
            t0 = time.perf_counter()
            out = fn(srcs, timer=StageTimer(), device=device, **kw)
            torch.cuda.synchronize()
            walls[f"{name}_{device}"] = round(time.perf_counter() - t0, 3)
            runs[f"{name}_{device}"] = out
    t0 = time.perf_counter()
    ds_c = open_source(stores[2], "dataset")
    mvbs_c = et.compute_MVBS(ds_c, range_bin=mvbs_kw["range_bin"],
                             ping_time_bin=mvbs_kw["ping_time_bin"])
    torch.cuda.synchronize()
    walls["compute_MVBS_C_cuda"] = round(time.perf_counter() - t0, 3)
    launches = {**sbp.LAUNCHES, **wp.LAUNCHES}
    t0 = time.perf_counter()
    want_c = mvbs_f64(ds_c, runs["mvbs_C_cuda"])
    walls["C_f64_oracle"] = round(time.perf_counter() - t0, 3)
    del ds_c
    c_db, c_nan = _max_db(runs["mvbs_C_cuda"]["Sv"].values, want_c)
    c_f64_db, c_f64_nan = _max_db(mvbs_c["Sv"].values, want_c)

    g, w = (np.asarray(runs[f"mvbs_{d}"]["Sv"].values) for d in ("cuda", "cpu"))
    mvbs_db, mvbs_nan = _max_db(g, w)
    finite = float(np.isfinite(g).mean())
    nasc_rel, nasc_nan = _nasc_rel(runs["nasc_cuda"]["NASC"].values,
                                   runs["nasc_cpu"]["NASC"].values)
    nasc_finite = float(np.isfinite(np.asarray(runs["nasc_cuda"]["NASC"].values)).mean())
    a_db, a_nan = _max_db(runs["mvbs_A_cuda"]["Sv"].values, mvbs_a["Sv"].values)
    a_rel, a_nasc_nan = _nasc_rel(runs["nasc_A_cuda"]["NASC"].values, nasc_a["NASC"].values)
    routes = {k: v.attrs["routes"] for k, v in runs.items()}
    say("sv_survey", pings=first_ping, prep_s=json.dumps(prep), walls_s=json.dumps(walls),
        mvbs_shape=list(g.shape), nasc_shape=list(runs["nasc_cuda"]["NASC"].shape),
        routes=json.dumps(routes), launches=json.dumps(launches),
        mvbs_cuda_vs_cpu_dB=mvbs_db, nasc_cuda_vs_cpu_rel=nasc_rel,
        mvbs_finite_share=round(finite, 4), nasc_finite_share=round(nasc_finite, 4),
        A_vs_compute_MVBS_dB=a_db, A_vs_compute_NASC_rel=a_rel,
        C_vs_f64_oracle_dB=c_db, C_compute_MVBS_vs_f64_oracle_dB=c_f64_db)
    for k, v in runs.items():
        print(f"[sv_survey_stages] {k} {v.attrs['stage_timing']}", flush=True)
    three = ["grid", "grid", "per_ping"]
    checks = {
        "run_survey_mvbs cuda vs cpu": (
            mvbs_nan and mvbs_db <= MVBS_ATOL_DB and finite > 0.9
            and _same_coords(runs["mvbs_cuda"], runs["mvbs_cpu"],
                             ("channel", "ping_time", "echo_range"))),
        "run_survey_nasc cuda vs cpu": (
            nasc_nan and nasc_rel <= NASC_RTOL and nasc_finite > 0.9
            and _same_coords(runs["nasc_cuda"], runs["nasc_cpu"],
                             ("channel", "distance", "depth"))
            and np.array_equal(runs["nasc_cuda"]["ping_time"].values,
                               runs["nasc_cpu"]["ping_time"].values)),
        "routes": all(routes[k] == three for k in ("mvbs_cuda", "mvbs_cpu", "nasc_cuda",
                                                   "nasc_cpu")),
        "A vs compute_MVBS": (a_nan and a_db <= MVBS_ATOL_DB and _same_coords(
            runs["mvbs_A_cuda"], mvbs_a, ("channel", "ping_time", "echo_range"))),
        "A vs compute_NASC": (a_nasc_nan and a_rel <= NASC_RTOL and _same_coords(
            runs["nasc_A_cuda"], nasc_a, ("channel", "distance", "depth"))),
        "C vs f64 oracle": (c_nan and c_db <= MVBS_ATOL_DB
                            and routes["mvbs_C_cuda"] == ["per_ping"]),
        "C compute_MVBS vs f64 oracle": (c_f64_nan and c_f64_db <= MVBS_ATOL_DB and _same_coords(
            runs["mvbs_C_cuda"], mvbs_c, ("channel", "ping_time", "echo_range"))),
        "no kernel launches": not any(launches.values()),
        "device attrs": all(v.attrs["device"] == ("cpu" if k.endswith("cpu") else
                                                  torch.cuda.get_device_name(0))
                            for k, v in runs.items()),
    }
    failed = [k for k, v in checks.items() if not v]
    if failed:
        raise AssertionError(f"sv_survey phase failed: {failed}")
    return stores


def inject_noise(ds):
    """A copy of ``ds`` with the noise of tests/test_survey_clean.py:35-49 at
    survey spacing: an impulse ping (+30 dB, channel 0) every 500 pings, a
    transient blob (+20 dB over 3 pings from 300 m down, channel 1) every
    1,000, an attenuated run (-25 dB over 400-500 m, 5 pings, channel 2)
    every 1,000."""
    sv = np.array(ds["Sv"].values, dtype="f8")
    depth = np.broadcast_to(np.asarray(ds["depth"].values, dtype="f8"), sv.shape)
    P_ = sv.shape[1]
    for p in range(250, P_, 500):
        sv[0, p] += 30.0
    for p in range(500, P_ - 2, 1000):
        blk = slice(p, p + 3)
        sv[1, blk] += np.where(depth[1, blk] >= 300.0, 20.0, 0.0)
    for p in range(100, P_ - 4, 1000):
        blk = slice(p, p + 5)
        sv[2, blk] -= np.where((depth[2, blk] >= 400.0) & (depth[2, blk] <= 500.0), 25.0, 0.0)
    out = ds.copy()
    out["Sv"] = (ds["Sv"].dims, sv, dict(ds["Sv"].attrs))
    return out


def _mask_fns():
    import echopype_torch as et

    return {"impulse": et.clean.mask_impulse_noise, "transient": et.clean.mask_transient_noise,
            "attenuated": et.clean.mask_attenuated_signal}


def _grid_operands(ds):
    """The device programs' operands as clean.mask_* builds them on a
    ping-invariant depth grid, at the JAX package's default parameters."""
    from echopype_torch.clean import utils as cu
    from echopype_torch.ops import windows as tw

    sv = np.asarray(ds["Sv"].values, dtype="f4")
    depth = np.broadcast_to(np.asarray(ds["depth"].values, dtype="f8"), sv.shape)
    grid = cu.uniform_grid(depth)
    if grid is None:
        raise AssertionError("masks phase: file A's depth grid varies by ping")
    lo, hi, v_r, halo = tw.grid_window_members(grid, 10.0, 250.0)
    edges = np.arange(np.nanmin(depth), np.nanmax(depth) + 5.0, 5.0)
    n_b = max(len(edges) - 1, 1)
    idx = np.clip(np.digitize(grid, edges) - 1, 0, n_b - 1).astype("i4")
    up = np.argmin(np.abs(grid - 400.0), axis=1).astype("i4")
    widths = np.maximum(np.argmin(np.abs(grid - 500.0), axis=1) - up, 0).astype("i4")
    return dict(sv=sv, grid=grid, lo=lo, hi=hi, v_r=v_r, halo=halo, gmask=np.isfinite(grid),
                idx=idx, n_b=n_b, up=up, widths=widths, s_max=max(int(widths.max()), 1))


def time_mask_programs(ds_a, ds_c_head):
    """Each device program of the masks alone on the card (CUDA events,
    median of 5), on the operands the clean masks build: the pooled
    transient mask, the impulse mask and the attenuated mask on file A at
    full width, the float64 pooling of a grid that varies by ping on C's
    head, and the freq-diff survey step on one 5,000-ping chunk.  Each with
    bytes (inputs read once, outputs written once) and the instructions the
    function needs (adds of every window member, the library exp / log10,
    sort compares) against the card's peaks."""
    from echopype_torch.ops import windows as tw
    from echopype_torch.parallel import pipeline as tp

    saved = (dict(tw.LAUNCHES), dict(tp.LAUNCHES))
    dev = torch.device("cuda")
    o = _grid_operands(ds_a)
    C_, P_, R_ = o["sv"].shape
    N = C_ * P_ * R_
    sv_t = torch.from_numpy(o["sv"]).to(dev)

    def t(a, dtype=torch.float32):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev, dtype)

    ops = (t(o["gmask"]), t(o["lo"], torch.int64), t(o["hi"], torch.int64),
           t(o["v_r"], torch.bool))
    members = float((o["hi"] - o["lo"]).sum())
    s_max, W_att = o["s_max"], 15
    n_sort = 2 * W_att * s_max
    chunk = chunk_inputs(7, vary_dr=False)
    fd_args = (*chunk[:8], chunk[8], len(chunk[7]) - 1, 1, 0, ">", 3.0)
    sv_c = np.asarray(ds_c_head["Sv"].values, dtype="f8")
    depth_c = np.asarray(ds_c_head["depth"].values, dtype="f8")
    Cc, Pc, Rc = sv_c.shape
    progs = {
        "transient_mask": (
            "echopype_tpu/ops/windows.py:424", "ops/windows.py::transient_mask_grid_idx_device",
            lambda: tw.transient_mask_grid_idx_device(sv_t, *ops, 25, 12.0,
                                                      range_halo=o["halo"], device=dev),
            5 * N + 13 * C_ * R_,
            2 * P_ * members + 2 * 51 * N + N * (EXPF_INSTR + LOG10F_INSTR + 2)),
        "impulse_mask": (
            "echopype_tpu/ops/windows.py:527", "ops/windows.py::impulse_mask_grid_device",
            lambda: tw.impulse_mask_grid_device(sv_t, t(o["idx"], torch.int64), o["n_b"], 2,
                                                10.0, device=dev),
            5 * N + 4 * C_ * R_, N * (EXPF_INSTR + 8) + C_ * P_ * o["n_b"] * LOG10F_INSTR),
        "attenuated_mask": (
            "echopype_tpu/ops/windows.py:581", "ops/windows.py::attenuated_ping_mask_grid_device",
            lambda: tw.attenuated_ping_mask_grid_device(sv_t, t(o["up"], torch.int64),
                                                        t(o["widths"], torch.int64), s_max,
                                                        W_att, 8.0, device=dev),
            4 * C_ * P_ * s_max + C_ * P_,
            C_ * P_ * (n_sort * int(np.ceil(np.log2(n_sort))) + s_max * EXPF_INSTR)),
        "exact_pooling_ping_varying": (
            "echopype_tpu/ops/windows.py:184",
            "ops/windows.py::pool_sv_nanmean_exact_device",
            lambda: tw.pool_sv_nanmean_exact_device(sv_c, depth_c, 10.0, 25, 250.0, device=dev),
            8 * (2 * Cc * Pc * (Rc + 1) + 3 * Cc * Pc * Rc),
            51 * Cc * Pc * Rc * (2 * int(np.ceil(np.log2(Rc + 1))) + 6)),
        "freqdiff_step": (
            "echopype_tpu/parallel/pipeline.py:325",
            "parallel/pipeline.py::sv_mvbs_window_partials_freqdiff",
            lambda: tp.sv_mvbs_window_partials_freqdiff(*fd_args, device=dev),
            2 * C * P * R + 2 * 4 * C * chunk[8] * (len(chunk[7]) - 1) + 4 * 4 * C * P,
            C * P * R * (INSTR_PER_SAMPLE["K2"] + 4)),
    }
    out = {}
    for name, (jax_src, port, fn, nbytes_, instr) in progs.items():
        ms = cuda_ms(fn, reps=5, warmup=1)
        out[name] = {"replaces": jax_src, "port": f"echopype_torch/{port}", "ms": ms,
                     "bytes": nbytes_, **bound_ms(nbytes_, instr), "library_ms": None}
    del sv_t
    torch.cuda.empty_cache()
    tw.LAUNCHES.update(saved[0])
    tp.LAUNCHES.update(saved[1])
    return out


def _flag_bins(flag, pt, rng_vals, x_left, r_left):
    """bool [C, n_x, n_r]: the output bins that hold a flagged sample.
    flag [C, P, R]; pt [P] datetime64 or distance; rng_vals [C, P, R]."""
    bins = np.zeros((flag.shape[0], len(x_left), len(r_left)), dtype=bool)
    c, p, r = np.nonzero(flag)
    if c.size:
        xi = np.clip(np.searchsorted(x_left, pt[p], side="right") - 1, 0, len(x_left) - 1)
        ri = np.searchsorted(r_left, rng_vals[c, p, r], side="right") - 1
        ok = (ri >= 0) & (ri < len(r_left))
        bins[c[ok], xi[ok], ri[ok]] = True
    return bins


def _cmp_excused(a, b, excused, rtol=False):
    """(max error over the bins not excused, NaN masks equal there, bins
    excused): dB difference, or the relative one with ``rtol``."""
    a, b = np.asarray(a, dtype="f8"), np.asarray(b, dtype="f8")
    keep = ~excused
    same_nan = bool(np.array_equal(np.isnan(a)[keep], np.isnan(b)[keep]))
    ok = keep & np.isfinite(a) & np.isfinite(b) & ((b != 0) if rtol else True)
    d = np.abs(a - b)[ok] / (np.abs(b[ok]) if rtol else 1.0)
    return (float(d.max()) if d.size else 0.0), same_nan, int(excused.sum())


def _margin_excused(bad, ds_list, eq_margin, margin_db, out, x_coord="ping_time"):
    """Of the output bins in ``bad`` (a bool [C, n_x, n_r] of bins over
    tolerance or with another NaN), those holding a sample whose
    frequency-differencing margin |Sv[ia] - Sv[ib] - diff| is under
    ``margin_db`` on the card's Sv (datasets ``ds_list``): the knife edges
    where the card and the CPU may rightly decide apart."""
    excused = np.zeros_like(bad)
    if not bad.any():
        return excused
    x_left = np.asarray(out.coords[x_coord].values).astype("i8")
    r_left = np.asarray(out.coords["echo_range"].values, dtype="f8")
    bad_xr = bad.any(axis=0)
    for ds in ds_list:
        pt = np.asarray(ds.coords["ping_time"].values, dtype="datetime64[ns]").astype("i8")
        xi = np.clip(np.searchsorted(x_left, pt, side="right") - 1, 0, len(x_left) - 1)
        pings = np.nonzero(bad_xr[xi].any(axis=1))[0]
        if not pings.size:
            continue
        sv = np.asarray(ds["Sv"].values, dtype="f8")[:, pings]
        er = np.broadcast_to(np.asarray(ds["echo_range"].values, dtype="f8"),
                             np.asarray(ds["Sv"].values).shape)[:, pings]
        knife = eq_margin(sv) < margin_db  # [P', R]
        excused |= _flag_bins(np.broadcast_to(knife, sv.shape), pt[pings], er, x_left, r_left)
    return excused & bad


def _bad_bins(a, b, atol):
    a, b = np.asarray(a, dtype="f8"), np.asarray(b, dtype="f8")
    with np.errstate(invalid="ignore"):
        return (np.isnan(a) != np.isnan(b)) | (np.abs(a - b) > atol)


def _fd_margin(ia, ib, diff):
    return lambda sv: np.abs(sv[ia] - sv[ib] - diff)


def _survey_distance(dss):
    """run_survey_nasc's cumulative distance per ping over ``dss``."""
    from echopype_torch.commongrid.utils import get_distance_from_latlon
    from echopype_torch.utils.geodesy import pairwise_distance_nmi

    out, offset, prev = [], 0.0, None
    for ds in dss:
        lat, lon = (np.asarray(ds[v].values, dtype="f8") for v in ("latitude", "longitude"))
        if prev is not None:
            offset += float(pairwise_distance_nmi(np.array([prev[0], lat[0]]),
                                                  np.array([prev[1], lon[0]]))[0])
        out.append(get_distance_from_latlon(ds) + offset)
        offset, prev = float(out[-1][-1]), (lat[-1], lon[-1])
    return out


def _noise_flags(ds, spec, device):
    """The OR of the ``spec`` clean masks on ``device``: bool [C, P, R]."""
    from echopype_torch.parallel.survey import _apply_noise_masks
    from echopype_torch.utils.profiling import StageTimer

    sv = np.asarray(ds["Sv"].values, dtype="f4")
    return np.isnan(_apply_noise_masks(ds, sv, spec, StageTimer(), device)) & ~np.isnan(sv)


def masks_card_vs_cpu(ds, tag):
    """The three masks at default parameters on the card (twice) and on the
    CPU over one head of pings; pooled and upsampled Sv on both.  Masks may
    differ only where the margin to the threshold is under MASK_MARGIN_DB."""
    from echopype_torch.clean import utils as cu

    sv = np.asarray(ds["Sv"].values, dtype="f8")
    depth = np.broadcast_to(np.asarray(ds["depth"].values, dtype="f8"), sv.shape)
    res, checks = {}, {}
    pooled = {d: cu.pool_Sv_nanmean(sv, depth, 10.0, 25, 250.0, device=d) for d in ("cuda", "cpu")}
    up = {d: cu.downsample_upsample_along_depth(sv, depth, 5.0, device=d)[1]
          for d in ("cuda", "cpu")}
    for name, vals in (("pooled", pooled), ("upsampled", up)):
        db, same_nan = _max_db(vals["cuda"], vals["cpu"])
        res[f"{name}_cuda_vs_cpu_dB"] = db
        checks[f"{tag} {name} Sv cuda vs cpu"] = same_nan and db <= MVBS_ATOL_DB
    with np.errstate(invalid="ignore"):
        u = up["cpu"]
        fwd = np.full(u.shape, np.inf)
        bwd = np.full(u.shape, np.inf)
        fwd[:, :-2] = u[:, :-2] - u[:, 2:]
        bwd[:, 2:] = u[:, 2:] - u[:, :-2]
        margins = {
            "transient": np.abs(sv - pooled["cpu"] - 12.0),
            "impulse": np.minimum(np.abs(np.nan_to_num(fwd, nan=np.inf) - 10.0),
                                  np.abs(np.nan_to_num(bwd, nan=np.inf) - 10.0)),
        }
    for kind, fn in _mask_fns().items():
        m1, m2 = (fn(ds, device="cuda").values for _ in range(2))
        mc = fn(ds, device="cpu").values
        diff = m1 != mc
        if kind == "attenuated" and diff.any():
            margin = _attenuated_margin(sv, depth, diff.any(axis=2))
        else:
            margin = margins.get(kind, np.zeros(sv.shape))[diff]
        res[f"{kind}_flagged"] = int(m1.sum())
        res[f"{kind}_differ"] = int(diff.sum())
        checks[f"{tag} {kind} rerun bit-identical"] = bool(np.array_equal(m1, m2))
        checks[f"{tag} {kind} cuda vs cpu"] = bool((np.asarray(margin) < MASK_MARGIN_DB).all())
    return res, checks


def _attenuated_margin(sv, depth, pings_cp):
    """|ping median - block median - 8 dB| in float64 for the (channel, ping)
    pairs in ``pings_cp`` (echopy_attenuated_signal_mask's medians)."""
    out = []
    lin = 10.0 ** (sv / 10.0)
    for c, p in zip(*np.nonzero(pings_cp)):
        up = int(np.argmin(np.abs(depth[c, p] - 400.0)))
        lw = int(np.argmin(np.abs(depth[c, p] - 500.0)))
        with np.errstate(invalid="ignore"):
            ping = 10 * np.log10(np.nanmedian(lin[c, p, up:lw]))
            block = 10 * np.log10(np.nanmedian(lin[c, p - 15 : p + 15, up:lw]))
        out.append(abs(ping - block - 8.0))
    return np.array(out)


def masks_phase(files, stores):
    """clean and mask on the card: the masks at full width on file A, card
    against CPU on heads of A (grid route) and C (grid by ping),
    frequency_differencing / apply_mask on A, the masked Sv-store surveys,
    run_survey_mvbs_from_raw with freq_diff over A, B, C and with
    noise_masks on an extra file, and the broadband freq-diff leg chunked
    and fused.  Returns the device programs' timings with their launches."""
    import echopype_torch as et
    from echopype_torch.echodata.simrad import retrieve_correct_beam_group
    from echopype_torch.ops import window_partials as wp
    from echopype_torch.ops import windows as tw
    from echopype_torch.parallel import pipeline as tp
    from echopype_torch.parallel.survey import _fd_mask
    from echopype_torch.utils.io import open_source
    from echopype_torch.utils.profiling import StageTimer

    tw.reset_launches()
    tp.LAUNCHES["freqdiff_step"] = 0
    checks, walls = {}, {}

    def timed(stage, fn):
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        walls[stage] = round(time.perf_counter() - t0, 3)
        return out

    # 1. the three masks at full width on the card, file A (10,000 pings)
    ds_a = timed("open_store_A", lambda: inject_noise(open_source(stores[0], "dataset")))
    ds_c = timed("open_store_C", lambda: inject_noise(open_source(stores[2], "dataset")))
    torch.cuda.reset_peak_memory_stats()
    flagged = {}
    for kind, fn in _mask_fns().items():
        flagged[kind] = int(timed(f"{kind}_A_cuda", lambda: fn(ds_a, device="cuda")).values.sum())
        checks[f"{kind} flags on A"] = flagged[kind] > 0
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    heads = {tag: ds.isel(ping_time=slice(0, MASK_HEAD[tag]))
             for tag, ds in (("A", ds_a), ("C", ds_c))}
    programs = timed("program_timing", lambda: time_mask_programs(ds_a, heads["C"]))
    say("masks_full_width", shape=list(np.shape(ds_a["Sv"].values)), flagged=json.dumps(flagged),
        peak_GB=round(peak_gb, 3), walls_s=json.dumps(walls),
        programs=json.dumps({k: {f: (round(v, 4) if isinstance(v, float) else v)
                                 for f, v in d.items() if f in ("ms", "bound_ms", "bound_by")}
                             for k, d in programs.items()}))
    checks["peak memory under 20 GB"] = peak_gb < 20.0

    # 2. card against CPU on heads: A (grid route), C (grid by ping)
    head_res = {}
    for tag, ds in heads.items():
        res, chk = timed(f"head_{tag}", lambda: masks_card_vs_cpu(ds, tag))
        head_res[tag] = res
        checks.update(chk)
    say("masks_heads", pings=json.dumps(MASK_HEAD), results=json.dumps(head_res))

    # 3. frequency_differencing and apply_mask on A: Sv from the card / CPU
    ed_a = et.open_raw(files[0], sonar_model="EK60")
    sv_cpu = timed("compute_Sv_A_cpu", lambda: et.calibrate.compute_Sv(ed_a, device="cpu"))
    del ed_a
    ds_card = open_source(stores[0], "dataset")
    m_card, m_cpu = (et.mask.frequency_differencing(d, freqABEq=FD_EQ) for d in (ds_card, sv_cpu))
    diff = m_card.values != m_cpu.values
    margin = _fd_margin(1, 0, 3.0)(np.asarray(ds_card["Sv"].values, dtype="f8"))
    a_card, a_cpu = (np.asarray(et.mask.apply_mask(d, m)["Sv"].values)
                     for d, m in ((ds_card, m_card), (sv_cpu, m_cpu)))
    keep = ~np.broadcast_to(diff, a_card.shape)
    fd_db, fd_nan = _max_db(a_card[keep], a_cpu[keep])
    checks["frequency_differencing cuda vs cpu"] = bool((margin[diff] < MASK_MARGIN_DB).all())
    checks["apply_mask cuda vs cpu"] = fd_nan and fd_db <= MVBS_ATOL_DB
    say("masks_freq_diff", kept_share=round(float(m_card.values.mean()), 4),
        mask_differ=int(diff.sum()), apply_mask_cuda_vs_cpu_dB=fd_db)
    del sv_cpu, ds_card, a_card, a_cpu, keep

    # 4. masked Sv-store surveys over the first 2,000 pings of A and C
    srcs = [ds.isel(ping_time=slice(0, MASK_SURVEY_PINGS[tag]))
            for tag, ds in (("A", ds_a), ("C", ds_c))]
    mvbs_kw = dict(range_bin=f"{RANGE_BIN_M:g}m", ping_time_bin=f"{PING_BIN_S}s")
    nasc_kw = dict(range_bin="10m", dist_bin="0.5nmi")
    runs = {}
    for name, fn, kw in (("mvbs_noise", et.run_survey_mvbs, dict(noise_masks=SURVEY_MASKS)),
                         ("mvbs_fd", et.run_survey_mvbs, dict(freq_diff=FD_EQ)),
                         ("nasc_noise", et.run_survey_nasc, dict(noise_masks=SURVEY_MASKS))):
        for device in ("cuda", "cpu"):
            runs[f"{name}_{device}"] = timed(f"{name}_{device}", lambda: fn(
                srcs, device=device, **(nasc_kw if name.startswith("nasc") else mvbs_kw), **kw))
    flags = {}  # each run's mask on both devices, made where the runs disagree

    def mask_differs(name):
        if name not in flags:
            if "noise" in name:
                by = {d: [_noise_flags(ds, SURVEY_MASKS, d) for ds in srcs]
                      for d in ("cuda", "cpu")}
            else:
                by = {d: [torch.isnan(_fd_mask((1, 0, ">", 3.0))(torch.from_numpy(np.asarray(
                    ds["Sv"].values, dtype="f4")).to(torch.device(d)))).cpu().numpy()
                    for ds in srcs] for d in ("cuda", "cpu")}
            flags[name] = [a != b for a, b in zip(by["cuda"], by["cpu"])]
        return flags[name]

    dists = _survey_distance(srcs)
    survey = {}
    for name in ("mvbs_noise", "mvbs_fd", "nasc_noise"):
        g, w = runs[f"{name}_cuda"], runs[f"{name}_cpu"]
        nasc = name.startswith("nasc")
        var, rname = ("NASC", "depth") if nasc else ("Sv", "echo_range")
        gv, wv = (np.asarray(o[var].values, dtype="f8") for o in (g, w))
        with np.errstate(invalid="ignore", divide="ignore"):
            bad = (np.isnan(gv) != np.isnan(wv)) | (
                np.abs(gv - wv) / (np.abs(wv) if nasc else 1.0)
                > (NASC_RTOL if nasc else MVBS_ATOL_DB))
        excused = np.zeros(gv.shape, dtype=bool)
        differ = 0
        if bad.any():
            x_left = (np.asarray(g.coords["distance"].values, dtype="f8") if nasc else
                      np.asarray(g.coords["ping_time"].values).astype("i8"))
            r_left = np.asarray(g.coords[rname].values, dtype="f8")
            for i, ds in enumerate(srcs):
                x = dists[i] if nasc else np.asarray(ds.coords["ping_time"].values).astype("i8")
                rv = np.broadcast_to(np.asarray(ds[rname].values, dtype="f8"),
                                     np.shape(ds["Sv"].values))
                excused |= _flag_bins(mask_differs(name)[i], x, rv, x_left, r_left)
                differ += int(mask_differs(name)[i].sum())
        err, same_nan, n_exc = _cmp_excused(gv, wv, excused & bad, rtol=nasc)
        coords = ("channel", "distance", "depth") if nasc else ("channel", "ping_time",
                                                               "echo_range")
        survey[name] = {"err": err, "bins_over_tol": int(bad.sum()), "bins_excused": n_exc,
                        "samples_differ": differ,
                        "finite_share": round(float(np.isfinite(gv).mean()), 4)}
        checks[f"{name} cuda vs cpu"] = (same_nan and err <= (NASC_RTOL if nasc else MVBS_ATOL_DB)
                                         and _same_coords(g, w, coords))
    # the fused noise-mask stream over all of A against the composed chain on the card
    fused = timed("mvbs_noise_A_fused", lambda: et.run_survey_mvbs(
        [ds_a], noise_masks=SURVEY_MASKS, **mvbs_kw))

    def composed():
        sv = np.asarray(ds_a["Sv"].values, dtype="f8")
        flag = np.zeros(sv.shape, dtype=bool)
        for kind, params in SURVEY_MASKS.items():
            flag |= np.asarray(_mask_fns()[kind](ds_a, **params).values, dtype=bool)
        masked = ds_a.copy()
        masked["Sv"] = (ds_a["Sv"].dims, np.where(flag, np.nan, sv))
        return et.run_survey_mvbs([masked], **mvbs_kw)

    comp = timed("mvbs_noise_A_composed", composed)
    checks["A fused noise masks == composed chain"] = bool(np.array_equal(
        np.asarray(fused["Sv"].values), np.asarray(comp["Sv"].values), equal_nan=True))
    survey["A_fused_vs_composed_equal"] = checks["A fused noise masks == composed chain"]
    say("masks_sv_survey", pings=json.dumps(MASK_SURVEY_PINGS), results=json.dumps(survey))
    del ds_a, ds_c, heads, srcs, runs, fused, comp

    # 5. run_survey_mvbs_from_raw with freq_diff over A, B, C
    raw_kw = dict(range_bin=f"{RANGE_BIN_M:g}m", ping_time_bin=f"{PING_BIN_S}s", chunk_pings=P,
                  freq_diff=FD_EQ)
    fd_runs, fd_launches = {}, {}
    for device in ("cuda", "cpu"):
        wp.reset_launches()
        tp.LAUNCHES["freqdiff_step"] = 0
        fd_runs[device] = timed(f"raw_fd_{device}", lambda: et.run_survey_mvbs_from_raw(
            files[:3], timer=StageTimer(), device=device, **raw_kw))
        fd_launches[device] = {**wp.LAUNCHES, **tp.LAUNCHES}
    g, w = (np.asarray(fd_runs[d]["Sv"].values) for d in ("cuda", "cpu"))
    bad = _bad_bins(g, w, MVBS_ATOL_DB)
    excused = _margin_excused(bad, [open_source(s, "dataset") for s in stores[:3]] if bad.any()
                              else [], _fd_margin(1, 0, 3.0), MASK_MARGIN_DB, fd_runs["cuda"])
    err, same_nan, n_exc = _cmp_excused(g, w, excused)
    chunks = sum(-(-n // P) for n in E2E_PINGS)
    checks["raw freq_diff cuda vs cpu"] = (same_nan and err <= MVBS_ATOL_DB and _same_coords(
        fd_runs["cuda"], fd_runs["cpu"], ("channel", "ping_time", "echo_range")))
    checks["raw freq_diff launches"] = fd_launches["cuda"] == {
        "window_partials_uniform": 0, "window_partials": 0, "freqdiff_step": chunks}
    say("masks_raw_freq_diff", pings=sum(E2E_PINGS), launches=json.dumps(fd_launches),
        cuda_vs_cpu_dB=err, bins_over_tol=int(bad.sum()), bins_excused=n_exc,
        pings_per_s={d: round(sum(E2E_PINGS) / walls[f"raw_fd_{d}"], 1) for d in ("cuda", "cpu")},
        stages=fd_runs["cuda"].attrs["stage_timing"])

    # 6. run_survey_mvbs_from_raw with noise_masks (two-pass) on an extra file
    extra = write_mask_raw_file()
    nm_runs = {d: timed(f"raw_noise_{d}", lambda: et.run_survey_mvbs_from_raw(
        [extra], noise_masks=RAW_MASKS, timer=StageTimer(), device=d,
        range_bin=f"{RANGE_BIN_M:g}m", ping_time_bin=f"{PING_BIN_S}s")) for d in ("cuda", "cpu")}
    ed = et.open_raw(extra, sonar_model="EK60")
    sv_by = {d: et.calibrate.compute_Sv(ed, device=d) for d in ("cuda", "cpu")}
    flag = _noise_flags(sv_by["cuda"], RAW_MASKS, "cuda") != _noise_flags(sv_by["cpu"], RAW_MASKS,
                                                                           "cpu")
    out = nm_runs["cuda"]
    excused = _flag_bins(flag, np.asarray(sv_by["cuda"].coords["ping_time"].values).astype("i8"),
                         np.broadcast_to(np.asarray(sv_by["cuda"]["echo_range"].values, "f8"),
                                         flag.shape),
                         np.asarray(out.coords["ping_time"].values).astype("i8"),
                         np.asarray(out.coords["echo_range"].values, dtype="f8"))
    err, same_nan, n_exc = _cmp_excused(out["Sv"].values, nm_runs["cpu"]["Sv"].values, excused)
    checks["raw noise_masks cuda vs cpu"] = (same_nan and err <= MVBS_ATOL_DB and _same_coords(
        out, nm_runs["cpu"], ("channel", "ping_time", "echo_range")))
    say("masks_raw_noise", pings=MASK_RAW_PINGS, cuda_vs_cpu_dB=err, samples_differ=int(flag.sum()),
        bins_excused=n_exc, finite_share=round(float(np.isfinite(out["Sv"].values).mean()), 4))
    del ed, sv_by, nm_runs

    # 7. the broadband freq-diff leg: two FM channels, chunked and fused
    bb = write_fd_bb_file()
    ed = et.open_raw(bb, sonar_model="EK80")
    chans = [str(c) for c in ed[retrieve_correct_beam_group(ed, "BB", "complex")]
             .coords["channel"].values]
    eq = f'"{chans[0]}" - "{chans[1]}" > 3.0dB'
    bb_runs = {}
    for mode, extra_kw in (("chunked", {}), ("fused", dict(device_fused=True))):
        for device in ("cuda", "cpu"):
            bb_runs[f"{mode}_{device}"] = timed(f"bb_fd_{mode}_{device}", lambda: (
                et.run_survey_mvbs_from_raw([bb], sonar_model="EK80", waveform_mode="BB",
                                            encode_mode="complex", freq_diff=eq,
                                            timer=StageTimer(), device=device,
                                            **EK80_GRID, **extra_kw)))
    sv_bb = []

    def bb_sv():  # the card's float32 BB Sv, for the knife-edge margins
        if not sv_bb:
            sv_bb.append(et.calibrate.compute_Sv(ed, waveform_mode="BB", encode_mode="complex",
                                                 precision="float32"))
        return sv_bb

    bb_res = {}
    for name, (ga, wa, tol, margin_db) in {
        "chunked_cuda_vs_cpu": ("chunked_cuda", "chunked_cpu", MVBS_ATOL_DB, BB_FD_MARGIN_DB),
        "fused_cuda_vs_cpu": ("fused_cuda", "fused_cpu", MVBS_ATOL_DB, BB_FD_MARGIN_DB),
        "fused_vs_chunked": ("fused_cuda", "chunked_cuda", FUSED_VS_CHUNKED_DB,
                             FUSED_VS_CHUNKED_DB),
    }.items():
        g, w = (np.asarray(bb_runs[k]["Sv"].values) for k in (ga, wa))
        bad = _bad_bins(g, w, tol)
        if name == "fused_vs_chunked":
            bad[:, :, -1] = _bad_bins(g[:, :, -1], w[:, :, -1], FUSED_LAST_BIN_DB)
        excused = _margin_excused(bad, bb_sv() if bad.any() else [], _fd_margin(0, 1, 3.0),
                                  margin_db, bb_runs[ga])
        body_bad = bad & ~excused
        same_nan = bool(np.array_equal(np.isnan(g)[~excused], np.isnan(w)[~excused]))
        bb_res[name] = {"max_dB": _max_db(g, w)[0], "bins_over_tol": int(bad.sum()),
                        "bins_excused": int(excused.sum())}
        checks[f"bb freq_diff {name}"] = (same_nan and not body_bad.any()
                                          and g.shape == w.shape and np.isfinite(g).any())
    say("masks_bb_freq_diff", pings=FD_BB_PINGS, channels=len(chans), results=json.dumps(bb_res),
        pings_per_s=json.dumps({k: round(FD_BB_PINGS / walls[f"bb_fd_{k}"], 1) for k in bb_runs}))
    del ed, sv_bb, bb_runs

    launches = {**tw.LAUNCHES, "freqdiff_step": fd_launches["cuda"]["freqdiff_step"]}
    say("masks", walls_s=json.dumps(walls), launches=json.dumps(launches))
    failed = [k for k, v in checks.items() if not v]
    if failed:
        raise AssertionError(f"masks phase failed: {failed}")
    launch_of = {"exact_pooling_ping_varying": "pool_sv_nanmean_exact"}
    for name, row in programs.items():
        row["launches"] = launches[launch_of.get(name, name)]
    return programs


def write_mask_raw_file():
    """File D: MASK_RAW_PINGS pings of file A's layout (the raw noise-mask route)."""
    from synth_ek60 import write_ek60_raw

    path = DATA_DIR / "SMOKED-D20200102-T000000.raw"
    write_ek60_raw(path, n_pings=MASK_RAW_PINGS, n_samples=R, channels=CHANNELS,
                   frequencies=FREQS, t0=np.datetime64("2020-01-02T00:00:00", "ns"), seed=7,
                   with_angle=False)
    return str(path)


def write_fd_bb_file():
    """File E: two FM channels (tests/synth_ek80.py, extra_fm_channel), the
    ek80 phase's full width, FD_BB_PINGS pings."""
    from synth_ek80 import write_ek80_raw

    path = DATA_DIR / "SMOKE80FD-D20210301-T000000.raw"
    write_ek80_raw(path, n_pings=FD_BB_PINGS, n_samples=EK80_R, n_sectors=EK80_SECTORS,
                   t0=np.datetime64("2021-03-01T00:00:00", "ns"), seed=300,
                   with_power_channel=False, with_cw_complex=False, extra_fm_channel=True)
    return str(path)


def write_ek80_files():
    """Files A and B: ``EK80_PINGS`` pings each, consecutive in time."""
    from synth_ek80 import write_ek80_raw

    t0 = np.datetime64("2021-02-01T00:00:00", "ns")
    files = []
    for i, tag in enumerate("AB"):
        path = DATA_DIR / f"SMOKE80{tag}-D20210201-T000000.raw"
        write_ek80_raw(path, n_pings=EK80_PINGS, n_samples=EK80_R, n_sectors=EK80_SECTORS,
                       t0=t0 + np.timedelta64(i * EK80_PINGS, "s"), seed=100 + i)
        files.append(str(path))
    return files


def _db_stats(a, b):
    """(p50, p99, max) of |a - b| over samples finite in both, and the count
    of NaN-mask mismatches."""
    a, b = np.asarray(a, dtype="f8"), np.asarray(b, dtype="f8")
    d = np.abs(a - b)[np.isfinite(a) & np.isfinite(b)]
    p50, p99, mx = (float(v) for v in np.percentile(d, [50, 99, 100]))
    return p50, p99, mx, int(np.count_nonzero(np.isnan(a) != np.isnan(b)))


def matched_filter_timing(ed, bp, ch, replica):
    """The matched filter's device program alone (the blocked-Toeplitz
    matmul of ``ops/matched_filter.py``) on one channel of file A, 2,000
    pings x 4 sectors x 8,192 float32 samples, timed with CUDA events in
    both of its forms: float64 accumulation (compute_Sv's) and float32 (the
    fused survey step's); each with its bound and one
    ``torch.nn.functional.conv1d`` computing the same correlation in the
    same dtype (the library call), timed and checked beside it."""
    from echopype_torch.ops import matched_filter as mf

    dev = torch.device("cuda")
    beam = ed[bp].sel(channel=[ch])
    lanes = []
    for part in ("backscatter_r", "backscatter_i"):
        x = np.asarray(beam[part].values, dtype="f4")[0]  # [P, R, B]
        P, R, B = x.shape
        x = np.nan_to_num(x.transpose(0, 2, 1).reshape(P * B, R))
        lanes.append(torch.from_numpy(np.ascontiguousarray(x)).to(dev))
    rep = np.flipud(np.conj(np.asarray(replica)))
    L, T, z, n_lanes = len(rep), mf._block_t(len(rep)), mf._leading_zeros(replica), P * B
    torch.backends.cudnn.allow_tf32 = False
    out = []
    for dtype in (torch.float64, torch.float32):
        hr, hi = (torch.from_numpy(np.ascontiguousarray(a)).to(dev, dtype)
                  for a in (rep.real, rep.imag))

        def product():
            return mf._toeplitz_conv(*(x.to(dtype) for x in lanes), hr, hi, L - 1, R,
                                     tail_zeros=z)

        ms = cuda_ms(product)
        re, im = product()
        # the library call: conv1d cross-correlates, so the kernel is the
        # conjugated replica in the real block form [[cr, -ci], [ci, cr]]
        cr, ci = hr.flip(0), hi.flip(0)
        weight = torch.stack([torch.stack([cr, -ci]), torch.stack([ci, cr])])  # [2, 2, L]
        x2 = torch.nn.functional.pad(torch.stack(lanes, dim=1).to(dtype), (0, L - 1))
        library_ms = cuda_ms(lambda: torch.nn.functional.conv1d(x2, weight))
        lib = torch.nn.functional.conv1d(x2, weight)
        scale = float(torch.maximum(re.abs().max(), im.abs().max()))
        lib_rel = float(torch.maximum((lib[:, 0] - re).abs().max(),
                                      (lib[:, 1] - im).abs().max())) / scale
        useful = 8.0 * n_lanes * R * L  # complex MACs, 4 multiplies and 4 adds each
        # float32 lanes in, the outputs out in the product's dtype, the replica
        nbytes = 2 * 4 * n_lanes * R + 2 * re.element_size() * n_lanes * R + 2 * 8 * L
        t_ops, t_bytes = useful / F32_OPS_PER_S * 1e3, nbytes / HBM_BYTES_PER_S * 1e3
        out.append({"channel": ch, "dtype": str(dtype).split(".")[-1], "lanes": n_lanes, "R": R,
                    "L": L, "T": T, "useful_flop": useful,
                    "issued_flop": useful * (T + L - 1) / L, "bytes": nbytes, "ms": ms,
                    "bound_ms": max(t_ops, t_bytes),
                    "bound_by": "operations" if t_ops >= t_bytes else "bytes",
                    "share_of_bound": max(t_ops, t_bytes) / ms, "library_ms": library_ms,
                    "library_max_rel_err": lib_rel})
        del re, im, x2, lib
        torch.cuda.empty_cache()
        if lib_rel > (1e-12 if dtype == torch.float64 else 2e-6):
            raise AssertionError(f"matched filter and conv1d disagree on {ch}: {lib_rel}")
    return out


def ek80_phase(files):
    """EK80 on the card: open_raw, compute_Sv in BB / CW complex / CW power
    against the CPU and (BB) float64, the matched filter alone against its
    bound, and run_survey_mvbs_from_raw's power, BB chunked, BB fused and CW
    complex legs on cuda and cpu.  Returns the K1/K2 launches of the power
    leg and the matched filter's launches and timings."""
    import echopype_torch as et
    from echopype_torch.calibrate.ek80 import CalibrateEK80
    from echopype_torch.echodata.simrad import retrieve_correct_beam_group
    from echopype_torch.ops import matched_filter as mf
    from echopype_torch.ops import window_partials as wp
    from echopype_torch.parallel.survey import _slice_echodata_pings
    from echopype_torch.utils.profiling import StageTimer

    seconds = {}

    def timed(stage, fn):
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        seconds[stage] = round(time.perf_counter() - t0, 3)
        return out

    ed = timed("open_raw_A", lambda: et.open_raw(files[0], sonar_model="EK80"))
    timed("open_raw_B", lambda: et.open_raw(files[1], sonar_model="EK80"))  # timed, not kept
    replicas = {}
    for wm in ("BB", "CW"):
        tx = CalibrateEK80(ed, waveform_mode=wm, encode_mode="complex",
                           device="cpu")._complex_sv_scalars()["tx"]
        replicas.update({(wm, ch): y for ch, y in tx.items()})
    say("ek80_open", pings=EK80_PINGS, files=len(files), seconds=json.dumps(seconds),
        replica_L=json.dumps({f"{wm} {ch}": len(y) for (wm, ch), y in replicas.items()}))

    checks, fields = {}, {}
    mf.reset_launches()
    for name, (wm, em) in {"BB": ("BB", "complex"), "CW_complex": ("CW", "complex"),
                           "CW_power": ("CW", "power")}.items():
        sv = timed(f"compute_Sv_{name}",
                   lambda: et.calibrate.compute_Sv(ed, waveform_mode=wm, encode_mode=em))
        head = _slice_echodata_pings(ed, retrieve_correct_beam_group(ed, wm, em),
                                     slice(0, EK80_HEAD))
        cpu = timed(f"compute_Sv_{name}_cpu_head", lambda: et.calibrate.compute_Sv(
            head, waveform_mode=wm, encode_mode=em, device="cpu"))
        g = np.asarray(sv["Sv"].values)[:, :EK80_HEAD]
        p50, p99, mx, nan_bad = _db_stats(g, cpu["Sv"].values)
        fields[f"{name}_vs_cpu_dB"] = {"p50": p50, "p99": p99, "max": mx, "nan_mismatch": nan_bad}
        checks[f"compute_Sv {name} cuda vs cpu"] = (nan_bad == 0 and mx <= EK80_CPU_DB[name]
                                                    and np.isfinite(g).mean() > 0.5)
        if name == "BB":
            f64 = timed("compute_Sv_BB_f64_head", lambda: et.calibrate.compute_Sv(
                head, waveform_mode=wm, encode_mode=em, precision="float64"))
            p50, p99, mx, nan_bad = _db_stats(g, f64["Sv"].values)
            fields["BB_f32_vs_f64_dB"] = {"p50": p50, "p99": p99, "max": mx,
                                          "nan_mismatch": nan_bad}
            checks["compute_Sv BB float32 vs float64"] = nan_bad == 0 and mx <= BB_F64_DB
        del sv, cpu
    compute_sv_launches = dict(mf.LAUNCHES)
    say("ek80_compute_Sv", shape=[1, EK80_PINGS, EK80_R], seconds=json.dumps(seconds),
        matched_filter_launches=json.dumps(compute_sv_launches),
        **{k: json.dumps(v) for k, v in fields.items()})

    timings = [t for (wm, ch), y in replicas.items()
               for t in matched_filter_timing(ed, retrieve_correct_beam_group(ed, wm, "complex"),
                                              ch, y)]
    for t in timings:
        say("matched_filter", **{k: (round(v, 4) if isinstance(v, float) and v < 1e6 else v)
                                 for k, v in t.items()})
    del ed

    runs, walls, launches = {}, {}, {}
    legs = {
        "power": (files, {}),
        "bb_chunked": (files, dict(waveform_mode="BB", encode_mode="complex")),
        "bb_fused": (files, dict(waveform_mode="BB", encode_mode="complex", device_fused=True)),
        "cw_fused_A": (files[:1], dict(waveform_mode="CW", encode_mode="complex",
                                       device_fused=True)),
        "cw_chunked_A": (files[:1], dict(waveform_mode="CW", encode_mode="complex")),
    }
    for leg, (srcs, kw) in legs.items():
        for device in ("cuda", "cpu"):
            wp.reset_launches()
            mf.reset_launches()
            t0 = time.perf_counter()
            out = et.run_survey_mvbs_from_raw(srcs, sonar_model="EK80", timer=StageTimer(),
                                              device=device, **EK80_GRID, **kw)
            torch.cuda.synchronize()
            walls[f"{leg}_{device}"] = round(time.perf_counter() - t0, 3)
            runs[f"{leg}_{device}"] = out
            launches[f"{leg}_{device}"] = {**wp.LAUNCHES, **mf.LAUNCHES}
    for k, v in runs.items():
        n = EK80_PINGS * (1 if k.startswith("cw") else len(files))
        print(f"[ek80_survey_stages] {k} pings_per_s={round(n / walls[k], 1)} "
              f"{v.attrs['stage_timing']}", flush=True)
    diffs = {}
    for leg in legs:
        g, w = runs[f"{leg}_cuda"], runs[f"{leg}_cpu"]
        db, same_nan = _max_db(g["Sv"].values, w["Sv"].values)
        diffs[f"{leg}_cuda_vs_cpu_dB"] = db
        finite = float(np.isfinite(np.asarray(g["Sv"].values)).mean())
        checks[f"{leg} cuda vs cpu"] = (
            same_nan and db <= MVBS_ATOL_DB and finite > 0.5
            and _same_coords(g, w, ("channel", "ping_time", "echo_range"))
            and g.attrs["device"] == torch.cuda.get_device_name(0))
    for fused, chunked in (("bb_fused", "bb_chunked"), ("cw_fused_A", "cw_chunked_A")):
        a = np.asarray(runs[f"{chunked}_cuda"]["Sv"].values)
        b = np.asarray(runs[f"{fused}_cuda"]["Sv"].values)
        same_nan = a.shape == b.shape and np.array_equal(np.isnan(a), np.isnan(b))
        body = float(np.nanmax(np.abs(b[:, :, :-1] - a[:, :, :-1]))) if same_nan else np.inf
        last = float(np.nanmax(np.abs(b[:, :, -1] - a[:, :, -1]))) if same_nan else np.inf
        diffs[f"{fused}_vs_chunked_dB"] = [body, last]
        checks[f"{fused} vs {chunked}"] = (same_nan and body <= FUSED_VS_CHUNKED_DB
                                           and last <= FUSED_LAST_BIN_DB)
    power = launches["power_cuda"]
    chunks = len(files) * -(-EK80_PINGS // EK80_GRID["chunk_pings"])
    checks["power leg launches"] = (power["window_partials_uniform"] + power["window_partials"]
                                    == chunks and power["toeplitz_matmul"] == 0)
    checks["no launches on cpu"] = not any(v for k, d in launches.items() if k.endswith("cpu")
                                           for v in d.values())
    say("ek80_survey", walls_s=json.dumps(walls), launches=json.dumps(launches),
        mvbs_shape=list(runs["bb_fused_cuda"]["Sv"].shape), diffs=json.dumps(diffs))
    failed = [k for k, v in checks.items() if not v]
    if failed:
        raise AssertionError(f"ek80 phase failed: {failed}")
    mf_launches = sum(d["toeplitz_matmul"] for k, d in launches.items() if k.endswith("cuda"))
    return ({k: power[k] for k in ("window_partials_uniform", "window_partials")},
            {"launches": mf_launches + compute_sv_launches["toeplitz_matmul"],
             "timings": timings})


def write_files():
    sys.path.insert(0, str(ROOT / "tests"))
    from synth_ek60 import write_ek60_raw

    DATA_DIR.mkdir(parents=True, exist_ok=True)
    t0 = np.datetime64("2020-01-01T00:00:00", "ns")
    files = []
    start_s = 0
    for tag, n_pings, jitter in zip("ABC", E2E_PINGS, (False, False, True)):
        path = DATA_DIR / f"SMOKE{tag}-D20200101-T000000.raw"
        write_ek60_raw(path, n_pings=n_pings, n_samples=R, channels=CHANNELS, frequencies=FREQS,
                       t0=t0 + np.timedelta64(start_s, "s"), seed=len(files),
                       with_angle=False, jitter_raw0=jitter)
        files.append(str(path))
        start_s += n_pings
    return files


def main():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; this needs a CUDA card")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    name = torch.cuda.get_device_name(0)
    sys.path.insert(0, str(ROOT))
    import echopype_torch as et
    from echopype_torch import native
    from echopype_torch.ops import window_partials as wp

    import scipy

    scanner = native.load_native()
    say("start", card=repr(smi), torch=torch.__version__, cuda=torch.version.cuda,
        python=sys.version.split()[0], device_count=torch.cuda.device_count(),
        scipy=scipy.__version__, allow_tf32=torch.backends.cuda.matmul.allow_tf32,
        native_scanner=scanner is not None,
        native_lib=repr(str(Path(scanner._name).relative_to(ROOT)) if scanner else None))
    from echopype_torch.ops._build import build
    from echopype_torch.utils.profiling import StageTimer

    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(KERNEL_SOURCES)) as pool:  # one nvcc per source, together
        built = list(pool.map(build, KERNEL_SOURCES))
    ptxas = [ln.strip() for _, log in built for ln in log.splitlines()
             if "registers" in ln or "spill" in ln]
    say("build", seconds=round(time.perf_counter() - t0, 2),
        libraries=",".join(lib.name for lib, _ in built), ptxas=json.dumps(ptxas))

    k1 = kernel_phase("K1", uniform=True, seed=1)
    kernel_phase("K1", uniform=True, seed=5, ping_bin_s=COARSE_PING_BIN_S)
    k2 = kernel_phase("K2", uniform=False, seed=2)
    kernel_phase("K2", uniform=False, seed=6, ping_bin_s=COARSE_PING_BIN_S)
    k3 = fused_phase("K3", with_sv=True, seed=3)
    k4 = fused_phase("K4", with_sv=False, seed=4)
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    files = write_files()
    say("write_raw", files=len(files), seconds=round(time.perf_counter() - t0, 2),
        GB=round(sum(Path(f).stat().st_size for f in files) / 1e9, 3))
    kw = dict(range_bin=f"{RANGE_BIN_M:g}m", ping_time_bin=f"{PING_BIN_S}s", chunk_pings=P)
    n_pings = sum(E2E_PINGS)
    try:
        timer = StageTimer()
        wp.reset_launches()
        t0 = time.perf_counter()
        mvbs = et.run_survey_mvbs_from_raw(files, timer=timer, **kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(wp.LAUNCHES)
        say("e2e_cuda", wall_s=round(wall, 3), pings_per_s=round(n_pings / wall, 1),
            launches=json.dumps(launches), stages=json.dumps(timer.report(log=False)))
        t0 = time.perf_counter()
        ref = et.run_survey_mvbs_from_raw(files, device="cpu", **kw)
        say("e2e_cpu", wall_s=round(time.perf_counter() - t0, 3))
        sv_launches, grid_a = sv_grid_phase(files[0])
        stores = sv_survey_phase(files, grid_a)
        del grid_a
        torch.cuda.empty_cache()
        mask_programs = masks_phase(files, stores)
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        files80 = write_ek80_files()
        say("write_ek80", files=len(files80), seconds=round(time.perf_counter() - t0, 2),
            GB=round(sum(Path(f).stat().st_size for f in files80) / 1e9, 3))
        ek80_launches, matched_filter = ek80_phase(files80)
    finally:
        shutil.rmtree(DATA_DIR, ignore_errors=True)

    chunks = [-(-n // P) for n in E2E_PINGS]
    want_launches = {"window_partials_uniform": chunks[0] + chunks[1],
                     "window_partials": chunks[2]}
    if launches != want_launches:
        raise AssertionError(f"launch counts {launches}, expected {want_launches}")
    g, w = np.asarray(mvbs["Sv"].values), np.asarray(ref["Sv"].values)
    same_coords = all(
        np.array_equal(np.asarray(mvbs.coords[k].values), np.asarray(ref.coords[k].values))
        for k in ("channel", "ping_time", "echo_range")
    )
    n_x = n_pings // PING_BIN_S + 1  # pings at t0 + 1 s .. t0 + n_pings s
    echo_range = np.asarray(mvbs.coords["echo_range"].values)
    grid_ok = g.shape[:2] == (C, n_x) and np.array_equal(
        echo_range, RANGE_BIN_M * np.arange(g.shape[2]))
    same_nan = np.array_equal(np.isnan(g), np.isnan(w))
    max_db = float(np.nanmax(np.abs(g - w)))
    finite = float(np.isfinite(g).mean())
    say("e2e_check", shape=list(g.shape), grid_ok=grid_ok, same_coords=same_coords,
        same_nan_mask=same_nan, finite_share=round(finite, 4), max_abs_dB=max_db,
        device=repr(mvbs.attrs["device"]))
    if not (grid_ok and same_coords and same_nan and max_db <= MVBS_ATOL_DB and finite > 0.9):
        raise AssertionError("card MVBS disagrees with the CPU run")

    # the matched filter is no Pallas kernel's port (a cuBLAS matmul), so it
    # is not in the kernels line; its row of PERF.md's second table
    say("device_programs", matched_filter=json.dumps(matched_filter))
    say("device_programs", masks=json.dumps(mask_programs))
    src = "echopype_torch/csrc/window_partials.cu"
    src_fused = "echopype_torch/csrc/sv_bin_partials.cu"
    table = [
        {"name": "window_partials_uniform", "route": "cuda", "source": src,
         "replaces": "echopype_tpu/ops/pallas_window.py:174",
         "launches": launches["window_partials_uniform"]
         + ek80_launches["window_partials_uniform"], **k1},
        {"name": "window_partials", "route": "cuda", "source": src,
         "replaces": "echopype_tpu/ops/pallas_window.py:219",
         "launches": launches["window_partials"] + ek80_launches["window_partials"], **k2},
        {"name": "sv_bin_partials", "route": "cuda", "source": src_fused,
         "replaces": "echopype_tpu/ops/pallas_pipeline.py:30",
         "launches": sv_launches["sv_bin_partials"], **k3},
        {"name": "mvbs_partials", "route": "cuda", "source": src_fused,
         "replaces": "echopype_tpu/ops/pallas_pipeline.py:170",
         "launches": sv_launches["mvbs_partials"], **k4},
    ]
    print(json.dumps({"kernels": table}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
