#!/usr/bin/env python3
"""Drive echopype_torch's survey, Sv-grid, masking, EK80, AZFP, cruise and mesh paths once on a CUDA card.

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
   then K1's and K2's float32 instances (``window_partials_uniform_f32``,
   ``window_partials_f32``) the same way on float32 dB power of the same
   shape (400 MB), whose short pings are NaN past their valid length and
   one ping all NaN;
5. K3 (``sv_bin_partials``) at the full width, 5 x 5,000 x 4,000 float32
   dB power with a NaN suffix on every 97th ping and scattered interior
   NaNs, dr 0.18944 m, 20 m range bins, against its plain twin on the card:
   Sv within rtol 1e-5 / atol 1e-5 with identical NaN masks, counts exact,
   sums within rtol 1e-5, two runs bit-identical, both timed, and its
   share of the bound (bound ms / ms) at least 0.5;
6. K4 (``mvbs_partials``) the same way for the partials;
7. the binning programs (``binning``) no survey path runs, on file A's grid
   at K3's shape (5 x 5,000 x 4,000 float32 Sv, 20 m x 20 s):
   ``binned_sum_partials``, ``binned_mean_linear``, ``binned_sum_raw``,
   ``blocked_banded_segment_sum`` (G from ``choose_block_g``) and
   ``binned_mean_1d``, each on the card against ``device="cpu"`` over the
   first 500 pings (counts exact, sums rtol 1e-6, identical NaN masks) and
   timed at the full shape with its byte bound (``torch.segment_reduce`` timed
   beside the blocked sum); then ``sv_mvbs_window_partials_uniform`` on one
   chunk with ``block_g=G`` and ``block_g=0``: one K1 launch each, counts
   equal and sums bit-identical;
8. the survey end to end: three synthetic EK60 files (5 channels,
   18-200 kHz, 4,000 samples a ping; two of 10,000 pings, one of 5,000 whose
   sound speed varies by ping, so it takes K2) through
   ``run_survey_mvbs_from_raw`` on the card; the K1/K2 launch counters must
   equal the chunks each path took, and the MVBS must agree with the same
   call on the CPU (plain twins) within 1e-4 dB with identical NaN masks
   and coordinates;
9. the Sv grids end to end on file A: ``open_raw`` -> ``compute_Sv`` on the
   card -> ``compute_MVBS`` (20 m x 20 s) and ``compute_NASC`` (depth from
   ``consolidate.add_depth`` with the Platform vertical offsets, and a
   synthetic track), each against the same call on the CPU (1e-4 dB, NASC
   rtol 1e-5, identical NaN masks); and
   ``survey_pipeline_step`` with and without Sv (K3, K4) on the same file's
   calibration inputs and compute_MVBS's grid: K3's Sv equals compute_Sv's
   (rtol/atol 1e-5, same NaN mask), its MVBS equals compute_MVBS's within
   1e-4 dB, K4's MVBS equals K3's within 1e-3 dB, one launch each;
10. the Sv-store surveys: files A, B and C through open_raw -> compute_Sv
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
11. masks (``masks``): noise injected into A's and C's stores as
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
12. EK80 (``ek80``): two files of tests/synth_ek80.py (70 kHz FM, 120 kHz
   CW complex, 38 kHz GPT power; 2,000 pings x 8,192 samples x 4 sectors
   each, consecutive in time): ``open_raw`` (seconds, each complex
   channel's replica length); ``compute_Sv`` on file A in BB, CW complex
   and CW power on the card, each against the same call on the CPU over
   the first 200 pings (1e-3 dB BB, 1e-4 dB otherwise, identical NaN
   masks) and BB against ``precision="float64"`` there (1e-3 dB, no NaN-mask
   mismatch; p50 / p99 / max printed), and BB there under
   ``set_conv_precision("HIGH")`` and ``"DEFAULT"`` against the default
   "HIGHEST" (HIGH within 0.004 dB for Sv within 40 dB of the channel's
   peak, 0.02 dB within 60 dB, identical NaN masks; the precision restored
   afterwards, also on failure); the matched filter's matmul alone per
   complex channel, float64 (compute_Sv's), float32 (the fused step's) and
   the bf16 split products HIGH and DEFAULT, CUDA events, median of 20,
   against its bound, with one ``conv1d`` computing the same correlation
   timed beside it (bf16 for DEFAULT, within bf16 output rounding; none for
   HIGH), the split products also on the CPU over 256 lanes (2e-6 of
   scale), their product alone against its plain version on the card, and
   their power against the float64 product's in dB (HIGH within 0.004 dB
   within 40 dB of the peak, and within 60 dB within 0.02 dB or, where the
   bf16x3 arithmetic itself exceeds that, within 1e-3 dB of its plain
   version's error on the card); then
   ``run_survey_mvbs_from_raw`` (5 m x 20 s, chunks of 1,000 pings) over
   both files in power mode, BB chunked and BB fused, and CW complex fused
   and chunked on A, each on cuda and cpu: within 1e-4 dB with identical
   NaN masks and coordinates, fused vs chunked within 5e-3 dB (0.2 dB in
   the last range bin, tests/test_survey.py:536-538), K1 + K2 launched
   once per power-mode chunk, nothing launched on cpu; walls, stage
   seconds and pings/s of every run;
13. AZFP and the other instruments (``azfp``): three hourly files of a
   four-frequency AZFP (38/125/200/455 kHz, 1,000/1,000/800/600 bins, 1 Hz,
   3,600 pings each; the script's own writer of tests/synth_azfp.py's
   header): ``open_raw`` and ``compute_Sv`` on one file, card and CPU
   bit-identical (host float64); ``run_survey_mvbs_from_raw`` (5 m x 20 s,
   chunks of 5,000) over the three on the card twice (bit-identical) and
   on the CPU (1e-4 dB, identical NaN masks and coordinates), one K2-f32
   launch a chunk and no other K1/K2 launch, and against compute_Sv ->
   compute_MVBS on the card within rtol 2e-3 / atol 5e-2
   (tests/test_survey.py:284); the same survey with
   ``freq_diff="200kHz - 38kHz > 3.0dB"`` and, on one file, with
   ``noise_masks`` (card vs CPU, bins excused only where a sample's mask
   differs within 1e-4 dB); one tests/test_azfp6.py file (3,600 pings,
   1,000 bins) through the survey on cuda vs cpu; ``compute_Sv`` with
   tests/test_ecs.py's ECS text (SourceCals added for file A's other three
   channels) on A's first 2,000 pings, equal on the card to the same
   parameters given explicitly and within 1e-4 dB of the CPU; ``open_raw``
   of one tests/test_ad2cp.py file;
14. the multi-file cruise (``cruise``): ``run_survey_mvbs_from_raw`` over
   the survey files A, B, C with ``workers=3`` (a spawned pool decodes one
   file a process and never touches the card), bit-identical to
   ``workers=0, prefetch=False`` on the card with the same K1 / K2 launches,
   and within 1e-4 dB of the default prefetch streamer; walls and pings/s of
   the three with ``os.cpu_count()`` and the card's name and power limit;
   the same for the three AZFP files (K2-f32 a chunk); then three EK60
   files of 2,000 pings at the survey's width through ``open_raw`` ->
   ``combine_echodata`` -> one reversed ping time (as
   tests/test_metrics_qc.py:158-168) -> ``to_zarr`` ->
   ``qc.orchestrate_reverse_time_check(zarr_store=)`` -> ``open_converted``
   (the store equals the repaired tree bit for bit), ``compute_Sv`` and
   ``compute_MVBS`` on the card against the CPU (1e-4 dB, identical NaN
   masks and coordinates) and the five ``metrics`` on the first 2,000 pings
   of the card's and the CPU's Sv (rtol 1e-4, identical NaN masks); last,
   one survey of file A inside ``utils.profiling.trace``: the Chrome trace
   is written and holds every host-side K1 launch of the survey, and its
   device kernel events are counted by name with the card's busy share of
   the traced window (none found is printed, not a failure);
15. multi-device surveys (``mesh``), the port of
   __graft_entry__.py::dryrun_multichip on ``make_mesh(4,
   devices=["cuda:0"] * 4)``, four blocks of this one card (it prints
   ``distinct_devices=1``): the EK60 survey over A, B, C on a (ping 4,
   channel 1) mesh twice against the one-device survey above (MVBS within
   1e-4 dB, NaN masks and coordinates identical, the reruns bit-identical,
   K1 / K2 launches exactly 4 x the one-device launches, pings/s of each);
   file A on the card's mesh against the same mesh on the CPU (1e-4 dB);
   ``freq_diff`` over A and C on the (4, 1) mesh against one device (1e-5
   dB, bins excused only where a sample sits within 1e-4 dB of the
   criterion);
   ``run_survey_mvbs`` over the dry run's Sv stores (6 channels, 40,000 +
   40,000 + 21,056 pings, R = 64, chunks of 4,096) on (ping 2, channel 2)
   against one device within 1e-6 dB, and ``run_survey_nasc`` over its NASC
   files with an impulse-noise mask (rtol 1e-5, atol 1e-8), and
   ``run_survey_mvbs`` over the Sv stores with impulse and attenuated
   masks on echo_range against one device (1e-6 dB, identical NaN masks;
   each leg's wall and K1-K4 launches printed); the EK80
   broadband surveys (three two-FM-channel files, chunked; two-epoch CW and
   BB files) against one device within 1e-4 dB, and ``device_fused=True``
   with the mesh (a warning, then the chunked path, bit-identical to it);
   at the kernel phase's shape, ``survey_pipeline_step`` with K3 and K4 once
   per block and the 3-axis step (ping 2, channel 1, range 2) against the
   one-device step, ``sharded_mvbs_step_closed`` and K1 / K2 through
   ``sharded_mvbs_partials_closed`` (counts exact, sums rtol 1e-5), each
   kernel's launches counted;
16. print the matched filter's and the masks' device programs (plain
   PyTorch, not a Pallas kernel's port) with launches and timings, then the
   kernel table as one JSON line
   (launches on the main paths, the survey's, the ek80 power leg's, the
   cruise phase's and the mesh phase's for K1 / K2, the Sv-grid phase's
   and the mesh phase's for K3 / K4, the AZFP survey's and the cruise
   phase's for the float32 instances; error, kernel /
   plain twin ms, bound ms and what sets it; no
   single PyTorch call computes any of the four functions, so
   ``library_ms`` is null), then the result line ``{"ok": true, "device":
   {...}}`` last.

Imports nothing of JAX.  The synthetic files are written under ``build/``
in the checkout and removed at the end.
"""

import ast
import json
import shutil
import statistics
import struct
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
# the matched filter's bf16 split products ("HIGH", "DEFAULT"): card against
# the plain version on the CPU over a head of lanes (float32 sums in another
# order: 2e-6 of the output's scale, tests/test_calibrate_ek80.py:308), and
# HIGH against float64 within the JAX package's budget
# (echopype_tpu/ops/matched_filter.py:25-29), in dB within 40 / 60 dB of the
# peak: the product's power at full width, and compute_Sv BB on EK80_HEAD
# pings against "HIGHEST" (Sv within 40 / 60 dB of the channel's peak Sv)
SPLIT_HEAD, SPLIT_CPU_REL = 256, 2e-6
HIGH_DB = {40: 0.004, 60: 0.02}
# the bf16x3 arithmetic itself (its plain version on the card, float32 sums
# rounded to nearest) reads 0.0221 dB within 60 dB of the peak over one
# channel of file A, 65.5 M samples of noise (PERF.md §6): over 0.02 at
# full width, the card's product is held to that arithmetic's own error
# within this margin, and to HIGH_DB everywhere else
HIGH_PLAIN_MARGIN_DB = 1e-3
FUSED_VS_CHUNKED_DB, FUSED_LAST_BIN_DB = 5e-3, 0.2  # tests/test_survey.py:536-538
# the masks phase: noise injected as tests/test_survey_clean.py:35-49 does
# pings of A (grid route) and C (grid by ping) for the masks' card-vs-CPU
# checks and the masked Sv-store surveys: C's pooling runs in float64 and
# its CPU reference takes tens of ms a ping of 5 x 4,000 samples, so C
# takes a shorter head
MASK_HEAD = {"A": 500, "C": 150}
MASK_SURVEY_PINGS = {"A": 1000, "C": 150}
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
# the azfp phase: four-frequency AZFP moorings (the OOI Endurance Array's
# 38/125/200/455 kHz units), 1 Hz pings in hourly files, bins ragged across
# channels; pulse lengths from parse_azfp.SV_OFFSET's table
AZFP_FREQS_KHZ = (38, 125, 200, 455)
AZFP_PULSE_US = (1000, 300, 300, 300)
AZFP_BINS = (1000, 1000, 800, 600)
AZFP_PINGS, AZFP_FILES = 3600, 3
AZFP_LOCKOUT, AZFP_SAMPLES_PER_BIN, AZFP_DIG_RATE = 8, 8, 64000
AZFP_ENV = {"salinity": 32.0, "pressure": 60.0}  # tests/test_survey.py:258
AZFP_GRID = dict(range_bin="5m", ping_time_bin="20s", chunk_pings=5000)
AZFP_FD_EQ = "200kHz - 38kHz > 3.0dB"
COMPOSED_RTOL, COMPOSED_ATOL_DB = 2e-3, 5e-2  # tests/test_survey.py:284
AZFP6_BINS = 1000
ECS_PINGS = 2000  # the head of file A calibrated with an ECS file
# the cruise phase: the survey files decoded by a pool of one process a
# file; a three-file cruise at the survey's width, combined, repaired (one
# reversed ping time in the second file) and stored; the metrics on the
# first file's pings of the card's and the CPU's Sv (host float64 numpy,
# ~7 s per 1,000 pings on a CPU core: the whole cruise would take minutes)
CRUISE_WORKERS = 3
CRUISE_PINGS, CRUISE_FILES = 2000, 3
METRICS = ("abundance", "center_of_mass", "dispersion", "evenness", "aggregation")
METRICS_PINGS = 2000
# the card's Sv within 1e-4 dB of the CPU's is within 2.3e-5 relative in
# linear sv; the metrics' sums over 4,000 samples and their ratios stay
# inside this
METRICS_RTOL = 1e-4
# the mesh phase: __graft_entry__.py::dryrun_multichip on four blocks of one
# card; the Sv-store, NASC and broadband files are its own layouts
MESH_SHARDS = 4
MESH_SV_C, MESH_SV_R, MESH_SV_PINGS = 6, 64, (40_000, 40_000, 21_056)
MESH_SV_DB = 1e-6  # __graft_entry__.py:199-207
MESH_NASC_PINGS = (16_000, 8_192)
MESH_NASC_RTOL, MESH_NASC_ATOL = 1e-5, 1e-8  # __graft_entry__.py:352-358
MESH_BB_PINGS = (4096, 4096, 2048)
MESH_EPOCH_PINGS = 512  # a filter epoch of the two-epoch files
# the raw freq-diff mesh leg: files A and C (K1's and K2's geometry); the
# Sv-store noise-mask leg: the masks of tests/test_torch_survey_masks.py on
# echo_range (the dry-run stores carry no depth)
MESH_FD_DB = 1e-5
MESH_NOISE_MASKS = {
    "impulse": dict(depth_bin="4m", num_side_pings=2, impulse_noise_threshold="10.0dB",
                    range_var="echo_range"),
    "attenuated": dict(upper_limit_sl="10.0m", lower_limit_sl="30.0m", num_side_pings=3,
                       attenuation_signal_threshold="5.0dB", range_var="echo_range"),
}
# the binning phase: the public binning names on the card against the CPU
# over a head of pings (counts exact, sums rtol 1e-6)
BINNING_HEAD, BINNING_RTOL = 500, 1e-6
# H100 SXM peaks at the full 700 W (NVIDIA's data sheet): HBM3 bytes/s and
# float32 operations/s outside the tensor cores.  The latter counts an FMA
# as two: the card issues half as many instructions, 128 lanes a clock per
# SM, and every instruction, whatever its unit, takes one of those slots.
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
BF16_FLOP_PER_S = 989e12  # dense bf16 on the tensor cores
INSTR_PER_S = F32_OPS_PER_S / 2
# instructions of the library expf / log10f on sm_90a inside a loop (SASS,
# counted by tools/window_probe.py: 10 and 28, less the constant moves a
# loop hoists)
EXPF_INSTR, LOG10F_INSTR = 8, 25
# instructions a sample needs (what the function computes, not what the
# kernel issues): the int16 -> float conversion (K1, K2) or the sample's
# range k dr - shift (K3, K4: 3), the sonar equation's rounded multiplies
# and adds, the library calls, the adds into the bin sum (and count, K3/K4)
# float32 dB power (K1_f32, K2_f32) has no conversion and no INDEX2POWER
# multiply, and selects out a NaN sample before its add
INSTR_PER_SAMPLE = {
    "K1": 1 + 6 + EXPF_INSTR + 1,
    "K2": 1 + 10 + LOG10F_INSTR + EXPF_INSTR + 1,
    "K1_f32": 5 + EXPF_INSTR + 2,
    "K2_f32": 9 + LOG10F_INSTR + EXPF_INSTR + 2,
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


def chunk_inputs(seed, vary_dr, ping_bin_s=PING_BIN_S, f32=False):
    """One survey chunk at the main path's shape, made from ``seed``: int16
    indices, or with ``f32`` float32 dB power (the AZFP path's type) whose
    short pings are NaN past their valid length and one ping is all NaN."""
    rng = np.random.default_rng(seed)
    power = rng.integers(-12000, -2000, (C, P, R), dtype=np.int16)
    if f32:
        power = (power * np.float32(0.011758984205624481)).astype("f4")
    dr = np.full((C, P), 256e-6 * 1480.0 / 2.0, "f4")  # 0.18944 m
    if vary_dr:
        dr = (dr * rng.uniform(0.97, 1.03, (C, P))).astype("f4")
    shift = (2.0 * dr).astype("f4")
    ab = np.tile(rng.uniform(0.002, 0.05, (C, 1)), (1, P)).astype("f4")
    off = rng.normal(-30.0, 2.0, (C, P)).astype("f4")
    vl = np.full((C, P), R, "i4")
    vl[:, ::97] = rng.integers(0, R, vl[:, ::97].shape)  # some short pings
    if f32:
        vl[C // 2, 13] = 0  # one all-NaN ping
        power[np.arange(R)[None, None, :] >= vl[:, :, None]] = np.nan
    t = 7.0 + np.arange(P)  # 1 Hz pings, not aligned to the bin edges
    ids = (t // ping_bin_s).astype("i4")
    x_rel = ids - ids[0]
    W = int(x_rel[-1]) + 1
    r_bound = R * 256e-6 * 1700.0 / 2.0  # the streamer's scanned range bound
    edges = np.arange(0, r_bound + RANGE_BIN_M, RANGE_BIN_M).astype("f4")
    return power, dr, shift, ab, off, vl, x_rel, edges, W


def kernel_phase(name, uniform, seed, ping_bin_s=PING_BIN_S):
    """K1 / K2 (``name`` K1, K2, or K1_f32, K2_f32 for the float32 instances)
    against the plain twin on the card, timed, with the bound."""
    from echopype_torch.ops import window_partials as wp
    from echopype_torch.parallel.pipeline import (
        closed_bounds_k0_np, closed_window_counts_np, kernel_inputs_from_numpy)

    args = chunk_inputs(seed, vary_dr=not uniform, ping_bin_s=ping_bin_s,
                        f32=name.endswith("_f32"))
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
    # each binned valid sample read once (2 bytes, float32 4), the small
    # operands read once, the outputs written once
    n_binned = float(c_k.sum())
    sample_bytes = ops["power"].element_size()
    small = [t for key, t in plain_ops.items() if key != "power"]
    bound = bound_ms(sample_bytes * n_binned + nbytes(*small)
                     + nbytes(*(out if isinstance(out, tuple) else [out])),
                     INSTR_PER_SAMPLE[name] * n_binned)
    n_slabs = ops["plan"].shape[0] - args[-1] - 1
    say(name, shape=list(ops["power"].shape), W=args[-1], slabs=n_slabs,
        n_r=ops["bounds"].shape[1] - 1, counts_exact=counts_exact, bit_identical=bit_identical,
        max_abs_err=max_abs, max_rel_err=max_rel, ms=round(ms, 4), plain_ms=round(plain_ms, 4),
        power_MB=round(nbytes(ops["power"]) / 1e6, 1),
        bound_ms=round(bound["bound_ms"], 4), bound_by=bound["bound_by"],
        share_of_bound=round(bound["bound_ms"] / ms, 3),
        power_GBps=round(nbytes(ops["power"]) / 1e6 / ms, 1), h2d_s=round(h2d_s, 3))
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
        power_MB=round(nbytes(ops["power"]) / 1e6, 1),
        bound_ms=round(bound["bound_ms"], 4), bound_by=bound["bound_by"],
        share_of_bound=round(bound["bound_ms"] / ms, 3), power_GBps=round(power_mb / ms, 1),
        moved_GBps=round(power_mb * (2 if with_sv else 1) / ms, 1))
    if not (sv_ok and counts_exact and bit_identical and max_rel <= SUM_RTOL):
        raise AssertionError(f"{name}: kernel disagrees with its plain twin")
    if bound["bound_ms"] / ms < MIN_SHARE_OF_BOUND:
        raise AssertionError(f"{name}: {ms:.4f} ms is under half its bound's speed")
    return {"max_abs_err": max_abs, "ms": ms, "plain_ms": plain_ms, **bound, "library_ms": None}


def binning_inputs(seed):
    """File A's geometry at the kernel phase's shape: Sv float32 [C, P, R]
    (normal about -70 dB, 8 dB wide, sparse NaNs), its echo_range on A's
    uniform 0.18944 m grid, 20 m range edges, the ping bounds of 20 s bins
    of 1 Hz pings, and a latitude track with a few NaN fixes."""
    rng = np.random.default_rng(seed)
    sv = rng.normal(-70.0, 8.0, (C, P, R)).astype("f4")
    sv[rng.random((C, P, R), dtype=np.float32) < 1e-4] = np.nan
    dr = np.float32(256e-6 * 1480.0 / 2.0)
    er = np.broadcast_to(np.arange(R, dtype="f4") * dr, (C, P, R)).copy()
    r_edges = np.arange(0, R * float(dr) + RANGE_BIN_M, RANGE_BIN_M).astype("f4")
    ids = ((7.0 + np.arange(P)) // PING_BIN_S).astype("i8")
    x_idx = ids - ids[0]
    lat = 45.0 + np.cumsum(rng.normal(0.0, 1e-5, P))
    lat[rng.random(P) < 0.01] = np.nan
    # linear Sv (0 for NaN) made once on the host, so that the raw and
    # blocked sums take the same values on both devices (the card's pow
    # differs from the CPU's by up to ~1e-6 relative at these exponents)
    with np.errstate(invalid="ignore"):
        lin = np.nan_to_num(10.0 ** (sv.astype("f8") / 10.0), nan=0.0).astype("f4")
    return sv, er, r_edges, x_idx, lat, dr, lin


def binning_phase():
    """The public binning names of ``ops/binning.py`` that no survey path
    runs, on the card against ``device="cpu"`` on a head of pings and timed
    at the full shape; then ``sv_mvbs_window_partials_uniform(block_g=G)``
    on one chunk: K1 whatever ``block_g`` is.  Returns (device programs,
    K1 launches)."""
    from echopype_torch.device import resolve_device
    from echopype_torch.ops import binning as tb
    from echopype_torch.ops import window_partials as wp
    from echopype_torch.parallel import pipeline as tp

    sv, er, r_edges, x_idx, lat, dr, lin_np = binning_inputs(seed=31)
    n_x, n_r = int(x_idx[-1]) + 1, len(r_edges) - 1
    bounds = tp.closed_bounds_k0_np(np.full(C, dr, "f4"), np.full(C, 2 * dr, "f4"), r_edges,
                                    R)[0]
    G = tb.choose_block_g(bounds, R)
    dev = resolve_device("cuda")
    checks, programs = {}, {}

    def ops_on(device, pings):
        x_b = tb.x_bounds_np(x_idx[:pings], np.arange(n_x + 1))

        def t(a):  # the head of a [C, P, R] array, on ``device``
            return torch.from_numpy(np.ascontiguousarray(a[..., :pings, :])).to(device)

        lin = t(lin_np)
        return {
            "binned_sum_partials": (tb.binned_sum_partials,
                                    (t(sv), t(er), torch.from_numpy(r_edges).to(device), x_b)),
            "binned_mean_linear": (tb.binned_mean_linear,
                                   (t(sv), t(er), torch.from_numpy(r_edges).to(device), x_b)),
            "binned_sum_raw": (tb.binned_sum_raw,
                               (lin, t(er), torch.from_numpy(r_edges).to(device), x_b)),
            "blocked_banded_segment_sum": (tb.blocked_banded_segment_sum,
                                           (lin, torch.from_numpy(bounds).to(device), n_r, G)),
            "binned_mean_1d": (tb.binned_mean_1d, (torch.from_numpy(lat[:pings]).to(device),
                                                   torch.from_numpy(x_idx[:pings]).to(device),
                                                   n_x)),
        }

    head = {k: fn(*a) for k, (fn, a) in ops_on(dev, BINNING_HEAD).items()}
    ref = {k: fn(*a) for k, (fn, a) in ops_on(torch.device("cpu"), BINNING_HEAD).items()}
    errs = {}
    for name in head:
        got = [t.cpu().double().numpy() for t in (head[name] if isinstance(head[name], tuple)
                                                  else (head[name],))]
        want = [t.double().numpy() for t in (ref[name] if isinstance(ref[name], tuple)
                                             else (ref[name],))]
        if name == "binned_mean_linear":  # dB: rtol 1e-6 of the linear mean
            got, want = [10.0 ** (g / 10.0) for g in got], [10.0 ** (w / 10.0) for w in want]
        sums, counts = (got[0], want[0]), list(zip(got[1:], want[1:]))
        same_nan = all(np.array_equal(np.isnan(a), np.isnan(b)) for a, b in (sums, *counts))
        ok = np.isfinite(sums[1]) & (sums[1] != 0)
        errs[name] = float(np.max(np.abs(sums[0][ok] / sums[1][ok] - 1.0))) if ok.any() else 0.0
        checks[f"{name} counts exact"] = all(np.array_equal(a, b) for a, b in counts)
        checks[f"{name} cuda vs cpu"] = same_nan and ok.any() and errs[name] <= BINNING_RTOL
    del head, ref

    full = ops_on(dev, P)
    # the byte bound alone: these are plain PyTorch programs, not kernels
    out_bytes = {"binned_sum_partials": 3 * 8 * C * n_x * n_r,
                 "binned_mean_linear": 8 * C * n_x * n_r, "binned_sum_raw": 8 * C * n_x * n_r,
                 "blocked_banded_segment_sum": 4 * C * P * n_r, "binned_mean_1d": 8 * n_x}
    lin_full, bounds_t = full["blocked_banded_segment_sum"][1][:2]
    b64 = bounds_t.long()
    lengths = torch.cat([b64[:, :1], torch.diff(b64, dim=1), R - b64[:, -1:]], dim=1)
    lengths = lengths[:, None, :].expand(C, P, n_r + 2).contiguous()

    def seg():  # the library call: one segment sum per bin, less the two margins
        return torch.segment_reduce(lin_full, "sum", lengths=lengths, axis=2)[:, :, 1:-1]

    lib_err = float((seg().double() / full["blocked_banded_segment_sum"][0](
        *full["blocked_banded_segment_sum"][1]).double() - 1.0).abs().nan_to_num(0.0).max())
    library = {"blocked_banded_segment_sum": cuda_ms(seg)}
    for name, (fn, args) in full.items():  # launches: no survey path runs them
        in_bytes = nbytes(*[a for a in args if isinstance(a, torch.Tensor)])
        ms = cuda_ms(lambda: fn(*args))
        programs[name] = {"ms": ms, "bytes": in_bytes + out_bytes[name],
                          **bound_ms(in_bytes + out_bytes[name], 0),
                          "library_ms": library.get(name), "launches": 0}
    torch.cuda.synchronize()
    del full, lin_full, bounds_t, lengths

    # the uniform window step with block_g: K1 both ways, one launch each
    args = chunk_inputs(seed=32, vary_dr=False)
    W = args[-1]
    runs, k1 = {}, {}
    for g in (0, G):
        wp.reset_launches()
        runs[g] = tp.sv_mvbs_window_partials_uniform(*args[:8], W, len(args[7]) - 1, g)
        torch.cuda.synchronize()
        k1[g] = wp.LAUNCHES["window_partials_uniform"]
    checks["block_g counts exact"] = torch.equal(runs[0][1], runs[G][1])
    checks["block_g sums bit-identical"] = torch.equal(runs[0][0], runs[G][0])
    checks["block_g one K1 launch each"] = k1 == {0: 1, G: 1}
    say("binning", card_shape=[C, P, R], head_pings=BINNING_HEAD, G=G, n_x=n_x, n_r=n_r,
        cuda_vs_cpu_rel=json.dumps(errs), rtol=BINNING_RTOL,
        block_g_k1_launches=json.dumps(k1), segment_reduce_rel=lib_err)
    failed = [k for k, v in checks.items() if not v]
    if failed:
        raise AssertionError(f"binning phase: {failed}")
    return programs, sum(k1.values())


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
                                 "window_partials_uniform": 0, "window_partials": 0,
                                 "window_partials_uniform_f32": 0, "window_partials_f32": 0},
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
        "window_partials_uniform": 0, "window_partials": 0, "window_partials_uniform_f32": 0,
        "window_partials_f32": 0, "freqdiff_step": chunks}
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


def _sv_db_within(sv, ref):
    """|sv - ref| in dB over the samples whose ``ref`` lies within 40 and
    within 60 dB of its channel's peak, and the NaN-mask mismatches."""
    sv, ref = np.asarray(sv, dtype="f8"), np.asarray(ref, dtype="f8")
    peak = np.nanmax(ref.reshape(ref.shape[0], -1), axis=1).reshape(-1, *[1] * (ref.ndim - 1))
    err = np.abs(sv - ref)
    out = {f"max_dB_within_{db}": float(np.nanmax(np.where(ref >= peak - db, err, np.nan)))
           for db in (40, 60)}
    out["nan_mismatch"] = int(np.count_nonzero(np.isnan(sv) != np.isnan(ref)))
    return out


def _power_db_err(re, im, re64, im64):
    """Max |dB| error of the product's power against the float64 product's,
    over the samples within 40 and within 60 dB of the float64 peak."""
    p = (re.double() ** 2 + im.double() ** 2)
    p64 = re64 ** 2 + im64 ** 2
    peak = float(p64.max())
    err = (10 * torch.log10(p / p64)).abs()
    return {f"max_dB_within_{db}": float(err[p64 >= peak * 10 ** (-db / 10)].max())
            for db in (40, 60)}


def matched_filter_timing(ed, bp, ch, replica):
    """The matched filter's device program alone (the blocked-Toeplitz
    matmul of ``ops/matched_filter.py``) on one channel of file A, 2,000
    pings x 4 sectors x 8,192 float32 samples, timed with CUDA events in
    each of its forms: float64 accumulation (compute_Sv's at "HIGHEST"),
    float32 (the fused survey step's), and the bf16 split products "HIGH"
    and "DEFAULT"; each with its bound and, where one PyTorch call computes
    the same, that call (``torch.nn.functional.conv1d`` in the same dtype;
    bf16 for "DEFAULT"), timed and checked beside it.  The split products
    are also held to their plain version on the CPU over a head of lanes,
    timed alone against that plain version on the card, and held to the
    float64 product at full width in dB within 40 and 60 dB of the peak."""
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
    out, exact = [], None
    for form, dtype, precision in (("float64", torch.float64, "HIGHEST"),
                                   ("float32", torch.float32, "HIGHEST"),
                                   ("HIGH", torch.float32, "HIGH"),
                                   ("DEFAULT", torch.float32, "DEFAULT")):
        hr, hi = (torch.from_numpy(np.ascontiguousarray(a)).to(dev, dtype)
                  for a in (rep.real, rep.imag))

        def product():
            return mf._toeplitz_conv(*(x.to(dtype) for x in lanes), hr, hi, L - 1, R,
                                     tail_zeros=z, precision=precision)

        ms = cuda_ms(product)
        re, im = product()
        scale = float(torch.maximum(re.abs().max(), im.abs().max()))
        row = {"channel": ch, "dtype": form, "lanes": n_lanes, "R": R, "L": L, "T": T}
        # the library call: conv1d cross-correlates, so the kernel is the
        # conjugated replica in the real block form [[cr, -ci], [ci, cr]];
        # no single call computes HIGH's three bf16 passes
        lib_dtype = {"HIGH": None, "DEFAULT": torch.bfloat16}.get(form, dtype)
        if lib_dtype is not None:
            cr, ci = hr.flip(0).to(lib_dtype), hi.flip(0).to(lib_dtype)
            weight = torch.stack([torch.stack([cr, -ci]), torch.stack([ci, cr])])  # [2, 2, L]
            x2 = torch.nn.functional.pad(torch.stack(lanes, dim=1).to(lib_dtype), (0, L - 1))
            library_ms = cuda_ms(lambda: torch.nn.functional.conv1d(x2, weight))
            lib = torch.nn.functional.conv1d(x2, weight).to(re.dtype)
            lib_err = torch.maximum((lib[:, 0] - re).abs(), (lib[:, 1] - im).abs())
            lib_rel = float(lib_err.max()) / scale
            if form == "DEFAULT":  # conv1d rounds its outputs to bf16 (2^-9 of each)
                slack = 2.0 ** -8 * torch.maximum(re.abs(), im.abs())
                lib_ok = float((lib_err - slack).max()) / scale <= 2e-6
            else:
                lib_ok = lib_rel <= (1e-12 if dtype == torch.float64 else 2e-6)
            row.update(library_ms=library_ms, library_max_rel_err=lib_rel)
            del x2, lib, lib_err
        else:
            lib_ok = True
            row.update(library_ms=None,
                       library_note="no single PyTorch call computes a three-pass bf16 product")
        passes = {"HIGH": 3, "DEFAULT": 1}.get(form)
        useful = 8.0 * n_lanes * R * L  # complex MACs, 4 multiplies and 4 adds each
        # float32 lanes in, the outputs out in the product's dtype, the replica
        nbytes = 2 * 4 * n_lanes * R + 2 * re.element_size() * n_lanes * R + 2 * hr.element_size() * L
        t_ops = (useful * passes / BF16_FLOP_PER_S if passes else useful / F32_OPS_PER_S) * 1e3
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        row.update(useful_flop=useful, issued_flop=useful * (passes or 1) * (T + L - 1) / L,
                   bytes=nbytes, ms=ms, bound_ms=max(t_ops, t_bytes),
                   bound_by="operations" if t_ops >= t_bytes else "bytes",
                   share_of_bound=max(t_ops, t_bytes) / ms)
        if form == "float64":
            exact = (re, im)
        else:
            row.update(_power_db_err(re, im, *exact))
        if passes:
            # the product alone, tensor cores against the plain version on
            # the card, on the operands the call above formed
            A, Bm, _, _ = mf._split_operands(*lanes, hr, hi, L - 1, R, precision)
            card = mf._split_matmul(A, Bm)
            plain = mf._split_matmul_plain(A, Bm)
            row.update(product_ms=cuda_ms(lambda: mf._split_matmul(A, Bm)),
                       plain_ms=cuda_ms(lambda: mf._split_matmul_plain(A, Bm)),
                       product_vs_plain_on_card=float((card - plain).abs().max())
                       / float(plain.abs().max()))
            plain_re_im = (plain[:, :, :T].reshape(n_lanes, -1)[:, :R],
                           plain[:, :, T:].reshape(n_lanes, -1)[:, :R])
            row.update({f"plain_{k}": v
                        for k, v in _power_db_err(*plain_re_im, *exact).items()})
            del A, Bm, card, plain, plain_re_im
            cpu = mf._toeplitz_conv(*(x[:SPLIT_HEAD].cpu() for x in lanes), hr.cpu(), hi.cpu(),
                                    L - 1, R, tail_zeros=z, precision=precision)
            head_scale = float(torch.maximum(cpu[0].abs().max(), cpu[1].abs().max()))
            head_rel = max(float((g[:SPLIT_HEAD].cpu() - c).abs().max())
                           for g, c in zip((re, im), cpu)) / head_scale
            row.update(card_vs_cpu_plain_head=head_rel, head_lanes=SPLIT_HEAD)
            if head_rel > SPLIT_CPU_REL:
                raise AssertionError(f"{form} product on the card vs CPU plain on {ch}: {head_rel}")
            limit_60 = max(HIGH_DB[60], row["plain_max_dB_within_60"] + HIGH_PLAIN_MARGIN_DB)
            if form == "HIGH" and not (row["max_dB_within_40"] <= HIGH_DB[40]
                                       and row["max_dB_within_60"] <= limit_60):
                raise AssertionError(f"HIGH product vs float64 on {ch}: {row}")
        out.append(row)
        del re, im
        torch.cuda.empty_cache()
        if not lib_ok:
            raise AssertionError(f"matched filter and conv1d disagree on {ch} ({form}): {lib_rel}")
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

    checks, fields, reduced_launches = {}, {}, {}
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
            for precision in ("HIGH", "DEFAULT"):
                n0, before = mf.LAUNCHES["toeplitz_matmul"], mf._CONV_PRECISION
                try:
                    mf.set_conv_precision(precision)
                    red = timed(f"compute_Sv_BB_{precision}_head", lambda: et.calibrate.compute_Sv(
                        head, waveform_mode=wm, encode_mode=em))
                finally:
                    mf.set_conv_precision(before)
                reduced_launches[precision] = mf.LAUNCHES["toeplitz_matmul"] - n0
                stats = _sv_db_within(np.asarray(red["Sv"].values), g)
                fields[f"BB_{precision}_vs_HIGHEST_dB"] = stats
                if precision == "HIGH":
                    checks["compute_Sv BB HIGH vs HIGHEST"] = (
                        stats["nan_mismatch"] == 0 and stats["max_dB_within_40"] <= HIGH_DB[40]
                        and stats["max_dB_within_60"] <= HIGH_DB[60])
                del red
        del sv, cpu
    compute_sv_launches = dict(mf.LAUNCHES)
    say("ek80_compute_Sv", shape=[1, EK80_PINGS, EK80_R], seconds=json.dumps(seconds),
        matched_filter_launches=json.dumps(compute_sv_launches),
        reduced_precision_launches=json.dumps(reduced_launches),
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
                                    == chunks and power["toeplitz_matmul"] == 0
                                    and power["window_partials_uniform_f32"]
                                    + power["window_partials_f32"] == 0)
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
             "launches_by_precision": {**reduced_launches, "HIGHEST": mf_launches
                                       + compute_sv_launches["toeplitz_matmul"]
                                       - sum(reduced_launches.values())},
             "timings": timings})



# ------------------------------------------------------------------ AZFP
def write_azfp_xml4(path):
    """The instrument XML of a four-frequency AZFP (tests/synth_azfp.py's
    layout, one value per frequency)."""
    def per(tag, vals):
        return "".join(f"<{tag}>{v}</{tag}>" for v in vals)

    Path(path).write_text(f"""<?xml version="1.0"?>
<InstrumentInfo>
  <NumFreq>4</NumFreq>
  <SerialNumber>55077</SerialNumber>
  <SensorsFlag PressureSensorInstalled="no"/>
  <ka>0.001</ka><kb>5000.0</kb><kc>5.0</kc>
  <A>0.00123</A><B>0.000234</B><C>0.00000011</C>
  <X_a>0.0</X_a><X_b>0.01</X_b><X_c>0.0</X_c><X_d>0.0</X_d>
  <Y_a>0.0</Y_a><Y_b>0.01</Y_b><Y_c>0.0</Y_c><Y_d>0.0</Y_d>
  <a0>0.0</a0><a1>0.0</a1>
  {per("DS", (0.0242, 0.0246, 0.0251, 0.0238))}
  {per("EL", (140.2, 142.1, 141.3, 143.0))}
  {per("TVR", (167.3, 169.8, 170.9, 172.4))}
  {per("VTX0", (90.1, 88.2, 87.5, 86.9))}
  {per("BP", (0.0088, 0.0049, 0.0041, 0.0035))}
</InstrumentInfo>""")


def write_azfp_raw4(path, hour, seed, n_pings=None, num_bins=None):
    """One .01A file of the four-frequency AZFP: ``n_pings`` (AZFP_PINGS) 1 Hz
    pings from ``hour``:00:00, counts made from ``seed``; each ping is the
    67-field header of tests/synth_azfp.py::HEADER_FORMAT (four channel
    slots), then each channel's big-endian u16 counts (``num_bins``,
    AZFP_BINS, of them)."""
    sys.path.insert(0, str(ROOT / "tests"))
    from synth_azfp import HEADER_FORMAT

    n_pings = AZFP_PINGS if n_pings is None else n_pings
    num_bins = AZFP_BINS if num_bins is None else num_bins
    rng = np.random.default_rng(seed)
    counts = [rng.integers(0, 60000, (n_pings, n)).astype(">u2") for n in num_bins]
    chunks = []
    for p in range(n_pings):
        vals = [64770, p + 1, 55077, 1, 60, 2021, 3, 15, hour, p // 60, p % 60, 0]
        vals += [AZFP_DIG_RATE] * 4 + [AZFP_LOCKOUT] * 4 + list(num_bins)
        vals += [AZFP_SAMPLES_PER_BIN] * 4
        vals += [1, 0, 1, 1, 1, 1]  # pings a profile, averaged, acquired, period, first, last
        vals += [0, 0, 0, 0, 0]  # data type x4 (counts, not averaged), data error
        vals += [1, 0, len(num_bins)]  # phase, overrun, channels
        vals += [1, 1, 1, 1, 0]  # gain x4, spare
        vals += list(AZFP_PULSE_US) + [1, 2, 3, 4] + list(AZFP_FREQS_KHZ)
        vals += [1, 100, 200, 30000, 0, 30000, 20000, 0]  # sensors, tilt, battery, p, T, ad
        chunks.append(struct.pack(HEADER_FORMAT, *vals))
        chunks.extend(c[p].tobytes() for c in counts)
    Path(path).write_bytes(b"".join(chunks))


def write_azfp_files():
    DATA_DIR.mkdir(parents=True, exist_ok=True)
    xml = DATA_DIR / "55077.XML"
    write_azfp_xml4(xml)
    files = []
    for i in range(AZFP_FILES):
        path = DATA_DIR / f"210315{10 + i:02d}.01A"
        write_azfp_raw4(path, hour=10 + i, seed=i)
        files.append(str(path))
    return files, str(xml)


def test_helpers(module, names, **ns):
    """Top-level constants and undecorated functions of tests/<module>.py,
    run without the module's imports (they import the JAX package, which the
    card's machine does not have); ``ns`` supplies what the helpers use."""
    path = ROOT / "tests" / f"{module}.py"
    keep = [n for n in ast.parse(path.read_text()).body
            if isinstance(n, ast.Assign)
            or (isinstance(n, ast.FunctionDef) and not n.decorator_list)]
    env = {"np": np, "struct": struct, **ns}
    exec(compile(ast.Module(keep, type_ignores=[]), str(path), "exec"), env)
    return [env[n] for n in names]


def _same_run(a, b):
    """Two survey outputs equal bit for bit, coordinates included."""
    return np.array_equal(np.asarray(a["Sv"].values), np.asarray(b["Sv"].values),
                          equal_nan=True) and _same_coords(
        a, b, ("channel", "ping_time", "echo_range"))


def _cuda_vs_cpu(runs, excused=None):
    """(max dB over the bins not excused, NaN masks equal there, coords
    equal) of the cuda and cpu runs."""
    g, w = (np.asarray(runs[d]["Sv"].values) for d in ("cuda", "cpu"))
    err, same_nan, n_exc = _cmp_excused(g, w, np.zeros(g.shape, bool) if excused is None
                                        else excused)
    return err, same_nan and _same_coords(runs["cuda"], runs["cpu"],
                                          ("channel", "ping_time", "echo_range")), n_exc


def azfp_phase(file_a):
    """AZFP, AZFP6, ECS and AD2CP: conversion, calibration and the float32
    dB power survey on K2's float32 instance."""
    import echopype_torch as et
    from echopype_torch.calibrate.ecs import ecs_to_params
    from echopype_torch.convert.parse_ad2cp import checksum
    from echopype_torch.ops import window_partials as wp
    from echopype_torch.parallel import pipeline as tp
    from echopype_torch.parallel.survey import _slice_echodata_pings
    from echopype_torch.utils.profiling import StageTimer

    checks, walls = {}, {}
    t_phase = time.perf_counter()

    def timed(tag, fn):
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        walls[tag] = time.perf_counter() - t0
        return out

    t0 = time.perf_counter()
    files, xml = write_azfp_files()
    say("azfp_write", files=len(files), pings=AZFP_FILES * AZFP_PINGS,
        seconds=round(time.perf_counter() - t0, 2),
        MB=round(sum(Path(f).stat().st_size for f in files) / 1e6, 1))

    # open_raw and compute_Sv on one file: host float64 on cuda and cpu alike
    ed = timed("open_raw", lambda: et.open_raw(files[0], sonar_model="AZFP", xml_path=xml))
    sv = {d: timed(f"compute_Sv_{d}", lambda: et.calibrate.compute_Sv(
        ed, env_params=AZFP_ENV, device=d)) for d in ("cuda", "cpu")}
    checks["compute_Sv cuda == cpu"] = all(
        np.array_equal(sv["cuda"][v].values, sv["cpu"][v].values, equal_nan=True)
        for v in ("Sv", "echo_range"))
    sv_c = np.asarray(sv["cuda"]["Sv"].values)
    ragged = [int(np.isfinite(sv_c[c, 0]).sum()) for c in range(sv_c.shape[0])]
    checks["ragged channels"] = ragged == list(AZFP_BINS)  # channels ascend in frequency
    say("azfp_open", shape=list(sv_c.shape), finite_bins=ragged,
        open_raw_s=round(walls["open_raw"], 2),
        compute_Sv_s={d: round(walls[f"compute_Sv_{d}"], 2) for d in ("cuda", "cpu")},
        device=repr(sv["cuda"].attrs["device"]), bit_identical=checks["compute_Sv cuda == cpu"])

    # the survey over the three files: twice on the card, once on the cpu
    kw = dict(sonar_model="AZFP", xml_path=xml, env_params=AZFP_ENV, **AZFP_GRID)
    n_pings = AZFP_FILES * AZFP_PINGS
    chunks = AZFP_FILES * -(-AZFP_PINGS // AZFP_GRID["chunk_pings"])
    runs, launches, stages = {}, {}, {}
    for tag, device in (("cuda", "cuda"), ("cuda_rerun", "cuda"), ("cpu", "cpu")):
        wp.reset_launches()
        timer = StageTimer()
        runs[tag] = timed(f"survey_{tag}", lambda: et.run_survey_mvbs_from_raw(
            files, timer=timer, device=device, **kw))
        launches[tag] = dict(wp.LAUNCHES)
        stages[tag] = timer.report(log=False)
    survey_launches = launches["cuda"]
    checks["survey launches"] = survey_launches == {
        "window_partials_uniform": 0, "window_partials": 0, "window_partials_uniform_f32": 0,
        "window_partials_f32": chunks} and not any(launches["cpu"].values())
    checks["survey card rerun bit-identical"] = _same_run(runs["cuda"], runs["cuda_rerun"])
    err, same, _ = _cuda_vs_cpu(runs)
    checks["survey cuda vs cpu"] = same and err <= MVBS_ATOL_DB
    g = np.asarray(runs["cuda"]["Sv"].values)

    # the composed chain on the card: compute_Sv -> compute_MVBS, file by file
    sv_files, parts = [], []
    for f in files:
        e = et.open_raw(f, sonar_model="AZFP", xml_path=xml)
        sv_files.append(et.calibrate.compute_Sv(e, env_params=AZFP_ENV))
        parts.append(et.compute_MVBS(sv_files[-1], range_bin=AZFP_GRID["range_bin"],
                                     ping_time_bin=AZFP_GRID["ping_time_bin"]))
    want = np.concatenate([np.asarray(m["Sv"].values) for m in parts], axis=1)
    n_r = min(g.shape[2], want.shape[2])
    # each file's bins in the survey grid; the survey's other bins hold no ping
    pt_s = np.asarray(runs["cuda"].coords["ping_time"].values)
    pt_w = np.concatenate([np.asarray(m.coords["ping_time"].values) for m in parts])
    pos = np.clip(np.searchsorted(pt_s, pt_w), 0, len(pt_s) - 1)
    pt_ok = np.array_equal(pt_s[pos], pt_w) and bool(np.isnan(np.delete(g, pos, axis=1)).all())
    gg, ww = g[:, pos, :n_r], want[:, :, :n_r]
    with np.errstate(invalid="ignore"):
        comp_ok = np.array_equal(np.isnan(gg), np.isnan(ww)) and bool(np.all(
            np.abs(gg - ww)[np.isfinite(ww)] <= COMPOSED_ATOL_DB
            + COMPOSED_RTOL * np.abs(ww[np.isfinite(ww)])))
    checks["survey vs composed chain"] = pt_ok and comp_ok and g.shape[2] >= want.shape[2] - 1
    n_x = ((AZFP_FILES - 1) * 3600 + AZFP_PINGS - 1) // 20 + 1  # hourly files of 1 Hz pings
    checks["survey grid"] = g.shape[:2] == (len(AZFP_FREQS_KHZ), n_x) and (
        np.isfinite(gg).mean() > 0.5)
    say("azfp_survey", pings=n_pings, shape=list(g.shape), launches=json.dumps(survey_launches),
        cuda_vs_cpu_dB=err, rerun_bit_identical=checks["survey card rerun bit-identical"],
        composed_max_dB=_max_db(gg, ww)[0], composed_n_r=[g.shape[2], want.shape[2]],
        pings_per_s={t: round(n_pings / walls[f"survey_{t}"], 1) for t in runs},
        stages=json.dumps(stages["cuda"]))

    # freq_diff over the three files; the mask may flip where the card's Sv
    # sits within MASK_MARGIN_DB of the criterion
    freqs = np.asarray(sv["cuda"]["frequency_nominal"].values, dtype="f8")
    ia, ib = int(np.nonzero(freqs == 200e3)[0][0]), int(np.nonzero(freqs == 38e3)[0][0])
    fd, fd_launches = {}, {}
    for device in ("cuda", "cpu"):
        wp.reset_launches()
        tp.LAUNCHES["freqdiff_step"] = 0
        fd[device] = timed(f"fd_{device}", lambda: et.run_survey_mvbs_from_raw(
            files, freq_diff=AZFP_FD_EQ, timer=StageTimer(), device=device, **kw))
        fd_launches[device] = {**wp.LAUNCHES, **tp.LAUNCHES}
    g, w = (np.asarray(fd[d]["Sv"].values) for d in ("cuda", "cpu"))
    bad = _bad_bins(g, w, MVBS_ATOL_DB)
    excused = _margin_excused(bad, sv_files, _fd_margin(ia, ib, 3.0), MASK_MARGIN_DB, fd["cuda"])
    err, same, n_exc = _cuda_vs_cpu(fd, excused)
    checks["freq_diff cuda vs cpu"] = same and err <= MVBS_ATOL_DB and np.isfinite(g).any()
    checks["freq_diff launches"] = fd_launches["cuda"]["freqdiff_step"] == chunks and not any(
        v for k, v in fd_launches["cuda"].items() if k != "freqdiff_step")

    # noise_masks on one file (two-pass, compute_Sv per file)
    nm = {d: timed(f"noise_{d}", lambda: et.run_survey_mvbs_from_raw(
        files[:1], noise_masks=RAW_MASKS, timer=StageTimer(), device=d, **kw))
        for d in ("cuda", "cpu")}
    flag = _noise_flags(sv["cuda"], RAW_MASKS, "cuda") != _noise_flags(sv["cpu"], RAW_MASKS, "cpu")
    excused = _flag_bins(flag, np.asarray(sv["cuda"].coords["ping_time"].values).astype("i8"),
                         np.broadcast_to(np.asarray(sv["cuda"]["echo_range"].values, "f8"),
                                         flag.shape),
                         np.asarray(nm["cuda"].coords["ping_time"].values).astype("i8"),
                         np.asarray(nm["cuda"].coords["echo_range"].values, dtype="f8"))
    nm_err, nm_same, nm_exc = _cuda_vs_cpu(nm, excused)
    checks["noise_masks cuda vs cpu"] = nm_same and nm_err <= MVBS_ATOL_DB
    say("azfp_masks", freq_diff=AZFP_FD_EQ, fd_cuda_vs_cpu_dB=err, fd_bins_excused=n_exc,
        fd_launches=json.dumps(fd_launches["cuda"]),
        fd_finite_share=round(float(np.isfinite(g).mean()), 4),
        noise_cuda_vs_cpu_dB=nm_err, noise_samples_differ=int(flag.sum()),
        noise_bins_excused=nm_exc,
        noise_finite_share=round(float(np.isfinite(nm["cuda"]["Sv"].values).mean()), 4),
        pings_per_s={t: round(n_pings / walls[f"fd_{t}"], 1) for t in fd})
    del ed, sv, sv_files, parts, runs, fd, nm

    # AZFP6: one tests/test_azfp6.py file through the survey
    (write_azfp6_raw,) = test_helpers("test_azfp6", ["write_azfp6_raw"])
    raw6 = DATA_DIR / "22070112.azfp"
    write_azfp6_raw(raw6, n_pings=AZFP_PINGS, num_bins=AZFP6_BINS)
    kw6 = dict(sonar_model="AZFP6", env_params=AZFP_ENV, **AZFP_GRID)
    runs6, l6 = {}, {}
    for device in ("cuda", "cpu"):
        wp.reset_launches()
        runs6[device] = timed(f"azfp6_{device}", lambda: et.run_survey_mvbs_from_raw(
            [raw6], timer=StageTimer(), device=device, **kw6))
        l6[device] = wp.LAUNCHES["window_partials_f32"]
    err6, same6, _ = _cuda_vs_cpu(runs6)
    checks["azfp6 cuda vs cpu"] = same6 and err6 <= MVBS_ATOL_DB and np.isfinite(
        runs6["cuda"]["Sv"].values).any()
    checks["azfp6 launches"] = l6 == {"cuda": -(-AZFP_PINGS // AZFP_GRID["chunk_pings"]),
                                      "cpu": 0}
    say("azfp6_survey", pings=AZFP_PINGS, shape=list(np.shape(runs6["cuda"]["Sv"].values)),
        cuda_vs_cpu_dB=err6, launches=json.dumps(l6),
        pings_per_s={d: round(AZFP_PINGS / walls[f"azfp6_{d}"], 1) for d in runs6})

    # ECS: tests/test_ecs.py's text (18 and 38 kHz) with SourceCals for file
    # A's other three channels, on A's first ECS_PINGS pings
    (ecs_text,) = test_helpers("test_ecs", ["ECS_CONTENT"])
    extra = "".join(
        f"SourceCal T{i}\n    AbsorptionCoefficient = {a} # (decibels per meter)\n"
        f"    Frequency = {f:.2f} # (kilohertz)\n    TransducerGain = {gain} # (decibels)\n"
        "    SaCorrectionFactor = -0.55 # (decibels)\n"
        "    TwoWayBeamAngle = -20.70 # (decibels re 1 steradian)\n\n"
        for i, (f, a, gain) in enumerate(((70, 0.0201, 27.1), (120, 0.0365, 26.9),
                                          (200, 0.0528, 25.8)), start=3))
    marker = "#" + "=" * 88 + "#\n#" + " " * 36 + "LOCALCAL"
    ecs = DATA_DIR / "smoke.ecs"
    ecs.write_text(ecs_text.replace(marker, extra + marker, 1))
    head = _slice_echodata_pings(et.open_raw(file_a, sonar_model="EK60"), "Sonar/Beam_group1",
                                 slice(0, ECS_PINGS))
    env_p, cal_p = ecs_to_params(str(ecs), "EK60", head["Sonar/Beam_group1"]["frequency_nominal"])
    by_ecs = {d: timed(f"ecs_{d}", lambda: et.calibrate.compute_Sv(head, ecs_file=str(ecs),
                                                                    device=d))
              for d in ("cuda", "cpu")}
    explicit = et.calibrate.compute_Sv(head, env_params=env_p, cal_params=cal_p)
    ecs_db, ecs_nan = _max_db(by_ecs["cuda"]["Sv"].values, by_ecs["cpu"]["Sv"].values)
    checks["ecs == explicit parameters (card)"] = np.array_equal(
        by_ecs["cuda"]["Sv"].values, explicit["Sv"].values, equal_nan=True)
    checks["ecs cuda vs cpu"] = ecs_nan and ecs_db <= MVBS_ATOL_DB
    checks["ecs parameters used"] = bool(np.allclose(
        np.asarray(by_ecs["cuda"]["sound_speed"].values, "f8"), 1473.0))
    say("azfp_ecs", pings=ECS_PINGS, channels=len(env_p["sound_absorption"].values),
        cuda_vs_cpu_dB=ecs_db, equals_explicit=checks["ecs == explicit parameters (card)"],
        seconds=round(walls["ecs_cuda"], 2))
    del head, by_ecs, explicit

    # AD2CP: open_raw of one tests/test_ad2cp.py file on this machine
    (write_ad2cp,) = test_helpers("test_ad2cp", ["write_ad2cp"], checksum=checksum)
    ad = DATA_DIR / "smoke.ad2cp"
    write_ad2cp(ad, with_bottom_track=True, with_echosounder_raw=True)
    ed_ad = timed("ad2cp", lambda: et.open_raw(ad, sonar_model="AD2CP"))
    checks["ad2cp groups"] = "Sonar/Beam_group1" in ed_ad.group_paths and "Vendor_specific" in (
        ed_ad.group_paths)
    say("azfp_ad2cp", groups=json.dumps(sorted(ed_ad.group_paths)),
        seconds=round(walls["ad2cp"], 3))

    failed = [k for k, v in checks.items() if not v]
    say("azfp_check", checks=len(checks), failed=json.dumps(failed),
        phase_s=round(time.perf_counter() - t_phase, 1))
    if failed:
        raise AssertionError(f"azfp phase: {failed}")
    return survey_launches, files, xml


def write_cruise_files():
    """Three consecutive EK60 files at the survey's width (5 channels x
    4,000 samples), CRUISE_PINGS pings each."""
    from synth_ek60 import write_ek60_raw

    t0 = np.datetime64("2020-02-01T00:00:00", "ns")
    files = []
    for i in range(CRUISE_FILES):
        path = DATA_DIR / f"CRUISE{i}-D20200201-T{i:02d}0000.raw"
        write_ek60_raw(path, n_pings=CRUISE_PINGS, n_samples=R, channels=CHANNELS,
                       frequencies=FREQS, t0=t0 + np.timedelta64(i * CRUISE_PINGS, "s"),
                       seed=40 + i, with_angle=False)
        files.append(str(path))
    return files


def _same_tree(got, want):
    """Groups of two EchoData trees with the same variables, coords and attr
    names, every array equal bit for bit (NaN where NaN); the differing
    names, empty when equal."""
    bad = []
    for g in want.group_paths:
        a, b = got[g], want[g]
        if sorted(a.data_vars) != sorted(b.data_vars) or sorted(a.coords) != sorted(b.coords):
            bad.append(f"{g}: names")
            continue
        for n in [*b.coords, *b.data_vars]:
            x = np.asarray((a.coords[n] if n in a.coords else a[n]).values)
            y = np.asarray((b.coords[n] if n in b.coords else b[n]).values)
            if x.dtype.kind in "OUS" or y.dtype.kind in "OUS":
                ok = x.shape == y.shape and [str(v) for v in x.ravel()] == [
                    str(v) for v in y.ravel()]
            else:
                ok = x.dtype == y.dtype and np.array_equal(x, y, equal_nan=x.dtype.kind in "fc")
            if not ok:
                bad.append(f"{g}:{n}")
        if sorted(a.attrs) != sorted(b.attrs):
            bad.append(f"{g}: attrs")
    if sorted(got.group_paths) != sorted(want.group_paths):
        bad.append("group paths")
    return bad


def cruise_phase(files, azfp_files, azfp_xml, smi):
    """The multi-file cruise path: the raw survey's ``workers=`` decode pool
    (EK60 and AZFP) against the in-process paths; open_raw ->
    combine_echodata -> to_zarr -> qc.orchestrate_reverse_time_check
    (zarr_store=) -> open_converted -> compute_Sv -> compute_MVBS and the
    metrics, card vs CPU; and one survey traced with
    utils.profiling.trace."""
    import collections
    import os

    import echopype_torch as et
    from echopype_torch.ops import window_partials as wp
    from echopype_torch.utils.profiling import StageTimer, trace

    checks, walls, launches = {}, {}, collections.Counter()
    t_phase = time.perf_counter()

    def survey(tag, raws, **kw):
        """One survey on the card, timed, its launches read just after."""
        wp.reset_launches()
        timer = StageTimer()
        t0 = time.perf_counter()
        out = et.run_survey_mvbs_from_raw(raws, timer=timer, **kw)
        torch.cuda.synchronize()
        walls[tag] = time.perf_counter() - t0
        got = {k: v for k, v in wp.LAUNCHES.items() if v}
        launches.update(got)
        return out, got, timer.report(log=False)

    # (a) the workers= pool on the survey files, then on the AZFP files
    kw = dict(range_bin=f"{RANGE_BIN_M:g}m", ping_time_bin=f"{PING_BIN_S}s", chunk_pings=P)
    chunks = [-(-n // P) for n in E2E_PINGS]
    want = {"window_partials_uniform": chunks[0] + chunks[1], "window_partials": chunks[2]}
    runs, got_l, stages = {}, {}, {}
    for tag, opts in (("pool", dict(workers=CRUISE_WORKERS)),
                      ("eager", dict(workers=0, prefetch=False)), ("prefetch", {})):
        runs[tag], got_l[tag], stages[tag] = survey(tag, files, **opts, **kw)
    checks["pool == workers=0 (bit)"] = _same_run(runs["pool"], runs["eager"])
    checks["pool launches"] = got_l["pool"] == got_l["eager"] == got_l["prefetch"] == want
    pre_db, pre_nan = _max_db(runs["prefetch"]["Sv"].values, runs["pool"]["Sv"].values)
    checks["prefetch vs pool"] = pre_nan and pre_db <= MVBS_ATOL_DB and _same_coords(
        runs["prefetch"], runs["pool"], ("channel", "ping_time", "echo_range"))
    n_pings = sum(E2E_PINGS)
    say("cruise_workers", card=repr(smi), cpu_count=os.cpu_count(), workers=CRUISE_WORKERS,
        pings=n_pings, wall_s=json.dumps({t: round(walls[t], 3) for t in runs}),
        pings_per_s=json.dumps({t: round(n_pings / walls[t], 1) for t in runs}),
        bit_identical=checks["pool == workers=0 (bit)"], prefetch_vs_pool_dB=pre_db,
        launches=json.dumps(got_l["pool"]), stages=json.dumps(
            {t: {k: v["total_s"] for k, v in stages[t].items()} for t in runs}))
    del runs

    akw = dict(sonar_model="AZFP", xml_path=azfp_xml, env_params=AZFP_ENV, **AZFP_GRID)
    azfp_chunks = AZFP_FILES * -(-AZFP_PINGS // AZFP_GRID["chunk_pings"])
    runs = {}
    for tag, workers in (("azfp_pool", CRUISE_WORKERS), ("azfp_eager", 0)):
        runs[tag], got_l[tag], _ = survey(tag, azfp_files, workers=workers, **akw)
    checks["azfp pool == workers=0 (bit)"] = _same_run(runs["azfp_pool"], runs["azfp_eager"])
    checks["azfp pool launches"] = got_l["azfp_pool"] == got_l["azfp_eager"] == {
        "window_partials_f32": azfp_chunks}
    n_az = AZFP_FILES * AZFP_PINGS
    say("cruise_workers_azfp", card=repr(smi), cpu_count=os.cpu_count(), pings=n_az,
        wall_s=json.dumps({t: round(walls[t], 3) for t in runs}),
        pings_per_s=json.dumps({t: round(n_az / walls[t], 1) for t in runs}),
        bit_identical=checks["azfp pool == workers=0 (bit)"],
        launches=json.dumps(got_l["azfp_pool"]))
    del runs

    # (b) the cruise: combine, one reversed ping, store, repair, reopen
    t0 = time.perf_counter()
    cruise = write_cruise_files()
    walls["write"] = time.perf_counter() - t0

    def timed(tag, fn):
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        walls[tag] = time.perf_counter() - t0
        return out

    comb = timed("combine", lambda: et.combine_echodata(
        [et.open_raw(f, sonar_model="EK60") for f in cruise]))
    beam = comb["Sonar/Beam_group1"]
    pt = beam.coords["ping_time"].values.copy()
    k = CRUISE_PINGS + CRUISE_PINGS // 2  # in the second file
    pt[k] = pt[k - 1] - np.timedelta64(3, "s")
    beam.coords["ping_time"] = et.xrlite.DataArray(pt, ("ping_time",), name="ping_time")
    store = DATA_DIR / "cruise.zarr"
    timed("to_zarr", lambda: comb.to_zarr(store))
    timed("qc", lambda: et.qc.orchestrate_reverse_time_check(comb, zarr_store=str(store)))
    back = timed("open_converted", lambda: et.open_converted(store))
    bad = _same_tree(back, comb)
    fixed = np.asarray(back["Sonar/Beam_group1"].coords["ping_time"].values)
    checks["store == repaired tree"] = bad == []
    old = back["Provenance"]["sonar_beam_group1_old_ping_time"].values
    checks["reversal repaired"] = (
        bool((np.diff(fixed) > np.timedelta64(0, "ns")).all())
        and np.array_equal(fixed[:k], pt[:k]) and np.array_equal(np.diff(fixed)[k:],
                                                                  np.diff(pt)[k:])
        and np.array_equal(old, pt) and back["Provenance"].attrs["reversed_ping_times"] == 1)
    sv = {d: timed(f"compute_Sv_{d}", lambda: et.calibrate.compute_Sv(back, device=d))
          for d in ("cuda", "cpu")}
    sv_db, sv_nan = _max_db(sv["cuda"]["Sv"].values, sv["cpu"]["Sv"].values)
    checks["Sv cuda vs cpu"] = sv_nan and sv_db <= MVBS_ATOL_DB
    grid = {d: timed(f"compute_MVBS_{d}", lambda: et.compute_MVBS(
        sv[d], range_bin=f"{RANGE_BIN_M:g}m", ping_time_bin=f"{PING_BIN_S}s", device=d))
        for d in ("cuda", "cpu")}
    mv_db, mv_same, _ = _cuda_vs_cpu(grid)
    n_x = CRUISE_FILES * CRUISE_PINGS // PING_BIN_S + 1
    checks["MVBS cuda vs cpu"] = mv_same and mv_db <= MVBS_ATOL_DB and np.shape(
        grid["cuda"]["Sv"].values)[:2] == (C, n_x)
    rel = {}
    for m in METRICS:
        a, b = (np.asarray(timed(f"{m}_{d}", lambda: getattr(et.metrics, m)(
            sv[d].isel(ping_time=slice(0, METRICS_PINGS)))).values, dtype="f8")
            for d in ("cuda", "cpu"))
        with np.errstate(invalid="ignore", divide="ignore"):
            rel[m] = float(np.nanmax(np.abs(a - b) / np.abs(b)))
        checks[f"{m} cuda vs cpu"] = (np.array_equal(np.isnan(a), np.isnan(b))
                                      and np.isfinite(a).mean() > 0.9 and rel[m] <= METRICS_RTOL)
    say("cruise_chain", files=CRUISE_FILES, pings=CRUISE_FILES * CRUISE_PINGS,
        store_equals_tree=checks["store == repaired tree"], differing=json.dumps(bad),
        repaired=checks["reversal repaired"], Sv_cuda_vs_cpu_dB=sv_db,
        MVBS_cuda_vs_cpu_dB=mv_db, metrics_pings=METRICS_PINGS,
        metrics_max_rel=json.dumps(rel), metrics_rtol=METRICS_RTOL,
        seconds=json.dumps({t: round(v, 2) for t, v in walls.items()
                            if not t.startswith(("pool", "eager", "prefetch", "azfp"))}))
    del comb, back, sv, grid

    # (c) one survey of file A traced on the card
    log_dir = DATA_DIR / "trace"
    wp.reset_launches()
    with trace(str(log_dir)) as prof:
        t0 = time.perf_counter()
        et.run_survey_mvbs_from_raw(files[:1], **kw)
        torch.cuda.synchronize()
        window_us = (time.perf_counter() - t0) * 1e6
    k1_traced = wp.LAUNCHES["window_partials_uniform"]
    launches.update({k: v for k, v in wp.LAUNCHES.items() if v})
    written = sorted(log_dir.glob("*.pt.trace.json"))
    events = json.loads(written[0].read_text())["traceEvents"] if written else []
    # the wrappers' record_function spans (host side; the trace mirrors each
    # on the device's timeline as a gpu_user_annotation)
    host_k1 = sum(e.get("name") == "ep_window_partials_uniform"
                  and e.get("cat") == "user_annotation" for e in events)
    kernels = [e for e in events if e.get("cat") == "kernel"]
    copies = [e for e in events if e.get("cat") == "gpu_memcpy"]
    by_name = collections.Counter(e["name"][:80] for e in kernels)
    busy = sum(float(e.get("dur", 0)) for e in kernels) / window_us if kernels else None
    copy_share = sum(float(e.get("dur", 0)) for e in copies) / window_us if copies else None
    checks["trace written"] = len(written) == 1
    checks["trace holds the K1 launches"] = host_k1 == k1_traced == chunks[0]
    say("cruise_trace", card=repr(smi), file=written[0].name if written else None,
        MB=round(written[0].stat().st_size / 1e6, 2) if written else None,
        events=len(events), categories=json.dumps(collections.Counter(
            str(e.get("cat")) for e in events).most_common(8)),
        host_k1_launches=host_k1, k1_launches=k1_traced, device_kernel_events=len(kernels),
        kernels_by_name=json.dumps(by_name.most_common(12)), window_ms=round(window_us / 1e3, 1),
        busy_share=busy, copy_share=copy_share, copies=len(copies),
        profiler_ops=len(prof.key_averages()))

    failed = [k for k, v in checks.items() if not v]
    say("cruise_check", checks=len(checks), failed=json.dumps(failed),
        phase_s=round(time.perf_counter() - t_phase, 1))
    if failed:
        raise AssertionError(f"cruise phase: {failed}")
    return dict(launches)

def mesh_sv_datasets(C=MESH_SV_C, ping_counts=MESH_SV_PINGS, R=MESH_SV_R, seed=3):
    """__graft_entry__.py::_survey_sv_datasets as port Datasets: 4 Hz pings,
    20 s bins straddling chunks, shards and files, an uneven last file."""
    from echopype_torch.xrlite import Dataset

    rng = np.random.default_rng(seed)
    t0 = np.datetime64("2021-01-01T00:00:00", "ns")
    dims = ("channel", "ping_time", "range_sample")
    svs, off = [], 0
    for n in ping_counts:
        ds = Dataset(coords={
            "channel": np.asarray([f"ch{k}" for k in range(C)], dtype=object),
            "ping_time": t0 + ((off + np.arange(n)) * 250_000_000).astype("timedelta64[ns]"),
            "range_sample": np.arange(R)})
        off += n
        ds["Sv"] = (dims, rng.normal(-70.0, 8.0, (C, n, R)).astype("f4"))
        ds["echo_range"] = (dims, np.broadcast_to(np.arange(R, dtype="f4") * 0.5,
                                                  (C, n, R)).copy())
        svs.append(ds)
    return svs


def mesh_nasc_datasets():
    """__graft_entry__.py::_dryrun_mesh_nasc's two files: depth = echo_range,
    a straight track."""
    svs = mesh_sv_datasets(C=2, ping_counts=MESH_NASC_PINGS, R=48, seed=11)
    for i, ds in enumerate(svs):
        n = ds.sizes["ping_time"]
        base = 45.0 + (0 if i == 0 else (MESH_NASC_PINGS[0] + 1) * 3e-5)
        ds["depth"] = (("channel", "ping_time", "range_sample"), ds["echo_range"].values.copy())
        ds["latitude"] = (("ping_time",), base + np.arange(n) * 3e-5)
        ds["longitude"] = (("ping_time",), np.full(n, -125.0))
    return svs


def write_mesh_bb_files():
    """__graft_entry__.py::_dryrun_mesh_bb's files: three two-FM-channel
    EK80 files (4,096 + 4,096 + 2,048 pings x 64 samples), and the two-epoch
    CW and BB files of tests/test_ek80_epochs.py (512 pings an epoch)."""
    import synth_ek80  # its namespace holds what the epoch writer uses

    write_two_epoch_ek80, = test_helpers("test_ek80_epochs", ["write_two_epoch_ek80"],
                                         **vars(synth_ek80))
    t0 = np.datetime64("2021-02-01T00:00:00", "ns")
    bb = []
    for i, n in enumerate(MESH_BB_PINGS):
        path = DATA_DIR / f"DRY{i}-D20210201-T000000.raw"
        synth_ek80.write_ek80_raw(path, n_pings=n, n_samples=64, seed=i,
                                  t0=t0 + np.timedelta64(i * 4200, "s"),
                                  with_power_channel=False, extra_fm_channel=True)
        bb.append(str(path))
    epochs = {}
    for wm in ("CW", "BB"):
        path = DATA_DIR / f"DRYEP{wm}-D20210201-T000000.raw"
        write_two_epoch_ek80(path, n_pings_per_epoch=MESH_EPOCH_PINGS, n_samples=64, waveform=wm)
        epochs[wm] = str(path)
    return bb, epochs


def _db_close(a, b, atol, var="Sv"):
    """(max |a - b|, NaN masks equal, coords equal) of two outputs."""
    g, w = np.asarray(a[var].values, dtype="f8"), np.asarray(b[var].values, dtype="f8")
    same = g.shape == w.shape and np.array_equal(np.isnan(g), np.isnan(w))
    err = float(np.nanmax(np.abs(g - w))) if same and np.isfinite(g).any() else float("inf")
    coords = same and all(np.array_equal(np.asarray(a.coords[k].values, dtype=str),
                                         np.asarray(b.coords[k].values, dtype=str))
                          for k in a.coords if k in b.coords)
    return err, same and coords and err <= atol


def mesh_phase(files, stores, e2e, smi):
    """Multi-device surveys on a mesh of ``MESH_SHARDS`` blocks of this one
    card (``make_mesh(..., devices=["cuda:0"] * 4)``), the port of
    __graft_entry__.py::dryrun_multichip: the EK60 raw survey (also with
    ``freq_diff`` over A and C), the Sv-store surveys (also with noise
    masks), the EK80 broadband surveys and the survey steps, each against
    one device; the survey on the card against the same mesh on the CPU;
    reruns bit-identical.  ``stores`` are the Sv stores of A, B, C (the
    freq-diff margins); ``e2e`` is the one-device survey of A, B, C: (MVBS,
    K1/K2 launches, wall)."""
    import collections
    import logging

    import echopype_torch as et
    from echopype_torch.ops import sv_bin_partials as sbp
    from echopype_torch.ops import window_partials as wp
    from echopype_torch.parallel import make_mesh
    from echopype_torch.parallel import pipeline as tp
    from echopype_torch.parallel import survey as ts
    from echopype_torch.utils.io import open_source
    from echopype_torch.utils.profiling import StageTimer

    checks, walls, launches = {}, {}, collections.Counter()
    t_phase = time.perf_counter()
    mesh = make_mesh(MESH_SHARDS, devices=["cuda:0"] * MESH_SHARDS)
    say("mesh_start", card=repr(smi), mesh=json.dumps(mesh.shape),
        distinct_devices=len({str(d) for d in mesh.devices.flat}))

    def survey(tag, fn, srcs, **kw):
        """One survey, timed; its K1-K4 and freq-diff step launches read
        just after."""
        wp.reset_launches()
        sbp.reset_launches()
        tp.LAUNCHES["freqdiff_step"] = 0
        timer = StageTimer()
        t0 = time.perf_counter()
        out = fn(srcs, timer=timer, **kw)
        torch.cuda.synchronize()
        walls[tag] = time.perf_counter() - t0
        got = {k: v for k, v in (*wp.LAUNCHES.items(), *sbp.LAUNCHES.items(),
                                 *tp.LAUNCHES.items()) if v}
        launches.update(got)
        return out, got, timer.report(log=False)

    # (a) the EK60 raw survey over A, B, C: (ping 4, channel 1) against one device
    one, one_launches, one_wall = e2e
    kw = dict(range_bin=f"{RANGE_BIN_M:g}m", ping_time_bin=f"{PING_BIN_S}s", chunk_pings=P)
    runs, got_l, stages = {}, {}, {}
    for tag in ("mesh", "mesh_rerun"):
        runs[tag], got_l[tag], stages[tag] = survey(tag, et.run_survey_mvbs_from_raw, files,
                                                    mesh=mesh, **kw)
    err, checks["raw survey mesh vs one device"] = _db_close(runs["mesh"], one, MVBS_ATOL_DB)
    checks["raw survey rerun (bit)"] = _same_run(runs["mesh"], runs["mesh_rerun"])
    checks["K1/K2 launches 4 x one device"] = got_l["mesh"] == got_l["mesh_rerun"] == {
        k: MESH_SHARDS * v for k, v in one_launches.items() if v}
    n_pings = sum(E2E_PINGS)
    say("mesh_raw_survey", card=repr(smi), pings=n_pings, max_abs_dB=err,
        limit_dB=MVBS_ATOL_DB, same_nan_and_coords=checks["raw survey mesh vs one device"],
        rerun_bit_identical=checks["raw survey rerun (bit)"],
        launches_one=json.dumps(one_launches), launches_mesh=json.dumps(got_l["mesh"]),
        wall_s=json.dumps({"one_device": round(one_wall, 3),
                           **{t: round(walls[t], 3) for t in runs}}),
        pings_per_s=json.dumps({"one_device": round(n_pings / one_wall, 1),
                                **{t: round(n_pings / walls[t], 1) for t in runs}}),
        stages=json.dumps({k: v["total_s"] for k, v in stages["mesh"].items()}))
    del runs

    # (b) file A on the card's mesh against the same mesh on the CPU
    cpu_mesh = make_mesh(MESH_SHARDS, devices=["cpu"] * MESH_SHARDS)
    card, _, _ = survey("A_mesh_cuda", et.run_survey_mvbs_from_raw, files[:1], mesh=mesh, **kw)
    t0 = time.perf_counter()
    cpu = et.run_survey_mvbs_from_raw(files[:1], mesh=cpu_mesh, **kw)
    walls["A_mesh_cpu"] = time.perf_counter() - t0
    err_cpu, checks["mesh cuda vs cpu"] = _db_close(card, cpu, MVBS_ATOL_DB)
    say("mesh_cuda_vs_cpu", pings=E2E_PINGS[0], max_abs_dB=err_cpu, limit_dB=MVBS_ATOL_DB,
        ok=checks["mesh cuda vs cpu"], wall_s=json.dumps(
            {t: round(walls[t], 3) for t in ("A_mesh_cuda", "A_mesh_cpu")}))
    del card, cpu

    # (b2) the raw freq-diff leg over A and C, the mesh against one device:
    # bins over the limit are excused only where a sample sits within
    # MASK_MARGIN_DB of the criterion
    fd_files, fd_runs, fd_launches = [files[0], files[2]], {}, {}
    for tag, mesh_kw in (("fd_one", {}), ("fd_mesh", {"mesh": mesh})):
        fd_runs[tag], fd_launches[tag], _ = survey(tag, et.run_survey_mvbs_from_raw, fd_files,
                                                   freq_diff=FD_EQ, **mesh_kw, **kw)
    g, w = (np.asarray(fd_runs[t]["Sv"].values) for t in ("fd_mesh", "fd_one"))
    bad = _bad_bins(g, w, MESH_FD_DB)
    excused = _margin_excused(bad, [open_source(stores[i], "dataset") for i in (0, 2)]
                              if bad.any() else [], _fd_margin(1, 0, 3.0), MASK_MARGIN_DB,
                              fd_runs["fd_one"])
    fd_err, fd_nan, fd_exc = _cmp_excused(g, w, excused)
    checks["raw freq_diff mesh vs one device"] = (
        fd_nan and fd_err <= MESH_FD_DB and np.isfinite(g).any() and _same_coords(
            fd_runs["fd_mesh"], fd_runs["fd_one"], ("channel", "ping_time", "echo_range")))
    say("mesh_raw_freq_diff", files=2, pings=E2E_PINGS[0] + E2E_PINGS[2], eq=repr(FD_EQ),
        max_abs_dB=fd_err, limit_dB=MESH_FD_DB, bins_over_limit=int(bad.sum()),
        bins_excused=fd_exc, same_nan=fd_nan, launches=json.dumps(fd_launches),
        wall_s=json.dumps({t: round(walls[t], 3) for t in fd_runs}))
    del fd_runs, g, w

    # (c) the Sv-store surveys on (ping 2, channel 2)
    mesh22 = make_mesh(MESH_SHARDS, channel_axis=2, devices=["cuda:0"] * MESH_SHARDS)
    svs = mesh_sv_datasets()
    skw = dict(range_bin="5m", ping_time_bin="20s", chunk_pings=4096)
    sv_one, _, _ = survey("sv_one", et.run_survey_mvbs, svs, **skw)
    sv_mesh, _, _ = survey("sv_mesh", et.run_survey_mvbs, svs, mesh=mesh22, **skw)
    sv_err, checks["Sv-store MVBS mesh vs one device"] = _db_close(sv_mesh, sv_one, MESH_SV_DB)
    checks["Sv-store grid >= 1e5 pings"] = np.shape(sv_mesh["Sv"].values)[1] >= 1264
    # with noise masks (host masks a chunk, then the binning per block)
    masked, nm_launches = {}, {}
    for tag, mesh_kw in (("sv_masks_one", {}), ("sv_masks_mesh", {"mesh": mesh22})):
        masked[tag], nm_launches[tag], _ = survey(tag, et.run_survey_mvbs, svs,
                                                  noise_masks=MESH_NOISE_MASKS, **mesh_kw, **skw)
    nm_err, checks["Sv-store noise masks mesh vs one device"] = _db_close(
        masked["sv_masks_mesh"], masked["sv_masks_one"], MESH_SV_DB)
    nm_grid = [np.isnan(np.asarray(x["Sv"].values)) for x in (masked["sv_masks_one"], sv_one)]
    checks["Sv-store noise masks flag bins"] = bool((nm_grid[0] & ~nm_grid[1]).any())
    say("mesh_sv_noise_masks", mesh=json.dumps(mesh22.shape), pings=sum(MESH_SV_PINGS),
        masks=json.dumps(sorted(MESH_NOISE_MASKS)), max_abs_dB=nm_err, limit_dB=MESH_SV_DB,
        bins_masked=int((nm_grid[0] & ~nm_grid[1]).sum()), launches=json.dumps(nm_launches),
        wall_s=json.dumps({t: round(walls[t], 3) for t in masked}))
    del svs, sv_one, sv_mesh, masked, nm_grid
    nsv = mesh_nasc_datasets()
    nkw = dict(range_bin="5m", dist_bin="0.1nmi", chunk_pings=4096, noise_masks={
        "impulse": dict(depth_bin="2m", num_side_pings=2, impulse_noise_threshold="10.0dB",
                        range_var="depth")})
    n_one, _, _ = survey("nasc_one", et.run_survey_nasc, nsv, **nkw)
    n_mesh, _, _ = survey("nasc_mesh", et.run_survey_nasc, nsv, mesh=mesh22, **nkw)
    g, w = (np.asarray(x["NASC"].values, dtype="f8") for x in (n_mesh, n_one))
    nasc_same = np.array_equal(np.isnan(g), np.isnan(w)) and np.isfinite(g).any()
    nasc_rel = float(np.nanmax(np.abs(g - w) / (MESH_NASC_ATOL + MESH_NASC_RTOL * np.abs(w))))
    checks["Sv-store NASC mesh vs one device"] = nasc_same and nasc_rel <= 1.0
    say("mesh_sv_surveys", mesh=json.dumps(mesh22.shape), pings=sum(MESH_SV_PINGS),
        channels=MESH_SV_C, mvbs_max_abs_dB=sv_err, mvbs_limit_dB=MESH_SV_DB,
        nasc_pings=sum(MESH_NASC_PINGS), nasc_error_over_limit=nasc_rel,
        nasc_rtol=MESH_NASC_RTOL, nasc_atol=MESH_NASC_ATOL, wall_s=json.dumps(
            {t: round(walls[t], 3) for t in ("sv_one", "sv_mesh", "nasc_one", "nasc_mesh")}))
    del nsv, n_one, n_mesh

    # (d) the EK80 broadband surveys: chunked, two filter epochs, device_fused
    bb, epochs = write_mesh_bb_files()
    bkw = dict(sonar_model="EK80", waveform_mode="BB", encode_mode="complex",
               range_bin="0.5m", ping_time_bin="60s", chunk_pings=1024)
    bb_err = {}
    b_one, _, _ = survey("bb_one", et.run_survey_mvbs_from_raw, bb, **bkw)
    b_mesh, _, _ = survey("bb_mesh", et.run_survey_mvbs_from_raw, bb, mesh=mesh, **bkw)
    bb_err["chunked"], checks["BB chunked mesh vs one device"] = _db_close(b_mesh, b_one,
                                                                           MVBS_ATOL_DB)
    warned = []

    class _Keep(logging.Handler):
        def emit(self, record):
            warned.append(record.getMessage())

    keep = _Keep(logging.WARNING)
    ts.logger.addHandler(keep)
    try:
        b_fused, _, _ = survey("bb_fused_mesh", et.run_survey_mvbs_from_raw, bb, mesh=mesh,
                               device_fused=True, **bkw)
    finally:
        ts.logger.removeHandler(keep)
    checks["device_fused mesh warns"] = any("no mesh path" in m for m in warned)
    checks["device_fused mesh = chunked mesh (bit)"] = _same_run(b_fused, b_mesh)
    del b_one, b_mesh, b_fused
    for wm, path in epochs.items():
        ekw = dict(bkw, waveform_mode=wm, range_bin="0.5m", ping_time_bin="30s",
                   chunk_pings=128)
        e_one, _, _ = survey(f"epochs_{wm}_one", et.run_survey_mvbs_from_raw, [path], **ekw)
        e_mesh, _, _ = survey(f"epochs_{wm}_mesh", et.run_survey_mvbs_from_raw, [path],
                              mesh=mesh, **ekw)
        bb_err[f"epochs_{wm}"], checks[f"{wm} epochs mesh vs one device"] = _db_close(
            e_mesh, e_one, MVBS_ATOL_DB)
    say("mesh_ek80", files=len(bb), pings=sum(MESH_BB_PINGS), max_abs_dB=json.dumps(bb_err),
        limit_dB=MVBS_ATOL_DB, fused_warned=checks["device_fused mesh warns"],
        fused_equals_chunked=checks["device_fused mesh = chunked mesh (bit)"],
        wall_s=json.dumps({t: round(v, 3) for t, v in walls.items()
                           if t.startswith(("bb_", "epochs_"))}))

    # (e) the steps at the kernel phase's shape (5 x 5,000 x 4,000)
    step_err = {}
    args = fused_inputs(seed=21)
    n_x, n_r = args[7:]
    for with_sv, name in ((True, "sv_bin_partials"), (False, "mvbs_partials")):
        one_step = tp.survey_pipeline_step(None, n_x, n_r, with_sv=with_sv)(*args[:7])
        sbp.reset_launches()
        got = [tp.survey_pipeline_step(mesh, n_x, n_r, with_sv=with_sv)(*args[:7])
               for _ in range(2)]
        torch.cuda.synchronize()
        launches[name] += sbp.LAUNCHES[name]
        checks[f"{name} {MESH_SHARDS} launches a step"] = sbp.LAUNCHES[name] == 2 * MESH_SHARDS
        mv, mv1, mv_again = ((x[1] if with_sv else x) for x in (got[0], one_step, got[1]))
        if with_sv:
            checks["K3 mesh Sv = one device (bit)"] = torch.equal(
                got[0][0].view(torch.int32), one_step[0].view(torch.int32))
        checks[f"{name} mesh rerun (bit)"] = torch.equal(mv.view(torch.int32),
                                                        mv_again.view(torch.int32))
        step_err[name], checks[f"{name} mesh MVBS vs one device"] = _max_db(
            mv.cpu().numpy(), mv1.cpu().numpy())
        checks[f"{name} mesh MVBS vs one device"] &= step_err[name] <= MVBS_ATOL_DB
        del one_step, got, mv, mv1, mv_again
    mesh3 = make_mesh(MESH_SHARDS, range_axis=2, devices=["cuda:0"] * MESH_SHARDS)
    sv3, mv3 = tp.survey_pipeline_step(mesh3, n_x, n_r)(*args[:7])
    sv1, mv1 = tp.survey_pipeline_step(None, n_x, n_r)(*args[:7])
    same_nan = torch.equal(torch.isnan(sv3), torch.isnan(sv1))
    checks["3-axis Sv vs one device"] = same_nan and torch.allclose(
        sv3, sv1, rtol=SV_RTOL, atol=SV_ATOL, equal_nan=True)
    step_err["3_axis"], ok3 = _max_db(mv3.cpu().numpy(), mv1.cpu().numpy())
    checks["3-axis MVBS vs one device"] = ok3 and step_err["3_axis"] <= MVBS_ATOL_DB
    del sv3, mv3, sv1, mv1, args
    power, dr, shift, ab, off, vl, x_rel, edges, W = chunk_inputs(seed=22, vary_dr=False)
    closed = (power, dr, shift, ab, off, vl, x_rel, edges)
    n_r_c = len(edges) - 1
    m_closed = tp.sharded_mvbs_step_closed(mesh, W, n_r_c)(*closed)
    m_closed1 = tp.sharded_mvbs_step_closed(None, W, n_r_c)(*closed)
    step_err["closed"], okc = _max_db(m_closed.cpu().numpy(), m_closed1.cpu().numpy())
    checks["closed step mesh vs one device"] = okc and step_err["closed"] <= MVBS_ATOL_DB
    for uniform, name in ((True, "window_partials_uniform"), (False, "window_partials")):
        step_args = chunk_inputs(seed=23, vary_dr=not uniform)
        W = step_args[-1]
        s_1, c_1 = tp.sharded_mvbs_partials_closed(None, W, n_r_c, uniform=uniform)(
            *step_args[:8])
        wp.reset_launches()
        s_m, c_m = tp.sharded_mvbs_partials_closed(mesh, W, n_r_c, uniform=uniform)(
            *step_args[:8])
        torch.cuda.synchronize()
        launches[name] += wp.LAUNCHES[name]
        checks[f"{name} {MESH_SHARDS} launches"] = wp.LAUNCHES[name] == MESH_SHARDS
        s_m, c_m, s_1, c_1 = (t.double().cpu().numpy() for t in (s_m, c_m, s_1, c_1))
        checks[f"{name} mesh counts exact"] = np.array_equal(c_m, c_1)
        step_err[name] = float(np.max(np.abs(s_m - s_1) / np.where(s_1 != 0, s_1, 1.0)))
        checks[f"{name} mesh sums vs one device"] = step_err[name] <= SUM_RTOL
    say("mesh_steps", shape=[C, P, R], mesh=json.dumps(mesh.shape),
        mesh_3_axis=json.dumps(mesh3.shape), max_abs_dB_or_rel=json.dumps(step_err),
        limit_dB=MVBS_ATOL_DB, sum_rtol=SUM_RTOL)

    failed = [k for k, v in checks.items() if not v]
    say("mesh_check", checks=len(checks), failed=json.dumps(failed),
        phase_s=round(time.perf_counter() - t_phase, 1))
    if failed:
        raise AssertionError(f"mesh phase: {failed}")
    return dict(launches)


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
             if "registers" in ln or "spill" in ln or "Compiling entry" in ln]
    say("build", seconds=round(time.perf_counter() - t0, 2),
        libraries=",".join(lib.name for lib, _ in built), ptxas=json.dumps(ptxas))

    k1 = kernel_phase("K1", uniform=True, seed=1)
    kernel_phase("K1", uniform=True, seed=5, ping_bin_s=COARSE_PING_BIN_S)
    k2 = kernel_phase("K2", uniform=False, seed=2)
    kernel_phase("K2", uniform=False, seed=6, ping_bin_s=COARSE_PING_BIN_S)
    k1_f32 = kernel_phase("K1_f32", uniform=True, seed=7)
    kernel_phase("K1_f32", uniform=True, seed=8, ping_bin_s=COARSE_PING_BIN_S)
    k2_f32 = kernel_phase("K2_f32", uniform=False, seed=9)
    kernel_phase("K2_f32", uniform=False, seed=10, ping_bin_s=COARSE_PING_BIN_S)
    k3 = fused_phase("K3", with_sv=True, seed=3)
    k4 = fused_phase("K4", with_sv=False, seed=4)
    torch.cuda.empty_cache()
    binning_programs, binning_k1 = binning_phase()
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
        one_device = {k: v for k, v in launches.items() if v}
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
        torch.cuda.empty_cache()
        azfp_launches, azfp_files, azfp_xml = azfp_phase(files[0])
        torch.cuda.empty_cache()
        cruise_launches = cruise_phase(files, azfp_files, azfp_xml, smi)
        torch.cuda.empty_cache()
        mesh_launches = mesh_phase(files, stores, (mvbs, one_device, wall), smi)
    finally:
        shutil.rmtree(DATA_DIR, ignore_errors=True)

    chunks = [-(-n // P) for n in E2E_PINGS]
    want_launches = {"window_partials_uniform": chunks[0] + chunks[1],
                     "window_partials": chunks[2], "window_partials_uniform_f32": 0,
                     "window_partials_f32": 0}
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
    say("device_programs", binning=json.dumps(binning_programs))
    src = "echopype_torch/csrc/window_partials.cu"
    src_fused = "echopype_torch/csrc/sv_bin_partials.cu"
    table = [
        {"name": "window_partials_uniform", "route": "cuda", "source": src,
         "replaces": "echopype_tpu/ops/pallas_window.py:174",
         "launches": launches["window_partials_uniform"] + binning_k1
         + ek80_launches["window_partials_uniform"]
         + cruise_launches.get("window_partials_uniform", 0)
         + mesh_launches.get("window_partials_uniform", 0), **k1},
        {"name": "window_partials", "route": "cuda", "source": src,
         "replaces": "echopype_tpu/ops/pallas_window.py:219",
         "launches": launches["window_partials"] + ek80_launches["window_partials"]
         + cruise_launches.get("window_partials", 0)
         + mesh_launches.get("window_partials", 0), **k2},
        {"name": "sv_bin_partials", "route": "cuda", "source": src_fused,
         "replaces": "echopype_tpu/ops/pallas_pipeline.py:30",
         "launches": sv_launches["sv_bin_partials"]
         + mesh_launches.get("sv_bin_partials", 0), **k3},
        {"name": "mvbs_partials", "route": "cuda", "source": src_fused,
         "replaces": "echopype_tpu/ops/pallas_pipeline.py:170",
         "launches": sv_launches["mvbs_partials"]
         + mesh_launches.get("mvbs_partials", 0), **k4},
        # the float32 dB instances of K1 / K2: K2's runs every chunk of the
        # AZFP survey; K1's is on no survey path (AZFP echo_range has an
        # intercept, so it is never uniform) and runs in the kernel phase only
        {"name": "window_partials_uniform_f32", "route": "cuda", "source": src,
         "replaces": "echopype_tpu/ops/pallas_window.py:174",
         "launches": azfp_launches["window_partials_uniform_f32"], **k1_f32},
        {"name": "window_partials_f32", "route": "cuda", "source": src,
         "replaces": "echopype_tpu/ops/pallas_window.py:219",
         "launches": azfp_launches["window_partials_f32"]
         + cruise_launches.get("window_partials_f32", 0), **k2_f32},
    ]
    print(json.dumps({"kernels": table}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
