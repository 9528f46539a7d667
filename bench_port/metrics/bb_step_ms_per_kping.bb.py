"""The fused broadband step inside ops.bb_pipeline: stages bb_h2d (samples to the card), bb_compress (the matched filter) and bb_sv_bins (prx, Sv, bins) summed, from the program's stages in the traced window (profiling.TRACED), ms per 1,000 pings."""

from bench_port.traced import stage_ms_per_kping

STAGES = ("bb_h2d", "bb_compress", "bb_sv_bins")


def read(rec):
    got = [v for v in (stage_ms_per_kping(rec, n) for n in STAGES) if v is not None]
    return sum(got) if got else None
