"""Chain stage bin_device (ops.binning: the chunk loop's H2D, bins, D2H and float64 adds), from the program's stages in the traced window (profiling.TRACED), ms per 1,000 pings."""

from bench_port.traced import stage_ms_per_kping


def read(rec):
    return stage_ms_per_kping(rec, "bin_device")
