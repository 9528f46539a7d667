"""compute_NASC's stage nasc_prepare (checks, the distance along the track, depth conformed and broadcast, edges, orientation, ping bins, the depth differences), from the program's stages in the traced window (profiling.TRACED), ms per 1,000 pings."""

from bench_port.traced import stage_ms_per_kping


def read(rec):
    return stage_ms_per_kping(rec, "nasc_prepare")
