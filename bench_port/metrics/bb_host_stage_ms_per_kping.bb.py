"""Stage bb_host_stage (the fused survey's host staging: float32 copies of the complex samples, valid lengths, the TVG boundary), from the program's stages in the traced window (profiling.TRACED), ms per 1,000 pings."""

from bench_port.traced import stage_ms_per_kping


def read(rec):
    return stage_ms_per_kping(rec, "bb_host_stage")
