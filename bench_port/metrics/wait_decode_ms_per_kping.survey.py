"""Survey stage wait_decode (the main thread blocked on the prefetch thread's decode), from the program's stages in the traced window (profiling.TRACED), ms per 1,000 pings."""

from bench_port.traced import stage_ms_per_kping


def read(rec):
    return stage_ms_per_kping(rec, "wait_decode")
