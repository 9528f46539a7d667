"""compute_NASC's stage nasc_assemble (the NASC product, mean ping times and positions, the Dataset), from the program's stages in the traced window (profiling.TRACED), ms per 1,000 pings."""

from bench_port.traced import stage_ms_per_kping


def read(rec):
    return stage_ms_per_kping(rec, "nasc_assemble")
