"""consolidate.add_depth and consolidate.add_location: stages add_depth + add_location, from the program's stages in the traced window (profiling.TRACED), ms per 1,000 pings."""

from bench_port.traced import stage_ms_per_kping


def read(rec):
    got = [stage_ms_per_kping(rec, n) for n in ("add_depth", "add_location")]
    if None in got:
        return None
    return sum(got)
