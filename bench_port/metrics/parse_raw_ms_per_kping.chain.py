"""Chain stage parse_raw (open_raw's parser: parse_raw and rectangularize_data), from the program's stages in the traced window (profiling.TRACED), ms per 1,000 pings."""

from bench_port.traced import stage_ms_per_kping


def read(rec):
    return stage_ms_per_kping(rec, "parse_raw")
