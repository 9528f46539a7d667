"""The frequency-differenced survey's decode: stage ingest (every file decoded, eagerly, before the first chunk reaches the card), from the program's stages in the traced window (profiling.TRACED), ms per 1,000 pings."""

from bench_port.traced import stage_ms_per_kping


def read(rec):
    return stage_ms_per_kping(rec, "ingest")
