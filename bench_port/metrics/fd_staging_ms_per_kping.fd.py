"""The frequency-differenced survey's staging: stages valid_len (a file's NaN pass) and to_int16 (each chunk's int16 indices) summed, from the program's stages in the traced window (profiling.TRACED), ms per 1,000 pings."""

from bench_port.traced import stage_ms_per_kping

STAGES = ("valid_len", "to_int16")


def read(rec):
    got = [v for v in (stage_ms_per_kping(rec, n) for n in STAGES) if v is not None]
    return sum(got) if got else None
