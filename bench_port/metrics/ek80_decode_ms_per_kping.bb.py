"""Stage ek80_raw3 (the RAW3 datagrams' decode in the EK80 parser (headers, complex samples, bound parameters)), from the program's stages in the traced window (profiling.TRACED), ms per 1,000 pings."""

from bench_port.traced import stage_ms_per_kping


def read(rec):
    return stage_ms_per_kping(rec, "ek80_raw3")
