"""Stage ek80_beam_complex (the complex beam groups' assembly in the EK80 set-groups), from the program's stages in the traced window (profiling.TRACED), ms per 1,000 pings."""

from bench_port.traced import stage_ms_per_kping


def read(rec):
    return stage_ms_per_kping(rec, "ek80_beam_complex")
