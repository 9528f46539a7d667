"""Stage bb_params (the fused survey's broadband parameters: CalibrateEK80, its Sv scalars and replicas, their norms, prx's impedance term), from the program's stages in the traced window (profiling.TRACED), ms per 1,000 pings."""

from bench_port.traced import stage_ms_per_kping


def read(rec):
    return stage_ms_per_kping(rec, "bb_params")
