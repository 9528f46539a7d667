"""Chain stage cal_inputs (compute_Sv: environment and calibration parameters, the sonar equation's host inputs), from the program's stages in the traced window (profiling.TRACED), ms per 1,000 pings."""

from bench_port.traced import stage_ms_per_kping


def read(rec):
    return stage_ms_per_kping(rec, "cal_inputs")
