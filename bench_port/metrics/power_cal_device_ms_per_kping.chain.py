"""Chain stage power_cal_device (ops.calibration.ek_power_cal: operands' H2D, the sonar equation, D2H of Sv and echo_range), from the program's stages in the traced window (profiling.TRACED), ms per 1,000 pings."""

from bench_port.traced import stage_ms_per_kping


def read(rec):
    return stage_ms_per_kping(rec, "power_cal_device")
