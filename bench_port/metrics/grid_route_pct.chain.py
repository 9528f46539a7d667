"""Share of the pings compute_MVBS binned that took the range-row route (counters mvbs_grid_pings over mvbs_pings in the traced window), %."""

from bench_port.traced import counter


def read(rec):
    pings, grid = counter(rec, "mvbs_pings"), counter(rec, "mvbs_grid_pings")
    if not pings or grid is None:
        return None
    return 100.0 * grid / pings
