"""Share of the complex channel-pings the fused broadband survey staged straight from the parser's float32 planes: counter bb_plane_pings over bb_plane_pings plus complex_widened_pings (channel-pings widened into float64 complex beam groups) in the traced window, %."""

from bench_port.traced import counter


def read(rec):
    planes, widened = counter(rec, "bb_plane_pings"), counter(rec, "complex_widened_pings")
    total = (planes or 0) + (widened or 0)
    if not total:
        return None
    return 100.0 * (planes or 0) / total
