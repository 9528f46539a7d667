"""Share of the pings the power streamer staged that are padding (counters padded_pings over staged_pings in the traced window), %."""

from bench_port.traced import counter


def read(rec):
    staged, padded = counter(rec, "staged_pings"), counter(rec, "padded_pings")
    if not staged or padded is None:
        return None
    return 100.0 * padded / staged
