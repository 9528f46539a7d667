"""Share of the masked chunks' valid samples that the frequency-differencing mask kept: counters fd_kept_samples over fd_valid_samples (summed over the channels) in the traced window, %."""

from bench_port.traced import counter


def read(rec):
    valid, kept = counter(rec, "fd_valid_samples"), counter(rec, "fd_kept_samples")
    if not valid or kept is None:
        return None
    return 100.0 * kept / valid
