"""Share of the pings compute_NASC binned whose samples it resolved one by one (counters nasc_sample_pings over nasc_pings in the traced window), %."""

from bench_port.traced import counter


def read(rec):
    pings, per_sample = counter(rec, "nasc_pings"), counter(rec, "nasc_sample_pings")
    if not pings or per_sample is None:
        return None
    return 100.0 * per_sample / pings
