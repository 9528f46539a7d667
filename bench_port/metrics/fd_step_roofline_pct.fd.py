"""The masked steps against their bound: the seconds the window's steps need at the card's peak (bench_port/roofline_fd.py, from the traffic's shapes) over the device time of every kernel in the traced window, %."""


def read(rec):
    tr = rec["trace"]
    if tr is None or not rec.get("fd_bound_s"):
        return None
    t = sum(tr["kernels"].values())
    if t <= 0:
        return None
    return 100.0 * rec["fd_bound_s"] / t
