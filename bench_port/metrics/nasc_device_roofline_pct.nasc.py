"""The NASC chain's device work against its bound: the seconds the window's calls need at the card's peak (bench_port/roofline_nasc.py: power calibration and the two binning passes, from the traffic's shapes) over the device time of every kernel in the traced window, %."""


def read(rec):
    tr = rec["trace"]
    if tr is None or not rec.get("nasc_bound_s"):
        return None
    t = sum(tr["kernels"].values())
    if t <= 0:
        return None
    return 100.0 * rec["nasc_bound_s"] / t
