"""The survey's fused window kernels (K1, K2 and their float32 instances) against the HBM byte bound: the bytes their launches need (bench_port/roofline.py, from the traffic's shapes) over 3.35e12 B/s, over their device time in the trace (kernels matched by name), %."""

from bench_port.roofline import HBM_BYTES_PER_S, WINDOW_KERNELS


def read(rec):
    tr = rec["trace"]
    if tr is None or not rec.get("kernel_bytes"):
        return None
    t = sum(s for name, s in tr["kernels"].items() if any(k in name for k in WINDOW_KERNELS))
    if t <= 0:
        return None
    return 100.0 * rec["kernel_bytes"] / HBM_BYTES_PER_S / t
