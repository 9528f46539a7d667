"""Host-to-device rate of the masked step's operands: counter h2d_bytes over the device's Memcpy HtoD seconds in the traced window, GB/s."""

from bench_port.traced import counter


def read(rec):
    n = counter(rec, "h2d_bytes")
    if not n:
        return None
    t = sum(s for name, s in rec["trace"]["breakdown"]["device_ops"] if "Memcpy HtoD" in name)
    if t <= 0:
        return None
    return n / t / 1e9
