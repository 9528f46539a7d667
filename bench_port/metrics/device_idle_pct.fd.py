"""Share of the traced window in which the card ran no kernel, copy or set (torch.profiler's device activity), %."""


def read(rec):
    tr = rec["trace"]
    if tr is None or tr["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])
