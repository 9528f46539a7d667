"""Pings of every open_raw -> compute_Sv -> compute_MVBS call in the window over the window's wall time (host clock)."""


def read(rec):
    if not rec["pings"]:
        return None
    return rec["pings"] / rec["window_s"]
