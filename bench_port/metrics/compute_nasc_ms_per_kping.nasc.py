"""The benchmark's span around compute_NASC (host clock), ms per 1,000 pings."""


def read(rec):
    t = rec["spans"].get("compute_NASC")
    if t is None or not rec["pings"]:
        return None
    return t * 1e3 / (rec["pings"] / 1e3)
