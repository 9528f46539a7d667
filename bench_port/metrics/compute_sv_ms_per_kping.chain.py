"""The benchmark's span around compute_Sv on the card (host clock), ms per 1,000 pings."""


def read(rec):
    got = [rec["spans"][n] for n in ['compute_Sv'] if n in rec["spans"]]
    if not got or not rec["pings"]:
        return None
    return sum(got) * 1e3 / (rec["pings"] / 1e3)
