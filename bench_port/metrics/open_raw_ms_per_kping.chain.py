"""The benchmark's span around open_raw (host clock), ms per 1,000 pings."""


def read(rec):
    got = [rec["spans"][n] for n in ['open_raw'] if n in rec["spans"]]
    if not got or not rec["pings"]:
        return None
    return sum(got) * 1e3 / (rec["pings"] / 1e3)
