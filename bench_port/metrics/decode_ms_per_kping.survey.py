"""Survey stages scan + ingest (the program's stage timer, host wall; ingest overlaps on the prefetch thread), ms per 1,000 pings."""


def read(rec):
    got = [rec["stages"][n] for n in ['scan', 'ingest'] if n in rec["stages"]]
    if not got or not rec["pings"]:
        return None
    return sum(got) * 1e3 / (rec["pings"] / 1e3)
