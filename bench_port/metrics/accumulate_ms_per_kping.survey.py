"""Survey stage accumulate (late D2H of the window partials, float64 add), host wall, ms per 1,000 pings."""


def read(rec):
    got = [rec["stages"][n] for n in ['accumulate'] if n in rec["stages"]]
    if not got or not rec["pings"]:
        return None
    return sum(got) * 1e3 / (rec["pings"] / 1e3)
