"""Survey stage to_int16 (EK) or pad_float32 (AZFP), host wall, ms per 1,000 pings."""


def read(rec):
    got = [rec["stages"][n] for n in ['to_int16', 'pad_float32'] if n in rec["stages"]]
    if not got or not rec["pings"]:
        return None
    return sum(got) * 1e3 / (rec["pings"] / 1e3)
