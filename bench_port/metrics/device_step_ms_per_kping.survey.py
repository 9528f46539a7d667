"""Survey stage device_mvbs / device_mvbs_f32 (host operands, synchronous H2D, the K1/K2 launch), host wall, ms per 1,000 pings."""


def read(rec):
    got = [rec["stages"][n] for n in ['device_mvbs', 'device_mvbs_f32'] if n in rec["stages"]]
    if not got or not rec["pings"]:
        return None
    return sum(got) * 1e3 / (rec["pings"] / 1e3)
