"""Simrad EK60 ``.raw`` files for the benchmark, written from a seed.

A frozen copy of the datagram layout of ``tests/synth_ek60.py`` (CON0, RAW0
with power and split-beam angles, NME0 GGA), assembled with NumPy
structured arrays so that a file of 10,000 pings x 5 channels x 4,000
samples (800 MB) is one ``tofile`` call.  The samples are drawn on
``device`` with a seeded ``torch.Generator`` in one call a file.

Every datagram is fixed-size, so a pair of pings is one record:
``RAW0 x C, NME0, RAW0 x C`` (a GGA every other ping, as the instrument
logs its GPS); an odd last ping is ``RAW0 x C, NME0``.  Ping times sit half
a second past whole seconds, so the microsecond rounding of NT time on
decode never moves a ping across a ping-time bin edge.

A file's sound speed is the one its traffic entry gives; an entry with
``ctd_update_ping`` records, from that ping on, a new sound speed drawn
from the seed within the configuration's ``ctd_update_sound_speed_range``
(the operator entering a CTD cast's mean sound speed mid-file).
"""

from __future__ import annotations

import struct
from pathlib import Path

import numpy as np
import torch

__all__ = ["NT_UNIX_DELTA_S", "sound_speeds", "write_files"]

NT_UNIX_DELTA_S = 11644473600
_HEADER_FLOATS = ("transducer_depth", "frequency", "transmit_power", "pulse_length",
                  "bandwidth", "sample_interval", "sound_velocity",
                  "absorption_coefficient", "heave", "roll", "pitch", "temperature",
                  "heading")


def _nt_ticks(ns):
    """int64 ns since the Unix epoch -> (low, high) 100 ns NT ticks."""
    ticks = np.asarray(ns, dtype="i8") // 100 + NT_UNIX_DELTA_S * 10_000_000
    return (ticks & 0xFFFFFFFF).astype("<u4"), (ticks >> 32).astype("<u4")


def _frame(body: bytes) -> bytes:
    return struct.pack("<l", len(body)) + body + struct.pack("<l", len(body))


def make_con0(t_ns, channels, survey="BenchSurvey"):
    """The CON0 datagram (tests/synth_ek60.py:make_con0's layout)."""
    low, high = _nt_ticks([t_ns])
    body = struct.pack("<4sLL128s128s128s30s98sl", b"CON0", int(low[0]), int(high[0]),
                       survey.encode(), b"transect", b"ER60", b"2.4.3", b"", len(channels))
    for ch in channels:
        body += struct.pack(
            "<128sl" + "f" * 15 + "5f8s5f8s5f8s16s28s",
            ch["channel_id"].encode(), 1, ch["frequency"], ch["gain"],
            ch["equivalent_beam_angle"], ch["beamwidth_alongship"],
            ch["beamwidth_athwartship"], ch["angle_sensitivity_alongship"],
            ch["angle_sensitivity_athwartship"], 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0,
            *ch["pulse_length_table"], b"", *ch["gain_table"], b"",
            *ch["sa_correction_table"], b"", b"070413", b"",
        )
    return _frame(body)


def _raw0_dtype(R):
    return np.dtype([
        ("len1", "<i4"), ("type", "S4"), ("low", "<u4"), ("high", "<u4"),
        ("channel", "<i2"), ("mode", "<i2"), ("f", "<f4", (13,)), ("tmode", "<i2"),
        ("spare", "S6"), ("offset", "<i4"), ("count", "<i4"),
        ("power", "<i2", (R,)), ("angle", "i1", (R, 2)), ("len2", "<i4"),
    ])


def _gga(lat_deg, lon_deg):
    """Fixed-width GGA sentences, one per position."""
    out = []
    for la, lo in zip(lat_deg, lon_deg):
        la_d, lo_d = int(la), int(lo)
        out.append(f"$GPGGA,120000,{la_d:02d}{(la - la_d) * 60:07.4f},N,"
                   f"{lo_d:03d}{(lo - lo_d) * 60:07.4f},W,1,08,0.9,5.0,M,,M,,")
    return np.asarray(out, dtype="S")


def _fill_raw0(r, sl, chans, R, low, high, c, power, angle):
    """RAW0 datagrams [pings, C] of the pings ``sl``."""
    C = len(chans)
    r["len1"] = r["len2"] = _raw0_dtype(R).itemsize - 8
    r["type"] = b"RAW0"
    r["low"] = low[sl, None]
    r["high"] = high[sl, None]
    r["channel"] = np.arange(1, C + 1, dtype="<i2")[None, :]
    r["mode"] = 3  # power and angles
    f = np.zeros(r.shape + (13,), dtype="f4")
    for i, ch in enumerate(chans):
        f[:, i] = [ch["transducer_depth"], ch["frequency"], ch["transmit_power"],
                   ch["pulse_length"], ch["bandwidth"], ch["sample_interval"], 0.0,
                   ch["absorption_coefficient"], 0.0, 0.0, 0.0, ch["temperature"], 0.0]
    f[:, :, _HEADER_FLOATS.index("sound_velocity")] = c[sl, None]
    r["f"] = f
    r["count"] = R
    r["power"] = power[:, sl].transpose(1, 0, 2)
    r["angle"] = angle[:, sl].transpose(1, 0, 2, 3)


def _fill_nme0(n, sl, low, high, gga):
    n["len1"] = n["len2"] = n.dtype.itemsize - 8
    n["type"] = b"NME0"
    n["low"], n["high"] = low[sl], high[sl]
    n["text"] = gga


def sound_speeds(config, spec, n_pings, rng):
    """[P] float32 sound speed a ping, as the file records it."""
    c = np.full(n_pings, float(spec["sound_speed"]), dtype="f4")
    if "ctd_update_ping" in spec:
        lo_c, hi_c = config["ctd_update_sound_speed_range"]
        c[int(spec["ctd_update_ping"]):] = np.float32(round(rng.uniform(lo_c, hi_c), 1))
    return c


def write_file(path, config, spec, t0_ns, seed, device):
    """Write the file of traffic entry ``spec``; returns its truth: power
    indices [C, P, R] int16, ping times [P] int64 ns, sound speed [P]
    float32 (RAW0 field)."""
    chans = config["channels"]
    C, R, n_pings = len(chans), int(config["samples_per_ping"]), int(spec["pings"])
    g = torch.Generator(device=device)
    g.manual_seed(int(seed))
    lo_i, hi_i = config["power_index_range"]
    power = torch.randint(lo_i, hi_i, (C, n_pings, R), generator=g, device=device,
                          dtype=torch.int16).cpu().numpy()
    angle = torch.randint(-50, 50, (C, n_pings, R, 2), generator=g, device=device,
                          dtype=torch.int8).cpu().numpy()
    c = sound_speeds(config, spec, n_pings, np.random.default_rng(int(seed) % 2**63))
    t_ns = t0_ns + np.arange(n_pings, dtype="i8") * int(config["ping_interval_ns"]) \
        + int(config["ping_offset_ns"])
    low, high = _nt_ticks(t_ns)

    raw_dt = _raw0_dtype(R)  # tests/synth_ek60.py:make_raw0's "<4sLLhh13fh6sll", then samples
    n_pair, odd = divmod(n_pings, 2)
    pos = np.arange(n_pair + odd, dtype="f8")
    gga = _gga(45.0 + pos * 1e-4, 124.0 + pos * 1e-4)
    nme_dt = np.dtype([("len1", "<i4"), ("type", "S4"), ("low", "<u4"), ("high", "<u4"),
                       ("text", f"S{gga.dtype.itemsize}"), ("len2", "<i4")])
    rec = np.zeros(n_pair, dtype=[("a", raw_dt, (C,)), ("n", nme_dt), ("b", raw_dt, (C,))])
    tail = np.zeros(odd, dtype=[("a", raw_dt, (C,)), ("n", nme_dt)])
    last = 2 * n_pair
    _fill_raw0(rec["a"], slice(0, last, 2), chans, R, low, high, c, power, angle)
    _fill_raw0(rec["b"], slice(1, last, 2), chans, R, low, high, c, power, angle)
    _fill_nme0(rec["n"], slice(0, last, 2), low, high, gga[:n_pair])
    if odd:
        _fill_raw0(tail["a"], slice(last, None), chans, R, low, high, c, power, angle)
        _fill_nme0(tail["n"], slice(last, None), low, high, gga[n_pair:])
    with open(path, "wb") as fh:
        fh.write(make_con0(t0_ns, chans))
        rec.tofile(fh)
        tail.tofile(fh)
    return {"power": power, "ping_time_ns": t_ns, "sound_speed": c}


def write_files(config, traffic, seed, out_dir, device):
    """The traffic's files in ``out_dir``, each from its own stream of
    ``seed``; consecutive in time.  Returns [(path, truth)]."""
    out_dir = Path(out_dir)
    t_ns = int(np.datetime64(config["start_time"], "ns").astype("i8"))
    made = []
    for i, spec in enumerate(traffic["files"]):
        path = out_dir / spec["name"]
        truth = write_file(path, config, spec, t_ns, (int(seed) * 1_000_003 + i) % 2**62,
                           device)
        made.append((str(path), truth))
        t_ns += int(spec["pings"]) * int(config["ping_interval_ns"])
    return made
