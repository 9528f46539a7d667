"""ASL AZFP ``.01A`` files and their instrument XML, written from a seed.

A frozen copy of the four-frequency layout of ``chip_smoke.py``'s
``write_azfp_xml4`` / ``write_azfp_raw4`` (``tests/synth_azfp.py``'s
67-field big-endian header, then each channel's big-endian u16 counts),
one file an hour of 1 Hz pings.  Each ping is one fixed-size record of a
NumPy structured array; the counts are drawn on ``device`` with a seeded
``torch.Generator``, and the thermistor counts (the temperature, hence the
sound speed, by ping) from the same seed.
"""

from __future__ import annotations

import struct
from pathlib import Path

import numpy as np
import torch

__all__ = ["HEADER_FORMAT", "write_files", "write_xml"]

HEADER_FORMAT = ">HHHHIHHHHHHHHHHHHHHHHHHHHHHHHHHHHHBBBBHBBBBBBBBHHHHHHHHHHHHHHHHHHHH"
FILE_TYPE = 64770


def write_xml(path, config):
    """The instrument XML: coefficients from the configuration's ``xml``,
    one value per frequency where a list."""
    xml = config["xml"]
    parts = [f"<NumFreq>{len(config['channels'])}</NumFreq>",
             f"<SerialNumber>{config['serial_number']}</SerialNumber>",
             '<SensorsFlag PressureSensorInstalled="no"/>']
    for key, val in xml.items():
        vals = val if isinstance(val, list) else [val]
        parts.append("".join(f"<{key}>{v!r}</{key}>" for v in vals))
    Path(path).write_text('<?xml version="1.0"?>\n<InstrumentInfo>\n  '
                          + "\n  ".join(parts) + "\n</InstrumentInfo>")


def _headers(config, n_pings, hour, t_counts):
    """The 124-byte header of every ping (chip_smoke.py's field values)."""
    chans = config["channels"]
    bins = [int(c["bins"]) for c in chans]
    fixed = config["header"]
    out = np.empty(n_pings, dtype="S124")
    y, mo, d = (int(v) for v in config["date"].split("-"))
    for p in range(n_pings):
        vals = [FILE_TYPE, p + 1, int(config["serial_number"]), 1, 60, y, mo, d,
                hour, p // 60, p % 60, 0]
        vals += [fixed["dig_rate"]] * 4 + [fixed["lockout"]] * 4 + bins
        vals += [fixed["samples_per_bin"]] * 4
        vals += [1, 0, 1, 1, 1, 1]  # pings a profile, averaged, acquired, period, first, last
        vals += [0, 0, 0, 0, 0]  # data type x4 (counts, not averaged), data error
        vals += [1, 0, len(chans)]  # phase, overrun, channels
        vals += [1, 1, 1, 1, 0]  # gain x4, spare
        vals += [int(c["pulse_us"]) for c in chans] + [1, 2, 3, 4]
        vals += [int(c["frequency_khz"]) for c in chans]
        # sensor flag, ancillary (tilt x, tilt y, battery, pressure, temperature), ad
        vals += [1, 100, 200, 30000, 0, int(t_counts[p]), 20000, 0]
        out[p] = struct.pack(HEADER_FORMAT, *vals)
    return out


def write_file(path, config, n_pings, hour, seed, device):
    """One hourly file; returns its truth: counts [C] of [P, bins] int32,
    thermistor counts [P], ping times [P] int64 ns."""
    chans = config["channels"]
    g = torch.Generator(device=device)
    g.manual_seed(int(seed))
    lo, hi = config["count_range"]
    counts = [torch.randint(lo, hi, (n_pings, int(c["bins"])), generator=g, device=device,
                            dtype=torch.int32).cpu().numpy() for c in chans]
    rng = np.random.default_rng(int(seed) % 2**63)
    t_mid, t_sd = config["temperature_counts"]
    t_counts = np.clip(np.round(rng.normal(t_mid, t_sd, n_pings)), 0, 65535).astype("i8")
    rec_dt = np.dtype([("hdr", "S124")] + [(f"c{i}", ">u2", (int(c["bins"]),))
                                           for i, c in enumerate(chans)])
    rec = np.empty(n_pings, dtype=rec_dt)
    rec["hdr"] = _headers(config, n_pings, hour, t_counts)
    for i, c in enumerate(counts):
        rec[f"c{i}"] = c
    rec.tofile(str(path))
    day = np.datetime64(config["date"], "ns").astype("i8")
    t_ns = day + (hour * 3600 + np.arange(n_pings, dtype="i8")) * 1_000_000_000
    return {"counts": counts, "temperature_counts": t_counts, "ping_time_ns": t_ns}


def write_files(config, traffic, seed, out_dir, device):
    """The traffic's hourly files and the XML in ``out_dir``; returns
    ([(path, truth)], {"xml_path": ...})."""
    out_dir = Path(out_dir)
    xml = out_dir / f"{config['serial_number']}.XML"
    write_xml(xml, config)
    made = []
    for i, spec in enumerate(traffic["files"]):
        path = out_dir / spec["name"]
        made.append((str(path), write_file(path, config, int(spec["pings"]), int(spec["hour"]),
                                           (int(seed) * 1_000_003 + i) % 2**62, device)))
    return made, {"xml_path": str(xml)}
