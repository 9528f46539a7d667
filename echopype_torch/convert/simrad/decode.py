"""Columnar (vectorized) decoders for Simrad datagram payloads.

Behavioral contract from echopype/convert/utils/ek_raw_parsers.py:
- RAW0 (":1628-1674" header layout): sample-data datagram, int16 power and
  int8 angle pairs; mode bit0 = power present, bit1 = angle present.
- CON0 (":1311-1353"): file configuration with per-transceiver blocks
  (ER60/ES60/ES70 layout incl. 5-entry pulse_length/gain/sa_correction tables).
- NME0 (":406-411"): raw NMEA sentence text.

All RAW0 headers in a file are decoded in ONE structured-dtype gather; sample
payloads are decoded with ONE masked gather per channel straight into the
NaN-padded ``[ping, range_sample]`` arrays the compute core consumes.
"""

from __future__ import annotations

import struct

import numpy as np

from .framing import DatagramIndex, nt_to_datetime64
from ...utils.log import _init_logger

logger = _init_logger(__name__)


def _clamp_counts(counts, per_count_bytes, sizes, hdr_itemsize, what):
    """Cap untrusted header sample counts to what the datagram body holds.

    The framing trailer validates ``size``, but the in-body count field is
    independent: a corrupt file can claim more samples than the body
    carries, which would read past the datagram (and, in the fused C++
    gathers, past the buffer).  Clamped rows keep their in-extent prefix
    and NaN-pad the rest; the clamp is logged once per call."""
    avail = np.maximum(sizes.astype("i8") - int(hdr_itemsize), 0)
    per = np.asarray(per_count_bytes, dtype="i8")
    cap = np.where(per > 0, avail // np.maximum(per, 1), 0)
    used = per > 0
    bad = used & (counts > cap)
    if bad.any():
        logger.warning(
            f"{int(bad.sum())} {what} datagram(s) claim more samples than "
            f"their body holds; extra samples treated as missing."
        )
        counts = np.minimum(counts, cap)
    return counts

# Manufacturer power scaling: raw int16 -> dB (parse_base.py:24)
INDEX2POWER = 10.0 * np.log10(2.0) / 256.0

RAW0_HEADER = np.dtype(
    [
        ("type", "S4"),
        ("low_date", "<u4"),
        ("high_date", "<u4"),
        ("channel", "<i2"),
        ("mode", "<i2"),
        ("transducer_depth", "<f4"),
        ("frequency", "<f4"),
        ("transmit_power", "<f4"),
        ("pulse_length", "<f4"),
        ("bandwidth", "<f4"),
        ("sample_interval", "<f4"),
        ("sound_velocity", "<f4"),
        ("absorption_coefficient", "<f4"),
        ("heave", "<f4"),
        ("roll", "<f4"),
        ("pitch", "<f4"),
        ("temperature", "<f4"),
        ("heading", "<f4"),
        ("transmit_mode", "<i2"),
        ("spare0", "S6"),
        ("offset", "<i4"),
        ("count", "<i4"),
    ]
)
assert RAW0_HEADER.itemsize == 84

_CON0_HEADER_FMT = "<4sLL128s128s128s30s98sl"
_CON0_HEADER_SIZE = struct.calcsize(_CON0_HEADER_FMT)

# ER60/ES60/ES70 per-transceiver block (CON0 COMMON_KEYS layout)
_TXCVR_FMT = "<128sl" + "f" * 15 + "5f8s5f8s5f8s16s28s"
_TXCVR_SIZE = struct.calcsize(_TXCVR_FMT)


def decode_raw0_headers(index: DatagramIndex, rows: np.ndarray):
    """Decode all RAW0 headers at once into a structured array + timestamps."""
    u8 = np.frombuffer(index.buf, dtype="u1")
    offs = index.body_offset[rows]
    hdr_bytes = u8[offs[:, None] + np.arange(RAW0_HEADER.itemsize)]
    hdr = np.ascontiguousarray(hdr_bytes).view(RAW0_HEADER).ravel()
    ts = nt_to_datetime64(hdr["low_date"], hdr["high_date"])
    return hdr, ts


def _gather_i16(u8: np.ndarray, starts: np.ndarray, counts: np.ndarray, max_count: int):
    """Gather little-endian int16 runs of varying length into a padded matrix.

    Alignment-free: bytes are gathered as u8 pairs and recombined, so datagram
    offsets need no 2-byte alignment.  Returns (int16 matrix, valid mask).
    """
    if max_count == 0 or len(starts) == 0:
        return (
            np.zeros((len(starts), 0), dtype="i2"),
            np.zeros((len(starts), 0), dtype=bool),
        )
    from ... import native

    res = native.gather_i16(u8, np.asarray(starts), np.asarray(counts), max_count)
    if res is not None:
        return res
    lane = np.arange(max_count, dtype="i8")
    valid = lane[None, :] < counts[:, None].astype("i8")
    idx = starts[:, None] + 2 * lane[None, :]
    idx = np.where(valid, idx, 0)  # clamp padded lanes to a safe offset
    lo = u8[idx].astype("u2")
    hi = u8[idx + 1].astype("u2")
    vals = (lo | (hi << np.uint16(8))).astype("u2").view("i2").reshape(lo.shape)
    return vals, valid


def decode_raw0_samples(index: DatagramIndex, rows: np.ndarray, hdr: np.ndarray):
    """Vectorized decode of RAW0 power/angle payloads into padded arrays.

    Returns dict with:
      power      f4 [n_ping, max_count]  (raw int16 * INDEX2POWER, NaN-padded)
      angle      f4 [n_ping, max_count, 2]  (athwartship, alongship; NaN-padded)
    Missing data (mode bit unset) yields None for that key.
    """
    u8 = np.frombuffer(index.buf, dtype="u1")
    offs = index.body_offset[rows]
    counts = hdr["count"].astype("i8")
    mode = hdr["mode"].astype("i8")
    sample_start = offs + RAW0_HEADER.itemsize

    out = {"power": None, "angle": None}
    has_power = (mode & 1).astype(bool)
    has_angle = (mode & 2).astype(bool)
    counts = _clamp_counts(
        counts,
        2 * (has_power.astype("i8") + has_angle.astype("i8")),
        index.size[rows],
        RAW0_HEADER.itemsize,
        "RAW0",
    )
    max_count = int(counts.max()) if len(counts) else 0

    if has_power.any():
        pw_counts = np.where(has_power, counts, 0)
        out["power"] = _power_f4(u8, sample_start, pw_counts, max_count)

    if has_angle.any():
        ang_start = sample_start + np.where(has_power, 2 * counts, 0)
        ang_counts = np.where(has_angle, counts, 0)
        out["angle"] = _angle_f4(u8, ang_start, ang_counts, max_count)
    return out


def _power_f4(u8, starts, counts, max_count):
    """int16 sample runs -> f4 * INDEX2POWER, NaN-padded [n, max_count]."""
    from ... import native

    fused = native.gather_i16_scaled(u8, starts, counts, max_count, float(INDEX2POWER))
    if fused is not None:
        return fused
    vals, valid = _gather_i16(u8, starts, counts, max_count)
    # in-place scale; rows are full in the common non-ragged case, so the
    # NaN masking (a large fancy-index write) is skipped entirely then
    power = vals.astype("f4")
    power *= np.float32(INDEX2POWER)
    if counts.min() < max_count:
        power[~valid] = np.nan
    return power


def _angle_f4(u8, starts, counts, max_count):
    """(athwart, along) int8-pair runs -> f4 [n, max_count, 2], NaN-padded."""
    from ... import native

    fused = native.gather_angle(u8, starts, counts, max_count)
    if fused is not None:
        return fused
    vals, valid = _gather_i16(u8, starts, counts, max_count)
    pairs = vals.view("i1").reshape(vals.shape + (2,))
    angle = pairs.astype("f4")
    if counts.min() < max_count:
        angle[~valid] = np.nan
    return angle


def decode_con0(index: DatagramIndex, row: int) -> dict:
    """Decode the CON0 configuration datagram (one per EK60 file)."""
    start = int(index.body_offset[row])
    body = index.buf[start : start + int(index.size[row])]
    vals = struct.unpack_from(_CON0_HEADER_FMT, body, 0)
    (_type, low, high, survey, transect, sounder, version, _spare, txcvr_count) = vals

    def s(b):
        return b.decode("latin_1").strip("\x00")

    cfg = {
        "timestamp": nt_to_datetime64(np.array([low]), np.array([high]))[0],
        "survey_name": s(survey),
        "transect_name": s(transect),
        "sounder_name": s(sounder),
        "version": s(version),
        "transceiver_count": txcvr_count,
        "transceivers": {},
    }
    pos = _CON0_HEADER_SIZE
    for i in range(1, txcvr_count + 1):
        f = struct.unpack_from(_TXCVR_FMT, body, pos)
        pos += _TXCVR_SIZE
        names = [
            "channel_id",
            "beam_type",
            "frequency",
            "gain",
            "equivalent_beam_angle",
            "beamwidth_alongship",
            "beamwidth_athwartship",
            "angle_sensitivity_alongship",
            "angle_sensitivity_athwartship",
            "angle_offset_alongship",
            "angle_offset_athwartship",
            "pos_x",
            "pos_y",
            "pos_z",
            "dir_x",
            "dir_y",
            "dir_z",
        ]
        tx = dict(zip(names, f[:17]))
        tx["channel_id"] = s(tx["channel_id"])
        r6 = lambda x: round(float(x), 6)  # noqa: E731 - table entries rounded like ref
        tx["pulse_length_table"] = np.array([r6(x) for x in f[17:22]])
        tx["gain_table"] = np.array([r6(x) for x in f[23:28]])
        tx["sa_correction_table"] = np.array([r6(x) for x in f[29:34]])
        tx["gpt_software_version"] = s(f[35])
        cfg["transceivers"][i] = tx
    return cfg


def decode_nmea(index: DatagramIndex, rows: np.ndarray):
    """Extract raw NMEA sentence strings + timestamps."""
    out = []
    for r in rows:
        start = int(index.body_offset[r]) + 12
        end = int(index.body_offset[r]) + int(index.size[r])
        raw = index.buf[start:end].split(b"\x00", 1)[0]
        out.append(raw.decode("latin_1", "replace").strip("\r\n"))
    return np.asarray(out, dtype=object), index.timestamp[rows]


# ----------------------------------------------------------------- EK80: RAW3
RAW3_HEADER = np.dtype(
    [
        ("type", "S4"),
        ("low_date", "<u4"),
        ("high_date", "<u4"),
        ("channel_id", "S128"),
        ("data_type", "<i2"),
        ("spare", "S2"),
        ("offset", "<i4"),
        ("count", "<i4"),
    ]
)
assert RAW3_HEADER.itemsize == 152


def decode_raw3_headers(index: DatagramIndex, rows: np.ndarray):
    """Decode all RAW3/RAW4 headers in one structured gather.

    Returns (structured header array, timestamps, channel_id strings).
    """
    u8 = np.frombuffer(index.buf, dtype="u1")
    offs = index.body_offset[rows]
    if len(offs) == 0:
        return (
            np.empty(0, dtype=RAW3_HEADER),
            np.empty(0, "datetime64[ns]"),
            np.empty(0, dtype=object),
        )
    hdr_bytes = u8[offs[:, None] + np.arange(RAW3_HEADER.itemsize)]
    hdr = np.ascontiguousarray(hdr_bytes).view(RAW3_HEADER).ravel()
    ts = nt_to_datetime64(hdr["low_date"], hdr["high_date"])
    ch_ids = np.array(
        [c.split(b"\x00", 1)[0].decode("latin_1").replace("\x00t", "") for c in hdr["channel_id"]],
        dtype=object,
    )
    return hdr, ts, ch_ids


def _gather_f32(u8: np.ndarray, starts: np.ndarray, n_vals: np.ndarray, max_vals: int):
    """Gather little-endian float32 runs into a padded [rows, max_vals] matrix."""
    if max_vals == 0 or len(starts) == 0:
        return np.zeros((len(starts), 0), "f4"), np.zeros((len(starts), 0), bool)
    lane = np.arange(max_vals, dtype="i8")
    valid = lane[None, :] < n_vals[:, None].astype("i8")
    idx = np.where(valid, starts[:, None] + 4 * lane[None, :], 0)
    b = np.stack([u8[idx], u8[idx + 1], u8[idx + 2], u8[idx + 3]], axis=-1)
    vals = np.ascontiguousarray(b).view("<f4").reshape(b.shape[:-1])
    return vals, valid


def _gather_f16_as_f32(u8: np.ndarray, starts: np.ndarray, n_vals: np.ndarray, max_vals: int):
    """Gather little-endian float16 runs into a padded f32 [rows, max_vals] matrix."""
    if max_vals == 0 or len(starts) == 0:
        return np.zeros((len(starts), 0), "f4"), np.zeros((len(starts), 0), bool)
    lane = np.arange(max_vals, dtype="i8")
    valid = lane[None, :] < n_vals[:, None].astype("i8")
    idx = np.where(valid, starts[:, None] + 2 * lane[None, :], 0)
    b = np.stack([u8[idx], u8[idx + 1]], axis=-1)
    vals = np.ascontiguousarray(b).view("<f2").reshape(b.shape[:-1]).astype("f4")
    return vals, valid


def decode_raw3_samples(index: DatagramIndex, rows: np.ndarray, hdr: np.ndarray):
    """Vectorized RAW3/RAW4 payload decode for one channel's rows.

    data_type bits (ek_raw_parsers.py:1676-1760): bit0 power, bit1 angle,
    bit2 complex-f16, bit3 complex-f32; n_complex = data_type >> 8 (number
    of sectors).  float16 complex samples decode as 2x f16 per complex value
    (4 bytes) per the RAW3 datagram layout — the reference's f16 branch
    (ek_raw_parsers.py:1746-1765) sizes the block at 2 bytes/complex and then
    reinterprets the f16 buffer as complex64, which cannot be right; we
    follow the format spec instead.

    Returns dict with keys power [N,R], angle [N,R,2], complex_r/complex_i
    [N,R,n_complex] (None where absent).  The complex parts are float32
    views of one interleaved [N,R,n_complex,2] buffer, NaN past each ping's
    count.
    """
    u8 = np.frombuffer(index.buf, dtype="u1")
    offs = index.body_offset[rows]
    counts = hdr["count"].astype("i8")
    dt = hdr["data_type"].astype("i8")
    n_complex = int((dt >> 8).max()) if len(dt) else 0
    pos = offs + RAW3_HEADER.itemsize

    has_power = (dt & 1).astype(bool)
    has_angle = (dt & 2).astype(bool)
    # mirror the gather's layout exactly: it uses the file-max n_complex for
    # every row and picks f32 vs f16 width from the whole-file any() check
    cplx_width = 4 if bool(((dt & 0b1000) > 0).any()) else 2
    cplx_bytes = np.where(dt >> 8 > 0, n_complex * 2 * cplx_width, 0)
    counts = _clamp_counts(
        counts,
        2 * (has_power.astype("i8") + has_angle.astype("i8")) + cplx_bytes,
        index.size[rows],
        RAW3_HEADER.itemsize,
        "RAW3/RAW4",
    )
    max_count = int(counts.max()) if len(counts) else 0

    out = {"power": None, "angle": None, "complex_r": None, "complex_i": None,
           "n_complex": n_complex}
    if has_power.any():
        pw_counts = np.where(has_power, counts, 0)
        out["power"] = _power_f4(u8, pos, pw_counts, max_count)
        pos = pos + np.where(has_power, 2 * counts, 0)
    if has_angle.any():
        ang_counts = np.where(has_angle, counts, 0)
        out["angle"] = _angle_f4(u8, pos, ang_counts, max_count)
        pos = pos + np.where(has_angle, 2 * counts, 0)
    if n_complex > 0:
        n_vals = np.where(dt >> 8 > 0, counts * n_complex * 2, 0)
        max_vals = max_count * n_complex * 2
        if bool((dt & 0b1000).any()):
            from ... import native

            vals = native.gather_f32_nan(u8, pos, n_vals, max_vals)
            if vals is None:
                vals, valid = _gather_f32(u8, pos, n_vals, max_vals)
                vals = np.where(valid, vals, np.nan)
        else:
            # float16 complex (data_type bit2): 2x f16 per complex sample
            vals, valid = _gather_f16_as_f32(u8, pos, n_vals, max_vals)
            vals = np.where(valid, vals, np.nan)
        vals = vals.reshape(len(rows), max_count, n_complex, 2)
        # float32 views of the gather, no copy: set-groups widens them to
        # float64 once, as it fills the beam group
        out["complex_r"] = vals[..., 0]
        out["complex_i"] = vals[..., 1]
    return out


def decode_fil1(index: DatagramIndex, row: int) -> dict:
    """FIL1 filter datagram (ek_raw_parsers.py:1161-1205)."""
    import struct as _s

    start = int(index.body_offset[row])
    body = index.buf[start : start + int(index.size[row])]
    (_t, low, high, stage, _sp, ch, n_coeff, deci) = _s.unpack_from("<4sLLh2s128shh", body, 0)
    coeffs = np.frombuffer(body, dtype="<c8", count=n_coeff, offset=_s.calcsize("<4sLLh2s128shh"))
    return {
        "timestamp": index.timestamp[row],
        "stage": stage,
        "channel_id": ch.split(b"\x00", 1)[0].decode("latin_1"),
        "n_coefficients": n_coeff,
        "decimation_factor": deci,
        "coefficients": coeffs,
    }


IDX0_STRUCT = "<4sLLLdddL"  # ping_number, distance, latitude, longitude, file_offset


def decode_idx(index: DatagramIndex, rows: np.ndarray):
    """IDX0 index datagrams (ek_raw_parsers.py:639-705)."""
    import struct as _s

    out = {
        "ping_number": [],
        "vessel_distance": [],
        "latitude": [],
        "longitude": [],
        "file_offset": [],
        "timestamp": [],
    }
    for r in rows:
        start = int(index.body_offset[r])
        (_t, _lo, _hi, ping_no, dist, lat, lon, foff) = _s.unpack_from(
            IDX0_STRUCT, index.buf, start
        )
        out["ping_number"].append(ping_no)
        out["vessel_distance"].append(dist)
        out["latitude"].append(lat)
        out["longitude"].append(lon)
        out["file_offset"].append(foff)
        out["timestamp"].append(index.timestamp[r])
    return {k: np.asarray(v) for k, v in out.items()}


def decode_bot(index: DatagramIndex, rows: np.ndarray):
    """BOT0 seafloor-depth datagrams: 16-byte header (type/dates/count) then
    one f8 depth per transceiver (ek_raw_parsers.py:212-268).

    The transceiver count is untrusted: it is clamped to what the framed
    datagram body actually holds (same policy as the RAW0/RAW3 sample-count
    clamps) so one corrupt BOT0 cannot balloon a read or drop the file."""
    import struct as _s

    depths, times = [], []
    for r in rows:
        start = int(index.body_offset[r])
        (_t, _lo, _hi, cnt) = _s.unpack_from("<4sLLL", index.buf, start)
        fit = max(0, (int(index.size[r]) - 16) // 8)
        if cnt > fit:
            logger.warning(
                f"BOT0 datagram claims {cnt} transceiver depths but its body "
                f"holds {fit}; clamping."
            )
            cnt = fit
        depths.append(np.frombuffer(index.buf, dtype="<f8", count=cnt, offset=start + 16))
        times.append(index.timestamp[r])
    out = {}
    if depths:
        n = max(len(d) for d in depths)
        if any(len(d) != n for d in depths):
            depths = [
                np.concatenate([d, np.full(n - len(d), np.nan)]) for d in depths
            ]
        out["depth"] = np.stack(depths)
        out["timestamp"] = np.asarray(times, dtype="datetime64[ns]")
    return out


MRU0_STRUCT = "<4sLLffff"  # heave, roll, pitch, heading


def decode_mru0(index: DatagramIndex, rows: np.ndarray):
    import struct as _s

    out = {"heave": [], "roll": [], "pitch": [], "heading": [], "timestamp": []}
    for r in rows:
        start = int(index.body_offset[r])
        (_t, low, high, heave, roll, pitch, heading) = _s.unpack_from(
            MRU0_STRUCT, index.buf, start
        )
        out["heave"].append(heave)
        out["roll"].append(roll)
        out["pitch"].append(pitch)
        out["heading"].append(heading)
        out["timestamp"].append(index.timestamp[r])
    return {k: np.asarray(v) for k, v in out.items()}


# KMB-format motion record (ek_raw_parsers.py:559-589): lat/lon doubles then
# the full attitude/rate/error/acceleration float block
MRU1_STRUCT = "<4sLL4sL12sdd" + "f" * 21 + "LLf"
MRU1_FIELDS = (
    "latitude", "longitude", "ellipsoid_height", "roll", "pitch", "heading",
    "heave", "roll_rate", "pitch_rate", "yaw_rate", "velocity_north",
    "velocity_east", "velocity_down", "latitude_error", "longitude_error",
    "height_error", "roll_error", "pitch_error", "heading_error",
    "heave_error", "accel_north", "accel_east", "accel_down",
    "heave_delay_secs", "heave_delay_usecs", "heave_delay_m",
)


def decode_mru1(index: DatagramIndex, rows: np.ndarray):
    import struct as _s

    out = {f: [] for f in MRU1_FIELDS}
    out["timestamp"] = []
    for r in rows:
        start = int(index.body_offset[r])
        vals = _s.unpack_from(MRU1_STRUCT, index.buf, start)
        for f, v in zip(MRU1_FIELDS, vals[6:]):
            out[f].append(v)
        out["timestamp"].append(index.timestamp[r])
    return {k: np.asarray(v) for k, v in out.items()}


# ---------------------------------------------------------------- NMEA lat/lon
def _dm_to_deg(dm: str, hemi: str) -> float:
    """ddmm.mmmm -> decimal degrees."""
    if not dm:
        return np.nan
    try:
        v = float(dm)
    except ValueError:
        return np.nan
    deg = int(v // 100)
    minutes = v - deg * 100
    out = deg + minutes / 60.0
    if hemi in ("S", "W"):
        out = -out
    return out


def parse_nmea_latlon(sentences, timestamps, allowed=("GGA", "GLL", "RMC")):
    """Extract lat/lon from GGA/GLL/RMC sentences.

    Capability parity with the reference's pynmea2-based extraction
    (set_groups_base.py:180-220) without the dependency.
    Returns (time, msg_type, lat, lon) arrays for matching sentences.
    """
    times, types, lats, lons = [], [], [], []
    for sent, ts in zip(sentences, timestamps):
        if not sent.startswith("$") or len(sent) < 10:
            continue
        body = sent[1:].split("*")[0]
        fields = body.split(",")
        stype = fields[0][-3:]
        if stype not in allowed:
            continue
        try:
            if stype == "GGA":
                lat = _dm_to_deg(fields[2], fields[3])
                lon = _dm_to_deg(fields[4], fields[5])
            elif stype == "GLL":
                lat = _dm_to_deg(fields[1], fields[2])
                lon = _dm_to_deg(fields[3], fields[4])
            else:  # RMC
                lat = _dm_to_deg(fields[3], fields[4])
                lon = _dm_to_deg(fields[5], fields[6])
        except IndexError:
            continue
        times.append(ts)
        types.append(stype)
        lats.append(lat)
        lons.append(lon)
    return (
        np.asarray(times, dtype="datetime64[ns]"),
        np.asarray(types, dtype=object),
        np.asarray(lats, dtype="f8"),
        np.asarray(lons, dtype="f8"),
    )
