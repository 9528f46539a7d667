"""Nortek AD2CP parser.

Capability parity: echopype/convert/parse_ad2cp.py:221-1856 — 0xA5-framed
packets with Fletcher-style 16-bit checksums; burst/average record versions
2/3, echosounder, echosounder-raw (+transmit), bottom-track, and string
(configuration) records; bitfield postprocessing for the configuration and
beam/coordinate-system words; config-string parsing (GETCLOCKSTR etc.).

The format tables below re-express Nortek's public AD2CP integrator spec in a
compact declarative form: (name, entry_bytes, kind, shape, convert, exists).
"""

from __future__ import annotations

import struct
from pathlib import Path

import numpy as np

from ..utils.log import _init_logger
from ..utils.io import read_source_bytes

logger = _init_logger(__name__)

__all__ = ["ParseAd2cp", "checksum"]

BURST_IDS = (0x15, 0x18, 0x1A)  # burst, burst avg?, burst altimeter
AVERAGE_IDS = (0x16, 0x1D, 0x1E, 0x1F)  # average, dvl water track, altimeters
BOTTOM_TRACK_IDS = (0x17, 0x1B)
ECHOSOUNDER_ID = 0x1C
ECHOSOUNDER_RAW_ID = 0x23
ECHOSOUNDER_RAW_TRANSMIT_ID = 0x24
STRING_ID = 0xA0


def checksum(data: bytes) -> int:
    """Nortek 16-bit checksum seeded with 0xB58C (parse_ad2cp.py:807-820).

    Odd-length records: the trailing byte contributes TWICE — the reference's
    final 2-byte window holds just that byte (little-endian -> low byte), and
    the odd-length branch adds it again shifted high.  Summing it only once
    made every odd-length record fail validation and get skipped."""
    c = 0xB58C
    n = len(data)
    even = n - (n % 2)
    if even:
        c += int(np.frombuffer(data[:even], dtype="<u2").sum(dtype="u8") % 65536)
        c %= 65536
    if n % 2 == 1:
        c = (c + data[-1] + (data[-1] << 8)) % 65536
    return c


class Packet:
    """One parsed AD2CP packet (header + data record fields in ``data``)."""

    __slots__ = ("data", "record_kind")

    def __init__(self):
        self.data = {}
        self.record_kind = None

    # id predicates (parse_ad2cp.py:337-397)
    def is_burst(self):
        return self.data["id"] in (0x15, 0x18) or self.data["id"] == 0x1A

    def is_average(self):
        return self.data["id"] in (0x16, 0x1D, 0x1E, 0x1F)

    def is_bottom_track(self):
        return self.data["id"] in BOTTOM_TRACK_IDS

    def is_echosounder(self):
        return self.data["id"] == ECHOSOUNDER_ID

    def is_echosounder_raw(self):
        return self.data["id"] == ECHOSOUNDER_RAW_ID

    def is_echosounder_raw_transmit(self):
        return self.data["id"] == ECHOSOUNDER_RAW_TRANSMIT_ID

    def is_string(self):
        return self.data["id"] == STRING_ID

    def has_timestamp(self):
        return "year" in self.data

    @property
    def timestamp(self) -> np.datetime64:
        d = self.data
        from datetime import datetime

        return np.datetime64(
            datetime(
                int(d["year"]) + 1900,
                int(d["month"]) + 1,
                int(d["day"]),
                int(d["hour"]),
                int(d["minute"]),
                int(d["seconds"]),
                int(d["microsec100"]) * 100,
            ),
            "ns",
        )


# ------------------------------------------------------------ record reading
def _read_scaled(buf, pos, size, signed, div=None, mul=None):
    """Read one little-endian integer; unit-convert with the same floating
    ops as the reference descriptors (x / div and/or x * mul, in that order)
    so converted values are bit-identical."""
    dtype = {(1, False): "<u1", (1, True): "<i1", (2, False): "<u2", (2, True): "<i2",
             (4, False): "<u4", (4, True): "<i4"}[(size, signed)]
    val = int(np.frombuffer(buf, dtype=dtype, count=1, offset=pos)[0])
    if div is not None:
        val = val / div
    if mul is not None:
        val = val * mul
    return val, pos + size


def _read_array(buf, pos, size, signed, count, div=None, mul=None):
    dtype = {(1, False): "<u1", (1, True): "<i1", (2, False): "<u2", (2, True): "<i2",
             (4, False): "<u4", (4, True): "<i4"}[(size, signed)]
    arr = np.frombuffer(buf, dtype=dtype, count=count, offset=pos).astype("f8")
    if div is not None:
        arr = arr / div
    if mul is not None:
        arr = arr * mul
    return arr, pos + size * count


def _read_f32(buf, pos):
    return float(np.frombuffer(buf, dtype="<f4", count=1, offset=pos)[0]), pos + 4


def _read_f32_array(buf, pos, count):
    arr = np.frombuffer(buf, dtype="<f4", count=count, offset=pos).astype("f8")
    return arr, pos + 4 * count


def _bitfield(value, specs, data):
    for name, hi, lo in specs:
        mask = (1 << (hi - lo + 1)) - 1
        data[name] = (int(value) >> lo) & mask


CONFIG_BITS_V3 = [
    ("pressure_sensor_valid", 0, 0),
    ("temperature_sensor_valid", 1, 1),
    ("compass_sensor_valid", 2, 2),
    ("tilt_sensor_valid", 3, 3),
    ("velocity_data_included", 5, 5),
    ("amplitude_data_included", 6, 6),
    ("correlation_data_included", 7, 7),
    ("altimeter_data_included", 8, 8),
    ("altimeter_raw_data_included", 9, 9),
    ("ast_data_included", 10, 10),
    ("echosounder_data_included", 11, 11),
    ("ahrs_data_included", 12, 12),
    ("percentage_good_data_included", 13, 13),
    ("std_dev_data_included", 14, 14),
]


def _parse_burst_average_v3(buf: bytes, pkt: Packet):
    """BURST_AVERAGE_VERSION3 record (parse_ad2cp.py:1169+)."""
    d = pkt.data
    pos = 0
    d["version"], pos = _read_scaled(buf, pos, 1, False)
    d["offset_of_data"], pos = _read_scaled(buf, pos, 1, False)
    cfg, pos = _read_scaled(buf, pos, 2, False)
    d["configuration"] = cfg
    _bitfield(cfg, CONFIG_BITS_V3, d)
    d["serial_number"], pos = _read_scaled(buf, pos, 4, False)
    for f in ("year", "month", "day", "hour", "minute", "seconds"):
        d[f], pos = _read_scaled(buf, pos, 1, False)
    d["microsec100"], pos = _read_scaled(buf, pos, 2, False)
    d["speed_of_sound"], pos = _read_scaled(buf, pos, 2, False, div=10)
    d["temperature"], pos = _read_scaled(buf, pos, 2, True, div=100)
    d["pressure"], pos = _read_scaled(buf, pos, 4, False, div=1000)
    d["heading"], pos = _read_scaled(buf, pos, 2, False, div=100)
    d["pitch"], pos = _read_scaled(buf, pos, 2, True, div=100)
    d["roll"], pos = _read_scaled(buf, pos, 2, True, div=100)
    bcc, pos = _read_scaled(buf, pos, 2, False)
    d["num_beams_and_coordinate_system_and_num_cells"] = bcc
    if d["echosounder_data_included"]:
        d["num_echosounder_cells"] = bcc
        d["num_cells"] = 0
        d["num_beams"] = 0
        d["coordinate_system"] = 0
    else:
        _bitfield(bcc, [("num_cells", 9, 0), ("coordinate_system", 11, 10), ("num_beams", 15, 12)], d)
    d["cell_size"], pos = _read_scaled(buf, pos, 2, False, div=1000)
    d["blanking"], pos = _read_scaled(buf, pos, 2, False, div=1000)
    d["nominal_correlation"], pos = _read_scaled(buf, pos, 1, False)
    d["temperature_from_pressure_sensor"], pos = _read_scaled(buf, pos, 1, False, mul=5)
    d["battery_voltage"], pos = _read_scaled(buf, pos, 2, False, div=10)
    d["magnetometer_raw"], pos = _read_array(buf, pos, 2, True, 3)
    for ax in ("x", "y", "z"):
        d[f"accelerometer_raw_{ax}_axis"], pos = _read_scaled(
            buf, pos, 2, True, div=16384, mul=9.819
        )
    amb, pos = _read_scaled(buf, pos, 2, False)
    d["dataset_description"], pos = _read_scaled(buf, pos, 2, False)
    d["transmit_energy"], pos = _read_scaled(buf, pos, 2, False)
    d["velocity_scaling"], pos = _read_scaled(buf, pos, 1, True)
    d["power_level"], pos = _read_scaled(buf, pos, 1, True)
    if d["echosounder_data_included"]:
        d["echosounder_frequency"] = amb
    else:
        d["ambiguity_velocity"] = amb * (10.0 ** d["velocity_scaling"])
    # beams in dataset_description: three 4-bit slots + one 5-bit slot
    # (v3 layout differs from v2; ref parse_ad2cp.py:702-705)
    beams = [
        (int(d["dataset_description"]) >> lo) & mask
        for lo, mask in ((0, 0xF), (4, 0xF), (8, 0xF), (12, 0x1F))
    ]
    d["beams"] = np.array([b for b in beams if b > 0], dtype="<u8")
    d["magnetometer_temperature"], pos = _read_scaled(buf, pos, 2, True, mul=1000)
    d["real_time_clock_temperature"], pos = _read_scaled(buf, pos, 2, True, div=100)
    d["error"], pos = _read_scaled(buf, pos, 2, False)
    d["status0"], pos = _read_scaled(buf, pos, 2, False)
    if d["status0"] & 0b1000_0000_0000_0000:
        _bitfield(d["status0"], [("procidle3", 0, 0), ("procidle6", 1, 1),
                                 ("procidle12", 2, 2)], d)
    d["status"], pos = _read_scaled(buf, pos, 4, False)
    _bitfield(d["status"], STATUS_BITS, d)
    d["ensemble_counter"], pos = _read_scaled(buf, pos, 4, False)

    nb, nc = int(d["num_beams"]), int(d["num_cells"])
    vel_scale = 10.0 ** d["velocity_scaling"]
    mode = "burst" if pkt.is_burst() else ("echosounder" if pkt.is_echosounder() else "average")
    if d["velocity_data_included"]:
        v, pos = _read_array(buf, pos, 2, True, nb * nc, mul=vel_scale)
        d[f"velocity_data_{mode}"] = v.reshape(nb, nc)
    if d["amplitude_data_included"]:
        v, pos = _read_array(buf, pos, 1, False, nb * nc, div=2)
        d[f"amplitude_data_{mode}"] = v.reshape(nb, nc)
    if d["correlation_data_included"]:
        v, pos = _read_array(buf, pos, 1, False, nb * nc)
        d[f"correlation_data_{mode}"] = v.reshape(nb, nc)
    if d["altimeter_data_included"]:
        d["altimeter_distance"], pos = _read_f32(buf, pos)
        d["altimeter_quality"], pos = _read_scaled(buf, pos, 2, False)
    if d["ast_data_included"]:
        # AST block: f32 distance/pressure, quality/100, SIGNED offset, then
        # an 8-byte raw spare the reference keeps as a u1 array
        # (ref parse_ad2cp.py:1459-1489)
        d["ast_distance"], pos = _read_f32(buf, pos)
        d["ast_quality"], pos = _read_scaled(buf, pos, 2, False, div=100)
        d["ast_offset_100us"], pos = _read_scaled(buf, pos, 2, True)
        d["ast_pressure"], pos = _read_f32(buf, pos)
        d["altimeter_spare"] = np.frombuffer(buf, dtype="<u1", count=8, offset=pos)
        pos += 8
    if d["altimeter_raw_data_included"]:
        # num_samples is a 2-byte field (the reference notes the spec's
        # size/count swap, parse_ad2cp.py:1491-1497); samples are 2-byte
        # two's-complement signed fractions scaled by 2^-15 (:513-518)
        d["altimeter_raw_data_num_samples"], pos = _read_scaled(buf, pos, 2, False)
        d["altimeter_raw_data_sample_distance"], pos = _read_scaled(buf, pos, 2, False, div=10000)
        d["altimeter_raw_data_samples"], pos = _read_array(
            buf, pos, 2, True, int(d["altimeter_raw_data_num_samples"]), div=32768
        )
    if d["echosounder_data_included"]:
        ne = int(d["num_echosounder_cells"])
        # spec says unsigned, instruments emit signed (ref parse_ad2cp.py:1520)
        v, pos = _read_array(buf, pos, 2, True, ne, div=100)
        d["echosounder_data"] = v
    if d["ahrs_data_included"]:
        # AHRS rotation/quaternion/gyro values are float32 on the wire
        # (ref parse_ad2cp.py:1530-1551)
        d["ahrs_rotation_matrix"], pos = _read_f32_array(buf, pos, 9)
        d["ahrs_quaternions"], pos = _read_f32_array(buf, pos, 4)
        d["ahrs_gyro"], pos = _read_f32_array(buf, pos, 3)
    if d["percentage_good_data_included"]:
        d["percentage_good_data"], pos = _read_array(buf, pos, 1, False, nc)
    if d["std_dev_data_included"]:
        for name in ("std_dev_pitch", "std_dev_roll", "std_dev_heading"):
            d[name], pos = _read_scaled(buf, pos, 2, True, div=100)
        d["std_dev_pressure"], pos = _read_scaled(buf, pos, 2, True, div=100)
        pos += 24  # spare
    return pkt


CONFIG_BITS_V2 = [
    ("pressure_sensor_valid", 0, 0),
    ("temperature_sensor_valid", 1, 1),
    ("compass_sensor_valid", 2, 2),
    ("tilt_sensor_valid", 3, 3),
    ("velocity_data_included", 5, 5),
    ("amplitude_data_included", 6, 6),
    ("correlation_data_included", 7, 7),
]


def _parse_burst_average_v2(buf: bytes, pkt: Packet):
    """BURST_AVERAGE_VERSION2 record (parse_ad2cp.py:898-1100)."""
    d = pkt.data
    pos = 0
    d["version"], pos = _read_scaled(buf, pos, 1, False)
    d["offset_of_data"], pos = _read_scaled(buf, pos, 1, False)
    d["serial_number"], pos = _read_scaled(buf, pos, 4, False)
    cfg, pos = _read_scaled(buf, pos, 2, False)
    d["configuration"] = cfg
    _bitfield(cfg, CONFIG_BITS_V2, d)
    # NOTE: v2 records carry no altimeter/ast/echosounder/ahrs/percentage-
    # good/std-dev include flags; the reference leaves those keys absent from
    # packet.data (its v2 bitfield list, parse_ad2cp.py:611-619), which makes
    # the corresponding Vendor variables EMPTY for v2-only files — do not
    # zero-fill them here.
    for f in ("year", "month", "day", "hour", "minute", "seconds"):
        d[f], pos = _read_scaled(buf, pos, 1, False)
    d["microsec100"], pos = _read_scaled(buf, pos, 2, False)
    d["speed_of_sound"], pos = _read_scaled(buf, pos, 2, False, div=10)
    d["temperature"], pos = _read_scaled(buf, pos, 2, True, div=100)
    d["pressure"], pos = _read_scaled(buf, pos, 4, False, div=1000)
    d["heading"], pos = _read_scaled(buf, pos, 2, False, div=100)
    d["pitch"], pos = _read_scaled(buf, pos, 2, True, div=100)
    d["roll"], pos = _read_scaled(buf, pos, 2, True, div=100)
    d["error"], pos = _read_scaled(buf, pos, 2, False)
    d["status"], pos = _read_scaled(buf, pos, 2, False)
    bcc, pos = _read_scaled(buf, pos, 2, False)
    _bitfield(bcc, [("num_cells", 9, 0), ("coordinate_system", 11, 10), ("num_beams", 15, 12)], d)
    d["cell_size"], pos = _read_scaled(buf, pos, 2, False, div=1000)
    d["blanking"], pos = _read_scaled(buf, pos, 2, False, div=1000)
    d["velocity_range"], pos = _read_scaled(buf, pos, 2, False, div=1000)
    d["battery_voltage"], pos = _read_scaled(buf, pos, 2, False, div=10)
    d["magnetometer_raw"], pos = _read_array(buf, pos, 2, True, 3)
    for ax in ("x", "y", "z"):
        d[f"accelerometer_raw_{ax}_axis"], pos = _read_scaled(buf, pos, 2, True, div=16384, mul=9.819)
    amb, pos = _read_scaled(buf, pos, 2, False, div=10000)
    d["ambiguity_velocity"] = amb
    d["dataset_description"], pos = _read_scaled(buf, pos, 2, False)
    d["transmit_energy"], pos = _read_scaled(buf, pos, 2, False)
    d["velocity_scaling"], pos = _read_scaled(buf, pos, 1, True)
    d["power_level"], pos = _read_scaled(buf, pos, 1, True)
    pos += 4  # spare
    beams = [(int(d["dataset_description"]) >> lo) & 0x7 for lo in (0, 3, 6, 9, 12)]
    d["beams"] = np.array([b for b in beams if b > 0], dtype="<u8")

    nb, nc = int(d["num_beams"]), int(d["num_cells"])
    vel_scale = 10.0 ** d["velocity_scaling"]
    mode = "burst" if pkt.is_burst() else "average"
    if d["velocity_data_included"]:
        v, pos = _read_array(buf, pos, 2, True, nb * nc, mul=vel_scale)
        d[f"velocity_data_{mode}"] = v.reshape(nb, nc)
    if d["amplitude_data_included"]:
        v, pos = _read_array(buf, pos, 1, False, nb * nc, div=2)
        d[f"amplitude_data_{mode}"] = v.reshape(nb, nc)
    if d["correlation_data_included"]:
        v, pos = _read_array(buf, pos, 1, False, nb * nc)
        d[f"correlation_data_{mode}"] = v.reshape(nb, nc)
    return pkt


STATUS_BITS = [
    ("wakeup_state", 31, 28),
    ("orientation", 27, 25),
    ("autoorientation", 24, 22),
    ("previous_wakeup_state", 21, 18),
    ("last_measurement_low_voltage_skip", 17, 17),
    ("active_configuration", 16, 16),
    ("echosounder_index", 15, 12),
    ("telemetry_data", 11, 11),
    ("boost_running", 10, 10),
    ("echosounder_frequency_bin", 9, 5),
    ("bd_scaling", 1, 1),
]


CONFIG_BITS_BT = [
    ("pressure_sensor_valid", 0, 0),
    ("temperature_sensor_valid", 1, 1),
    ("compass_sensor_valid", 2, 2),
    ("tilt_sensor_valid", 3, 3),
    ("velocity_data_included", 5, 5),
    ("distance_data_included", 8, 8),
    ("figure_of_merit_data_included", 9, 9),
    ("ahrs_data_included", 10, 10),
]


def _parse_bottom_track(buf: bytes, pkt: Packet):
    """BOTTOM_TRACK record: per-beam velocity/distance/figure-of-merit,
    4-byte ambiguity velocity, 4-byte error word, and an MSB-first beams
    layout in dataset_description (ref parse_ad2cp.py:739-774, 1600+)."""
    d = pkt.data
    pos = 0
    d["version"], pos = _read_scaled(buf, pos, 1, False)
    d["offset_of_data"], pos = _read_scaled(buf, pos, 1, False)
    cfg, pos = _read_scaled(buf, pos, 2, False)
    d["configuration"] = cfg
    _bitfield(cfg, CONFIG_BITS_BT, d)
    d["serial_number"], pos = _read_scaled(buf, pos, 4, False)
    for f in ("year", "month", "day", "hour", "minute", "seconds"):
        d[f], pos = _read_scaled(buf, pos, 1, False)
    d["microsec100"], pos = _read_scaled(buf, pos, 2, False)
    d["speed_of_sound"], pos = _read_scaled(buf, pos, 2, False, div=10)
    d["temperature"], pos = _read_scaled(buf, pos, 2, True, div=100)
    d["pressure"], pos = _read_scaled(buf, pos, 4, False, div=1000)
    d["heading"], pos = _read_scaled(buf, pos, 2, False, div=100)
    d["pitch"], pos = _read_scaled(buf, pos, 2, True, div=100)
    d["roll"], pos = _read_scaled(buf, pos, 2, True, div=100)
    bcc, pos = _read_scaled(buf, pos, 2, False)
    d["num_beams_and_coordinate_system_and_num_cells"] = bcc
    _bitfield(bcc, [("num_cells", 9, 0), ("coordinate_system", 11, 10), ("num_beams", 15, 12)], d)
    d["cell_size"], pos = _read_scaled(buf, pos, 2, False, div=1000)
    d["blanking"], pos = _read_scaled(buf, pos, 2, False, div=1000)
    d["nominal_correlation"], pos = _read_scaled(buf, pos, 1, False)
    pos += 1  # spare
    d["battery_voltage"], pos = _read_scaled(buf, pos, 2, False, div=10)
    d["magnetometer_raw"], pos = _read_array(buf, pos, 2, True, 3)
    for ax in ("x", "y", "z"):
        d[f"accelerometer_raw_{ax}_axis"], pos = _read_scaled(
            buf, pos, 2, True, div=16384, mul=9.819
        )
    d["ambiguity_velocity"], pos = _read_scaled(buf, pos, 4, False)
    d["dataset_description"], pos = _read_scaled(buf, pos, 2, False)
    d["transmit_energy"], pos = _read_scaled(buf, pos, 2, False)
    d["velocity_scaling"], pos = _read_scaled(buf, pos, 1, True)
    d["power_level"], pos = _read_scaled(buf, pos, 1, True)
    d["ambiguity_velocity"] = d["ambiguity_velocity"] * (10.0 ** d["velocity_scaling"])
    # beams slots MSB-first in bottom track (opposite of burst/average)
    beams = [
        (int(d["dataset_description"]) >> lo) & mask
        for lo, mask in ((12, 0x1F), (8, 0xF), (4, 0xF), (0, 0xF))
    ]
    d["beams"] = np.array([b for b in beams if b > 0], dtype="<u8")
    d["magnetometer_temperature"], pos = _read_scaled(buf, pos, 2, True, mul=1000)
    d["real_time_clock_temperature"], pos = _read_scaled(buf, pos, 2, True, div=100)
    d["error"], pos = _read_scaled(buf, pos, 4, False)
    d["status"], pos = _read_scaled(buf, pos, 4, False)
    d["ensemble_counter"], pos = _read_scaled(buf, pos, 4, False)

    nb = int(d["num_beams"])
    if d["velocity_data_included"]:
        vel_scale = 10.0 ** d["velocity_scaling"]
        d["velocity_data"], pos = _read_array(buf, pos, 4, True, nb, mul=vel_scale)
    if d["distance_data_included"]:
        d["distance_data"], pos = _read_array(buf, pos, 4, True, nb, div=1000)
    if d["figure_of_merit_data_included"]:
        d["figure_of_merit_data"], pos = _read_array(buf, pos, 2, False, nb)
    return pkt


def _parse_echosounder_raw(buf: bytes, pkt: Packet, transmit=False):
    """ECHOSOUNDER_RAW(_TRANSMIT) records: own header layout (time fields at
    offset 2, no configuration word) followed by a 208-byte reserved block
    and i32 two's-complement signed-fraction IQ pairs scaled by 2^-31
    (ref parse_ad2cp.py:512-518, 1739+)."""
    d = pkt.data
    pos = 0
    d["version"], pos = _read_scaled(buf, pos, 1, False)
    d["offset_of_data"], pos = _read_scaled(buf, pos, 1, False)
    for f in ("year", "month", "day", "hour", "minute", "seconds"):
        d[f], pos = _read_scaled(buf, pos, 1, False)
    d["microsec100"], pos = _read_scaled(buf, pos, 2, False)
    d["error"], pos = _read_scaled(buf, pos, 2, False)
    d["status"], pos = _read_scaled(buf, pos, 4, False)
    _bitfield(d["status"], STATUS_BITS, d)
    d["serial_number"], pos = _read_scaled(buf, pos, 4, False)
    d["num_complex_samples"], pos = _read_scaled(buf, pos, 4, False)
    d["ind_start_samples"], pos = _read_scaled(buf, pos, 4, False)
    d["freq_raw_sample_data"] = float(np.frombuffer(buf, "<f4", count=1, offset=pos)[0])
    pos += 4
    pos += 208  # reserved
    n = int(d["num_complex_samples"])
    raw = np.frombuffer(buf, dtype="<i4", count=n * 2, offset=pos)
    pairs = (raw / 2**31).astype("<f8").reshape(n, 2)
    key = "echosounder_raw_transmit_samples" if transmit else "echosounder_raw_samples"
    d[key] = pairs
    d[key + "_i"] = pairs[:, 0]
    d[key + "_q"] = pairs[:, 1]
    return pkt


def _parse_string(buf: bytes, pkt: Packet):
    pkt.data["string_data_id"] = buf[0]
    pkt.data["string_data"] = buf[1:].split(b"\x00", 1)[0].decode("utf-8", "replace")
    return pkt


class ParseAd2cp:
    """Parse one Nortek .ad2cp file into a packet list."""

    sonar_model = "AD2CP"

    def __init__(self, file, xml_path=None, storage_options=None, sonar_model="AD2CP", **kw):
        self.source_file = str(file)
        self.storage_options = storage_options
        self.sonar_model = sonar_model
        self.packets: list[Packet] = []
        self.config = None
        self.ping_time = []
        self.nmea = {"string": np.empty(0, object), "timestamp": np.empty(0, "datetime64[ns]")}

    def parse_raw(self):
        buf = read_source_bytes(self.source_file, self.storage_options)
        pos = 0
        n = len(buf)
        while pos + 10 <= n:
            sync = buf[pos]
            if sync != 0xA5:
                pos += 1  # resync
                continue
            header_size = buf[pos + 1]
            pkt_id = buf[pos + 2]
            family = buf[pos + 3]
            if pkt_id in (ECHOSOUNDER_RAW_ID, ECHOSOUNDER_RAW_TRANSMIT_ID):
                (record_size,) = struct.unpack_from("<I", buf, pos + 4)
                cks_off = pos + 8
            else:
                (record_size,) = struct.unpack_from("<H", buf, pos + 4)
                cks_off = pos + 6
            try:
                record_cks, header_cks = struct.unpack_from("<HH", buf, cks_off)
            except struct.error:
                break
            header_end = pos + header_size
            if checksum(buf[pos : header_end - 2]) != header_cks:
                pos += 1
                continue
            record = buf[header_end : header_end + record_size]
            if len(record) < record_size:
                break
            if checksum(record) != record_cks:
                logger.warning("AD2CP record checksum mismatch at byte %d; skipping", pos)
                pos = header_end + record_size
                continue
            pkt = Packet()
            pkt.data["id"] = pkt_id
            pkt.data["family"] = family
            try:
                if pkt.is_string():
                    _parse_string(record, pkt)
                    if self.config is None:
                        self.config = self.parse_config(pkt.data["string_data"])
                elif pkt.is_echosounder_raw():
                    _parse_echosounder_raw(record, pkt)
                elif pkt.is_echosounder_raw_transmit():
                    _parse_echosounder_raw(record, pkt, transmit=True)
                elif pkt.is_bottom_track():
                    _parse_bottom_track(record, pkt)
                else:
                    version = record[0]
                    if version == 3:
                        _parse_burst_average_v3(record, pkt)
                    elif version == 2:
                        _parse_burst_average_v2(record, pkt)
                    else:
                        logger.warning("AD2CP record version %d not supported; skipped", version)
                        pkt = None
            except Exception as e:  # noqa: BLE001 - skip malformed records
                logger.warning("Failed to parse AD2CP record id=0x%02x: %r", pkt_id, e)
                pkt = None
            if pkt is not None:
                # a burst/average/echosounder record names the beam used by an
                # immediately preceding raw record (ref parse_ad2cp.py:706-710)
                if (
                    self.packets
                    and len(np.atleast_1d(pkt.data.get("beams", []))) > 0
                    and (self.packets[-1].is_echosounder_raw()
                         or self.packets[-1].is_echosounder_raw_transmit())
                    and not (pkt.is_echosounder_raw() or pkt.is_echosounder_raw_transmit()
                             or pkt.is_string() or pkt.is_bottom_track())
                ):
                    self.packets[-1].data["echosounder_raw_beam"] = pkt.data["beams"][0]
                self.packets.append(pkt)
            pos = header_end + record_size

        if self.config is not None and "GETCLOCKSTR" in self.config:
            self.ping_time.append(np.datetime64(self.config["GETCLOCKSTR"]["TIME"]))
        else:
            self.ping_time.append(np.datetime64("NaT"))
        return self

    @staticmethod
    def parse_config(data: str) -> dict:
        """Parse the 'HEADING,KEY=VALUE,...' configuration string."""
        result = {}
        for line in data.splitlines():
            tokens = line.split(",")
            line_dict = {}
            for token in tokens[1:]:
                if "=" not in token:
                    continue
                k, v = token.split("=", 1)
                if v.startswith('"'):
                    v = v.strip('"')
                else:
                    try:
                        v = int(v)
                    except ValueError:
                        try:
                            v = float(v)
                        except ValueError:
                            pass
                line_dict[k] = v
            result[tokens[0]] = line_dict
        return result

    def get_firmware_version(self):
        return (self.config or {}).get("GETHW")

    def get_pulse_compressed(self) -> int:
        for i in range(1, 4):
            if self.config and "GETECHO" in self.config and self.config["GETECHO"].get(
                f"PULSECOMP{i}", 0
            ) > 0:
                return i
        return 0

    def rectangularize_data(self, *a, **kw):
        return self
