"""AZFP .01A parser: binary profiles + instrument XML configuration.

Capability parity: echopype/convert/parse_azfp.py:16-582 — 124-byte
big-endian profile headers (FILE_TYPE 64770), per-channel count payloads
(raw u16 counts or averaged u32+overflow), temperature/tilt/pressure/battery
conversions from ancillary counts, and the frequency x pulse-length Sv_offset
table from the operator's manual.
"""

from __future__ import annotations

import struct
import xml.etree.ElementTree as ET
from collections import defaultdict
from datetime import datetime as dt
from pathlib import Path

import numpy as np

from ..utils.log import _init_logger
from ..utils.misc import camelcase2snakecase
from ..utils.io import read_source_bytes

logger = _init_logger(__name__)

__all__ = ["ParseAZFP", "SV_OFFSET"]

SV_OFFSET_HF = {300: 1.1, 500: 0.8, 700: 0.5, 900: 0.3, 1000: 0.3}
SV_OFFSET_LF = {500: 1.1, 1000: 0.7}
SV_OFFSET = {
    38000.0: {**SV_OFFSET_LF},
    67000.0: {500: 1.1, **SV_OFFSET_HF},
    120000.0: {150: 1.4, 250: 1.3, **SV_OFFSET_HF},
    125000.0: {150: 1.4, 250: 1.3, **SV_OFFSET_HF},
    130000.0: {150: 1.4, 250: 1.3, **SV_OFFSET_HF},
    200000.0: {150: 1.4, 250: 1.3, **SV_OFFSET_HF},
    455000.0: {250: 1.3, **SV_OFFSET_HF},
    769000.0: {150: 1.4, **SV_OFFSET_HF},
}

HEADER_FIELDS = (
    ("profile_flag", 1),
    ("profile_number", 1),
    ("serial_number", 1),
    ("ping_status", 1),
    ("burst_int", 1),
    ("year", 1),
    ("month", 1),
    ("day", 1),
    ("hour", 1),
    ("minute", 1),
    ("second", 1),
    ("hundredths", 1),
    ("dig_rate", 4),
    ("lock_out_index", 4),
    ("num_bins", 4),
    ("range_samples_per_bin", 4),
    ("ping_per_profile", 1),
    ("avg_pings", 1),
    ("num_acq_pings", 1),
    ("ping_period", 1),
    ("first_ping", 1),
    ("last_ping", 1),
    ("data_type", 4),
    ("data_error", 1),
    ("phase", 1),
    ("overrun", 1),
    ("num_chan", 1),
    ("gain", 4),
    ("spare_chan", 1),
    ("pulse_len", 4),
    ("board_num", 4),
    ("frequency", 4),
    ("sensor_flag", 1),
    ("ancillary", 5),
    ("ad", 2),
)

FREQ_FIELDS = {
    "dig_rate",
    "lock_out_index",
    "num_bins",
    "range_samples_per_bin",
    "data_type",
    "gain",
    "pulse_len",
    "board_num",
    "frequency",
}


class ParseAZFP:
    HEADER_SIZE = 124
    HEADER_FORMAT = ">HHHHIHHHHHHHHHHHHHHHHHHHHHHHHHHHHHBBBBHBBBBBBBBHHHHHHHHHHHHHHHHHHHH"
    FILE_TYPE = 64770

    sonar_model = "AZFP"

    def __init__(self, file, xml_path=None, storage_options=None, sonar_model="AZFP", **kw):
        self.source_file = str(file)
        self.xml_path = str(xml_path) if xml_path else None
        self.storage_options = storage_options
        self.sonar_model = sonar_model
        self.parameters = defaultdict(list)
        self.unpacked_data = defaultdict(list)
        self.ping_time = []
        self.Sv_offset = None
        self.freq_sorted = None
        self.freq_ind_sorted = None
        self.nmea = {"string": np.empty(0, object), "timestamp": np.empty(0, "datetime64[ns]")}

    # ------------------------------------------------------------ XML config
    def load_AZFP_xml(self):
        """Parse the instrument XML into flat parameter lists
        (parse_azfp.py:143-183)."""
        phase_number = None
        from io import BytesIO

        xml_bytes = read_source_bytes(self.xml_path, self.storage_options)
        for event, child in ET.iterparse(BytesIO(xml_bytes), events=("start", "end")):
            if event == "end" and child.tag == "Phases":
                phase_number = None
            if event == "start":
                if len(child.tag) > 3 and not child.tag.startswith("VTX"):
                    tag = camelcase2snakecase(child.tag)
                else:
                    tag = child.tag
                if len(child.attrib) > 0:
                    for key, val in child.attrib.items():
                        attrib_tag = tag + "_" + camelcase2snakecase(key)
                        if phase_number is not None and tag != "phase":
                            attrib_tag += f"_phase{phase_number}"
                        self.parameters[attrib_tag].append(val)
                        if child.tag == "Phase":
                            phase_number = val
                if child.text is None or all(c in "\n\t " for c in (child.text or "")):
                    continue
                try:
                    val = int(child.text)
                except ValueError:
                    try:
                        val = float(child.text)
                    except ValueError:
                        continue
                if phase_number is not None and tag != "phase":
                    tag += f"_phase{phase_number}"
                self.parameters[tag].append(val)
        for key, val in list(self.parameters.items()):
            if isinstance(val, list) and len(val) == 1:
                self.parameters[key] = val[0]

    # ------------------------------------------------------- sensor conversions
    def _compute_temperature(self, counts, is_valid):
        if not is_valid:
            return np.nan
        v_in = 2.5 * (counts / 65535)
        R = (self.parameters["ka"] + self.parameters["kb"] * v_in) / (
            self.parameters["kc"] - v_in
        )
        return 1 / (
            self.parameters["A"]
            + self.parameters["B"] * np.log(R)
            + self.parameters["C"] * np.log(R) ** 3
        ) - 273

    def _compute_tilt(self, N, xy, is_valid):
        if not is_valid:
            return np.nan
        a, b, c, d = (self.parameters[f"{xy}_{k}"] for k in "abcd")
        return a + b * N + c * N**2 + d * N**3

    def _compute_pressure(self, counts, is_valid):
        if not is_valid or self.parameters.get("sensors_flag_pressure_sensor_installed") == "no":
            return np.nan
        v_in = 2.5 * (counts / 65535)
        return v_in * self.parameters["a1"] + self.parameters["a0"] - 10.125

    @staticmethod
    def _compute_battery(N):
        USL5_BAT_CONSTANT = (2.5 / 65536.0) * (86.6 + 475.0) / 86.6
        return N * USL5_BAT_CONSTANT

    # ----------------------------------------------------------------- parsing
    def parse_raw(self):
        if self.xml_path is None:
            raise ValueError("AZFP conversion requires an instrument XML file (xml_path)")
        self.load_AZFP_xml()
        buf = read_source_bytes(self.source_file, self.storage_options)

        def _valid(params):
            return not all(np.isclose(self.parameters.get(p, 0), 0) for p in params)

        temp_ok = _valid(["ka", "kb", "kc"])
        pres_ok = _valid(["a0", "a1"])
        tx_ok = _valid(["X_a", "X_b", "X_c"])
        ty_ok = _valid(["Y_a", "Y_b", "Y_c"])

        num_freq = int(self.parameters["num_freq"])
        pos = 0
        layout = None  # slicing fields established by the first profile
        n_rec = 0
        while pos + self.HEADER_SIZE <= len(buf):
            header = struct.unpack(
                self.HEADER_FORMAT, buf[pos : pos + self.HEADER_SIZE]
            )
            if header[0] != self.FILE_TYPE:
                logger.error("Unknown file type")
                break
            pos += self.HEADER_SIZE
            # split header into fields (4 slots reserved per freq field)
            i = 0
            rec = {}
            for name, width in HEADER_FIELDS:
                if name in FREQ_FIELDS:
                    rec[name] = header[i : i + num_freq]
                    i += 4
                else:
                    if width > 1:
                        rec[name] = header[i : i + width]
                    else:
                        rec[name] = header[i]
                    i += width

            # --- ingest hardening: num_chan/num_bins/data_type come from the
            # untrusted header and drive the payload slicing — a corrupt field
            # would mis-slice every later profile (or balloon the read).  The
            # instrument writes ONE layout per deployment (the reference
            # enforces this, parse_azfp.py:484 uniqueness checks), so the
            # first profile establishes it and later deviations are repaired
            # from it with a logged warning; payload reads are then clamped
            # to the file extent (mirrors the RAW0/RAW3 count clamps,
            # convert/simrad/decode.py:_clamp_counts).
            cur = (
                int(rec["num_chan"]),
                tuple(int(b) for b in rec["num_bins"]),
                tuple(int(t) for t in rec["data_type"]),
            )
            if layout is not None and cur != layout:
                logger.warning(
                    f"AZFP profile {n_rec}: header layout fields "
                    f"(num_chan/num_bins/data_type) differ from the "
                    f"established layout; repairing from profile 0."
                )
                rec["num_chan"], rec["num_bins"], rec["data_type"] = layout
            elif layout is None and not (1 <= cur[0] <= max(num_freq, 1)):
                logger.warning(
                    f"AZFP profile 0 claims {cur[0]} channels; clamping to "
                    f"the XML-declared {num_freq}."
                )
                rec["num_chan"] = num_freq
            need = sum(
                (5 if rec["data_type"][c] else 2) * int(rec["num_bins"][c])
                for c in range(int(rec["num_chan"]))
            )
            if need < 0 or pos + need > len(buf):
                logger.warning(
                    f"AZFP profile {n_rec} claims a {need}-byte payload but "
                    f"only {len(buf) - pos} bytes remain; dropping the "
                    f"truncated tail."
                )
                break
            if layout is None:
                layout = (
                    int(rec["num_chan"]),
                    tuple(int(b) for b in rec["num_bins"]),
                    tuple(int(t) for t in rec["data_type"]),
                )
            n_rec += 1
            for name, _ in HEADER_FIELDS:
                self.unpacked_data[name].append(rec[name])

            # counts payload per channel
            vv = []
            for chf in range(int(rec["num_chan"])):
                n_bins = int(rec["num_bins"][chf])
                if rec["data_type"][chf]:
                    if rec["avg_pings"]:
                        divisor = rec["ping_per_profile"] * rec["range_samples_per_bin"][chf]
                    else:
                        divisor = rec["range_samples_per_bin"][chf]
                    ls = np.frombuffer(buf, dtype=">u4", count=n_bins, offset=pos)
                    pos += n_bins * 4
                    lso = np.frombuffer(buf, dtype=">u1", count=n_bins, offset=pos)
                    pos += n_bins
                    v = (ls.astype("f8") + lso.astype("f8") * 4294967295) / divisor
                    with np.errstate(divide="ignore"):
                        v = (np.log10(v) - 2.5) * (8 * 65535) * np.atleast_1d(
                            self.parameters["DS"]
                        )[chf]
                    v[np.isinf(v)] = 0
                    vv.append(v)
                else:
                    v = np.frombuffer(buf, dtype=">u2", count=n_bins, offset=pos)
                    pos += n_bins * 2
                    vv.append(v.astype("f8"))
            self.unpacked_data["counts"].append(vv)

            anc = rec["ancillary"]
            self.unpacked_data["temperature"].append(self._compute_temperature(anc[4], temp_ok))
            self.unpacked_data["pressure"].append(self._compute_pressure(anc[3], pres_ok))
            tilt_x = self._compute_tilt(anc[0], "X", tx_ok)
            tilt_y = self._compute_tilt(anc[1], "Y", ty_ok)
            self.unpacked_data["tilt_x"].append(tilt_x)
            self.unpacked_data["tilt_y"].append(tilt_y)
            self.unpacked_data["cos_tilt_mag"].append(
                np.cos(np.sqrt(tilt_x**2 + tilt_y**2) * np.pi / 180)
            )
            self.unpacked_data["battery_main"].append(self._compute_battery(anc[2]))
            self.unpacked_data["battery_tx"].append(self._compute_battery(rec["ad"][0]))

        self._check_uniqueness()
        self._get_ping_time()
        for key, val in self.unpacked_data.items():
            if isinstance(val, list) and val and not isinstance(val[0], (list,)):
                self.unpacked_data[key] = np.asarray(val)
        for key, val in self.parameters.items():
            if isinstance(val, list):
                self.parameters[key] = np.asarray(val)

        self.unpacked_data["frequency"] = np.asarray(
            self.unpacked_data["frequency"], dtype="f8"
        )
        freq_old = np.atleast_1d(self.unpacked_data["frequency"])
        self.freq_ind_sorted = freq_old.argsort()
        self.freq_sorted = freq_old[self.freq_ind_sorted] * 1000.0
        self.Sv_offset = np.zeros_like(self.freq_sorted)
        pulse_len = np.atleast_1d(self.unpacked_data["pulse_len"])
        for ind, ich in enumerate(self.freq_ind_sorted):
            self.Sv_offset[ind] = self._calc_Sv_offset(self.freq_sorted[ind], pulse_len[ich])
        return self

    def _check_uniqueness(self):
        """Collapse per-ping header fields that are constant (parse_azfp.py:484)."""
        field_w_freq = tuple(FREQ_FIELDS)
        field_include = (
            "profile_flag",
            "serial_number",
            "burst_int",
            "ping_per_profile",
            "avg_pings",
            "ping_period",
            "phase",
            "num_chan",
            "spare_chan",
        )
        for field in field_w_freq:
            uniq = np.unique(np.asarray(self.unpacked_data[field]), axis=0)
            if uniq.shape[0] == 1:
                self.unpacked_data[field] = uniq.squeeze(axis=0)
            else:
                raise ValueError(f"Header value {field} is not constant for each ping")
        for field in field_include:
            uniq = np.unique(np.asarray(self.unpacked_data[field]))
            if uniq.shape[0] == 1:
                self.unpacked_data[field] = uniq.squeeze()
            else:
                raise ValueError(f"Header value {field} is not constant for each ping")

    def _get_ping_time(self):
        ping_time = []
        for i, year in enumerate(self.unpacked_data["year"]):
            ping_time.append(
                np.datetime64(
                    dt(
                        int(year),
                        int(self.unpacked_data["month"][i]),
                        int(self.unpacked_data["day"][i]),
                        int(self.unpacked_data["hour"][i]),
                        int(self.unpacked_data["minute"][i]),
                        int(
                            self.unpacked_data["second"][i]
                            + self.unpacked_data["hundredths"][i] / 100
                        ),
                    ),
                    "ns",
                )
            )
        self.ping_time = np.asarray(ping_time, dtype="datetime64[ns]")

    @staticmethod
    def _calc_Sv_offset(freq, pulse_len):
        """Sv compensation factor by frequency and pulse length
        (parse_azfp.py:554-582)."""
        if freq not in SV_OFFSET:
            raise ValueError(
                f"Frequency {freq} Hz is not in the Sv offset dictionary! "
                "Please contact AZFP Environmental Sciences."
            )
        if pulse_len not in SV_OFFSET[freq]:
            raise ValueError(
                f"Pulse length {pulse_len} us is not in the Sv offset dictionary "
                f"for the {freq} Hz channel!"
            )
        return SV_OFFSET[freq][pulse_len]

    def rectangularize_data(self, *a, **kw):
        return self
