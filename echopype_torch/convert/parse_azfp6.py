"""AZFP ULS6 (.azfp) parser: self-describing records with embedded XML.

Capability parity: echopype/convert/parse_azfp6.py:105-698 — XML block framed
by 0xF044CC11/0xE088DD66, per-profile data blocks framed by
0xFF01AA00/0xEF02BB66, typed header records (type+array-size codes), and the
same count/sensor conversions as the .01A format.
"""

from __future__ import annotations

import struct
import xml.etree.ElementTree as ET
from collections import defaultdict
from datetime import datetime as dt
from io import BytesIO
from pathlib import Path

import numpy as np

from ..utils.log import _init_logger
from ..utils.misc import camelcase2snakecase
from .parse_azfp import SV_OFFSET, ParseAZFP
from ..utils.io import read_source_bytes

logger = _init_logger(__name__)

__all__ = ["ParseAZFP6"]

HEADER_FIELDS = [
    "FirstHeaderRecord",
    "HeaderBytes",
    "HeaderNumRecords",
    "ProfileNumber",
    "SerialNumber",
    "Date",
    "AcqStatus",
    "BurstInt",
    "BaseTime",
    "PingPeriod",
    "PingPeriodCounts",
    "PingPerProfile",
    "AvgPings",
    "NumAcqPings",
    "FirstPing",
    "LastPing",
    "DataError",
    "OverRun",
    "Phase",
    "NumChan",
    "DigRate",
    "LockOutIndex",
    "NumBins",
    "RangeSamplesPerBin",
    "DataType",
    "PulseLen",
    "BoardNum",
    "Frequency",
    "NumSensors",
    "SensorStatus",
    "Ancillary",
    "GpsDateTime",
    "GpsLatLon",
    "Custom",
    "LastHeaderRecord",
]

_TYPE_CODES = {
    0x00: ("h", 2),
    0x20: ("H", 2),
    0x40: ("i", 4),
    0x60: ("I", 4),
    0x80: ("q", 8),
    0xA0: ("Q", 8),
    0xC0: ("d", 8),
    0xE0: ("c", 1),
}


class ParseAZFP6(ParseAZFP):
    """Parse one AZFP ULS6 .azfp file (subclasses the .01A machinery)."""

    XML_FILE_TYPE = 0xF044CC11
    XML_END_FLAG = 0xE088DD66
    DATA_START_FLAG = 0xFF01AA00
    HEADER_START_FLAG = 0xBCD0
    HEADER_END_FLAG = 0xABC1
    DATA_END_FLAG = 0xEF02BB66
    RECORD_DATA_TYPE_MASK = 0x00E0
    ARRAY_BITS_MASK = 0x001F

    def __init__(self, file, xml_path=None, storage_options=None, sonar_model="AZFP6", **kw):
        super().__init__(file, xml_path=xml_path, storage_options=storage_options, sonar_model=sonar_model, **kw)
        self.parameters = defaultdict(list)
        self.unpacked_data = defaultdict(list)

    # ------------------------------------------------------------ embedded XML
    def load_AZFP_xml(self, raw):
        """Decode the ULS6 embedded instrument-config XML into parameters.

        The parameter-key naming scheme (snake_cased tags/attrs, ``_phaseN``
        suffixes inside phase blocks) IS the output schema of the reference's
        parser (parse_azfp6.py) and must match; the extraction here is a
        recursive element-tree walk rather than an event stream.
        """
        (xml_size,) = struct.unpack("<I", raw.read(4))
        xml_string = raw.read(xml_size)
        if int.from_bytes(raw.read(4), "little") != self.XML_END_FLAG:
            raise ValueError("Error reading xml string")
        raw.read(4)  # prev-record byte count
        self._walk_config_node(ET.fromstring(xml_string), None)
        self._collapse_scalars()
        n_phases = int(self.parameters.get("num_phases", 1))
        self.parameters["phase_number"] = [str(n + 1) for n in range(n_phases)]
        # ULS6 removed the per-channel gain; keep backward-compatible gain=1
        for phase in range(n_phases):
            self.parameters[f"gain_phase{phase + 1}"] = [1] * int(self.parameters["num_freq"])

    @staticmethod
    def _schema_key(xml_tag: str) -> str:
        """Schema key for one XML tag (short and VTX* tags pass through)."""
        if len(xml_tag) <= 3 or xml_tag.startswith("VTX"):
            return xml_tag
        return camelcase2snakecase(xml_tag)

    @staticmethod
    def _scalarize(text: str):
        for cast in (int, float):
            try:
                return cast(text)
            except ValueError:
                continue
        return text

    def _walk_config_node(self, node, phase):
        """Depth-first config walk; ``phase`` is the enclosing <Phase> id."""
        tag = self._schema_key(node.tag)
        if node.tag == "Phase" and node.attrib:
            phase = next(iter(node.attrib.values()))
        suffix = f"_phase{phase}" if phase is not None and tag != "phase" else ""
        for key, val in node.attrib.items():
            self.parameters[f"{tag}_{camelcase2snakecase(key)}{suffix}"].append(val)
        if node.text is not None and node.text.strip():
            self.parameters[tag + suffix].append(self._scalarize(node.text))
        for sub in node:
            self._walk_config_node(sub, phase)

    def _collapse_scalars(self):
        for key, val in list(self.parameters.items()):
            if isinstance(val, list) and len(val) == 1 and key != "phase_number":
                self.parameters[key] = val[0]

    # -------------------------------------------------------------- raw parse
    def parse_raw(self):
        buf = read_source_bytes(self.source_file, self.storage_options)
        raw = BytesIO(buf)
        if struct.unpack("<I", raw.read(4))[0] != self.XML_FILE_TYPE:
            raise ValueError("Unknown file type")
        self.load_AZFP_xml(raw)

        def _valid(params):
            return not all(np.isclose(self.parameters.get(p, 0), 0) for p in params)

        temp_ok = _valid(["ka", "kb", "kc"])
        pres_ok = _valid(["a0", "a1"])
        tx_ok = _valid(["X_a", "X_b", "X_c"])
        ty_ok = _valid(["Y_a", "Y_b", "Y_c"])

        # --- ingest hardening: every record is framed by a start flag +
        # byte count and a matching end flag + byte count, which gives an
        # INDEPENDENT record extent (like the Simrad framing trailer).  A
        # record whose untrusted header/count fields disagree with that
        # extent is rolled back and the stream resyncs at the next start
        # flag — a single corrupt record costs one ping, never the tail of
        # the file (mirrors convert/simrad/framing.py resync semantics).
        start_magic = struct.pack("<I", self.DATA_START_FLAG)
        layout = None  # slicing fields established by the first clean record
        n_rec = 0
        while True:
            rec_start = raw.tell()
            head = raw.read(8)
            if len(head) < 8:
                break
            header_flag, num_data_bytes = struct.unpack("<II", head)
            if header_flag != self.DATA_START_FLAG:
                nxt = buf.find(start_magic, rec_start + 1)
                if nxt < 0:
                    break
                logger.warning(
                    f"AZFP6 stream desynced at byte {rec_start}; resyncing "
                    f"to the next record flag at byte {nxt}."
                )
                raw.seek(nxt)
                continue
            body_start = rec_start + 8
            body_end = body_start + int(num_data_bytes)
            snapshot = {k: len(v) for k, v in self.unpacked_data.items()}

            def _rollback():
                for k in list(self.unpacked_data):
                    if k in snapshot:
                        del self.unpacked_data[k][snapshot[k]:]
                    else:
                        del self.unpacked_data[k]

            def _resync(reason):
                _rollback()
                nxt = buf.find(start_magic, body_start)
                logger.warning(
                    f"AZFP6 record {n_rec} at byte {rec_start} dropped "
                    f"({reason}); "
                    + (f"resyncing at byte {nxt}." if nxt >= 0 else "end of stream.")
                )
                if nxt < 0:
                    return False
                raw.seek(nxt)
                return True

            if body_end + 8 > len(buf):
                _rollback()
                logger.warning(
                    f"AZFP6 record {n_rec} claims {num_data_bytes} data bytes "
                    f"but only {len(buf) - body_start} remain; dropping the "
                    f"truncated tail."
                )
                break
            if not self._split_header6(raw, body_end):
                if _resync("unreadable header"):
                    continue
                break
            rec = {k: self.unpacked_data[k][-1] for k in ("num_chan", "num_bins",
                                                          "data_type", "avg_pings",
                                                          "ping_per_profile",
                                                          "range_samples_per_bin",
                                                          "ancillary")}
            cur = (
                int(rec["num_chan"]),
                tuple(int(b) for b in np.atleast_1d(rec["num_bins"])),
                tuple(int(t) for t in np.atleast_1d(rec["data_type"])),
            )
            if layout is not None and cur != layout:
                logger.warning(
                    f"AZFP6 record {n_rec}: header layout fields "
                    f"(num_chan/num_bins/data_type) differ from the "
                    f"established layout; repairing from record 0."
                )
                rec["num_chan"] = layout[0]
                rec["num_bins"] = layout[1]
                rec["data_type"] = layout[2]
                for k in ("num_chan", "num_bins", "data_type"):
                    self.unpacked_data[k][-1] = rec[k]
            if not self._add_counts6(raw, rec, body_end):
                if _resync("counts exceed the framed record extent"):
                    continue
                break
            if raw.tell() != body_end:
                if _resync(
                    f"header+counts end at byte {raw.tell()}, framing says {body_end}"
                ):
                    continue
                break
            anc = rec["ancillary"]
            self.unpacked_data["temperature"].append(
                self._compute_temperature(anc[4], temp_ok)
            )
            self.unpacked_data["pressure"].append(self._compute_pressure(anc[3], pres_ok))
            tilt_x = self._compute_tilt(anc[0], "X", tx_ok)
            tilt_y = self._compute_tilt(anc[1], "Y", ty_ok)
            self.unpacked_data["tilt_x"].append(tilt_x)
            self.unpacked_data["tilt_y"].append(tilt_y)
            self.unpacked_data["cos_tilt_mag"].append(
                np.cos(np.sqrt(tilt_x**2 + tilt_y**2) * np.pi / 180)
            )
            self.unpacked_data["battery_main"].append(self._compute_battery(anc[2]))
            self.unpacked_data["battery_tx"].append(self._compute_battery(anc[-2]))
            tail = raw.read(8)
            if len(tail) < 8:
                break
            end_flag, end_bytes = struct.unpack("<II", tail)
            if end_flag != self.DATA_END_FLAG or end_bytes != num_data_bytes:
                logger.error("Invalid end-of-data flag; possibly corrupted file.")
                if _resync("end-of-data framing mismatch"):
                    continue
                break
            if layout is None:
                layout = cur
            n_rec += 1

        # per-channel gain placeholder (removed from ULS6 hardware)
        n_pings = len(self.unpacked_data["temperature"])
        num_freq = int(self.parameters["num_freq"])
        self.unpacked_data["gain"] = [tuple([1] * num_freq)] * n_pings
        self.unpacked_data["lock_out_index"] = self.unpacked_data["lock_out_index"]

        self._check_uniqueness6()
        self._get_ping_time6()
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

    def _split_header6(self, raw, body_end=None) -> bool:
        """Decode one typed-record header block; every read is bounded by the
        framed record extent (``body_end``) so corrupt type codes or array
        sizes cannot read past the record or crash struct.unpack."""
        header_byte_cnt = 4
        rc_val = raw.read(4)
        if len(rc_val) < 4:
            return False
        rc, val = struct.unpack("<HH", rc_val)
        if val != self.HEADER_START_FLAG:
            logger.error("Invalid header block; is this an AZFP6 file?")
            return False
        self.unpacked_data[camelcase2snakecase(HEADER_FIELDS[0])].append(val)
        for field in HEADER_FIELDS[1:]:
            field_sc = camelcase2snakecase(field)
            rc_b = raw.read(2)
            if len(rc_b) < 2:
                return False
            (rc,) = struct.unpack("<H", rc_b)
            spec = _TYPE_CODES.get(rc & self.RECORD_DATA_TYPE_MASK)
            if spec is None:
                logger.error("AZFP6 header record with unknown type code 0x%04x", rc)
                return False
            code, size = spec
            n = (rc & self.ARRAY_BITS_MASK) + 1
            if body_end is not None and raw.tell() + size * n > body_end:
                logger.error(
                    "AZFP6 header record %r overruns the framed record extent",
                    field_sc,
                )
                return False
            payload = raw.read(size * n)
            if len(payload) < size * n:
                return False
            vals = struct.unpack("<" + code * n, payload)
            header_byte_cnt += 2 + size * n
            if vals[0] == self.HEADER_END_FLAG:
                self.unpacked_data[camelcase2snakecase(HEADER_FIELDS[-1])].append(vals[0])
                break
            self.unpacked_data[field_sc].append(vals[0] if len(vals) == 1 else tuple(vals))
        hb = self.unpacked_data.get("header_bytes")
        if not hb:
            return False
        expected = hb[-1]
        if not isinstance(expected, (int, np.integer)) or header_byte_cnt != expected:
            logger.error("Error reading header: %d != %r", header_byte_cnt, expected)
            return False
        return True

    def _masked(self, rc):
        code, size = _TYPE_CODES[rc & self.RECORD_DATA_TYPE_MASK]
        n = (rc & self.ARRAY_BITS_MASK) + 1
        return code, size, n

    def _add_counts6(self, raw, rec, body_end=None) -> bool:
        """Read the per-channel count payloads; with ``body_end`` the total
        is validated against the framed record extent FIRST, so an inflated
        header count is rejected (caller resyncs) instead of mis-slicing."""
        num_chan = int(rec["num_chan"])
        num_bins = np.atleast_1d(rec["num_bins"])
        data_type = np.atleast_1d(rec["data_type"])
        rspb = np.atleast_1d(rec["range_samples_per_bin"])
        if num_chan > len(num_bins):
            logger.error(
                "AZFP6 record claims %d channels but carries %d num_bins entries",
                num_chan, len(num_bins),
            )
            return False
        need = sum(
            (5 if data_type[c] else 2) * int(num_bins[c]) for c in range(num_chan)
        )
        if body_end is not None and (need < 0 or raw.tell() + need > body_end):
            return False
        vv = []
        for chf in range(num_chan):
            n_bins = int(num_bins[chf])
            if data_type[chf]:
                if rec["avg_pings"]:
                    divisor = rec["ping_per_profile"] * rspb[chf]
                else:
                    divisor = rspb[chf]
                ls = np.frombuffer(raw.read(n_bins * 4), dtype="<u4")
                lso = np.frombuffer(raw.read(n_bins), dtype="<u1")
                v = (ls.astype("f8") + lso.astype("f8") * 4294967295) / divisor
                with np.errstate(divide="ignore"):
                    v = (np.log10(v) - 2.5) * (8 * 65535) * np.atleast_1d(
                        self.parameters["DS"]
                    )[chf]
                v[np.isinf(v)] = 0
                vv.append(v)
            else:
                v = np.frombuffer(raw.read(n_bins * 2), dtype="<u2")
                vv.append(v.astype("f8"))
        self.unpacked_data["counts"].append(vv)
        return True

    def _check_uniqueness6(self):
        field_w_freq = (
            "dig_rate",
            "lock_out_index",
            "num_bins",
            "range_samples_per_bin",
            "data_type",
            "pulse_len",
            "board_num",
            "frequency",
            "gain",
        )
        field_include = (
            "serial_number",
            "burst_int",
            "ping_per_profile",
            "avg_pings",
            "ping_period",
            "phase",
            "num_chan",
        )
        for field in field_w_freq:
            if field not in self.unpacked_data:
                continue
            uniq = np.unique(np.asarray(self.unpacked_data[field]), axis=0)
            if uniq.shape[0] == 1:
                self.unpacked_data[field] = uniq.squeeze(axis=0)
            else:
                raise ValueError(f"Header value {field} is not constant for each ping")
        for field in field_include:
            if field not in self.unpacked_data:
                continue
            uniq = np.unique(np.asarray(self.unpacked_data[field]))
            if uniq.shape[0] == 1:
                self.unpacked_data[field] = uniq.squeeze()
            else:
                raise ValueError(f"Header value {field} is not constant for each ping")

    def _get_ping_time6(self):
        ping_time = []
        for date_vals in self.unpacked_data["date"]:
            ping_time.append(
                np.datetime64(
                    dt(
                        int(date_vals[0]),
                        int(date_vals[1]),
                        int(date_vals[2]),
                        int(date_vals[3]),
                        int(date_vals[4]),
                        int(date_vals[5] + date_vals[6] / 100),
                    ),
                    "ns",
                )
            )
        self.ping_time = np.asarray(ping_time, dtype="datetime64[ns]")
