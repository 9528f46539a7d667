"""EK80 .raw parser: columnar RAW3/RAW4/XML0/FIL1/MRU decode.

Capability parity: echopype/convert/parse_ek80.py + the EK80 paths of
parse_base.py:415-655.  TPU-native redesign: one framing scan builds the
datagram index; RAW3 headers decode in one structured gather; XML parameter
payloads are parsed once per distinct byte string (they repeat per ping) and
bound to following RAW3/RAW4 rows positionally; sample payloads land in
padded per-channel arrays.  EC150 ADCP channels are filtered out
(parse_base.py:370-374,553).
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from ..utils.log import _init_logger
from ..utils.profiling import stage
from .simrad import framing
from .simrad import decode as dec
from .simrad.xml_config import parse_xml_datagram
from ..utils.io import read_source_bytes

logger = _init_logger(__name__)

__all__ = ["ParseEK80"]

PARAM_FIELDS = (
    "channel_mode",
    "pulse_form",
    "frequency",
    "frequency_start",
    "frequency_end",
    "pulse_duration",
    "pulse_duration_fm",
    "sample_interval",
    "transmit_power",
    "slope",
)


class ParseEK80:
    """Parse one EK80/ES80/EA640 .raw file into columnar per-channel data."""

    def __init__(self, file, bot_file="", idx_file="", storage_options=None, sonar_model="EK80", **kw):
        self.source_file = str(file)
        self.bot_file = str(bot_file) if bot_file else ""
        self.idx_file = str(idx_file) if idx_file else ""
        self.storage_options = storage_options
        self.sonar_model = sonar_model
        self.config_datagram = None  # {"configuration": {ch_id: {...}}, "xml": str}
        self.environment = {}
        self.ping_time = {}  # ch_id -> datetime64[ns][n_ping]
        self.ping_data_dict = {}  # field -> ch_id -> array
        self.ping_data_dict_tx = {}  # RAW4 transmit data
        self.ch_ids = {"power": [], "complex": [], "all": []}
        self.nmea = {"string": np.empty(0, object), "timestamp": np.empty(0, "datetime64[ns]")}
        self.fil = {"timestamp": []}
        self.mru0 = {}
        self.mru1 = {}
        self.bot = {"depth": [], "timestamp": []}
        self.idx = {}

    # ---------------------------------------------------------------- parsing
    def parse_raw(self):
        buf = read_source_bytes(self.source_file, self.storage_options)
        index = framing.scan_datagrams(buf)

        self._parse_xml_stream(index)
        with stage("ek80_raw3"):  # headers, samples and bound parameters of every RAW3
            self._parse_raw3(index, raw_type="RAW3")
        self._parse_raw3(index, raw_type="RAW4")

        nme_rows = index.select("NME0")
        self.nmea["string"], self.nmea["timestamp"] = dec.decode_nmea(index, nme_rows)

        self.mru0 = dec.decode_mru0(index, index.select("MRU0"))
        self.mru1 = dec.decode_mru1(index, index.select("MRU1"))

        if self.bot_file:
            self._parse_sidecar("bot")
        if self.idx_file:
            self._parse_sidecar("idx")

        for r in index.select("FIL1"):
            f = dec.decode_fil1(index, int(r))
            if "EC150" in f["channel_id"]:
                continue
            self.fil["timestamp"].append(f["timestamp"])
            key = (f["channel_id"], f["stage"])
            self.fil[key + ("coeffs", f["timestamp"])] = f["coefficients"]
            self.fil[key + ("deci_fac", f["timestamp"])] = f["decimation_factor"]
        return self

    def _parse_sidecar(self, kind):
        try:
            path = self.bot_file if kind == "bot" else self.idx_file
            buf = read_source_bytes(path, self.storage_options)
            index = framing.scan_datagrams(buf)
            if kind == "idx":
                self.idx = dec.decode_idx(index, index.select("IDX0"))
            else:
                self.bot.update(dec.decode_bot(index, index.select("BOT0")))
        except Exception as e:  # noqa: BLE001 - sidecars are best-effort
            logger.warning("Failed to parse %s sidecar: %r", kind, e)

    def _parse_xml_stream(self, index):
        """Parse XML0 datagrams; cache by payload bytes (parameters repeat)."""
        self._param_for_row = {}  # datagram row -> parameter dict
        cache = {}
        current_parameters = None
        xml_rows = index.select("XML0")
        raw_rows = set(index.type_starts_with("RAW").tolist())
        # walk all rows in order so parameter datagrams bind to following RAWs
        order = np.sort(np.concatenate([xml_rows, np.array(sorted(raw_rows), dtype="i8")])) if len(
            xml_rows
        ) else np.array(sorted(raw_rows), dtype="i8")
        for r in order:
            r = int(r)
            if r in raw_rows:
                self._param_for_row[r] = current_parameters
                continue
            start = int(index.body_offset[r]) + 12
            end = int(index.body_offset[r]) + int(index.size[r])
            payload = index.buf[start:end]
            if payload in cache:
                parsed = cache[payload]
            else:
                try:
                    parsed = parse_xml_datagram(payload)
                except Exception as e:  # noqa: BLE001 - skip malformed XML like reference resync
                    logger.warning("Failed to parse XML0 datagram: %r", e)
                    parsed = None
                cache[payload] = parsed
            if parsed is None:
                continue
            if parsed["subtype"] == "configuration":
                self.config_datagram = {
                    "configuration": parsed["configuration"],
                    "xml": parsed["xml"],
                }
            elif parsed["subtype"] == "environment":
                env = parsed["environment"]
                if set(env.keys()) != {"drop_keel_offset", "drop_keel_offset_is_manual"}:
                    self.environment = dict(env)
                    self.environment["xml"] = parsed["xml"]
                    self.environment["timestamp"] = index.timestamp[r]
            elif parsed["subtype"] == "parameter":
                if "EC150" not in parsed["parameter"].get("channel_id", ""):
                    current_parameters = parsed["parameter"]
        if self.config_datagram is None:
            raise ValueError(f"{self.source_file}: no XML0 configuration datagram found")

    def _parse_raw3(self, index, raw_type="RAW3"):
        rows = index.select(raw_type if raw_type != "RAW3" else "RAW3")
        hdr, ts, ch_ids = dec.decode_raw3_headers(index, rows)
        keep = np.array(["EC150" not in c for c in ch_ids], dtype=bool)
        rows, hdr, ts, ch_ids = rows[keep], hdr[keep], ts[keep], ch_ids[keep]

        target = self.ping_data_dict if raw_type == "RAW3" else self.ping_data_dict_tx
        for f in PARAM_FIELDS + ("power", "angle", "complex", "data_type", "count"):
            target.setdefault(f, {})

        for ch in sorted(set(ch_ids.tolist())):
            sel = np.nonzero(ch_ids == ch)[0]
            ch_hdr = hdr[sel]
            if raw_type == "RAW3":
                self.ping_time[ch] = ts[sel]
            samples = dec.decode_raw3_samples(index, rows[sel], ch_hdr)
            target["data_type"][ch] = ch_hdr["data_type"].astype("i8")
            target["count"][ch] = ch_hdr["count"].astype("i8")
            target["power"][ch] = samples["power"]
            target["angle"][ch] = samples["angle"]
            if samples["complex_r"] is not None:
                target["complex"][ch] = {
                    "real": samples["complex_r"],
                    "imag": samples["complex_i"],
                    "n_complex": samples["n_complex"],
                }
            # per-ping transmit parameters from the bound XML parameter dicts
            params = [self._param_for_row.get(int(r)) for r in rows[sel]]
            for pf in PARAM_FIELDS:
                vals = []
                for p in params:
                    if p is None or p.get("channel_id") != ch:
                        if p is not None and p.get("channel_id") != ch:
                            raise ValueError("Parameter ID does not match RAW")
                        vals.append(np.nan)
                    else:
                        v = p.get(pf, np.nan)
                        vals.append(v if v is not None else np.nan)
                try:
                    target[pf][ch] = np.asarray(vals, dtype="f8")
                except (TypeError, ValueError):
                    target[pf][ch] = np.asarray(vals, dtype=object)
            if raw_type == "RAW3":
                is_complex = samples["complex_r"] is not None
                bucket = "complex" if is_complex else "power"
                if ch not in self.ch_ids[bucket]:
                    self.ch_ids[bucket].append(ch)
                if ch not in self.ch_ids["all"]:
                    self.ch_ids["all"].append(ch)

    def rectangularize_data(self, *a, **kw):
        return self
