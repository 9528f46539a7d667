"""EK80 XML0 datagram parsing (configuration / environment / parameter).

Capability parity: echopype/convert/utils/ek_raw_parsers.py:725-1135
(SimradXMLParser) — type maps, camelCase->snake_case mangling, ';'-separated
list fields, per-channel Transceiver/Channel/Transducer assembly including
FrequencyPar broadband calibration curves.
"""

from __future__ import annotations

import re
import xml.etree.ElementTree as ET
from collections import Counter

import numpy as np

from ...utils.misc import camelcase2snakecase

__all__ = ["parse_xml_datagram"]

# serial-channel token inside a ChannelID, e.g. "WBT 549762-15 ES38B"
# (ek_raw_parsers.py:22)
_TCVR_CH_TOKEN = re.compile(r"\d{6}-\w{1,2}|\w{12}-\w{1,2}")

CHANNEL_OPTS = {
    "MaxTxPowerTransceiver": (int, "", ""),
    "PulseDuration": (float, "", ";"),
    "PulseDurationFM": (float, "pulse_duration_fm", ";"),
    "SampleInterval": (float, "", ";"),
    "ChannelID": (str, "channel_id", ""),
    "HWChannelConfiguration": (str, "hw_channel_configuration", ""),
}

TRANSCEIVER_OPTS = {
    "TransceiverNumber": (int, "", ""),
    "Version": (str, "transceiver_version", ""),
    "IPAddress": (str, "ip_address", ""),
    "Impedance": (int, "", ""),
}

TRANSDUCER_OPTS = {
    "SerialNumber": (str, "transducer_serial_number", ""),
    "Frequency": (float, "transducer_frequency", ""),
    "FrequencyMinimum": (float, "transducer_frequency_minimum", ""),
    "FrequencyMaximum": (float, "transducer_frequency_maximum", ""),
    "BeamType": (int, "transducer_beam_type", ""),
    "Gain": (float, "", ";"),
    "SaCorrection": (float, "", ";"),
    "MaxTxPowerTransducer": (float, "", ""),
    "EquivalentBeamAngle": (float, "", ""),
    "BeamWidthAlongship": (float, "", ""),
    "BeamWidthAthwartship": (float, "", ""),
    "AngleSensitivityAlongship": (float, "", ""),
    "AngleSensitivityAthwartship": (float, "", ""),
    "AngleOffsetAlongship": (float, "", ""),
    "AngleOffsetAthwartship": (float, "", ""),
    "DirectivityDropAt2XBeamWidth": (float, "directivity_drop_at_2x_beam_width", ""),
    "TransducerOffsetX": (float, "", ""),
    "TransducerOffsetY": (float, "", ""),
    "TransducerOffsetZ": (float, "", ""),
    "TransducerAlphaX": (float, "", ""),
    "TransducerAlphaY": (float, "", ""),
    "TransducerAlphaZ": (float, "", ""),
}

HEADER_OPTS = {"Version": (str, "application_version", "")}

ENVIRONMENT_OPTS = {
    "Depth": (float, "", ""),
    "Acidity": (float, "", ""),
    "Salinity": (float, "", ""),
    "SoundSpeed": (float, "", ""),
    "Temperature": (float, "", ""),
    "Latitude": (float, "", ""),
    "SoundVelocityProfile": (float, "", ";"),
    "DropKeelOffset": (float, "", ""),
    "DropKeelOffsetIsManual": (int, "", ""),
    "WaterLevelDraft": (float, "", ""),
    "WaterLevelDraftIsManual": (int, "", ""),
}

ENV_XDCR_OPTS = {"SoundSpeed": (float, "transducer_sound_speed", "")}

PARAMETER_OPTS = {
    "ChannelID": (str, "channel_id", ""),
    "ChannelMode": (int, "", ""),
    "PulseForm": (int, "", ""),
    "Frequency": (float, "", ""),
    "PulseDuration": (float, "", ""),
    "SampleInterval": (float, "", ""),
    "TransmitPower": (float, "", ""),
    "Slope": (float, "", ""),
}


def _apply_opts(attrib: dict, out: dict, opts: dict):
    for k, v in attrib.items():
        if k in opts:
            conv, name, sep = opts[k]
            if sep:
                data = v.split(sep)
                parsed = []
                for item in data:
                    try:
                        parsed.append(conv(item))
                    except (ValueError, TypeError):
                        parsed.append(item)
                data = parsed
            else:
                try:
                    data = conv(v)
                except (ValueError, TypeError):
                    data = v
            out[name or camelcase2snakecase(k)] = data
        else:
            out[camelcase2snakecase(k)] = v


def _match_mounting(mounts, channel_id: str, xducer_attrib: dict):
    """Pick this channel's entry from the ship-install <Transducers> section.

    Real WBT configuration XML keeps the mounting offsets
    (TransducerOffsetX/Y/Z, alpha rotations) in a root-level <Transducers>
    list rather than on the per-channel <Transducer> element; entries match a
    channel by transducer name, serial number, or the transceiver-channel
    token embedded in TransducerCustomName.  When several entries share one
    TransducerName, the name alone is ambiguous and only the serial/token
    rules apply (behavior contract: ek_raw_parsers.py:1010-1056).
    """
    token_m = _TCVR_CH_TOKEN.search(channel_id)
    token = token_m[0] if token_m else None
    entries = list(mounts.iter("Transducer"))
    name_counts = Counter(e.attrib.get("TransducerName", "") for e in entries)
    for entry in entries:
        ea = entry.attrib
        by_name = ea.get("TransducerName", "") == xducer_attrib.get("TransducerName")
        sn = ea.get("TransducerSerialNumber", "")
        by_sn = bool(sn) and sn == xducer_attrib.get("SerialNumber")
        by_token = token is not None and token in ea.get("TransducerCustomName", "")
        if name_counts[ea.get("TransducerName", "")] > 1:
            matched = by_sn or by_token
        else:
            matched = by_name or by_sn or by_token
        if matched:
            return ea
    return None


def parse_xml_datagram(xml_bytes: bytes) -> dict:
    """Parse one XML0 payload; returns {'subtype': ..., <subtype>: {...}, 'xml': str}."""
    xml_string = xml_bytes.split(b"\x00", 1)[0].decode("ascii", errors="replace")
    root = ET.fromstring(xml_string)
    subtype = root.tag.lower()
    data = {"subtype": subtype, "xml": xml_string, subtype: {}}

    if subtype == "configuration":
        mounts = root.find("Transducers")
        hdr = root.find("Header")
        for tcvr in root.iter("Transceiver"):
            for tcvr_ch in tcvr.iter("Channel"):
                channel_id = tcvr_ch.attrib["ChannelID"]
                cfg = data["configuration"].setdefault(channel_id, {})
                _apply_opts(tcvr.attrib, cfg, TRANSCEIVER_OPTS)
                _apply_opts(tcvr_ch.attrib, cfg, CHANNEL_OPTS)
                xducer = tcvr_ch.find("Transducer")
                if xducer is not None:
                    f_par = xducer.findall("FrequencyPar")
                    if f_par:
                        def col(name, conv=float):
                            return np.array([conv(f.attrib[name]) for f in f_par])

                        cfg["calibration"] = {
                            "frequency": col("Frequency", int),
                            "gain": col("Gain"),
                            "impedance": col("Impedance"),
                            "phase": col("Phase"),
                            "beamwidth_alongship": col("BeamWidthAlongship"),
                            "beamwidth_athwartship": col("BeamWidthAthwartship"),
                            "angle_offset_alongship": col("AngleOffsetAlongship"),
                            "angle_offset_athwartship": col("AngleOffsetAthwartship"),
                        }
                    _apply_opts(xducer.attrib, cfg, TRANSDUCER_OPTS)
                    if mounts is not None:
                        mount = _match_mounting(mounts, channel_id, xducer.attrib)
                        if mount is not None:
                            _apply_opts(mount, cfg, TRANSDUCER_OPTS)
                if hdr is not None:
                    # the reference replicates the Header attrs (notably
                    # application_version) into every channel dict
                    # (ek_raw_parsers.py:1058-1064)
                    _apply_opts(hdr.attrib, cfg, HEADER_OPTS)
        if hdr is not None:
            _apply_opts(hdr.attrib, data["configuration"].setdefault("_header", {}), HEADER_OPTS)
    elif subtype == "environment":
        _apply_opts(root.attrib, data["environment"], ENVIRONMENT_OPTS)
        for xdcr in root.iter("Transducer"):
            _apply_opts(xdcr.attrib, data["environment"], ENV_XDCR_OPTS)
    elif subtype == "parameter":
        ch = root.find("Channel")
        if ch is not None:
            _apply_opts(ch.attrib, data["parameter"], PARAMETER_OPTS)
    return data
