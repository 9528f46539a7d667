"""Common group-assembly helpers shared by all sonar models.

Capability parity: echopype/convert/set_groups_base.py:16-522 — Top-level,
Provenance, Platform/NMEA groups, NMEA lat/lon extraction, NaN-timestamp
handling.
"""

from __future__ import annotations

from datetime import datetime, timezone

import numpy as np

from ..echodata.convention import TOP_LEVEL_ATTRS, VARATTRS
from ..utils.prov import echopype_prov_attrs, source_files_vars
from ..xrlite import DataArray, Dataset
from .simrad.decode import parse_nmea_latlon

NMEA_SENTENCE_DEFAULT = ("GGA", "GLL", "RMC")


class SetGroupsBase:
    """Base class for assembling the SONAR-netCDF4 group tree."""

    def __init__(self, parser_obj, input_file, sonar_model, params=None):
        self.parser_obj = parser_obj
        self.input_file = str(input_file)
        self.sonar_model = sonar_model
        self.ui_param = params or {}
        self._varattrs = VARATTRS

    def _platform_attrs(self, default_type: str = "") -> dict:
        """Platform identity attrs, honoring convert_params (convert/api.py:239-241)."""
        return {
            "platform_name": str(self.ui_param.get("platform_name", "")),
            "platform_type": str(self.ui_param.get("platform_type", default_type)),
            "platform_code_ICES": str(self.ui_param.get("platform_code_ICES", "")),
        }

    # ------------------------------------------------------------- top level
    def set_toplevel(self) -> Dataset:
        date_created = None
        ping_time = getattr(self.parser_obj, "ping_time", {})
        time_lists = ping_time.values() if isinstance(ping_time, dict) else [ping_time]
        for times in time_lists:
            if len(times):
                t0 = times[0]
                date_created = t0 if date_created is None else min(date_created, t0)
        attrs = dict(TOP_LEVEL_ATTRS)
        attrs["keywords"] = self.sonar_model
        attrs["date_created"] = (
            np.datetime_as_string(date_created, unit="s") + "Z" if date_created is not None else ""
        )
        attrs["survey_name"] = self.ui_param.get("survey_name", "")
        # extra convert_params keys land on the top level (convert/api.py:246-248)
        known = {"platform_name", "platform_type", "platform_code_ICES",
                 "water_level", "survey_name"}
        for k, v in self.ui_param.items():
            if k not in known:
                attrs[k] = v
        return Dataset(attrs=attrs)

    def set_provenance(self) -> Dataset:
        ds = Dataset(attrs=echopype_prov_attrs("conversion"))
        for name, da in source_files_vars(self.input_file).items():
            ds[name] = da
        ds.attrs["source_file"] = self.input_file
        ds.attrs["duplicate_ping_times"] = 0
        return ds

    # ------------------------------------------------------------------ NMEA
    def set_nmea(self) -> Dataset:
        strings = self.parser_obj.nmea["string"]
        times = self.parser_obj.nmea["timestamp"]
        if len(strings) == 0:
            # no NMEA in the file: float-NaN datagram var on a first-ping
            # time stamp (reference set_groups_base.py:142-147)
            values = np.array([np.nan])
            times = [np.nan]
        else:
            values = np.asarray(strings, dtype=object)
        times = self._nan_timestamp_handler(times)
        return Dataset(
            {
                "NMEA_datagram": (
                    ("nmea_time",),
                    values,
                    {"long_name": "NMEA datagram contents"},
                )
            },
            coords={
                "nmea_time": (
                    ("nmea_time",),
                    np.asarray(times, dtype="datetime64[ns]"),
                    {
                        "axis": "T",
                        "long_name": "Timestamps for NMEA datagrams",
                        "standard_name": "time",
                    },
                )
            },
            attrs={"description": "All NMEA sensor datagrams"},
        )

    def _extract_NMEA_latlon(self, nmea_sentence=None):
        allowed = tuple(nmea_sentence) if nmea_sentence else NMEA_SENTENCE_DEFAULT
        return parse_nmea_latlon(
            self.parser_obj.nmea["string"], self.parser_obj.nmea["timestamp"], allowed
        )

    # --------------------------------------------------------- IDX sidecar
    def _add_index_data_to_platform_ds(self, platform_ds: Dataset) -> Dataset:
        """Append IDX-file index data on a new time4 dim
        (set_groups_base.py:371-467)."""
        idx = getattr(self.parser_obj, "idx", None)
        if not idx or not len(np.atleast_1d(idx.get("ping_number", []))):
            return platform_ds
        t4 = np.asarray(idx["timestamp"], dtype="datetime64[ns]")
        platform_ds.coords["time4"] = DataArray(
            t4,
            ("time4",),
            attrs={"axis": "T", "long_name": "Timestamps from the IDX datagrams"},
            name="time4",
        )
        platform_ds["ping_number_idx"] = (("time4",), np.asarray(idx["ping_number"], dtype="i8"))
        platform_ds["file_offset_idx"] = (("time4",), np.asarray(idx["file_offset"], dtype="i8"))
        platform_ds["vessel_distance_idx"] = (
            ("time4",),
            np.asarray(idx["vessel_distance"], dtype="f8"),
            {
                "long_name": "Vessel distance in nautical miles (nmi) from start of recording.",
                "comment": "Data from the IDX datagrams. Aligns time-wise with this "
                "dataset's `time4` dimension.",
            },
        )
        platform_ds["latitude_idx"] = (
            ("time4",),
            np.asarray(idx["latitude"], dtype="f8"),
            {"long_name": "Platform latitude from the IDX datagrams"},
        )
        platform_ds["longitude_idx"] = (
            ("time4",),
            np.asarray(idx["longitude"], dtype="f8"),
            {"long_name": "Platform longitude from the IDX datagrams"},
        )
        return platform_ds

    def _add_seafloor_detection_data_to_vendor_ds(
        self, vendor_ds: Dataset, channels, config_order=None
    ) -> Dataset:
        """Append BOT-file seafloor depths on a ``ping_time`` dim — its own
        BOT-timestamp coordinate in the Vendor group, matching the reference
        (set_groups_base.py:469-522).

        BOT columns follow transceiver (config) order; when the vendor group's
        channel coord uses a different order, pass ``config_order`` to remap.
        """
        bot = getattr(self.parser_obj, "bot", {})
        depth = bot.get("depth")
        if not isinstance(depth, np.ndarray) or not len(depth):
            return vendor_ds
        rows = depth.T  # [transceiver, time]
        if config_order is not None:
            out = np.full((len(channels), rows.shape[1]), np.nan)
            order = list(config_order)
            for i, ch in enumerate(channels):
                if ch in order and order.index(ch) < rows.shape[0]:
                    out[i] = rows[order.index(ch)]
            rows = out
        else:
            rows = rows[: len(channels)]
        vendor_ds.coords["ping_time"] = DataArray(
            np.asarray(bot["timestamp"], dtype="datetime64[ns]"),
            ("ping_time",),
            attrs={
                "long_name": "Timestamps from the BOT datagrams",
                "standard_name": "time",
                "axis": "T",
                "comment": "Time coordinate corresponding to seafloor detection data.",
            },
            name="ping_time",
        )
        vendor_ds["detected_seafloor_depth"] = (
            ("channel", "ping_time"),
            rows,
            {"long_name": "Echosounder detected seafloor depth from the BOT datagrams."},
        )
        return vendor_ds

    # ------------------------------------------------------------- utilities
    def _nan_timestamp_handler(self, time_data):
        """Empty or single-NaN time vector -> the earliest first-ping time
        (reference set_groups_base.py:110-125: xarray warns on all-NaN time
        coordinates, so a missing sensor stream borrows the earliest ping
        timestamp — min of each channel's first ping for Simrad models, the
        first profile time for AZFP)."""
        arr = np.asarray(time_data)
        if arr.size > 1:
            return time_data
        if arr.size == 1:
            missing = bool(
                np.isnat(arr[0]) if arr.dtype.kind == "M" else np.isnan(arr.astype("f8")[0])
            )
        else:
            missing = True
        if not missing:
            return time_data
        pt = getattr(self.parser_obj, "ping_time", None)
        if isinstance(pt, dict) and any(len(v) for v in pt.values()):
            first = min(np.asarray(v)[0] for v in pt.values() if len(v))
        elif pt is not None and not isinstance(pt, dict) and len(pt):
            first = np.asarray(pt)[0]
        else:
            return np.array(["NaT"], dtype="datetime64[ns]")
        return np.asarray([first], dtype="datetime64[ns]")

    @staticmethod
    def union_times(per_channel_times: dict):
        """Sorted union of per-channel ping times + per-channel row mappings."""
        all_times = np.unique(np.concatenate([t for t in per_channel_times.values()]))
        mapping = {}
        for ch, t in per_channel_times.items():
            mapping[ch] = np.searchsorted(all_times, t)
        return all_times, mapping

    @staticmethod
    def scatter_to_union(values: np.ndarray, rows: np.ndarray, n_union: int, fill=np.nan):
        """Place per-channel ping rows into the union ping grid."""
        shape = (n_union,) + values.shape[1:]
        dtype = values.dtype if values.dtype.kind in "fc" else np.float64
        out = np.full(shape, fill, dtype=dtype)
        out[rows] = values
        return out

    @staticmethod
    def utcnow_str():
        return datetime.now(timezone.utc).strftime("%Y-%m-%dT%H:%M:%SZ")
