"""AZFP group assembly.

Capability parity: echopype/convert/set_groups_azfp.py — channels sorted by
frequency; Beam_group1 carries raw counts as backscatter_r plus the
manual-derived transmit parameters; Vendor_specific carries EL/DS/TVR/VTX0/
Sv_offset plus digitization rate, lockout index, and samples-per-bin.
"""

from __future__ import annotations

import numpy as np

from ..xrlite import DataArray, Dataset
from .set_groups_base import SetGroupsBase


class SetGroupsAZFP(SetGroupsBase):
    beamgroups_possible = [
        {"name": "Beam_group1", "descr": "contains backscatter data in counts"}
    ]

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        p = self.parser_obj
        self.freq_sorted = p.freq_sorted
        self.freq_ind = p.freq_ind_sorted
        self.channel_labels = np.array(
            [f"{self.sonar_model} {int(p.unpacked_data['serial_number'])} {int(f)}"
             for f in self.freq_sorted],
            dtype=object,
        )
        self.ping_time = np.asarray(p.ping_time, dtype="datetime64[ns]")
        self.beam_group_map = {1: "power"}

    def _per_freq(self, arr):
        return np.atleast_1d(np.asarray(arr, dtype="f8"))[self.freq_ind]

    # ------------------------------------------------------------------- env
    def set_env(self) -> Dataset:
        p = self.parser_obj
        ds = Dataset(
            coords={
                "channel": (
                    ("channel",),
                    self.channel_labels,
                    self._varattrs["beam_coord_default"]["channel"],
                ),
                "time1": (
                    ("time1",),
                    self.ping_time,
                    {"axis": "T", "standard_name": "time",
                     "long_name": "Timestamps for environmental variables"},
                ),
            }
        )
        ds["frequency_nominal"] = (
            ("channel",),
            self.freq_sorted,
            self._varattrs["platform_var_default"]["frequency_nominal"],
        )
        temp = np.asarray(p.unpacked_data["temperature"], dtype="f8")
        if not np.isnan(temp).all():
            ds["temperature"] = (
                ("time1",),
                temp,
                {"long_name": "Water temperature",
                 "standard_name": "sea_water_temperature", "units": "deg_C"},
            )
        pres = np.asarray(p.unpacked_data["pressure"], dtype="f8")
        if not np.isnan(pres).all():
            ds["pressure"] = (
                ("time1",),
                pres,
                {"long_name": "Sea water pressure", "units": "dbar"},
            )
        return ds

    # ----------------------------------------------------------------- sonar
    def set_sonar(self) -> Dataset:
        ds = Dataset(
            {
                "beam_group_descr": (
                    ("beam_group",),
                    np.asarray([self.beamgroups_possible[0]["descr"]], dtype=object),
                )
            },
            coords={"beam_group": np.asarray(["Beam_group1"], dtype=object)},
            attrs={
                "sonar_manufacturer": "ASL Environmental Sciences",
                "sonar_model": self.sonar_model,
                "sonar_serial_number": int(self.parser_obj.unpacked_data["serial_number"]),
                "sonar_software_name": "AZFP",
                "sonar_software_version": "based on AZFP Matlab version 1.4",
                "sonar_type": "echosounder",
            },
        )
        return ds

    # -------------------------------------------------------------- platform
    def set_platform(self) -> Dataset:
        p = self.parser_obj
        pv = self._varattrs["platform_var_default"]
        tilt_x = np.asarray(p.unpacked_data["tilt_x"], dtype="f8")
        tilt_y = np.asarray(p.unpacked_data["tilt_y"], dtype="f8")
        if np.isnan(tilt_x).all() and np.isnan(tilt_y).all():
            time2 = self.ping_time[:1]
            tilt_x, tilt_y = np.array([np.nan]), np.array([np.nan])
        else:
            time2 = self.ping_time
        ds = Dataset(
            {
                "tilt_x": (("time2",), tilt_x, {"long_name": "Tilt X", "units": "arc_degree"}),
                "tilt_y": (("time2",), tilt_y, {"long_name": "Tilt Y", "units": "arc_degree"}),
                **{
                    var: ((), np.float64(np.nan), pv[var])
                    for var in (
                        "transducer_offset_x",
                        "transducer_offset_y",
                        "transducer_offset_z",
                    )
                },
                "frequency_nominal": (
                    ("channel",),
                    self.freq_sorted,
                    pv["frequency_nominal"],
                ),
            },
            coords={
                "channel": (
                    ("channel",),
                    self.channel_labels,
                    self._varattrs["beam_coord_default"]["channel"],
                ),
                "time2": (
                    ("time2",),
                    time2,
                    self._varattrs["platform_coord_default"]["time2"],
                ),
            },
            attrs=self._platform_attrs(default_type="subsurface mooring"),
        )
        return ds

    # ------------------------------------------------------------------ beam
    def set_beam(self) -> list:
        p = self.parser_obj
        ud = p.unpacked_data
        n_ping = len(self.ping_time)
        num_bins = np.atleast_1d(ud["num_bins"])
        max_r = int(np.max(num_bins))
        n_ch = len(self.freq_sorted)
        counts = np.full((n_ch, n_ping, max_r), np.nan, dtype="f4")
        for pi, ping_counts in enumerate(ud["counts"]):
            for out_i, src_ch in enumerate(self.freq_ind):
                v = ping_counts[src_ch]
                counts[out_i, pi, : len(v)] = v

        dig_rate = self._per_freq(ud["dig_rate"])
        # sample_interval = time per stored BIN: the instrument averages
        # range_samples_per_bin ADC samples into each bin
        # (reference: set_groups_azfp.py:374)
        rspb = self._per_freq(ud["range_samples_per_bin"])
        sample_int = np.where(
            dig_rate > 0, rspb / np.where(dig_rate > 0, dig_rate, 1), np.nan
        )
        tdn = self._per_freq(ud["pulse_len"]) / 1e6
        bp = np.atleast_1d(np.asarray(p.parameters.get("BP", np.full(n_ch, np.nan)), dtype="f8"))
        if bp.size >= n_ch:
            bp = bp[self.freq_ind]

        bv = self._varattrs["beam_var_default"]
        ds = Dataset(
            coords={
                "channel": (
                    ("channel",),
                    self.channel_labels,
                    self._varattrs["beam_coord_default"]["channel"],
                ),
                "ping_time": (
                    ("ping_time",),
                    self.ping_time,
                    self._varattrs["beam_coord_default"]["ping_time"],
                ),
                "range_sample": (
                    ("range_sample",),
                    np.arange(max_r),
                    self._varattrs["beam_coord_default"]["range_sample"],
                ),
            },
            attrs={"beam_mode": "", "conversion_equation_t": "type_4"},
        )
        ds["frequency_nominal"] = (
            ("channel",),
            self.freq_sorted,
            self._varattrs["platform_var_default"]["frequency_nominal"],
        )
        ds["backscatter_r"] = (
            ("channel", "ping_time", "range_sample"),
            counts,
            {**bv["backscatter_r"], "units": "count"},
        )
        ds["equivalent_beam_angle"] = (("channel",), bp, bv["equivalent_beam_angle"])
        ds["gain_correction"] = (
            ("channel",),
            self._per_freq(ud["gain"]),
            {"long_name": "Gain correction", "units": "dB"},
        )
        # sample_interval / transmit_duration_nominal carry a ping_time dim
        # (constant per channel): the reference's SetGroupsBase expands its
        # ping_time_only_names over pings (set_groups_azfp.py:38-43)
        n_ping = ds.sizes["ping_time"]
        ds["sample_interval"] = (
            ("channel", "ping_time"),
            np.repeat(np.asarray(sample_int, dtype="f8")[:, None], n_ping, axis=1),
            bv["sample_interval"],
        )
        ds["transmit_duration_nominal"] = (
            ("channel", "ping_time"),
            np.repeat(np.asarray(tdn, dtype="f8")[:, None], n_ping, axis=1),
            bv["transmit_duration_nominal"],
        )
        return [ds]

    # ---------------------------------------------------------------- vendor
    def set_vendor(self) -> Dataset:
        p = self.parser_obj
        ud = p.unpacked_data
        params = p.parameters
        ds = Dataset(
            coords={
                "channel": (
                    ("channel",),
                    self.channel_labels,
                    self._varattrs["beam_coord_default"]["channel"],
                ),
                "ping_time": (("ping_time",), self.ping_time),
            }
        )
        ds["frequency_nominal"] = (
            ("channel",),
            self.freq_sorted,
            self._varattrs["platform_var_default"]["frequency_nominal"],
        )
        for name in ("EL", "DS", "TVR", "VTX0"):
            vals = np.atleast_1d(np.asarray(params[name], dtype="f8"))[self.freq_ind]
            ds[name] = (("channel",), vals)
        ds["Sv_offset"] = (("channel",), p.Sv_offset)
        ds["digitization_rate"] = (("channel",), self._per_freq(ud["dig_rate"]))
        ds["lock_out_index"] = (("channel",), self._per_freq(ud["lock_out_index"]))
        ds["number_of_samples_per_average_bin"] = (
            ("channel",),
            self._per_freq(ud["range_samples_per_bin"]),
        )
        anc = np.asarray(ud["ancillary"], dtype="f8")
        ds["temperature_counts"] = (
            ("ping_time",),
            anc[:, 4],
            {"long_name": "Raw counts for temperature"},
        )
        ds["tilt_x_count"] = (("ping_time",), anc[:, 0], {"long_name": "Raw counts for Tilt-X"})
        ds["tilt_y_count"] = (("ping_time",), anc[:, 1], {"long_name": "Raw counts for Tilt-Y"})
        ds["battery_main"] = (("ping_time",), np.asarray(ud["battery_main"], dtype="f8"))
        ds["battery_tx"] = (("ping_time",), np.asarray(ud["battery_tx"], dtype="f8"))
        for name in ("ka", "kb", "kc", "A", "B", "C", "a0", "a1"):
            if name in params:
                ds.attrs[f"XML_{name}"] = float(np.atleast_1d(params[name])[0])
        ds.attrs["number_of_frequency"] = int(params.get("num_freq", len(self.freq_sorted)))
        return ds
