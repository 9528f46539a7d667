"""EK60 group assembly: parser columns -> SONAR-netCDF4 group Datasets.

Capability parity: echopype/convert/set_groups_ek60.py:18-787.  Channels are
sorted by channel_id string; per-channel pings are aligned onto the union
ping_time grid (the xr.concat(join="outer") behavior of the reference) with
NaN fill; backscatter is padded along range_sample to the widest channel.
"""

from __future__ import annotations

import numpy as np

from ..xrlite import DataArray, Dataset
from .set_groups_base import SetGroupsBase


class SetGroupsEK60(SetGroupsBase):
    beamgroups_possible = [
        {
            "name": "Beam_group1",
            "descr": "contains backscatter power (uncalibrated) and angle data",
        }
    ]

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        cfg = self.parser_obj.config_datagram
        channel_ids = {ch: tx["channel_id"] for ch, tx in cfg["transceivers"].items()}
        # ascending channel_id order, keeping only channels with data
        self.sorted_channel = dict(sorted(channel_ids.items(), key=lambda kv: kv[1]))
        self.sorted_channel = {
            ch: cid
            for ch, cid in self.sorted_channel.items()
            if ch in self.parser_obj.ping_data_dict["power"]
            and len(self.parser_obj.ping_data_dict["power"][ch])
        }
        self.freq = [
            cfg["transceivers"][ch]["frequency"] for ch in self.sorted_channel.keys()
        ]
        self.channel_labels = np.asarray(list(self.sorted_channel.values()), dtype=object)
        if self.sorted_channel:
            self.union_time, self.time_map = self.union_times(
                {ch: self.parser_obj.ping_time[ch] for ch in self.sorted_channel}
            )
        else:
            self.union_time, self.time_map = np.empty(0, "datetime64[ns]"), {}

    # ------------------------------------------------------------ group: env
    def set_env(self) -> Dataset:
        n_t = len(self.union_time)
        n_ch = len(self.sorted_channel)
        absorp = np.full((n_ch, n_t), np.nan)
        ss = np.full((n_ch, n_t), np.nan)
        for i, ch in enumerate(self.sorted_channel):
            rows = self.time_map[ch]
            absorp[i, rows] = self.parser_obj.ping_data_dict["absorption_coefficient"][ch]
            ss[i, rows] = self.parser_obj.ping_data_dict["sound_velocity"][ch]
        ds = Dataset(
            {
                "absorption_indicative": (
                    ("channel", "time1"),
                    absorp,
                    {
                        "long_name": "Indicative acoustic absorption",
                        "units": "dB/m",
                        "valid_min": 0.0,
                    },
                ),
                "sound_speed_indicative": (
                    ("channel", "time1"),
                    ss,
                    {
                        "long_name": "Indicative sound speed",
                        "standard_name": "speed_of_sound_in_sea_water",
                        "units": "m/s",
                        "valid_min": 0.0,
                    },
                ),
                "frequency_nominal": (
                    ("channel",),
                    np.asarray(self.freq, dtype="f8"),
                    self._varattrs["platform_var_default"]["frequency_nominal"],
                ),
            },
            coords={
                "channel": (
                    ("channel",),
                    self.channel_labels,
                    self._varattrs["beam_coord_default"]["channel"],
                ),
                "time1": (
                    ("time1",),
                    self.union_time,
                    {
                        "axis": "T",
                        "long_name": "Timestamps for environmental variables",
                        "standard_name": "time",
                    },
                ),
            },
        )
        return ds

    # ---------------------------------------------------------- group: sonar
    def set_sonar(self) -> Dataset:
        cfg = self.parser_obj.config_datagram
        names = [bg["name"] for bg in self.beamgroups_possible]
        descr = [bg["descr"] for bg in self.beamgroups_possible]
        ds = Dataset(
            {
                "beam_group_descr": (
                    ("beam_group",),
                    np.asarray(descr, dtype=object),
                    {"long_name": "Beam group description"},
                )
            },
            coords={
                "beam_group": (
                    ("beam_group",),
                    np.asarray(names, dtype=object),
                    {"long_name": "Beam group name"},
                )
            },
            attrs={
                "sonar_manufacturer": "Simrad",
                "sonar_model": self.sonar_model,
                "sonar_serial_number": "",
                "sonar_software_name": cfg["sounder_name"],
                "sonar_software_version": cfg["version"],
                "sonar_type": "echosounder",
            },
        )
        return ds

    # ------------------------------------------------------- group: platform
    def set_platform(self) -> Dataset:
        time1, msg_type, lat, lon = self._extract_NMEA_latlon()
        time1 = self._nan_timestamp_handler(time1)
        if len(lat) == 0:
            lat = np.array([np.nan])
            lon = np.array([np.nan])
            # the reference emits a float NaN sentence_type when the file has
            # no NMEA messages ([np.nan] msg_type, set_groups_base.py:218-222)
            msg_type = np.array([np.nan])

        # motion vars ride the FIRST channel's own ping times, raw rows — the
        # reference indexes ping_data_dict[...][ch] for one channel and sets
        # time2 = ping_time[ch] (set_groups_ek60.py:211-224,256-266), NOT the
        # union ping grid (found by the ek60sg soak on per-channel dropouts)
        ch0 = next(iter(self.sorted_channel))

        def on_time2(field):
            return np.asarray(self.parser_obj.ping_data_dict[field][ch0], dtype="f8")

        pv = self._varattrs["platform_var_default"]
        cfg = self.parser_obj.config_datagram
        ds = Dataset(
            {
                "latitude": (("time1",), lat, pv["latitude"]),
                "longitude": (("time1",), lon, pv["longitude"]),
                "sentence_type": (("time1",), msg_type, pv["sentence_type"]),
                "pitch": (("time2",), on_time2("pitch"), pv["pitch"]),
                "roll": (("time2",), on_time2("roll"), pv["roll"]),
                "vertical_offset": (("time2",), on_time2("heave"), pv["vertical_offset"]),
                "water_level": (
                    (),
                    np.float64(
                        self.ui_param["water_level"]
                        if self.ui_param.get("water_level") is not None
                        else self.parser_obj.ping_data_dict["transducer_depth"][ch0][0]
                    ),
                    pv["water_level"],
                ),
                **{
                    var: ((), np.float64(np.nan), pv[var])
                    for var in [
                        "MRU_offset_x",
                        "MRU_offset_y",
                        "MRU_offset_z",
                        "MRU_rotation_x",
                        "MRU_rotation_y",
                        "MRU_rotation_z",
                        "position_offset_x",
                        "position_offset_y",
                        "position_offset_z",
                    ]
                },
                "transducer_offset_x": (
                    ("channel",),
                    np.asarray(
                        [cfg["transceivers"][ch].get("pos_x", np.nan) for ch in self.sorted_channel],
                        dtype="f8",
                    ),
                    pv["transducer_offset_x"],
                ),
                "transducer_offset_y": (
                    ("channel",),
                    np.asarray(
                        [cfg["transceivers"][ch].get("pos_y", np.nan) for ch in self.sorted_channel],
                        dtype="f8",
                    ),
                    pv["transducer_offset_y"],
                ),
                "transducer_offset_z": (
                    ("channel",),
                    np.asarray(
                        [cfg["transceivers"][ch].get("pos_z", np.nan) for ch in self.sorted_channel],
                        dtype="f8",
                    ),
                    pv["transducer_offset_z"],
                ),
                "frequency_nominal": (
                    ("channel",),
                    np.asarray(self.freq, dtype="f8"),
                    pv["frequency_nominal"],
                ),
            },
            coords={
                "channel": (
                    ("channel",),
                    self.channel_labels,
                    self._varattrs["beam_coord_default"]["channel"],
                ),
                "time1": (
                    ("time1",),
                    time1,
                    {
                        **self._varattrs["platform_coord_default"]["time1"],
                        "comment": "Time coordinate corresponding to NMEA position data.",
                    },
                ),
                "time2": (
                    ("time2",),
                    np.asarray(self.parser_obj.ping_time[ch0],
                               dtype="datetime64[ns]"),
                    self._varattrs["platform_coord_default"]["time2"],
                ),
            },
            attrs=self._platform_attrs(),
        )
        ds = self._add_index_data_to_platform_ds(ds)
        return ds

    # ----------------------------------------------------------- group: beam
    def set_beam(self) -> list:
        cfg = self.parser_obj.config_datagram
        n_ch = len(self.sorted_channel)
        n_t = len(self.union_time)
        max_range = max(
            (self.parser_obj.ping_data_dict["power"][ch].shape[1] for ch in self.sorted_channel),
            default=0,
        )

        # allocate WITHOUT prefilling: the per-channel scatter below covers
        # almost every element (profiling showed the np.full NaN prefill of
        # these [channel, ping, range] blocks was ~90% of warm ingest time);
        # only uncovered rows/columns get an explicit NaN fill
        backscatter = np.empty((n_ch, n_t, max_range), dtype="f4")
        has_angle = any(
            self.parser_obj.ping_data_dict["angle"][ch] is not None for ch in self.sorted_channel
        )
        angle_athwart = np.empty((n_ch, n_t, max_range), dtype="f4") if has_angle else None
        angle_along = np.empty((n_ch, n_t, max_range), dtype="f4") if has_angle else None

        per_ping = {
            f: np.full((n_ch, n_t), np.nan)
            for f in [
                "sample_interval",
                "transmit_bandwidth",
                "transmit_duration_nominal",
                "transmit_power",
                "sample_time_offset",
            ]
        }
        data_type = np.zeros((n_ch, n_t), dtype="i1")
        channel_mode = np.full((n_ch, n_t), -1, dtype="i1")
        any_missing = False

        src_names = {
            "sample_interval": "sample_interval",
            "transmit_bandwidth": "bandwidth",
            "transmit_duration_nominal": "pulse_length",
            "transmit_power": "transmit_power",
        }
        pd = self.parser_obj.ping_data_dict
        for i, ch in enumerate(self.sorted_channel):
            rows = self.time_map[ch]
            covered = np.zeros(n_t, dtype=bool)
            covered[rows] = True
            missing = ~covered if not covered.all() else None
            pw = pd["power"][ch]
            backscatter[i, rows, : pw.shape[1]] = pw
            if pw.shape[1] < max_range:
                backscatter[i, rows, pw.shape[1] :] = np.nan
            if missing is not None:
                backscatter[i, missing] = np.nan
            ang = pd["angle"][ch]
            if has_angle and ang is None:
                angle_athwart[i] = np.nan
                angle_along[i] = np.nan
            elif ang is not None:
                angle_athwart[i, rows, : ang.shape[1]] = ang[:, :, 0]
                angle_along[i, rows, : ang.shape[1]] = ang[:, :, 1]
                if ang.shape[1] < max_range:
                    angle_athwart[i, rows, ang.shape[1] :] = np.nan
                    angle_along[i, rows, ang.shape[1] :] = np.nan
                if missing is not None:
                    angle_athwart[i, missing] = np.nan
                    angle_along[i, missing] = np.nan
            for out_name, src in src_names.items():
                per_ping[out_name][i, rows] = pd[src][ch]
            per_ping["sample_time_offset"][i, rows] = (
                np.asarray(pd["offset"][ch]) * np.asarray(pd["sample_interval"][ch])
            )
            data_type[i, rows] = np.asarray(pd["mode"][ch], dtype="i1")
            channel_mode[i, rows] = np.asarray(pd["transmit_mode"][ch], dtype="i1")
            any_missing = any_missing or missing is not None

        if any_missing:
            # xarray parity: the reference assembles data_type/channel_mode
            # per channel as np.byte on that channel's own ping rows
            # (set_groups_ek60.py:615-641); the outer-join merge across
            # channels promotes them to float64 with NaN at uncovered pings
            covered_all = np.zeros((n_ch, n_t), dtype=bool)
            for i, ch in enumerate(self.sorted_channel):
                covered_all[i, self.time_map[ch]] = True
            data_type = np.where(covered_all, data_type.astype("f8"), np.nan)
            channel_mode = np.where(covered_all, channel_mode.astype("f8"), np.nan)

        def ch_param(name, default=np.nan):
            return np.asarray(
                [cfg["transceivers"][ch].get(name, default) for ch in self.sorted_channel],
                dtype="f8",
            )

        dir_x, dir_y, dir_z = ch_param("dir_x"), ch_param("dir_y"), ch_param("dir_z")
        zero_dir = np.isclose(dir_x, 0) & np.isclose(dir_y, 0) & np.isclose(dir_z, 0)
        dir_x[zero_dir] = np.nan
        dir_y[zero_dir] = np.nan
        dir_z[zero_dir] = np.nan

        bv = self._varattrs["beam_var_default"]
        ds = Dataset(
            {
                "frequency_nominal": (
                    ("channel",),
                    np.asarray(self.freq, dtype="f8"),
                    self._varattrs["platform_var_default"]["frequency_nominal"],
                ),
                "beam_type": (
                    ("channel",),
                    np.asarray(
                        [cfg["transceivers"][ch].get("beam_type", 0) for ch in self.sorted_channel],
                        dtype="i8",
                    ),
                    {"long_name": "type of transducer (0-single, 1-split)"},
                ),
                "beamwidth_twoway_alongship": (
                    ("channel",),
                    ch_param("beamwidth_alongship"),
                    {
                        "long_name": "Half power two-way beam width along alongship axis of beam",
                        "units": "arc_degree",
                    },
                ),
                "beamwidth_twoway_athwartship": (
                    ("channel",),
                    ch_param("beamwidth_athwartship"),
                    {
                        "long_name": "Half power two-way beam width along athwartship axis of beam",
                        "units": "arc_degree",
                    },
                ),
                "beam_direction_x": (("channel",), dir_x, {"units": "1"}),
                "beam_direction_y": (("channel",), dir_y, {"units": "1"}),
                "beam_direction_z": (("channel",), dir_z, {"units": "1"}),
                "angle_offset_alongship": (
                    ("channel",),
                    ch_param("angle_offset_alongship"),
                    {"long_name": "electrical alongship angle offset of the transducer"},
                ),
                "angle_offset_athwartship": (
                    ("channel",),
                    ch_param("angle_offset_athwartship"),
                    {"long_name": "electrical athwartship angle offset of the transducer"},
                ),
                "angle_sensitivity_alongship": (
                    ("channel",),
                    ch_param("angle_sensitivity_alongship"),
                    {"long_name": "alongship angle sensitivity of the transducer"},
                ),
                "angle_sensitivity_athwartship": (
                    ("channel",),
                    ch_param("angle_sensitivity_athwartship"),
                    {"long_name": "athwartship angle sensitivity of the transducer"},
                ),
                "equivalent_beam_angle": (
                    ("channel",),
                    ch_param("equivalent_beam_angle"),
                    bv["equivalent_beam_angle"],
                ),
                "gain_correction": (
                    ("channel",),
                    ch_param("gain"),
                    {"long_name": "Gain correction", "units": "dB"},
                ),
                "gpt_software_version": (
                    ("channel",),
                    np.asarray(
                        [
                            cfg["transceivers"][ch].get("gpt_software_version", "")
                            for ch in self.sorted_channel
                        ],
                        dtype=object,
                    ),
                ),
                "transmit_frequency_start": (
                    ("channel",),
                    np.asarray(self.freq, dtype="f8"),
                    bv["transmit_frequency_start"],
                ),
                "transmit_frequency_stop": (
                    ("channel",),
                    np.asarray(self.freq, dtype="f8"),
                    bv["transmit_frequency_stop"],
                ),
                "sample_interval": (
                    ("channel", "ping_time"),
                    per_ping["sample_interval"],
                    bv["sample_interval"],
                ),
                "transmit_bandwidth": (
                    ("channel", "ping_time"),
                    per_ping["transmit_bandwidth"],
                    {
                        "long_name": "Nominal bandwidth of transmitted pulse",
                        "units": "Hz",
                        "valid_min": 0.0,
                    },
                ),
                "transmit_duration_nominal": (
                    ("channel", "ping_time"),
                    per_ping["transmit_duration_nominal"],
                    bv["transmit_duration_nominal"],
                ),
                "transmit_power": (
                    ("channel", "ping_time"),
                    per_ping["transmit_power"],
                    bv["transmit_power"],
                ),
                "sample_time_offset": (
                    ("channel", "ping_time"),
                    per_ping["sample_time_offset"],
                    {
                        "long_name": "Time offset that is subtracted from the timestamp of each sample",  # noqa: E501
                        "units": "s",
                    },
                ),
                "data_type": (
                    ("channel", "ping_time"),
                    data_type,
                    {
                        "long_name": "recorded data type (1=power only, 2=angle only, 3=power and angle)"  # noqa: E501
                    },
                ),
                "channel_mode": (
                    ("channel", "ping_time"),
                    channel_mode,
                    {"long_name": "Transceiver mode", "comment": "From transmit_mode in the EK60 datagram"},
                ),
                "backscatter_r": (
                    ("channel", "ping_time", "range_sample"),
                    backscatter,
                    {**bv["backscatter_r"], "units": "dB"},
                ),
                "transmit_type": ((), "CW", {"long_name": "Type of transmitted pulse"}),
                "beam_stabilisation": ((), np.int8(0), {"long_name": "Beam stabilisation applied (or not)"}),
                "non_quantitative_processing": (
                    (),
                    np.int16(0),
                    {"long_name": "Presence or not of non-quantitative processing applied to the backscattering data"},  # noqa: E501
                ),
            },
            coords={
                "channel": (
                    ("channel",),
                    self.channel_labels,
                    self._varattrs["beam_coord_default"]["channel"],
                ),
                "ping_time": (
                    ("ping_time",),
                    self.union_time,
                    self._varattrs["beam_coord_default"]["ping_time"],
                ),
                "range_sample": (
                    ("range_sample",),
                    np.arange(max_range),
                    self._varattrs["beam_coord_default"]["range_sample"],
                ),
            },
            attrs={"beam_mode": "vertical", "conversion_equation_t": "type_3"},
        )
        if has_angle:
            ds["angle_athwartship"] = (
                ("channel", "ping_time", "range_sample"),
                angle_athwart,
                {"long_name": "electrical athwartship angle"},
            )
            ds["angle_alongship"] = (
                ("channel", "ping_time", "range_sample"),
                angle_along,
                {"long_name": "electrical alongship angle"},
            )
        return [ds]

    # --------------------------------------------------------- group: vendor
    def set_vendor(self) -> Dataset:
        cfg = self.parser_obj.config_datagram
        pulse_length = np.stack(
            [cfg["transceivers"][ch]["pulse_length_table"] for ch in self.sorted_channel]
        )
        gain = np.stack([cfg["transceivers"][ch]["gain_table"] for ch in self.sorted_channel])
        sa = np.stack(
            [cfg["transceivers"][ch]["sa_correction_table"] for ch in self.sorted_channel]
        )
        ds = Dataset(
            {
                "frequency_nominal": (
                    ("channel",),
                    np.asarray(self.freq, dtype="f8"),
                    self._varattrs["platform_var_default"]["frequency_nominal"],
                ),
                "sa_correction": (("channel", "pulse_length_bin"), sa),
                "gain_correction": (("channel", "pulse_length_bin"), gain),
                "pulse_length": (("channel", "pulse_length_bin"), pulse_length),
            },
            coords={
                "channel": (
                    ("channel",),
                    self.channel_labels,
                    self._varattrs["beam_coord_default"]["channel"],
                ),
                "pulse_length_bin": np.arange(pulse_length.shape[1]),
            },
        )
        ds = self._add_seafloor_detection_data_to_vendor_ds(ds, self.sorted_channel)
        return ds
