"""EK80 group assembly: up to 3 beam groups split by waveform/encode mode.

Capability parity: echopype/convert/set_groups_ek80.py:21-1520 — complex
channels' pings split into FM (LFM) and CW groups; power channels form their
own group; Sonar group carries ``waveform_encode_descr``; Vendor_specific
holds narrowband tables, impedance/fs/transceiver type, broadband cal curves
on ``cal_frequency``, and WBT/PC filter coefficients + decimation on
``filter_time``.
"""

from __future__ import annotations

import warnings

import numpy as np
import torch

from ..utils.log import _init_logger
from ..utils.profiling import count, stage
from ..xrlite import DataArray, Dataset
from .set_groups_base import SetGroupsBase

logger = _init_logger(__name__)

WIDE_BAND_TRANS = "WBT"
PULSE_COMPRESS = "PC"
FILTER_IMAG = "coeffs_imag"
FILTER_REAL = "coeffs_real"
DECIMATION = "deci_fac"

PULSE_FORM_MAP = np.array(["CW", "LFM", "", "", "", "FMD"])


class SetGroupsEK80(SetGroupsBase):
    beamgroups_possible = [
        {"name": "Beam_group1", "descr": "first beam group"},
        {"name": "Beam_group2", "descr": "second beam group"},
        {"name": "Beam_group3", "descr": "third beam group"},
    ]

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        p = self.parser_obj
        self.config = {
            k: v for k, v in p.config_datagram["configuration"].items() if not k.startswith("_")
        }
        self.sorted_channel = {
            "power": sorted(p.ch_ids["power"]),
            "complex": sorted(p.ch_ids["complex"]),
        }
        self.sorted_channel["all"] = sorted(p.ch_ids["power"] + p.ch_ids["complex"])
        self.beam_group_map = {}
        #: whether set_beam widens the complex samples into their groups
        self.fill_complex = True

    # ------------------------------------------------------------------- env
    def set_env(self) -> Dataset:
        env = self.parser_obj.environment
        ds = Dataset()
        name_map = {
            "depth": "depth",
            "acidity": "acidity",
            "salinity": "salinity",
            "temperature": "temperature",
            "sound_speed": "sound_speed_indicative",
        }
        for src, dst in name_map.items():
            if src in env:
                ds[dst] = ((), np.float64(env[src]))
        if "sound_velocity_profile" in env:
            svp = np.asarray(env["sound_velocity_profile"], dtype="f8")
            ds["sound_velocity_profile"] = (
                ("sound_velocity_profile_depth",),
                svp[1::2] if svp.size % 2 == 0 else svp,
                {"long_name": "sound velocity profile"},
            )
        for extra in ("drop_keel_offset", "water_level_draft", "transducer_sound_speed"):
            if extra in env:
                ds[extra] = ((), np.float64(env[extra]))
        if "timestamp" in env:
            ds.attrs["environment_time"] = str(env["timestamp"])
        return ds

    # ----------------------------------------------------------------- sonar
    def set_sonar(self, beam_group_type=None) -> Dataset:
        names = [f"Beam_group{i}" for i in sorted(self.beam_group_map)]
        descr_map = {
            "complex_FM": (
                "contains complex backscatter data and other beam or channel-specific data"
            ),
            "complex_CW": (
                "contains CW-only complex backscatter data and other beam or channel-specific data"
            ),
            "power": (
                "contains backscatter power (uncalibrated) and other beam or channel-specific data"
            ),
        }
        modes = [self.beam_group_map[i] for i in sorted(self.beam_group_map)]
        ds = Dataset(
            {
                "beam_group_descr": (
                    ("beam_group",),
                    np.asarray([descr_map[m] for m in modes], dtype=object),
                ),
                "waveform_encode_descr": (
                    ("beam_group",),
                    np.asarray(modes, dtype=object),
                    {"long_name": "Waveform and encode mode of a beam group"},
                ),
            },
            coords={"beam_group": np.asarray(names, dtype=object)},
            attrs={
                "sonar_manufacturer": "Simrad",
                "sonar_model": self.sonar_model,
                "sonar_serial_number": "",
                "sonar_software_name": "EK80",
                "sonar_software_version": self.config.get("_header", {}).get(
                    "application_version", ""
                ),
                "sonar_type": "echosounder",
            },
        )
        return ds

    # -------------------------------------------------------------- platform
    def set_platform(self) -> Dataset:
        time1, msg_type, lat, lon = self._extract_NMEA_latlon()
        time1 = self._nan_timestamp_handler(time1)
        if len(lat) == 0:
            lat, lon = np.array([np.nan]), np.array([np.nan])
            msg_type = np.array([""], dtype=object)

        pv = self._varattrs["platform_var_default"]
        chans = self.sorted_channel["all"]
        freq = np.asarray(
            [self.config[ch].get("transducer_frequency", np.nan) for ch in chans], dtype="f8"
        )

        # MRU streams are ALWAYS materialized (reference set_groups_ek80.py
        # :328-536): a missing stream becomes a single-NaN row whose time2/
        # time3 stamp borrows the earliest first-ping time, so every EK80
        # Platform carries the full variable set
        def mru_field(d, key):
            vals = np.asarray(d.get(key) if d.get(key) is not None else [], dtype="f8")
            return vals if vals.size else np.array([np.nan])

        mru0 = self.parser_obj.mru0
        mru1 = self.parser_obj.mru1
        t2 = np.asarray(mru0.get("timestamp") if mru0.get("timestamp") is not None else [])
        time2 = self._nan_timestamp_handler(t2 if t2.size else [np.nan])
        t3 = np.asarray(mru1.get("timestamp") if mru1.get("timestamp") is not None else [])
        time3 = self._nan_timestamp_handler(t3 if t3.size else [np.nan])

        env = self.parser_obj.environment
        if "water_level_draft" in env:
            water_level = np.float64(env["water_level_draft"])
        else:
            water_level = np.float64(np.nan)
            logger.info("WARNING: The water_level_draft was not in the file. Value set to NaN.")

        latlon_mru1_comment = {
            "comment": "Derived from the Simrad MRU1 Datagrams which are "
            "a wrapper of the Kongsberg Maritime Binary Datagrams."
        }
        ds = Dataset(
            {
                "latitude": (("time1",), lat, pv["latitude"]),
                "longitude": (("time1",), lon, pv["longitude"]),
                "sentence_type": (("time1",), msg_type, pv["sentence_type"]),
                "pitch": (("time2",), mru_field(mru0, "pitch"), pv["pitch"]),
                "roll": (("time2",), mru_field(mru0, "roll"), pv["roll"]),
                "vertical_offset": (
                    ("time2",),
                    mru_field(mru0, "heave"),
                    pv["vertical_offset"],
                ),
                "water_level": ((), water_level, pv["water_level"]),
                "drop_keel_offset": ((), np.float64(env.get("drop_keel_offset", np.nan))),
                "drop_keel_offset_is_manual": (
                    (),
                    np.float64(env.get("drop_keel_offset_is_manual", np.nan)),
                ),
                "water_level_draft_is_manual": (
                    (),
                    np.float64(env.get("water_level_draft_is_manual", np.nan)),
                ),
                "frequency_nominal": (("channel",), freq, pv["frequency_nominal"]),
                "heading": (
                    ("time2",),
                    mru_field(mru0, "heading"),
                    {
                        "long_name": "Platform heading (true)",
                        "standard_name": "platform_orientation",
                        "units": "degrees_north",
                        "valid_min": 0.0,
                        "valid_max": 360.0,
                    },
                ),
                "latitude_mru1": (
                    ("time3",),
                    mru_field(mru1, "latitude"),
                    {**pv["latitude"], **latlon_mru1_comment},
                ),
                "longitude_mru1": (
                    ("time3",),
                    mru_field(mru1, "longitude"),
                    {**pv["longitude"], **latlon_mru1_comment},
                ),
                **{
                    f"transducer_offset_{x}": (
                        ("channel",),
                        np.asarray(
                            [self.config[ch].get(f"transducer_offset_{x}", np.nan) for ch in chans],
                            dtype="f8",
                        ),
                        pv[f"transducer_offset_{x}"],
                    )
                    for x in ("x", "y", "z")
                },
                **{
                    var: ((), np.float64(np.nan), pv[var])
                    for var in (
                        "MRU_offset_x",
                        "MRU_offset_y",
                        "MRU_offset_z",
                        "MRU_rotation_x",
                        "MRU_rotation_y",
                        "MRU_rotation_z",
                        "position_offset_x",
                        "position_offset_y",
                        "position_offset_z",
                    )
                },
            },
            coords={
                "channel": (
                    ("channel",),
                    np.asarray(chans, dtype=object),
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
                    np.asarray(time2, dtype="datetime64[ns]"),
                    {
                        "axis": "T",
                        "long_name": "Timestamps for platform motion and orientation data",
                        "standard_name": "time",
                        "comment": "Time coordinate corresponding to platform motion and "
                        "orientation data.",
                    },
                ),
                "time3": (
                    ("time3",),
                    np.asarray(time3, dtype="datetime64[ns]"),
                    {
                        "axis": "T",
                        "long_name": "Timestamps for platform motion and orientation data "
                        "from the Kongsberg Maritime Binary Datagram",
                        "standard_name": "time",
                        "comment": "Time coordinate corresponding to platform motion and "
                        "orientation data from the Kongsberg Maritime Binary Datagram.",
                    },
                ),
            },
            attrs=self._platform_attrs(),
        )
        ds = self._add_index_data_to_platform_ds(ds)
        return ds

    # ------------------------------------------------------------------ beam
    def _ping_invariant(self, chans):
        """Channel-invariant beam metadata from the XML config."""
        def cfgval(ch, *names, default=np.nan):
            for n in names:
                if n in self.config[ch]:
                    return self.config[ch][n]
            return default

        bv = self._varattrs["beam_var_default"]
        pv = self._varattrs["platform_var_default"]
        data = {
            "frequency_nominal": (
                ("channel",),
                np.asarray([cfgval(ch, "transducer_frequency") for ch in chans], dtype="f8"),
                pv["frequency_nominal"],
            ),
            "beam_type": (
                ("channel",),
                np.asarray(
                    [cfgval(ch, "transducer_beam_type", default=0) for ch in chans], dtype="i8"
                ),
            ),
            "beamwidth_twoway_alongship": (
                ("channel",),
                np.asarray([cfgval(ch, "beam_width_alongship") for ch in chans], dtype="f8"),
                {"long_name": "Half power two-way beam width along alongship axis of beam",
                 "units": "arc_degree"},
            ),
            "beamwidth_twoway_athwartship": (
                ("channel",),
                np.asarray([cfgval(ch, "beam_width_athwartship") for ch in chans], dtype="f8"),
                {"long_name": "Half power two-way beam width along athwartship axis of beam",
                 "units": "arc_degree"},
            ),
            "angle_offset_alongship": (
                ("channel",),
                np.asarray([cfgval(ch, "angle_offset_alongship") for ch in chans], dtype="f8"),
            ),
            "angle_offset_athwartship": (
                ("channel",),
                np.asarray([cfgval(ch, "angle_offset_athwartship") for ch in chans], dtype="f8"),
            ),
            "angle_sensitivity_alongship": (
                ("channel",),
                np.asarray([cfgval(ch, "angle_sensitivity_alongship") for ch in chans], dtype="f8"),
            ),
            "angle_sensitivity_athwartship": (
                ("channel",),
                np.asarray(
                    [cfgval(ch, "angle_sensitivity_athwartship") for ch in chans], dtype="f8"
                ),
            ),
            "equivalent_beam_angle": (
                ("channel",),
                np.asarray([cfgval(ch, "equivalent_beam_angle") for ch in chans], dtype="f8"),
                bv["equivalent_beam_angle"],
            ),
            "transducer_offset_x": (
                ("channel",),
                np.asarray([cfgval(ch, "transducer_offset_x") for ch in chans], dtype="f8"),
            ),
            "transducer_offset_y": (
                ("channel",),
                np.asarray([cfgval(ch, "transducer_offset_y") for ch in chans], dtype="f8"),
            ),
            "transducer_offset_z": (
                ("channel",),
                np.asarray([cfgval(ch, "transducer_offset_z") for ch in chans], dtype="f8"),
            ),
        }
        return data

    def set_beam(self) -> list:
        """The beam groups in order.  With :attr:`fill_complex` False the
        complex groups come without their samples, and
        :attr:`complex_layouts` holds each one's :class:`ComplexLayout` by
        its position in the returned list."""
        groups = []  # (mode_name, dataset)
        self.complex_layouts = {}

        # ---- complex channels split by FM / CW
        complex_ch = self.sorted_channel["complex"]
        if complex_ch:
            for mode, want in (("complex_FM", "LFM"), ("complex_CW", "CW")):
                with stage("ek80_beam_complex"):
                    ds, layout = self._assemble_complex_group(complex_ch, want,
                                                              fill=self.fill_complex)
                if ds is not None:
                    if not self.fill_complex:
                        self.complex_layouts[len(groups)] = layout
                    groups.append((mode, ds))
        power_ch = self.sorted_channel["power"]
        if power_ch:
            ds = self._assemble_power_group(power_ch)
            if ds is not None:
                groups.append(("power", ds))

        self.beam_group_map = {i + 1: mode for i, (mode, _) in enumerate(groups)}
        return [ds for _, ds in groups]

    def _transmit_types(self, ch):
        pf = np.asarray(self.parser_obj.ping_data_dict["pulse_form"][ch])
        pf = np.nan_to_num(pf.astype("f8"), nan=0.0).astype("i8")
        return PULSE_FORM_MAP[np.clip(pf, 0, len(PULSE_FORM_MAP) - 1)]

    @staticmethod
    def _dedup_rows(times, rows, ch, data_check=None):
        """Drop duplicate ping_time rows keeping the first occurrence.

        Mirrors utils/ek_duplicates.py:6 + set_groups_ek80.py:1157-1162:
        warn when the duplicate slices carry differing data before dedup.
        """
        _, first_idx = np.unique(times, return_index=True)
        if len(first_idx) == len(times):
            return times, rows
        keep = np.sort(first_idx)
        if data_check is not None:

            dup_mask = np.ones(len(times), dtype=bool)
            dup_mask[keep] = False
            for d in np.nonzero(dup_mask)[0]:
                k = np.nonzero(times == times[d])[0][0]
                if not np.array_equal(
                    data_check[rows[d]], data_check[rows[k]], equal_nan=True
                ):
                    logger.warning(
                        "Duplicate ping_time %s in channel %s carries differing data; "
                        "keeping the first occurrence.",
                        times[d],
                        ch,
                    )
                    break
        return times[keep], rows[keep]

    def _assemble_complex_group(self, chans, want_type, fill=True):
        """The complex group of ``chans``' pings of transmit type
        ``want_type`` and its :class:`ComplexLayout`, or (None, None).
        ``fill`` widens the samples into ``backscatter_r`` / ``_i``;
        without it the group has neither, and ``layout.fill(ds)`` adds them."""
        p = self.parser_obj
        sel_times = {}
        sel_rows = {}
        for ch in chans:
            tt = self._transmit_types(ch)
            rows = np.nonzero(tt == want_type)[0]
            if len(rows):
                times, rows = self._dedup_rows(
                    p.ping_time[ch][rows], rows, ch,
                    data_check=p.ping_data_dict["complex"][ch]["real"],
                )
                sel_times[ch] = times
                sel_rows[ch] = rows
        if not sel_times:
            return None, None
        union_time, time_map = self.union_times(sel_times)
        n_t = len(union_time)
        chans_used = list(sel_times)
        self._group_chans = chans_used
        comp = p.ping_data_dict["complex"]
        layout = ComplexLayout(
            chans_used, union_time,
            [(comp[ch]["real"], comp[ch]["imag"], complex_runs(sel_rows[ch], time_map[ch]))
             for ch in chans_used],
            attrs=[self._varattrs["beam_var_default"][k] for k in ("backscatter_r",
                                                                    "backscatter_i")],
        )
        arrays = {}
        tx_type = np.full((len(chans_used), n_t), "", dtype=object)
        f_start = np.full((len(chans_used), n_t), np.nan)
        f_stop = np.full((len(chans_used), n_t), np.nan)
        for ci, ch in enumerate(chans_used):
            rows_src = sel_rows[ch]
            rows_dst = time_map[ch]
            self._per_ping_vars_subset(ch, rows_src, rows_dst, n_t, arrays, len(chans_used))
            tx_type[ci, rows_dst] = want_type
            if want_type == "LFM":
                fs = np.asarray(p.ping_data_dict["frequency_start"][ch], dtype="f8")[rows_src]
                fe = np.asarray(p.ping_data_dict["frequency_end"][ch], dtype="f8")[rows_src]
                f_start[ci, rows_dst] = fs
                f_stop[ci, rows_dst] = fe
            else:
                freq = np.asarray(p.ping_data_dict["frequency"][ch], dtype="f8")[rows_src]
                if np.all(np.isnan(freq)):
                    freq = np.full(len(rows_src), self.config[ch].get("transducer_frequency", np.nan))
                f_start[ci, rows_dst] = freq
                f_stop[ci, rows_dst] = freq

        ds = self._build_group_ds(
            chans_used, union_time, arrays, tx_type, f_start, f_stop, layout.max_r,
            freq_ramp="per_ping" if want_type == "LFM" else "none",
        )
        if fill:
            layout.fill(ds)
        ds.coords["beam"] = DataArray(
            np.arange(1, layout.n_beam + 1).astype(str).astype(object), ("beam",),
            attrs=self._varattrs["beam_coord_default"]["beam"], name="beam",
        )
        ds = self._add_transmit_pulse_complex(ds, chans_used, sel_rows, time_map, n_t)
        return ds, layout

    def _add_transmit_pulse_complex(self, ds, chans_used, sel_rows, time_map, n_t):
        """RAW4 transmit pulse -> transmit_pulse_r/i on transmit_sample
        (set_groups_ek80.py:842-905)."""
        tx = self.parser_obj.ping_data_dict_tx.get("complex", {})
        present = [ch for ch in chans_used if ch in tx]
        if not present:
            return ds
        max_s = max(tx[ch]["real"].shape[1] for ch in present)
        shape = (len(chans_used), n_t, max_s)
        tr = np.full(shape, np.nan)
        ti = np.full(shape, np.nan)
        for ci, ch in enumerate(chans_used):
            if ch not in tx:
                continue
            real = tx[ch]["real"]
            imag = tx[ch]["imag"]
            if real.ndim == 3:  # sector dim present: use the first sector
                real, imag = real[..., 0], imag[..., 0]
            rows_src = sel_rows[ch]
            rows_src = rows_src[rows_src < real.shape[0]]
            rows_dst = time_map[ch][: len(rows_src)]
            tr[ci, rows_dst, : real.shape[1]] = real[rows_src]
            ti[ci, rows_dst, : imag.shape[1]] = imag[rows_src]
        ds.coords["transmit_sample"] = DataArray(
            np.arange(max_s),
            ("transmit_sample",),
            attrs={
                "long_name": "Transmit pulse sample number, base 0",
                "comment": "Only exist for Simrad EK80 file with RAW4 datagrams",
            },
            name="transmit_sample",
        )
        ds["transmit_pulse_r"] = (
            ("channel", "ping_time", "transmit_sample"),
            tr,
            {"long_name": "Real part of the transmit pulse", "units": "V"},
        )
        ds["transmit_pulse_i"] = (
            ("channel", "ping_time", "transmit_sample"),
            ti,
            {"long_name": "Imaginary part of the transmit pulse", "units": "V"},
        )
        return ds

    def _assemble_power_group(self, chans):
        p = self.parser_obj
        sel_times, sel_rows = {}, {}
        for ch in chans:
            if p.ping_data_dict["power"].get(ch) is None:
                continue
            rows = np.arange(len(p.ping_time[ch]))
            times, rows = self._dedup_rows(
                p.ping_time[ch], rows, ch, data_check=p.ping_data_dict["power"][ch]
            )
            sel_times[ch] = times
            sel_rows[ch] = rows
        if not sel_times:
            return None
        union_time, time_map = self.union_times(sel_times)
        n_t = len(union_time)
        chans_used = list(sel_times)
        self._group_chans = chans_used
        max_r = max(p.ping_data_dict["power"][ch].shape[1] for ch in chans_used)
        # np.empty + targeted NaN fill (see set_beam_complex / EK60 set_beam)
        bs = np.empty((len(chans_used), n_t, max_r), dtype="f4")
        has_angle = any(p.ping_data_dict["angle"].get(ch) is not None for ch in chans_used)
        ang_at = np.empty((len(chans_used), n_t, max_r), dtype="f4") if has_angle else None
        ang_al = np.empty((len(chans_used), n_t, max_r), dtype="f4") if has_angle else None
        arrays = {}
        tx_type = np.full((len(chans_used), n_t), "", dtype=object)
        f_start = np.full((len(chans_used), n_t), np.nan)
        f_stop = np.full((len(chans_used), n_t), np.nan)
        for ci, ch in enumerate(chans_used):
            rows_src = sel_rows[ch]
            rows_dst = time_map[ch]
            # index by the dedup-kept rows: with duplicate ping_times dropped,
            # rows_src is a strict subset and the raw arrays are longer than
            # the destination (keep-first, utils/ek_duplicates.py semantics)
            pw = p.ping_data_dict["power"][ch][rows_src]
            covered = np.zeros(n_t, dtype=bool)
            covered[rows_dst] = True
            missing = ~covered if not covered.all() else None
            bs[ci, rows_dst, : pw.shape[1]] = pw
            if pw.shape[1] < max_r:
                bs[ci, rows_dst, pw.shape[1] :] = np.nan
            if missing is not None:
                bs[ci, missing] = np.nan
            ang = p.ping_data_dict["angle"].get(ch)
            if ang is not None:
                ang = ang[rows_src]
            if has_angle and ang is None:
                ang_at[ci] = np.nan
                ang_al[ci] = np.nan
            elif ang is not None:
                ang_at[ci, rows_dst, : ang.shape[1]] = ang[:, :, 0]
                ang_al[ci, rows_dst, : ang.shape[1]] = ang[:, :, 1]
                if ang.shape[1] < max_r:
                    ang_at[ci, rows_dst, ang.shape[1] :] = np.nan
                    ang_al[ci, rows_dst, ang.shape[1] :] = np.nan
                if missing is not None:
                    ang_at[ci, missing] = np.nan
                    ang_al[ci, missing] = np.nan
            self._per_ping_vars_subset(ch, rows_src, rows_dst, n_t, arrays, len(chans_used))
            tx_type[ci, rows_dst] = self._transmit_types(ch)[rows_src]
            freq = np.asarray(p.ping_data_dict["frequency"][ch], dtype="f8")[rows_src]
            if np.all(np.isnan(freq)):
                freq = np.full(len(rows_src), self.config[ch].get("transducer_frequency", np.nan))
            f_start[ci, rows_dst] = freq
            f_stop[ci, rows_dst] = freq

        ds = self._build_group_ds(
            chans_used, union_time, arrays, tx_type, f_start, f_stop, max_r,
            freq_ramp="per_channel",
        )
        ds["backscatter_r"] = (
            ("channel", "ping_time", "range_sample"),
            bs,
            {**self._varattrs["beam_var_default"]["backscatter_r"], "units": "dB"},
        )
        if has_angle:
            ds["angle_athwartship"] = (
                ("channel", "ping_time", "range_sample"),
                ang_at,
                {"long_name": "electrical athwartship angle"},
            )
            ds["angle_alongship"] = (
                ("channel", "ping_time", "range_sample"),
                ang_al,
                {"long_name": "electrical alongship angle"},
            )
        return ds

    def _per_ping_vars_subset(self, ch, rows_src, rows_dst, n_t, arrays, n_ch):
        pd = self.parser_obj.ping_data_dict
        field_map = {
            "sample_interval": "sample_interval",
            "transmit_duration_nominal": "pulse_duration",
            "transmit_power": "transmit_power",
            "slope": "slope",
        }
        for out_name, src in field_map.items():
            vals = pd[src].get(ch)
            if vals is None:
                continue
            arr = arrays.setdefault(out_name, np.full((n_ch, n_t), np.nan))
            arr[self._group_chans.index(ch), rows_dst] = np.asarray(vals, dtype="f8")[rows_src]

    def _build_group_ds(
        self, chans, union_time, arrays, tx_type, f_start, f_stop, max_r,
        freq_ramp="per_ping",
    ):
        bv = self._varattrs["beam_var_default"]
        ds = Dataset(
            coords={
                "channel": (
                    ("channel",),
                    np.asarray(chans, dtype=object),
                    self._varattrs["beam_coord_default"]["channel"],
                ),
                "ping_time": (
                    ("ping_time",),
                    union_time,
                    self._varattrs["beam_coord_default"]["ping_time"],
                ),
                "range_sample": (
                    ("range_sample",),
                    np.arange(max_r),
                    self._varattrs["beam_coord_default"]["range_sample"],
                ),
            },
            attrs={"beam_mode": "vertical", "conversion_equation_t": "type_3"},
        )
        for name, arr in self._ping_invariant(chans).items():
            ds[name] = arr
        for name, arr in arrays.items():
            attrs = bv.get(name, {})
            ds[name] = (("channel", "ping_time"), arr, attrs)
        ds["transmit_type"] = (
            ("channel", "ping_time"),
            tx_type,
            {"long_name": "Type of transmitted pulse", "flag_values": ["CW", "LFM", "FMD"]},
        )
        # frequency ramp vars follow the reference's placement
        # (set_groups_ek80.py:735-790): per-ping for FM complex groups,
        # per-channel for power groups, ABSENT for CW-complex groups (the
        # raw CW pings carry no frequency_start/end fields)
        if freq_ramp == "per_ping":
            ds["transmit_frequency_start"] = (
                ("channel", "ping_time"),
                f_start,
                bv["transmit_frequency_start"],
            )
            ds["transmit_frequency_stop"] = (
                ("channel", "ping_time"),
                f_stop,
                bv["transmit_frequency_stop"],
            )
        elif freq_ramp == "per_channel":
            # per-channel value = the config transducer_frequency (reference:
            # set_groups_ek80.py:547-551), NOT a mean of per-ping datagram
            # frequencies (which may differ, e.g. LFM power pings)
            freq = np.array(
                [
                    float(self.config.get(ch, {}).get("transducer_frequency", np.nan))
                    for ch in chans
                ]
            )
            ds["transmit_frequency_start"] = (
                ("channel",), freq, bv["transmit_frequency_start"]
            )
            ds["transmit_frequency_stop"] = (
                ("channel",), freq.copy(), bv["transmit_frequency_stop"]
            )
        return ds

    # ---------------------------------------------------------------- vendor
    def set_vendor(self) -> Dataset:
        chans = self.sorted_channel["all"]
        cfg = self.config

        def table(name):
            rows = [np.atleast_1d(np.asarray(cfg[ch].get(name, [np.nan]), dtype="f8")) for ch in chans]
            width = max(len(r) for r in rows)
            out = np.full((len(chans), width), np.nan)
            for i, r in enumerate(rows):
                out[i, : len(r)] = r
            return out

        pulse_length = table("pulse_duration")
        gain = table("gain")
        sa = table("sa_correction")

        ds = Dataset(
            {
                "frequency_nominal": (
                    ("channel",),
                    np.asarray(
                        [cfg[ch].get("transducer_frequency", np.nan) for ch in chans], dtype="f8"
                    ),
                    self._varattrs["platform_var_default"]["frequency_nominal"],
                ),
                "sa_correction": (("channel", "pulse_length_bin"), sa),
                "gain_correction": (("channel", "pulse_length_bin"), gain),
                "pulse_length": (("channel", "pulse_length_bin"), pulse_length),
            },
            coords={
                "channel": (
                    ("channel",),
                    np.asarray(chans, dtype=object),
                    self._varattrs["beam_coord_default"]["channel"],
                ),
                "pulse_length_bin": np.arange(pulse_length.shape[1]),
            },
        )
        if any("impedance" in cfg[ch] for ch in chans):
            ds["impedance_transceiver"] = (
                ("channel",),
                np.asarray([cfg[ch].get("impedance", np.nan) for ch in chans], dtype="f8"),
                {"units": "ohm", "long_name": "Transceiver impedance"},
            )
        if any("rx_sample_frequency" in cfg[ch] for ch in chans):
            ds["receiver_sampling_frequency"] = (
                ("channel",),
                np.asarray(
                    [float(cfg[ch].get("rx_sample_frequency", np.nan)) for ch in chans], dtype="f8"
                ),
                {"units": "Hz", "long_name": "Receiver sampling frequency"},
            )
        if any("transceiver_type" in cfg[ch] for ch in chans):
            ds["transceiver_type"] = (
                ("channel",),
                np.asarray([cfg[ch].get("transceiver_type", "") for ch in chans], dtype=object),
                {"long_name": "Transceiver type"},
            )

        # broadband calibration curves
        cal_chans = [ch for ch in chans if "calibration" in cfg[ch]]
        if cal_chans:
            freqs = sorted(
                set(np.concatenate([cfg[ch]["calibration"]["frequency"] for ch in cal_chans]))
            )
            freqs = np.asarray(freqs, dtype="f8")
            ds.coords["cal_frequency"] = DataArray(
                freqs,
                ("cal_frequency",),
                attrs={"long_name": "Frequency of calibration parameter", "units": "Hz"},
                name="cal_frequency",
            )
            ds.coords["cal_channel_id"] = DataArray(
                np.asarray(cal_chans, dtype=object),
                ("cal_channel_id",),
                attrs={"long_name": "ID of channels containing broadband calibration information"},
                name="cal_channel_id",
            )
            for p_name in (
                "gain",
                "impedance",
                "phase",
                "beamwidth_alongship",
                "beamwidth_athwartship",
                "angle_offset_alongship",
                "angle_offset_athwartship",
            ):
                vals = np.full((len(cal_chans), len(freqs)), np.nan)
                found = False
                for i, ch in enumerate(cal_chans):
                    cal = cfg[ch]["calibration"]
                    if p_name in cal:
                        found = True
                        idx = np.searchsorted(freqs, np.asarray(cal["frequency"], dtype="f8"))
                        vals[i, idx] = cal[p_name]
                if found:
                    out_name = "impedance_transducer" if p_name == "impedance" else p_name
                    ds[out_name] = (("cal_channel_id", "cal_frequency"), vals)

        ds = self._add_filter_params(ds)
        ds = self._add_seafloor_detection_data_to_vendor_ds(
            ds, chans, config_order=list(self.config.keys())
        )
        ds.attrs["config_xml"] = self.parser_obj.config_datagram.get("xml", "")
        return ds

    def _add_filter_params(self, ds: Dataset) -> Dataset:
        fil = self.parser_obj.fil
        stage_type = {1: WIDE_BAND_TRANS, 2: PULSE_COMPRESS}
        times = np.unique(np.asarray(fil["timestamp"], dtype="datetime64[ns]"))
        if len(times) == 0:
            return ds
        ds.coords["filter_time"] = DataArray(
            times, ("filter_time",), attrs={"axis": "T"}, name="filter_time"
        )
        chans = list(ds.coords["channel"].values)
        max_len = {}
        for stage in stage_type:
            lens = [
                len(fil.get((ch, stage, "coeffs", t), []))
                for t in times
                for ch in chans
            ]
            max_len[stage] = max(lens, default=0)
        for stage, name in stage_type.items():
            nf = max(max_len[stage], 1)
            re = np.full((len(chans), len(times), nf), np.nan)
            im = np.full((len(chans), len(times), nf), np.nan)
            deci = np.full((len(chans), len(times)), np.nan)
            for ti, t in enumerate(times):
                for ci, ch in enumerate(chans):
                    coeffs = fil.get((ch, stage, "coeffs", t))
                    if coeffs is not None:
                        re[ci, ti, : len(coeffs)] = np.real(coeffs)
                        im[ci, ti, : len(coeffs)] = np.imag(coeffs)
                    d = fil.get((ch, stage, "deci_fac", t))
                    if d is not None:
                        deci[ci, ti] = d
            ds[f"{name}_{FILTER_REAL}"] = (("channel", "filter_time", f"{name}_filter_n"), re)
            ds[f"{name}_{FILTER_IMAG}"] = (("channel", "filter_time", f"{name}_filter_n"), im)
            ds[f"{name}_{DECIMATION}"] = (("channel", "filter_time"), deci)
        return ds


def complex_runs(rows_src, rows_dst):
    """The runs of a complex group's mapping, int64 [k, 3] of (parser row,
    group ping, length): stretches in which the parser's row and the group's
    ping both advance by one."""
    rows_src, rows_dst = np.asarray(rows_src, "i8"), np.asarray(rows_dst, "i8")
    if not len(rows_src):
        return np.empty((0, 3), "i8")
    cut = np.flatnonzero((np.diff(rows_src) != 1) | (np.diff(rows_dst) != 1)) + 1
    starts, stops = np.r_[0, cut], np.r_[cut, len(rows_src)]
    return np.stack([rows_src[starts], rows_dst[starts], stops - starts], axis=1)


class ComplexLayout:
    """Where each sample of a complex beam group comes from, without the
    group's float64 samples.

    Per channel, the parser's ``real`` / ``imag`` planes ([rows, r, b];
    [rows, r] is one sector) and the runs of :func:`complex_runs`.  The one
    rule both :meth:`fill` and the fused survey's staging apply
    (:meth:`copy_pings`): group ping <- parser row, run by run; a ping no
    row maps to is NaN; range samples >= the channel's ``r`` and sectors >=
    its ``b`` are NaN.  ``planes`` says whether the planes are the parser's
    (a group's own samples otherwise, :meth:`of_group`).
    """

    def __init__(self, channels, ping_time, parts, attrs=({}, {}), planes=True):
        """``parts``: per channel (real, imag, runs)."""
        self.channels = list(channels)
        self.ping_time = ping_time
        self.n_t = len(ping_time)
        self.attrs = attrs
        self.planes = planes
        self.real, self.imag, self.runs = [], [], []
        for real, imag, runs in parts:
            if real.ndim == 2:  # one sector
                real, imag = real[..., None], imag[..., None]
            self.real.append(real)
            self.imag.append(imag)
            self.runs.append(runs)
        self.max_r = max(a.shape[1] for a in self.real)
        self.n_beam = max(a.shape[2] for a in self.real)

    @classmethod
    def of_group(cls, bs_r, bs_i):
        """The layout of a group's own ``backscatter_r`` / ``_i`` ([C, P, R,
        B] or [C, P, R]): one run a channel."""
        n_t = bs_r.shape[1]
        whole = np.array([[0, 0, n_t]], "i8")
        return cls(range(bs_r.shape[0]), np.arange(n_t),
                   [(r, i, whole) for r, i in zip(bs_r, bs_i)], planes=False)

    @property
    def shape(self):
        return (len(self.channels), self.n_t, self.max_r, self.n_beam)

    @property
    def nbytes(self):
        """The bytes of the float64 ``backscatter_r`` and ``_i`` :meth:`fill` makes."""
        return 2 * 8 * int(np.prod(self.shape))

    def select(self, channels, ping_time):
        """The layout of ``channels`` (ids, in that order) over ``ping_time``,
        a contiguous stretch of the group's pings."""
        ping_time = np.asarray(ping_time, dtype=self.ping_time.dtype)
        p0 = int(np.searchsorted(self.ping_time, ping_time[0])) if len(ping_time) else 0
        if not np.array_equal(self.ping_time[p0:p0 + len(ping_time)], ping_time):
            raise ValueError("the pings are no contiguous stretch of the group's")
        parts = []
        for ch in channels:
            ci = self.channels.index(ch)
            runs = self.runs[ci].copy()
            runs[:, 1] -= p0
            parts.append((self.real[ci], self.imag[ci], runs))
        return ComplexLayout(channels, ping_time, parts, self.attrs, self.planes)

    def copy_pings(self, ci, sl, out_r, out_i):
        """Write channel ``ci``'s group pings ``sl`` into ``out_r`` /
        ``out_i`` (tensors [n, max_r, n_beam] of any float dtype; ``copy_``
        converts)."""
        p0, p1 = sl.start, sl.stop
        real, imag = self.real[ci], self.imag[ci]
        r, b = real.shape[1], real.shape[2]
        src0, dst0, n = self.runs[ci].T
        lo, hi = np.maximum(dst0, p0), np.minimum(dst0 + n, p1)
        covered = np.zeros(p1 - p0, dtype=bool)
        with warnings.catch_warnings():  # read-only planes: only ever read
            warnings.simplefilter("ignore", UserWarning)
            for k in np.flatnonzero(lo < hi):
                src = slice(src0[k] + lo[k] - dst0[k], src0[k] + hi[k] - dst0[k])
                dst = slice(lo[k] - p0, hi[k] - p0)
                covered[dst] = True
                for out, part in ((out_r, real), (out_i, imag)):
                    out[dst, :r, :b].copy_(torch.from_numpy(part[src]))
        for out in (out_r, out_i):
            if r < self.max_r:
                out[:, r:] = np.nan
            if b < self.n_beam:
                out[:, :r, b:] = np.nan
            if not covered.all():
                out[torch.from_numpy(np.flatnonzero(~covered))] = np.nan

    def fill(self, ds):
        """Add the float64 ``backscatter_r`` / ``_i`` to the group ``ds``
        (counter ``complex_widened_pings``: its channel-pings)."""
        bs = [np.empty(self.shape) for _ in range(2)]
        for ci in range(len(self.channels)):
            self.copy_pings(ci, slice(0, self.n_t),
                            *(torch.from_numpy(a[ci]) for a in bs))
        count("complex_widened_pings", len(self.channels) * self.n_t)
        for name, a, attrs in zip(("backscatter_r", "backscatter_i"), bs, self.attrs):
            ds[name] = (("channel", "ping_time", "range_sample", "beam"), a, attrs)
