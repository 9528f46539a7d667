"""AD2CP group assembly: up to 4 beam groups by acquisition mode.

Capability parity: echopype/convert/set_groups_ad2cp.py:29-520 — every group
(beam/env/platform/vendor) is assembled through the reference's
``_make_dataset`` combine semantics, re-implemented vectorized:

- every timestamped packet contributes one row per field, in stream order,
  with 0-padding when the packet lacks the field (set_groups_ad2cp.py:132-139);
- fields ride the time axis their reference descriptor declares
  (parse_ad2cp.py:124-140): ``time1`` rows are sliced at the FIRST packet
  index of each unique timestamp, mode axes (average/burst/echosounder/raw/
  raw-transmit ``ping_time``) keep one row per packet of that mode;
- fields that exist in no packet become EMPTY variables — dims ``()`` and a
  ``None`` payload, exactly like the reference's ``((), None)`` data_vars
  (set_groups_ad2cp.py:201-215);
- beam groups are built on ``time1`` then re-indexed onto their mode's
  ``ping_time`` via the reference's ``sel(time1=ds["ping_time"])`` +
  ``drop_vars("time1")`` step (set_groups_ad2cp.py:420-422), which takes each
  scalar's value from the first packet at that timestamp — whatever its type
  (the observable "cross-packet zero-fill" quirk);
- the ``beam`` coordinate holds the PHYSICAL beam numbers decoded from
  dataset_description (longest ``beams`` array over all packets,
  set_groups_ad2cp.py:99-103), mij/wxyz/xyz get the reference's string
  labels, and remaining dims get arange coords.

Documented deviation: the reference's ``set_vendor`` crashes on any file
carrying AST data (``altimeter_spare`` is an 8-byte array declared with a
single ``time1`` dim, so its own ``xr.Dataset`` construction raises); we
emit it on ("time1", "spare") instead.
"""

from __future__ import annotations

import numpy as np

from ..xrlite import DataArray, Dataset
from .set_groups_base import SetGroupsBase

BEAM_GROUP_DESCR = {
    "average": (
        "contains echo intensity, velocity and correlation data as well as other "
        "configuration parameters from the Average mode."
    ),
    "burst": (
        "contains echo intensity, velocity and correlation data as well as other "
        "configuration parameters from the Burst mode."
    ),
    "echosounder": (
        "contains backscatter echo intensity and other configuration parameters "
        "from the Echosounder mode. Data can be pulse compressed or raw intensity."
    ),
    "echosounder_raw": (
        "contains complex backscatter raw samples and other configuration "
        "parameters from the Echosounder mode, including complex data from the "
        "transmit pulse."
    ),
}

AHRS_COORDS = {
    "mij": np.array(["11", "12", "13", "21", "22", "23", "31", "32", "33"], dtype=object),
    "wxyz": np.array(["w", "x", "y", "z"], dtype=object),
    "xyz": np.array(["x", "y", "z"], dtype=object),
}

# Non-default field dimensions (reference parse_ad2cp.py F-entry declarations;
# everything not listed rides ("time1",)).  The first element names the time
# axis: "time1", or a (dim_name, mode) pair for per-mode ping_time axes.
_T1 = "time1"
_FIELD_DIMS = {
    "velocity_data_average": (("ping_time", "average"), "beam", "range_sample"),
    "velocity_data_burst": (("ping_time", "burst"), "beam", "range_sample"),
    "velocity_data_echosounder": (("ping_time", "echosounder"), "beam", "range_sample"),
    "amplitude_data_average": (("ping_time", "average"), "beam", "range_sample"),
    "amplitude_data_burst": (("ping_time", "burst"), "beam", "range_sample"),
    "amplitude_data_echosounder": (("ping_time", "echosounder"), "beam", "range_sample"),
    "correlation_data_average": (("ping_time", "average"), "beam", "range_sample"),
    "correlation_data_burst": (("ping_time", "burst"), "beam", "range_sample"),
    "correlation_data_echosounder": (("ping_time", "echosounder"), "beam", "range_sample"),
    "echosounder_data": (("ping_time", "echosounder"), "range_sample"),
    "echosounder_raw_samples_i": (("ping_time", "echosounder_raw"), "range_sample"),
    "echosounder_raw_samples_q": (("ping_time", "echosounder_raw"), "range_sample"),
    "echosounder_raw_transmit_samples_i": (
        ("ping_time_transmit", "echosounder_raw_transmit"),
        "transmit_sample",
    ),
    "echosounder_raw_transmit_samples_q": (
        ("ping_time_transmit", "echosounder_raw_transmit"),
        "transmit_sample",
    ),
    "ahrs_rotation_matrix": (_T1, "mij"),
    "ahrs_quaternions": (_T1, "wxyz"),
    "ahrs_gyro": (_T1, "xyz"),
    "magnetometer_raw": (_T1, "xyz"),
    "percentage_good_data": (_T1, "range_sample"),
    "altimeter_raw_data_samples": (_T1, "num_altimeter_samples"),
    "figure_of_merit_data": (_T1, "beam"),
    "altimeter_spare": (_T1, "spare"),  # deviation: see module docstring
}

_BEAM_SCALARS = (
    ("num_beams", "number_of_beams"),
    ("coordinate_system", "coordinate_system"),
    ("num_cells", "number_of_cells"),
    ("blanking", "blanking"),
    ("cell_size", "cell_size"),
    ("velocity_range", "velocity_range"),
    ("echosounder_frequency", "echosounder_frequency"),
    ("ambiguity_velocity", "ambiguity_velocity"),
    ("dataset_description", "data_set_description"),
    ("transmit_energy", "transmit_energy"),
    ("velocity_scaling", "velocity_scaling"),
)

# Reference set_vendor var map, in order (set_groups_ad2cp.py:425-495)
_VENDOR_MAP = (
    ("version", "data_record_version"),
    ("pressure_sensor_valid", "pressure_sensor_valid"),
    ("temperature_sensor_valid", "temperature_sensor_valid"),
    ("compass_sensor_valid", "compass_sensor_valid"),
    ("tilt_sensor_valid", "tilt_sensor_valid"),
    ("velocity_data_included", "velocity_data_included"),
    ("amplitude_data_included", "amplitude_data_included"),
    ("correlation_data_included", "correlation_data_included"),
    ("altimeter_data_included", "altimeter_data_included"),
    ("altimeter_raw_data_included", "altimeter_raw_data_included"),
    ("ast_data_included", "ast_data_included"),
    ("echosounder_data_included", "echosounder_data_included"),
    ("ahrs_data_included", "ahrs_data_included"),
    ("percentage_good_data_included", "percentage_good_data_included"),
    ("std_dev_data_included", "std_dev_data_included"),
    ("distance_data_included", "distance_data_included"),
    ("figure_of_merit_data_included", "figure_of_merit_data_included"),
    ("error", "error"),
    ("status0", "status0"),
    ("procidle3", "procidle3"),
    ("procidle6", "procidle6"),
    ("procidle12", "procidle12"),
    ("status", "status"),
    ("wakeup_state", "wakeup_state"),
    ("orientation", "orientation"),
    ("autoorientation", "autoorientation"),
    ("previous_wakeup_state", "previous_wakeup_state"),
    ("last_measurement_low_voltage_skip", "last_measurement_low_voltage_skip"),
    ("active_configuration", "active_configuration"),
    ("echosounder_index", "echosounder_index"),
    ("telemetry_data", "telemetry_data"),
    ("boost_running", "boost_running"),
    ("echosounder_frequency_bin", "echosounder_frequency_bin"),
    ("bd_scaling", "bd_scaling"),
    ("battery_voltage", "battery_voltage"),
    ("power_level", "power_level"),
    ("temperature_from_pressure_sensor", "temperature_of_pressure_sensor"),
    ("nominal_correlation", "nominal_correlation"),
    ("magnetometer_temperature", "magnetometer_temperature"),
    ("real_time_clock_temperature", "real_time_clock_temperature"),
    ("ensemble_counter", "ensemble_counter"),
    ("ahrs_rotation_matrix", "ahrs_rotation_matrix_mij"),
    ("ahrs_quaternions", "ahrs_quaternions_wxyz"),
    ("ahrs_gyro", "ahrs_gyro_xyz"),
    ("percentage_good_data", "percentage_good_data"),
    ("std_dev_pitch", "std_dev_pitch"),
    ("std_dev_roll", "std_dev_roll"),
    ("std_dev_heading", "std_dev_heading"),
    ("std_dev_pressure", "std_dev_pressure"),
    ("figure_of_merit_data", "figure_of_merit"),
    ("altimeter_distance", "altimeter_distance"),
    ("altimeter_quality", "altimeter_quality"),
    ("ast_distance", "ast_distance"),
    ("ast_quality", "ast_quality"),
    ("ast_offset_100us", "ast_offset_100us"),
    ("ast_pressure", "ast_pressure"),
    ("altimeter_spare", "altimeter_spare"),
    ("altimeter_raw_data_num_samples", "altimeter_raw_data_num_samples"),
    ("altimeter_raw_data_sample_distance", "altimeter_raw_data_sample_distance"),
    ("altimeter_raw_data_samples", "altimeter_raw_data_samples"),
    ("magnetometer_raw", "magnetometer_raw"),
)


class SetGroupsAd2cp(SetGroupsBase):
    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.pulse_compressed = self.parser_obj.get_pulse_compressed()
        self._beamgroups = []
        self._index_packets()

    # ------------------------------------------------------- packet indexing
    def _index_packets(self):
        """Precompute the reference's time indices (set_groups_ad2cp:40-73)."""
        self._pkts = [p for p in self.parser_obj.packets if p.has_timestamp()]
        self._timestamps = np.asarray(
            [p.timestamp for p in self._pkts], dtype="datetime64[ns]"
        )
        if len(self._pkts):
            self._uniq_t, self._time1_idx = np.unique(
                self._timestamps, return_index=True
            )
        else:
            self._uniq_t = np.empty(0, "datetime64[ns]")
            self._time1_idx = np.empty(0, "i8")
        mode_of = {
            "average": lambda p: p.is_average(),
            "burst": lambda p: p.is_burst(),
            "echosounder": lambda p: p.is_echosounder(),
            "echosounder_raw": lambda p: p.is_echosounder_raw(),
            "echosounder_raw_transmit": lambda p: p.is_echosounder_raw_transmit(),
        }
        self._mode_idx = {
            mode: np.asarray(
                [i for i, p in enumerate(self._pkts) if pred(p)], dtype="i8"
            )
            for mode, pred in mode_of.items()
        }
        # longest physical-beams array over all packets (first wins on ties)
        self._beam_coords = None
        for p in self._pkts:
            b = p.data.get("beams")
            if b is not None and len(b) and (
                self._beam_coords is None or len(b) > len(self._beam_coords)
            ):
                self._beam_coords = np.asarray(b)

    # --------------------------------------------------------- field combine
    def _combine(self, var_names) -> Dataset:
        """Reference ``_make_dataset`` (set_groups_ad2cp.py:75-229), vectorized.

        var_names: iterable of (field, var_name).  Returns a Dataset whose
        time1-dim variables are sliced at unique-first packet rows; mode-dim
        variables keep one row per packet of that mode.
        """
        data_vars = {}
        used_dims = set()
        for field, var in var_names:
            dims = _FIELD_DIMS.get(field, (_T1,))
            values = [p.data.get(field) for p in self._pkts]
            if not any(v is not None for v in values):
                data_vars[var] = ((), None)
                continue
            if len(dims) > 1:
                arrs = [None if v is None else np.asarray(v, dtype="f8") for v in values]
                ndim = len(dims) - 1
                max_shape = np.zeros(ndim, dtype="i8")
                for a in arrs:
                    if a is not None:
                        max_shape = np.maximum(max_shape, a.shape)
                out = np.zeros((len(arrs), *max_shape), dtype="f8")
                for i, a in enumerate(arrs):
                    if a is not None:
                        out[(i, *map(slice, a.shape))] = a
            else:
                out = np.asarray(
                    [0.0 if v is None else float(v) for v in values], dtype="f8"
                )
            t0 = dims[0]
            if t0 == _T1:
                rows = self._time1_idx
                dim_names = dims
            else:
                dim_name, mode = t0
                rows = self._mode_idx[mode]
                dim_names = (dim_name, *dims[1:])
                t0 = dim_name
            out = out[rows]
            data_vars[var] = (dim_names, out)
            used_dims.update(dim_names)
            used_dims.add((t0, dims[0]))

        coords = {}
        for t0, orig in {d for d in used_dims if isinstance(d, tuple)}:
            if orig == _T1:
                coords[_T1] = (( _T1,), self._uniq_t)
            else:
                coords[t0] = ((t0,), self._timestamps[self._mode_idx[orig[1]]])
        used_dims = {d for d in used_dims if not isinstance(d, tuple)}
        for dim, labels in AHRS_COORDS.items():
            if dim in used_dims:
                coords[dim] = ((dim,), labels)
        if "beam" in used_dims and self._beam_coords is not None:
            coords["beam"] = (("beam",), self._beam_coords.astype("i8"))

        ds = Dataset(coords=coords)
        for var, spec in data_vars.items():
            ds[var] = spec
        # arange coords for remaining dims (reference :226-228)
        for dim in sorted(used_dims - set(ds.coords)):
            if dim in ds.dims:
                ds.coords[dim] = DataArray(np.arange(ds.sizes[dim]), (dim,))
        return ds

    def _reindex_onto_ping_time(self, ds: Dataset) -> Dataset:
        """The reference's ``sel(time1=ds["ping_time"]).drop_vars("time1")``
        step (set_groups_ad2cp.py:420-422): time1-dim variables are re-indexed
        onto the group's ping_time axis, taking each unique timestamp's row."""
        if _T1 not in ds.dims or "ping_time" not in ds.coords:
            return ds
        pt = np.asarray(ds.coords["ping_time"].values, dtype="datetime64[ns]")
        rows = np.searchsorted(self._uniq_t, pt)
        out = Dataset(coords={k: v for k, v in ds.coords.items() if k != _T1}, attrs=ds.attrs)
        for name in ds.data_vars:
            da = ds[name]
            if da.dims and da.dims[0] == _T1:
                out[name] = (("ping_time", *da.dims[1:]), np.asarray(da.values)[rows])
            else:
                out[name] = da
        return out

    # ------------------------------------------------------------------- env
    def set_env(self) -> Dataset:
        ds = self._combine(
            (
                ("speed_of_sound", "sound_speed_indicative"),
                ("temperature", "temperature"),
                ("pressure", "pressure"),
            )
        )
        if _T1 in ds.coords:
            ds.coords[_T1].attrs.update({"axis": "T", "standard_name": "time"})
        return ds

    # -------------------------------------------------------------- platform
    def set_platform(self) -> Dataset:
        ds = self._combine(
            (("heading", "heading"), ("pitch", "pitch"), ("roll", "roll"))
        )
        ds.attrs.update(self._platform_attrs())
        pv = self._varattrs["platform_var_default"]
        for name in ("heading", "pitch", "roll"):
            if name in ds.data_vars:
                ds[name].attrs.update(pv.get(name, {"long_name": f"Platform {name}"}))
        return ds

    # ----------------------------------------------------------------- sonar
    def set_sonar(self) -> Dataset:
        names = [bg["name"] for bg in self._beamgroups]
        descr = [bg["descr"] for bg in self._beamgroups]
        fw = self.parser_obj.get_firmware_version() or {}
        serials = np.unique(
            [
                str(p.data["serial_number"])
                for p in self.parser_obj.packets
                if "serial_number" in p.data
            ]
        )
        ds = Dataset(
            {
                "beam_group_descr": (
                    ("beam_group",),
                    np.asarray(descr, dtype=object),
                )
            },
            coords={"beam_group": np.asarray(names, dtype=object)},
            attrs={
                "sonar_manufacturer": "Nortek",
                "sonar_model": self.sonar_model,
                "sonar_serial_number": ", ".join(serials),
                "sonar_software_name": "",
                "sonar_software_version": str(fw.get("FW", "")),
                "sonar_type": "acoustic Doppler current profiler (ADCP)",
            },
        )
        return ds

    # ------------------------------------------------------------------ beam
    def set_beam(self) -> list:
        groups = []
        self._beamgroups = []
        present = {mode for mode in ("average", "burst", "echosounder", "echosounder_raw")
                   if len(self._mode_idx[mode])}
        for mode in ("average", "burst", "echosounder", "echosounder_raw"):
            if mode not in present:
                continue
            spec = list(_BEAM_SCALARS)
            if mode in ("average", "burst"):
                spec += [
                    (f"velocity_data_{mode}", "velocity"),
                    (f"amplitude_data_{mode}", "amplitude"),
                    (f"correlation_data_{mode}", "correlation"),
                ]
            elif mode == "echosounder":
                spec += [
                    ("correlation_data_echosounder", "correlation"),
                    ("echosounder_data", "amplitude"),
                ]
            else:  # echosounder_raw
                spec += [
                    ("num_complex_samples", "num_complex_samples"),
                    ("ind_start_samples", "ind_start_samples"),
                    ("freq_raw_sample_data", "freq_raw_sample_data"),
                    ("echosounder_raw_samples_i", "backscatter_r"),
                    ("echosounder_raw_samples_q", "backscatter_i"),
                    ("echosounder_raw_transmit_samples_i", "transmit_pulse_r"),
                    ("echosounder_raw_transmit_samples_q", "transmit_pulse_i"),
                ]
            ds = self._combine(spec)
            # the scalar fields ride time1; attach the mode's ping_time axis
            # so the reference's sel() re-index step has a target
            if "ping_time" not in ds.coords:
                ds.coords["ping_time"] = DataArray(
                    self._timestamps[self._mode_idx[mode]], ("ping_time",)
                )
            ds = self._reindex_onto_ping_time(ds)
            ds.coords["ping_time"].attrs.update(
                self._varattrs["beam_coord_default"]["ping_time"]
            )
            if mode == "echosounder":
                ds.coords["echogram"] = DataArray(np.arange(3), ("echogram",))
                pulse_compressed = np.zeros(3)
                # reference keeps the index bug: pulse_compressed==0 marks the
                # LAST echogram as compressed (set_groups_ad2cp.py:358-360)
                pulse_compressed[self.pulse_compressed - 1] = 1
                ds["pulse_compressed"] = (("echogram",), pulse_compressed)
            groups.append(ds)
            self._beamgroups.append(
                {"name": f"Beam_group{len(self._beamgroups) + 1}", "descr": BEAM_GROUP_DESCR[mode]}
            )
        return groups

    # ---------------------------------------------------------------- vendor
    def set_vendor(self) -> Dataset:
        ds = self._combine(_VENDOR_MAP)
        if self.parser_obj.config:
            for heading, kv in self.parser_obj.config.items():
                for k, v in kv.items():
                    ds.attrs[f"{heading}_{k}"] = v
        return ds
