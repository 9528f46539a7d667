"""Legacy echopype-store migration: v0.5.x group trees -> v0.6+ layout.

Behavioral contract: echopype/echodata/sensor_ep_version_mapping/
(ep_version_mapper.py:6-30 + v05x_to_v06x.py:15-1156).  The reference keeps
this machinery but no longer dispatches it from ``open_converted`` (its own
test file is xfailed and notes the removal in PR #1143); we mirror that:
``map_ep_version`` is public API a user can call on an opened legacy store,
but nothing calls it automatically.

The migration is pure host-side metadata surgery on a handful of small
variables — nothing for the chip.  It is implemented as an ordered transform
pipeline over our flat ``{group_path: Dataset}`` tree rather than a DataTree
walk; every step cites the reference function it matches and is verified by
executing the reference module on the facade as an oracle
(tests/test_ref_version_mapping.py).

Known reference quirks mirrored deliberately:

- ``_add_source_filenames_var`` (reference :914-946): for combined v0.5
  files the reference calls ``drop_vars("src_filenames")`` without assigning
  the result, so the old variable SURVIVES next to the new
  ``source_filenames``.  We reproduce that observable output.

Known reference quirk NOT mirrored:

- ``_modify_sonar_group`` (reference :419-428) writes
  ``beamgroups_possible[i]["descr"]`` verbatim into ``beam_group_descr``;
  for EK80 groups 1-2 that value is a DICT (power/complex variants), which
  cannot serialize.  We resolve the dict the way v0.5 stores were laid out:
  when a ``Beam_power`` group exists, ``Beam`` held complex data (Beam_group1
  -> "complex", Beam_group2 -> "power"); otherwise Beam_group1 -> "power".
"""

from __future__ import annotations

import xml.etree.ElementTree as ET

import numpy as np

from ..convert.set_groups_base import VARATTRS
from ..utils.log import _init_logger
from ..utils.prov import ECHOPYPE_TPU_VERSION
from ..xrlite import DataArray, Dataset
from ..xrlite.ops import concat as xr_concat
from ..xrlite.ops import merge as xr_merge

logger = _init_logger(__name__)

__all__ = ["map_ep_version", "convert_v05x_to_v06x"]


#: v0.6-era beam-group descriptions written by the reference migration
#: (reference set_groups_ek60.py:48-56, set_groups_azfp.py:48-53,
#: set_groups_ek80.py:51-79 with the dict resolved — see module docstring)
_BEAMGROUP_DESCR = {
    "EK60": [
        "contains backscatter power (uncalibrated) and other beam or"
        " channel-specific data, including split-beam angle data when they exist."
    ],
    "AZFP": [
        "contains backscatter power (uncalibrated) and other beam or channel-specific data.",
    ],
    "EK80": {
        "power": "contains backscatter power (uncalibrated) and "
        "other beam or channel-specific data, "
        "including split-beam angle data when they exist.",
        "complex": "contains FM-only or CW-only complex backscatter data and "
        "other beam or channel-specific data.",
        "complex2": "contains CW-only complex backscatter data and other "
        "beam or channel-specific data.",
    },
}

#: AZFP variables whose ping_time dimension the migration appends
#: (reference set_groups_azfp.py:34-43 ping_time_only_names; EK60/EK80 sets
#: are empty since the v0.8 revert)
_AZFP_PING_TIME_ONLY = ("sample_interval", "transmit_duration_nominal")


def _get_sensor(sonar_model: str) -> str:
    """Top-level ``keywords`` -> set_groups family (reference :15-32)."""
    if sonar_model in ("EK60", "ES70"):
        return "EK60"
    if sonar_model in ("EK80", "ES80", "EA640"):
        return "EK80"
    return sonar_model


def map_ep_version(echodata_obj) -> None:
    """Migrate ``echodata_obj`` (in place) to the current group layout
    (reference ep_version_mapper.py:6-30).

    Stores written by this package are already current; echopype-written
    stores dispatch on their Provenance version: v0.5.x is converted,
    v0.6-v0.7 passes through, anything else raises.
    """
    version = echodata_obj.version_info
    prov = echodata_obj.get("Provenance")
    software = (
        prov.attrs.get("combination_software_name")
        or prov.attrs.get("conversion_software_name")
        if prov is not None
        else None
    )
    if software == "echopype_tpu":
        return
    if version is not None and (0, 5, 0) <= version < (0, 6, 0):
        convert_v05x_to_v06x(echodata_obj)
    elif version is not None and (0, 6, 0) <= version < (0, 8, 0):
        pass
    else:
        str_version = ".".join(map(str, version)) if version else "unknown"
        raise NotImplementedError(
            f"Conversion of data from echopype v{str_version} format to"
            f" v{ECHOPYPE_TPU_VERSION} format is not available. Please use open_raw"
            f" to convert data to version {ECHOPYPE_TPU_VERSION} format."
        )


# ---------------------------------------------------------------------------
# transform steps (ordered as in reference convert_v05x_to_v06x :1112-1156)
# ---------------------------------------------------------------------------


def _rename_coord_everywhere(ed, renames: dict) -> None:
    """Apply coordinate renames in every group where the coord exists
    (reference :35-54 range_bin, :725-748 location_time/mru_time)."""
    for grp in ed.group_paths:
        ds = ed[grp]
        hit = {old: new for old, new in renames.items() if old in ds.coords}
        if hit:
            ed[grp] = ds.rename(hit)


def _range_bin_to_range_sample(ed) -> None:
    """range_bin -> range_sample + its long_name (reference :35-54)."""
    _rename_coord_everywhere(ed, {"range_bin": "range_sample"})
    for grp in ed.group_paths:
        ds = ed[grp]
        if "range_sample" in ds.coords:
            ds.coords["range_sample"].attrs["long_name"] = "Along-range sample number, base 0"


def _add_attrs_to_freq(ed) -> None:
    """Uniform ``frequency`` coord attrs in every group (reference :57-86)."""
    freq_attrs = {
        "long_name": "Transducer frequency",
        "standard_name": "sound_frequency",
        "units": "Hz",
        "valid_min": 0.0,
    }
    for grp in ed.group_paths:
        ds = ed[grp]
        if "frequency" in ds.coords:
            ds.coords["frequency"].attrs.update(freq_attrs)


def _reorganize_beam_groups(ed) -> None:
    """Beam -> Sonar/Beam_group1, Beam_power -> Sonar/Beam_group2
    (reference :89-109)."""
    for old, new in (("Beam", "Sonar/Beam_group1"), ("Beam_power", "Sonar/Beam_group2")):
        if old in ed.group_paths:
            ed[new] = ed[old]
            del ed._tree[old]


def _beam_group_paths(ed):
    return tuple(p for p in ed.group_paths if p.startswith("Sonar/Beam_group"))


def _get_channel_id(ed, sensor: str) -> DataArray:
    """channel_id strings keyed by frequency (reference :112-162)."""
    if sensor == "AZFP":
        freq_nom = ed["Sonar/Beam_group1"].coords["frequency"]
        freq_khz = (np.asarray(freq_nom.values, dtype="f8") / 1000.0).astype(int).astype(str)
        serial = str(ed["Sonar"].attrs["sonar_serial_number"])
        # plain np.array of python str (unicode dtype), like the reference :137
        ids = np.array([f"{serial}-{khz}-{i + 1}" for i, khz in enumerate(freq_khz)])
        out = DataArray(ids, ("frequency",))
        out.coords["frequency"] = DataArray(freq_nom.values, ("frequency",), name="frequency")
        return out

    if "config_xml" in ed["Vendor"].attrs:
        # EK80: the per-channel frequency mapping lives only in the raw
        # config XML carried on the Vendor group (reference :145-154)
        root = ET.fromstring(ed["Vendor"].attrs["config_xml"])
        ids, freqs = [], []
        for trx in root.findall("./Transceivers/Transceiver"):
            ids.extend(ch.attrib["ChannelID"] for ch in trx.findall(".//Channel"))
            freqs.extend(np.float64(td.attrib["Frequency"]) for td in trx.findall(".//Transducer"))
        out = DataArray(np.asarray(ids), ("frequency",))
        out.coords["frequency"] = DataArray(np.asarray(freqs, dtype="f8"), ("frequency",))
        return out

    # EK60: every beam group carries a channel_id variable
    return xr_concat(
        [ed[p]["channel_id"] for p in _beam_group_paths(ed)], "frequency"
    )


def _frequency_to_channel(ed, sensor: str) -> None:
    """frequency dim -> channel (id strings) + frequency_nominal everywhere
    (reference :165-211)."""
    channel_id = _get_channel_id(ed, sensor)
    for grp in ed.group_paths:
        ds = ed[grp]
        if "frequency" not in ds.coords:
            continue
        ds["frequency_nominal"] = ds.coords["frequency"]
        ds = ds.rename({"frequency": "channel"})
        if "channel_id" in ds.data_vars:
            ds["channel"] = np.asarray(ds["channel_id"].values)
            ds = ds.drop_vars("channel_id")
        else:
            ds["channel"] = channel_id.sel(frequency=ds["frequency_nominal"]).values
        ds.coords["channel"].attrs.update(VARATTRS["beam_coord_default"]["channel"])
        ed[grp] = ds


def _change_beam_var_names(ed, sensor: str) -> None:
    """EK60 one-way -> two-way beamwidth renames/removals + EK60/EK80 angle
    attr text (reference :211-279)."""
    if sensor == "EK60":
        bg1 = (
            ed["Sonar/Beam_group1"]
            .rename({"beamwidth_receive_alongship": "beamwidth_twoway_alongship"})
            .rename({"beamwidth_transmit_athwartship": "beamwidth_twoway_athwartship"})
            .drop_vars(["beamwidth_receive_athwartship", "beamwidth_transmit_alongship"])
        )
        bg1["beamwidth_twoway_alongship"].attrs[
            "long_name"
        ] = "Half power two-way beam width along alongship axis of beam"
        bg1["beamwidth_twoway_athwartship"].attrs[
            "long_name"
        ] = "Half power two-way beam width along athwartship axis of beam"
        ed["Sonar/Beam_group1"] = bg1

    if sensor in ("EK60", "EK80"):
        for p in _beam_group_paths(ed):
            ds = ed[p]
            for side in ("alongship", "athwartship"):
                ds[f"angle_sensitivity_{side}"].attrs[
                    "long_name"
                ] = f"{side} angle sensitivity of the transducer"
                ds[f"angle_offset_{side}"].attrs[
                    "long_name"
                ] = f"electrical {side} angle offset of the transducer"


def _add_comment_to_beam_vars(ed, sensor: str) -> None:
    """Comment attrs on beamwidth/angle variables (reference :282-352)."""
    if sensor not in ("EK60", "EK80"):
        return
    for p in _beam_group_paths(ed):
        ds = ed[p]
        for side, convn in (("alongship", "minor"), ("athwartship", "major")):
            ds[f"beamwidth_twoway_{side}"].attrs["comment"] = (
                "Introduced in echopype for Simrad echosounders to avoid "
                f"potential confusion with convention definitions. The {side} "
                f"angle corresponds to the {convn} angle in SONAR-netCDF4 vers 2. The "
                "convention defines one-way transmit or receive beamwidth "
                f"(beamwidth_receive_{convn} and beamwidth_transmit_{convn}), but Simrad "
                "echosounders record two-way beamwidth in the data."
            )
            angle_comment = (
                f"Introduced in echopype for Simrad echosounders. The {side} "
                f"angle corresponds to the {convn} angle in SONAR-netCDF4 vers 2. "
            )
            ds[f"angle_offset_{side}"].attrs["comment"] = angle_comment
            ds[f"angle_sensitivity_{side}"].attrs["comment"] = angle_comment
            if f"angle_{side}" in ds.data_vars:
                ds[f"angle_{side}"].attrs["comment"] = angle_comment


def _modify_sonar_group(ed, sensor: str) -> None:
    """quadrant -> beam, AZFP ping_time expansion, Sonar beam_group coord +
    beam_group_descr (+ EK80 sonar_serial_number) (reference :355-441)."""
    for p in _beam_group_paths(ed):
        ds = ed[p]
        if "quadrant" in ds.coords or "quadrant" in ds.dims:
            ds = ds.rename({"quadrant": "beam"})
            beam_vals = (np.asarray(ds.coords["beam"].values) + 1).astype(str)
            ds["beam"] = beam_vals
            ds.coords["beam"].attrs["long_name"] = "Beam name"
            ed[p] = ds
        if sensor == "AZFP":
            ds = ed[p]
            for var in _AZFP_PING_TIME_ONLY:
                if var in ds.data_vars and "ping_time" not in ds[var].dims:
                    ds[var] = ds[var].expand_dims(
                        dim={"ping_time": ds.coords["ping_time"]}, axis=ds[var].ndim
                    )

    # beam_group coord + beam_group_descr on the Sonar group
    n_beams = len(_beam_group_paths(ed))
    names = [f"Beam_group{i + 1}" for i in range(n_beams)]
    if sensor == "EK80":
        table = _BEAMGROUP_DESCR["EK80"]
        if n_beams >= 2:
            descr = [table["complex"], table["power"]] + [table["power"]] * (n_beams - 2)
        else:
            descr = [table["power"]]
    else:
        descr = (_BEAMGROUP_DESCR[sensor] * n_beams)[:n_beams]
    sonar = ed["Sonar"]
    sonar.coords["beam_group"] = DataArray(
        np.asarray(names),
        ("beam_group",),
        attrs={"long_name": "Beam group name"},
        name="beam_group",
    )
    sonar["beam_group_descr"] = (
        ("beam_group",),
        np.asarray(descr),
        {"long_name": "Beam group description"},
    )
    if sensor == "EK80":
        sonar["sonar_serial_number"] = (
            ("channel",),
            np.full(len(np.atleast_1d(sonar["frequency_nominal"].values)), np.nan),
        )


def _move_transducer_offset_vars(ed, sensor: str) -> None:
    """transducer_offset_x/y/z: beam groups -> Platform; EK80 Platform
    frequency_nominal from Vendor (reference :443-483)."""
    if sensor in ("EK60", "EK80"):
        for spatial in ("x", "y", "z"):
            name = f"transducer_offset_{spatial}"
            pieces = []
            for p in _beam_group_paths(ed):
                pieces.append(ed[p][name])
                ed[p] = ed[p].drop_vars(name)
            ed["Platform"][name] = xr_concat(pieces, "channel")
    if sensor == "EK80":
        ed["Platform"]["frequency_nominal"] = ed["Vendor"]["frequency_nominal"].sel(
            channel=ed["Platform"].coords["channel"]
        )


def _add_vars_to_platform(ed, sensor: str) -> None:
    """NaN MRU/position placeholders, heave -> vertical_offset, EK80 time3
    block, AZFP placeholder scalars (reference :486-591)."""
    ds_tmp = Dataset(
        {
            var: ((), np.float64(np.nan), VARATTRS["platform_var_default"][var])
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
        }
    )
    if sensor == "EK60":
        ds_tmp = ds_tmp.expand_dims({"channel": ed["Platform"].coords["channel"]})
        ds_tmp.coords["channel"].attrs.update(VARATTRS["beam_coord_default"]["channel"])
    ed["Platform"] = xr_merge([ed["Platform"], ds_tmp])

    if sensor != "AZFP":  # heave was missing for AZFP v0.5.x
        ed["Platform"] = ed["Platform"].rename({"heave": "vertical_offset"})

    if sensor == "EK80":
        plat = ed["Platform"]
        plat["drop_keel_offset"] = (("time3",), np.array([plat.attrs["drop_keel_offset"]]))
        del plat.attrs["drop_keel_offset"]
        plat["drop_keel_offset_is_manual"] = (("time3",), np.array([np.nan]))
        plat["water_level_draft_is_manual"] = (("time3",), np.array([np.nan]))
        plat["water_level"] = plat["water_level"].expand_dims(dim=("time3",))
        plat.coords["time3"] = DataArray(
            np.asarray(ed["Environment"].coords["ping_time"].values),
            ("time3",),
            attrs={"axis": "T", "standard_name": "time"},
            name="time3",
        )

    if sensor == "AZFP":
        ds_tmp = Dataset(
            {
                var: ((), np.float64(np.nan), VARATTRS["platform_var_default"][var])
                for var in (
                    "transducer_offset_x",
                    "transducer_offset_y",
                    "transducer_offset_z",
                    "vertical_offset",
                    "water_level",
                )
            }
        )
        ed["Platform"] = xr_merge([ed["Platform"], ds_tmp])


def _add_vars_coords_to_environment(ed, sensor: str) -> None:
    """EK80 sound-velocity-profile placeholders (reference :594-658)."""
    if sensor != "EK80":
        return
    env = ed["Environment"]
    n = len(np.atleast_1d(env.coords["ping_time"].values))
    # np.array of python str (unicode dtype), like the reference :617-625
    env["sound_velocity_source"] = (("ping_time",), np.array(["None"] * n))
    env["transducer_name"] = (("ping_time",), np.array(["None"] * n))
    env["transducer_sound_speed"] = (("ping_time",), np.full(n, np.nan))
    env["sound_velocity_profile"] = (
        ("ping_time", "sound_velocity_profile_depth"),
        np.full((n, 1), np.nan),
        {
            "long_name": "sound velocity profile",
            "standard_name": "speed_of_sound_in_sea_water",
            "units": "m/s",
            "valid_min": 0.0,
            "comment": "parsed from raw data files as (depth, sound_speed) value pairs",
        },
    )
    env.coords["sound_velocity_profile_depth"] = DataArray(
        np.array([np.nan]),
        ("sound_velocity_profile_depth",),
        attrs={
            "standard_name": "depth",
            "units": "m",
            "axis": "Z",
            "positive": "down",
            "valid_min": 0.0,
        },
        name="sound_velocity_profile_depth",
    )


def _rearrange_azfp_attrs_vars(ed, sensor: str) -> None:
    """AZFP: tilt to Platform, vendor counts/calibration to Vendor, vendor
    attrs moved, cos_tilt_mag removed (reference :661-725)."""
    if sensor != "AZFP":
        return
    bg1 = ed["Sonar/Beam_group1"]
    beam_to_plat = ("tilt_x", "tilt_y")
    for var in beam_to_plat:
        ed["Platform"][var] = bg1[var]
    beam_to_vendor = (
        "temperature_counts",
        "tilt_x_count",
        "tilt_y_count",
        "DS",
        "EL",
        "TVR",
        "VTX",
        "Sv_offset",
        "number_of_samples_digitized_per_pings",
        "number_of_digitized_samples_averaged_per_pings",
    )
    for var in beam_to_vendor:
        ed["Vendor"][var] = bg1[var]
    moved_attrs = {
        k: v for k, v in bg1.attrs.items() if k not in ("beam_mode", "conversion_equation_t")
    }
    for k, v in moved_attrs.items():
        ed["Vendor"].attrs[k] = v
        del bg1.attrs[k]
    ed["Sonar/Beam_group1"] = bg1.drop_vars(
        ["cos_tilt_mag"] + list(beam_to_plat) + list(beam_to_vendor)
    )


def _make_time_coords_consistent(ed, sensor: str) -> None:
    """location_time/mru_time -> time1/time2, per-sensor ping_time renames in
    Platform/Environment, and the time coord attr text
    (reference :725-911)."""
    _rename_coord_everywhere(ed, {"location_time": "time1", "mru_time": "time2"})

    if sensor == "EK60":
        plat = ed["Platform"]
        # water_level keeps its own copy of the ping_time axis as time3
        # (reference :771-788: the per-variable rename drags the coordinate
        # along, so time3 values == the old ping_time values)
        t3_vals = np.asarray(plat.coords["ping_time"].values)
        plat["water_level"] = plat["water_level"].rename({"ping_time": "time3"})
        plat = plat.rename({"ping_time": "time2"})
        plat.coords["time3"] = DataArray(
            t3_vals,
            ("time3",),
            attrs={"axis": "T", "standard_name": "time"},
            name="time3",
        )
        ed["Platform"] = plat
        ed["Environment"] = ed["Environment"].rename({"ping_time": "time1"})
    elif sensor == "EK80":
        ed["Environment"] = ed["Environment"].rename({"ping_time": "time1"})
    elif sensor == "AZFP":
        ed["Platform"] = ed["Platform"].rename({"ping_time": "time2"})
        ed["Environment"] = ed["Environment"].rename({"ping_time": "time1"})

    # Platform time attrs (reference :790-831)
    plat = ed["Platform"]
    if "time1" in plat.coords:
        plat.coords["time1"].attrs[
            "comment"
        ] = "Time coordinate corresponding to NMEA position data."
    plat.coords["time2"].attrs[
        "long_name"
    ] = "Timestamps for platform motion and orientation data"
    plat.coords["time2"].attrs[
        "comment"
    ] = "Time coordinate corresponding to platform motion and orientation data."
    if sensor in ("EK60", "EK80"):
        plat.coords["time3"].attrs[
            "long_name"
        ] = "Timestamps for platform-related sampling environment"
        comment = "Time coordinate corresponding to platform-related sampling environment."
        if sensor == "EK80":
            comment += " Note that Platform.time3 is the same as Environment.time1."
        plat.coords["time3"].attrs["comment"] = comment

    # Environment time attrs (reference :834-863)
    env = ed["Environment"]
    if sensor in ("EK60", "EK80"):
        env.coords["time1"].attrs["long_name"] = "Timestamps for NMEA position datagrams"
    if sensor == "EK80":
        env.coords["time1"].attrs["comment"] = (
            "Time coordinate corresponding to "
            "environmental variables. Note that "
            "Platform.time3 is the same as Environment.time1."
        )
    else:
        env.coords["time1"].attrs[
            "comment"
        ] = "Time coordinate corresponding to environmental variables."

    if "Platform/NMEA" in ed.group_paths:
        ed["Platform/NMEA"].coords["time1"].attrs[
            "comment"
        ] = "Time coordinate corresponding to NMEA sensor data."


def _add_source_filenames_var(ed) -> None:
    """Provenance src_filenames attr -> source_filenames variable
    (reference :914-946; see module docstring for the combined-file
    drop_vars quirk)."""
    prov = ed["Provenance"]
    if "src_filenames" in prov.data_vars:
        prov["source_filenames"] = (
            ("filenames",),
            np.asarray(prov["src_filenames"].values),
            {"long_name": "Source filenames"},
        )
        # reference quirk: drop_vars result discarded, old variable survives
    else:
        prov["source_filenames"] = (
            ("filenames",),
            np.asarray([prov.attrs["src_filenames"]], dtype=object),
            {"long_name": "Source filenames"},
        )
        del prov.attrs["src_filenames"]


def _rename_vendor_group(ed) -> None:
    """Vendor -> Vendor_specific (reference :949-966)."""
    if "Vendor" in ed.group_paths:
        ed["Vendor_specific"] = ed["Vendor"]
        del ed._tree["Vendor"]


def _change_list_attrs_to_str(ed) -> None:
    """Platform valid_range array attrs -> "(lo, hi)" strings
    (reference :969-990)."""
    plat = ed["Platform"]
    for var in list(plat.data_vars):
        vr = plat[var].attrs.get("valid_range")
        if vr is not None and not isinstance(vr, str):
            plat[var].attrs["valid_range"] = f"({vr[0]}, {vr[1]})"


def _change_vertical_offset_attrs(ed) -> None:
    """Replace Platform.vertical_offset attrs (reference :993-1012)."""
    plat = ed["Platform"]
    if "vertical_offset" in plat.data_vars:
        plat["vertical_offset"].attrs = {
            "long_name": "Platform vertical offset from nominal",
            "units": "m",
        }


def _consistent_sonar_model_attr(ed, sensor: str) -> None:
    """Normalize the Sonar group's sonar_model attr (reference :1015-1048)."""
    sonar = ed["Sonar"]
    if sensor == "AZFP":
        sonar.attrs["sonar_model"] = "AZFP"
    elif sensor == "EK60":
        sonar.attrs["sonar_software_name"] = sonar.attrs["sonar_model"]
        sonar.attrs["sonar_model"] = "EK60"
    elif sensor == "EK80":
        ed["Sonar"] = sonar.rename({"sonar_model": "transducer_name"})
        ed["Sonar"].attrs["sonar_model"] = "EK80"


def convert_v05x_to_v06x(echodata_obj) -> None:
    """Migrate a v0.5.x tree in place (reference v05x_to_v06x.py:1051-1156).

    No actions are taken for AD2CP (beyond the Vendor rename), like the
    reference.
    """
    logger.warning(
        "Converting echopype version 0.5.x file to 0.6.0."
        " For specific details on how items have been changed,"
        " please see the echopype documentation. It is recommended "
        "that one creates the file using echopype.open_raw again, "
        "rather than relying on this conversion."
    )
    ed = echodata_obj
    sensor = _get_sensor(ed["Top-level"].attrs["keywords"])

    if sensor != "AD2CP":
        _range_bin_to_range_sample(ed)
        _add_attrs_to_freq(ed)
        _reorganize_beam_groups(ed)
        _frequency_to_channel(ed, sensor)
        _change_beam_var_names(ed, sensor)
        _add_comment_to_beam_vars(ed, sensor)
        _modify_sonar_group(ed, sensor)
        _move_transducer_offset_vars(ed, sensor)
        _add_vars_to_platform(ed, sensor)
        _add_vars_coords_to_environment(ed, sensor)
        _rearrange_azfp_attrs_vars(ed, sensor)
        _make_time_coords_consistent(ed, sensor)
        _add_source_filenames_var(ed)
        _change_list_attrs_to_str(ed)
        _change_vertical_offset_attrs(ed)
        _consistent_sonar_model_attr(ed, sensor)

    _rename_vendor_group(ed)
