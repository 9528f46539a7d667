"""SONAR-netCDF4 v1.0 convention: group map + default variable attributes.

Capability parity: echopype/echodata/convention/1.0.yml (loaded by
convention/conv.py:9).  Kept as a data-driven python dict (no yaml dep).
"""

#: Group map transcribed from the reference YAML (keys, names, ep_group
#: paths, and descriptions match 1.0.yml verbatim; drift is guarded by
#: tests/test_convention_drift.py, which parses the YAML and compares).
GROUP_MAP = {
    "top": {
        "name": "Top-level",
        "description": "contains metadata about the SONAR-netCDF4 file format.",
        "ep_group": None,
    },
    "environment": {
        "name": "Environment",
        "description": "contains information relevant to acoustic propagation through water.",
        "ep_group": "Environment",
    },
    "platform": {
        "name": "Platform",
        "description": "contains information about the platform on which the sonar is installed.",
        "ep_group": "Platform",
    },
    "nmea": {
        "name": "NMEA",
        "description": "contains information specific to the NMEA protocol.",
        "ep_group": "Platform/NMEA",
    },
    "provenance": {
        "name": "Provenance",
        "description": "contains metadata about how the SONAR-netCDF4 version of the data were obtained.",
        "ep_group": "Provenance",
    },
    "sonar": {
        "name": "Sonar",
        "description": "contains sonar system metadata and sonar beam groups.",
        "ep_group": "Sonar",
    },
    "beam": {
        "name": "Beam_group1",
        "description": (
            "contains backscatter data (either complex samples or uncalibrated power samples) "
            "and other beam or channel-specific data, including split-beam angle data when they exist."
        ),
        "ep_group": "Sonar/Beam_group1",
    },
    "beam_power": {
        "name": "Beam_group2",
        "description": (
            "contains backscatter power (uncalibrated) and other beam or channel-specific data, "
            "including split-beam angle data when they exist. "
            "Only exists if complex backscatter data are already in Sonar/Beam_group1"
        ),
        "ep_group": "Sonar/Beam_group2",
    },
    "beam_group3": {
        "name": "Beam_group3",
        "description": "",
        "ep_group": "Sonar/Beam_group3",
    },
    "beam_group4": {
        "name": "Beam_group4",
        "description": "",
        "ep_group": "Sonar/Beam_group4",
    },
    "vendor": {
        "name": "Vendor_specific",
        "description": "contains vendor-specific information about the sonar and the data.",
        "ep_group": "Vendor_specific",
    },
}

YAML_FILE_MAP = GROUP_MAP  # alias, mirrors reference naming

#: Default variable attributes (subset of the convention defaults that the
#: processing code and downstream users rely on).
VARATTRS = {
    "beam_coord_default": {
        "channel": {"long_name": "Vendor channel ID"},
        "ping_time": {
            "long_name": "Timestamp of each ping",
            "standard_name": "time",
            "axis": "T",
        },
        "range_sample": {"long_name": "Along-range sample number, base 0"},
        "beam": {"long_name": "Beam name"},
    },
    "beam_var_default": {
        "backscatter_r": {"long_name": "Raw backscatter measurements (real part)"},
        "backscatter_i": {"long_name": "Raw backscatter measurements (imaginary part)"},
        "transmit_frequency_start": {
            "long_name": "Start frequency in transmitted pulse",
            "standard_name": "sound_frequency",
            "units": "Hz",
            "valid_min": 0.0,
        },
        "transmit_frequency_stop": {
            "long_name": "Stop frequency in transmitted pulse",
            "standard_name": "sound_frequency",
            "units": "Hz",
            "valid_min": 0.0,
        },
        "transmit_duration_nominal": {
            "long_name": "Nominal duration of transmitted pulse",
            "units": "s",
            "valid_min": 0.0,
        },
        "transmit_power": {"long_name": "Nominal transmit power", "units": "W", "valid_min": 0.0},
        "sample_interval": {
            "long_name": "Interval between recorded raw data samples",
            "units": "s",
            "valid_min": 0.0,
        },
        "equivalent_beam_angle": {"long_name": "Equivalent beam angle", "units": "sr"},
    },
    "platform_coord_default": {
        "time1": {
            "axis": "T",
            "long_name": "Timestamps for NMEA datagrams",
            "standard_name": "time",
        },
        "time2": {
            "axis": "T",
            "long_name": "Timestamps for platform motion and orientation data",
            "standard_name": "time",
        },
    },
    "platform_var_default": {
        "latitude": {
            "long_name": "Platform latitude",
            "standard_name": "latitude",
            "units": "degrees_north",
            "valid_range": "(-90.0, 90.0)",
        },
        "longitude": {
            "long_name": "Platform longitude",
            "standard_name": "longitude",
            "units": "degrees_east",
            "valid_range": "(-180.0, 180.0)",
        },
        "sentence_type": {"long_name": "NMEA sentence type"},
        "pitch": {
            "long_name": "Platform pitch",
            "standard_name": "platform_pitch_angle",
            "units": "arc_degree",
            "valid_range": "(-90.0, 90.0)",
        },
        "roll": {
            "long_name": "Platform roll",
            "standard_name": "platform_roll_angle",
            "units": "arc_degree",
            "valid_range": "(-90.0, 90.0)",
        },
        "vertical_offset": {
            "long_name": "Platform vertical offset from nominal water level",
            "units": "m",
        },
        "water_level": {
            "long_name": "Distance from the platform coordinate system origin to the nominal water level along the z-axis",  # noqa: E501
            "units": "m",
        },
        "transducer_offset_x": {
            "long_name": "x-axis distance from the platform coordinate system origin to the sonar transducer",  # noqa: E501
            "units": "m",
        },
        "transducer_offset_y": {
            "long_name": "y-axis distance from the platform coordinate system origin to the sonar transducer",  # noqa: E501
            "units": "m",
        },
        "transducer_offset_z": {
            "long_name": "z-axis distance from the platform coordinate system origin to the sonar transducer",  # noqa: E501
            "units": "m",
        },
        "MRU_offset_x": {"long_name": "Distance along the x-axis from the platform coordinate system origin to the motion reference unit sensor origin", "units": "m"},  # noqa: E501
        "MRU_offset_y": {"long_name": "Distance along the y-axis from the platform coordinate system origin to the motion reference unit sensor origin", "units": "m"},  # noqa: E501
        "MRU_offset_z": {"long_name": "Distance along the z-axis from the platform coordinate system origin to the motion reference unit sensor origin", "units": "m"},  # noqa: E501
        "MRU_rotation_x": {"long_name": "Extrinsic rotation about the x-axis from the platform to MRU coordinate systems", "units": "arc_degree", "valid_range": "(–180.0, 180.0)"},  # noqa: E501
        "MRU_rotation_y": {"long_name": "Extrinsic rotation about the y-axis from the platform to MRU coordinate systems", "units": "arc_degree", "valid_range": "(–180.0, 180.0)"},  # noqa: E501
        "MRU_rotation_z": {"long_name": "Extrinsic rotation about the z-axis from the platform to MRU coordinate systems", "units": "arc_degree", "valid_range": "(–180.0, 180.0)"},  # noqa: E501
        "position_offset_x": {"long_name": "Distance along the x-axis from the platform coordinate system origin to the latitude/longitude sensor origin", "units": "m"},  # noqa: E501
        "position_offset_y": {"long_name": "Distance along the y-axis from the platform coordinate system origin to the latitude/longitude sensor origin", "units": "m"},  # noqa: E501
        "position_offset_z": {"long_name": "Distance along the z-axis from the platform coordinate system origin to the latitude/longitude sensor origin", "units": "m"},  # noqa: E501
        "frequency_nominal": {
            "units": "Hz",
            "long_name": "Transducer frequency",
            "valid_min": 0.0,
            "standard_name": "sound_frequency",
        },
    },
}

TOP_LEVEL_ATTRS = {
    "Conventions": "CF-1.7, SONAR-netCDF4-1.0, ACDD-1.3",
    "sonar_convention_authority": "ICES",
    "sonar_convention_name": "SONAR-netCDF4",
    "sonar_convention_version": "1.0",
    "summary": "",
    "title": "",
}
