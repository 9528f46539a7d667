"""consolidate: enrich Sv datasets with depth, location, split-beam angles.

Capability parity: echopype/consolidate/api.py:31-549.
"""

from __future__ import annotations

from datetime import datetime, timezone
from numbers import Number

import numpy as np

from ..utils.align import align_to_ping_time
from ..utils.log import _init_logger
from ..utils.profiling import stage
from ..utils.prov import add_processing_level
from ..xrlite import DataArray, Dataset
from .ek_depth_utils import (
    ek_use_beam_angles,
    ek_use_platform_angles,
    ek_use_platform_vertical_offsets,
)
from .loc_utils import check_loc_vars_validity, sel_nmea
from .split_beam_angle import get_angle_complex_samples, get_angle_power_samples

logger = _init_logger(__name__)

__all__ = [
    "swap_dims_channel_frequency",
    "add_depth",
    "add_location",
    "add_splitbeam_angle",
]


def swap_dims_channel_frequency(ds: Dataset) -> Dataset:
    """Swap channel dim for frequency_nominal (consolidate/api.py:31-64)."""
    freqs = np.asarray(ds["frequency_nominal"].values)
    if np.unique(freqs).size != freqs.size:
        raise ValueError(
            "This file carries duplicate transducer nominal frequencies; "
            "Operation is not valid."
        )
    out = ds.copy()
    out.coords["frequency_nominal"] = DataArray(
        freqs, ("channel",), attrs=dict(ds["frequency_nominal"].attrs), name="frequency_nominal"
    )
    del out.data_vars["frequency_nominal"]
    out = out.swap_dims({"channel": "frequency_nominal"})
    # channel becomes a plain variable on the frequency dim
    ch = out.coords.pop("channel")
    out.data_vars["channel"] = DataArray(
        ch.values, ("frequency_nominal",), attrs=ch.attrs, name="channel"
    )
    return out


def _history(msg):
    return f"{datetime.now(timezone.utc).isoformat()}. {msg}"


@add_processing_level("L2A")
def add_depth(
    ds: Dataset,
    echodata=None,
    depth_offset=None,
    tilt=None,
    downward: bool = True,
    use_platform_vertical_offsets: bool = False,
    use_platform_angles: bool = False,
    use_beam_angles: bool = False,
) -> Dataset:
    """depth = transducer_depth + (+-1) * echo_range * scaling
    (consolidate/api.py:67-241); timed as stage ``add_depth``
    (``utils.profiling.stage``)."""
    with stage("add_depth"):
        from ..utils.io import open_source

        ds = open_source(ds, "dataset")
        if echodata is not None and not hasattr(echodata, "group_paths"):
            echodata = open_source(echodata, "echodata")
        if (not echodata) and (
            use_platform_vertical_offsets or use_platform_angles or use_beam_angles
        ):
            raise ValueError(
                "If any of `use_platform_vertical_offsets`, `use_platform_angles` "
                "or `use_beam_angles` is `True`, then `echodata` cannot be `None`."
            )
        if use_platform_angles and use_beam_angles:
            raise NotImplementedError(
                "Depth from platform angles combined with beam angles is not supported yet."
            )
        if depth_offset is not None and use_platform_vertical_offsets:
            logger.warning(
                "When `depth_offset` is specified, platform vertical offset variables will not "
                "be used."
            )
        if tilt is not None and (use_beam_angles or use_platform_angles):
            logger.warning(
                "When `tilt` is specified, beam/platform angle variables will not be used."
            )

        sonar_model = None
        if echodata is not None:
            sonar_model = echodata["Sonar"].attrs.get("sonar_model", echodata.sonar_model)
            if sonar_model not in ("EK60", "EK80") and (
                use_platform_vertical_offsets or use_platform_angles or use_beam_angles
            ):
                raise NotImplementedError(
                    "The use_platform_*/use_beam_* options are not supported for "
                    f"{sonar_model} yet."
                )

        beam_group_name = None
        transducer_depth = 0.0
        if isinstance(depth_offset, Number):
            transducer_depth = depth_offset
        elif isinstance(depth_offset, DataArray):
            if len(depth_offset.dims) != 1:
                raise ValueError(
                    "If depth_offset is passed in as a DataArray, it must contain a single "
                    "dimension."
                )
            transducer_depth = align_to_ping_time(
                depth_offset, depth_offset.dims[0], ds.coords["ping_time"]
            )
        elif (echodata is not None and sonar_model in ("EK60", "EK80")
              and use_platform_vertical_offsets):
            transducer_depth = ek_use_platform_vertical_offsets(
                echodata["Platform"], ds.coords["ping_time"]
            )

        echo_range_scaling = 1.0
        if isinstance(tilt, Number):
            echo_range_scaling = np.cos(np.deg2rad(tilt))
        elif isinstance(tilt, DataArray):
            if len(tilt.dims) != 1:
                raise ValueError(
                    "If tilt is passed in as a DataArray, it must contain a single dimension."
                )
            echo_range_scaling = np.cos(
                np.deg2rad(align_to_ping_time(tilt, tilt.dims[0], ds.coords["ping_time"]))
            )
        elif echodata is not None and sonar_model in ("EK60", "EK80"):
            if use_platform_angles:
                echo_range_scaling = ek_use_platform_angles(
                    echodata["Platform"], ds.coords["ping_time"]
                )
            elif use_beam_angles:
                if np.array_equal(
                    echodata["Sonar/Beam_group1"].coords["channel"].values,
                    ds.coords["channel"].values,
                ):
                    beam_group_name = "Beam_group1"
                else:
                    beam_group_name = "Beam_group2"
                echo_range_scaling = ek_use_beam_angles(echodata[f"Sonar/{beam_group_name}"])

        orientation_mult = 1 if downward else -1
        depth = transducer_depth + orientation_mult * ds["echo_range"] * echo_range_scaling
        if isinstance(depth, DataArray):
            depth = depth.transpose(*[d for d in ds["Sv"].dims if d in depth.dims])

        out = ds.copy()
        used_pvo = use_platform_vertical_offsets and not depth_offset
        used_pa = use_platform_angles and not tilt
        used_ba = use_beam_angles and not tilt
        hist = _history(
            "`depth` calculated using: Sv `echo_range`"
            + (", Echodata `Platform` Vertical Offsets" if used_pvo else "")
            + (", Echodata `Platform` Angles" if used_pa else "")
            + (f", Echodata `{beam_group_name}` Angles" if used_ba else "")
            + "."
        )
        out["depth"] = (depth.dims, depth.values, {"history": hist, "units": "m"})
        return out


@add_processing_level("L2A")
def add_location(ds: Dataset, echodata, datagram_type=None, nmea_sentence=None) -> Dataset:
    """Interpolate Platform lat/lon onto ping_time (consolidate/api.py:244-342);
    timed as stage ``add_location`` (``utils.profiling.stage``)."""
    with stage("add_location"):
        from ..utils.io import open_source

        ds = open_source(ds, "dataset")
        if not hasattr(echodata, "group_paths"):
            echodata = open_source(echodata, "echodata")
        if echodata.sonar_model and echodata.sonar_model.startswith("EK") and datagram_type in (
            "MRU1",
            "IDX",
        ):
            lat_name = f"latitude_{datagram_type.lower()}"
            lon_name = f"longitude_{datagram_type.lower()}"
        elif echodata.sonar_model and not echodata.sonar_model.startswith("EK") and datagram_type:
            raise ValueError("datagram_type requires an EK-family sonar model.")
        else:
            lat_name, lon_name = "latitude", "longitude"

        check_loc_vars_validity(echodata, lat_name, lon_name, datagram_type, "missing")
        check_loc_vars_validity(echodata, lat_name, lon_name, datagram_type, "all_nan")
        check_loc_vars_validity(echodata, lat_name, lon_name, datagram_type, "some_nan")
        check_loc_vars_validity(echodata, lat_name, lon_name, datagram_type, "some_zero")

        time_dim_name = echodata["Platform"][lon_name].dims[0]
        out = ds.copy()
        hist = _history(f"Interpolated or propagated from Platform {lat_name}/{lon_name}.")
        for loc_name, interp_name in ((lat_name, "latitude"), (lon_name, "longitude")):
            loc_var = sel_nmea(
                echodata=echodata,
                loc_name=loc_name,
                nmea_sentence=nmea_sentence,
                datagram_type=datagram_type,
            )
            tvals = loc_var.coords[time_dim_name].values
            if len(np.unique(tvals)) != len(tvals):
                raise ValueError(
                    f"Duplicate timestamps in Platform.{time_dim_name} for the NMEA subset; "
                    "cannot interpolate location."
                )
            # drop NaN samples before interpolating
            vals = np.asarray(loc_var.values, dtype="f8")
            good = ~np.isnan(vals)
            loc_var = loc_var.isel({time_dim_name: np.nonzero(good)[0]})
            interp = align_to_ping_time(loc_var, time_dim_name, ds.coords["ping_time"], "linear")
            out[interp_name] = (
                interp.dims,
                interp.values,
                {**echodata["Platform"][loc_name].attrs, "history": hist},
            )
        return out


def add_splitbeam_angle(
    source_Sv: Dataset,
    echodata,
    waveform_mode: str,
    encode_mode: str,
    pulse_compression: bool = False,
    storage_options: dict = {},
    to_disk: bool = False,
    drop_last_hanning_zero: bool = False,
) -> Dataset:
    """Add physical split-beam angles to an Sv dataset
    (consolidate/api.py:345-549)."""
    from ..echodata.simrad import check_input_args_combination, retrieve_correct_beam_group

    from ..utils.io import open_source

    source_Sv = open_source(source_Sv, "dataset", storage_options=storage_options)
    if echodata.sonar_model not in ("EK60", "ES70", "EK80", "ES80", "EA640"):
        raise ValueError("add_splitbeam_angle is only supported for EK echosounders")
    if "ping_time" not in source_Sv.sizes or "range_sample" not in source_Sv.sizes:
        raise NotImplementedError("Split-beam angles can only be added to full-resolution Sv, not MVBS.")
    if echodata.sonar_model in ("EK80", "ES80", "EA640"):
        waveform_mode, encode_mode = check_input_args_combination(
            waveform_mode, encode_mode, pulse_compression
        )
    ed_beam_group = retrieve_correct_beam_group(echodata, waveform_mode, encode_mode)
    if "channel" not in source_Sv.sizes:
        raise ValueError("source_Sv needs a channel dimension.")

    ds_beam = echodata[ed_beam_group].sel(channel=list(source_Sv.coords["channel"].values))

    angle_params = {}
    for p_name in (
        "angle_sensitivity_alongship",
        "angle_sensitivity_athwartship",
        "angle_offset_alongship",
        "angle_offset_athwartship",
    ):
        if p_name in source_Sv:
            angle_params[p_name] = source_Sv[p_name]
        else:
            raise ValueError(f"source_Sv is missing the required parameter {p_name}.")

    if waveform_mode == "CW":
        if encode_mode == "power":
            theta, phi = get_angle_power_samples(ds_beam, angle_params)
        else:
            theta, phi = get_angle_complex_samples(ds_beam, angle_params)
    else:
        if pulse_compression:
            from ..calibrate.ek80_complex import get_filter_coeff

            pc_params = get_filter_coeff(
                echodata["Vendor_specific"].sel(
                    channel=list(source_Sv.coords["channel"].values)
                )
            )
            pc_params["receiver_sampling_frequency"] = source_Sv["receiver_sampling_frequency"]
            pc_params["drop_last_hanning_zero"] = drop_last_hanning_zero
            theta, phi = get_angle_complex_samples(ds_beam, angle_params, pc_params)
        else:
            theta, phi = get_angle_complex_samples(ds_beam, angle_params)

    hist = _history("Calculated using data stored in the Beam groups of the echodata object.")
    out = source_Sv.copy()
    out["angle_alongship"] = (
        theta.dims,
        theta.values,
        {"long_name": "split-beam alongship angle", "history": hist},
    )
    out["angle_athwartship"] = (
        phi.dims,
        phi.values,
        {"long_name": "split-beam athwartship angle", "history": hist},
    )
    return out
