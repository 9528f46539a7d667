"""compute_Sv / compute_TS for EK60/ES70 power-mode data.

Counterpart of ``echopype_tpu/calibrate/api.py`` (reference
echopype/calibrate/api.py:23-449): calibrator dispatch, output attrs,
provenance and water_level.  Other sonar models and modes are not ported
yet (ROADMAP Queue 1 items 6-8) and raise ``NotImplementedError``.
"""

from __future__ import annotations

from ..utils.prov import echopype_prov_attrs, source_files_vars
from ..xrlite import Dataset
from .ek import CalibrateEK60

__all__ = ["compute_Sv", "compute_TS"]

_EK60_MODELS = ("EK60", "ES70")


def _compute_cal(
    cal_type,
    echodata,
    env_params=None,
    cal_params=None,
    ecs_file=None,
    waveform_mode=None,
    encode_mode=None,
    device="cuda",
    **kwargs,
) -> Dataset:
    model = echodata.sonar_model
    if model not in _EK60_MODELS:
        raise NotImplementedError(
            f"compute_{cal_type} for {model} is not ported to echopype_torch yet "
            "(ROADMAP Queue 1: EK80 is item 6, AZFP follows); use echopype_tpu"
        )
    if waveform_mode is not None and waveform_mode != "CW":
        raise ValueError("EK60-style data can only be calibrated with waveform_mode='CW'")
    if encode_mode is not None and encode_mode != "power":
        raise ValueError("EK60-style data can only be calibrated with encode_mode='power'")
    if kwargs.get("assume_single_filter_time") is not None:
        raise ValueError("assume_single_filter_time can only be used on complex EK80 data.")
    if ecs_file is not None:
        raise NotImplementedError(
            "ecs_file is not ported to echopype_torch yet (ROADMAP Queue 1 item 2); "
            "use echopype_tpu"
        )

    cal_obj = CalibrateEK60(
        echodata, env_params=env_params, cal_params=cal_params, device=device, **kwargs,
    )
    cal_obj._check_echodata_backscatter_size()
    cal_ds = getattr(cal_obj, f"compute_{cal_type}")()

    cal_ds.coords["range_sample"].attrs = {"long_name": "Along-range sample number, base 0"}
    cal_ds.data_vars[cal_type].attrs.update(
        {
            "long_name": {
                "Sv": "Volume backscattering strength (Sv re 1 m-1)",
                "TS": "Target strength (TS re 1 m^2)",
            }[cal_type],
            "units": "dB",
        }
    )
    cal_ds.data_vars["echo_range"].attrs.update({"long_name": "Range distance", "units": "m"})

    source_file = echodata.source_file or echodata.converted_raw_path or "SOURCE FILE NOT IDENTIFIED"
    prov = echopype_prov_attrs(process_type="processing")
    prov["processing_function"] = f"calibrate.compute_{cal_type}"
    cal_ds.attrs.update(prov)
    for name, da in source_files_vars(source_file).items():
        cal_ds[name] = da

    plat = echodata.get("Platform")
    if plat is not None and "water_level" in plat.data_vars:
        cal_ds["water_level"] = plat["water_level"]
    return cal_ds


def compute_Sv(
    echodata, env_params=None, cal_params=None, ecs_file=None,
    waveform_mode=None, encode_mode=None, device="cuda", **kwargs,
) -> Dataset:
    """Volume backscattering strength Sv from EK60/ES70 raw data.

    Parameters mirror ``echopype_tpu.calibrate.compute_Sv`` (an ECS file is
    not supported yet); ``device`` picks where the float32 sonar-equation
    pass runs, and ``precision="float64"`` runs it on the host in numpy
    instead.
    """
    return _compute_cal(
        "Sv", echodata, env_params=env_params, cal_params=cal_params,
        ecs_file=ecs_file, waveform_mode=waveform_mode, encode_mode=encode_mode,
        device=device, **kwargs,
    )


def compute_TS(
    echodata, env_params=None, cal_params=None, ecs_file=None,
    waveform_mode=None, encode_mode=None, device="cuda", **kwargs,
) -> Dataset:
    """Target strength TS from EK60/ES70 raw data."""
    return _compute_cal(
        "TS", echodata, env_params=env_params, cal_params=cal_params,
        ecs_file=ecs_file, waveform_mode=waveform_mode, encode_mode=encode_mode,
        device=device, **kwargs,
    )
