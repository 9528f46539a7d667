"""Environmental parameter resolution for calibration.

Capability parity: echopype/calibrate/env_params.py — user dict > data-file
values; sound speed & absorption recomputed when T/S/P(/pH) all supplied;
time1-indexed parameters harmonized onto ping_time.
"""

from __future__ import annotations

import numpy as np

from ..utils import uwa
from ..utils.align import align_to_ping_time
from ..xrlite import DataArray

ENV_PARAMS = (
    "sound_speed",
    "sound_absorption",
    "temperature",
    "salinity",
    "pressure",
    "pH",
    "formula_sound_speed",
    "formula_absorption",
)

__all__ = ["ENV_PARAMS", "get_env_params_EK", "get_env_params_AZFP", "harmonize_env_param_time"]


def harmonize_env_param_time(p, ping_time=None):
    """time1-indexed env param -> scalar / ping_time-aligned (env_params.py:24-71)."""
    if not isinstance(p, DataArray):
        return p
    if "time1" not in p.dims:
        return p
    n_t = p.sizes["time1"]
    if n_t == 1:
        return p.isel(time1=0, drop=True)
    # all-NaN-dropped single value
    pd = p.dropna("time1", how="all")
    if pd.sizes.get("time1", 0) == 1:
        return pd.isel(time1=0, drop=True)
    if ping_time is None:
        raise ValueError("ping_time needed to interpolate env param")
    return align_to_ping_time(pd, "time1", ping_time, method="linear")


def _sanitize_user_env_dict(user_dict, channel):
    out = {p: None for p in ENV_PARAMS}
    if not user_dict:
        return out
    n_ch = len(channel.values) if isinstance(channel, DataArray) else len(channel)
    for k, v in user_dict.items():
        if k not in ENV_PARAMS:
            continue
        if isinstance(v, list):
            if len(v) != n_ch:
                raise ValueError(f"env param {k!r} list length != number of channels")
            v = DataArray(np.asarray(v, dtype="f8"), ("channel",), coords={"channel": channel})
        out[k] = v
    return out


def get_env_params_EK(sonar_type, beam, env, user_dict=None, freq=None):
    """Resolve EK60/EK80 env params (env_params.py:224-353)."""
    if sonar_type not in ("EK60", "EK80"):
        raise ValueError("'sonar_type' has to be 'EK60' or 'EK80'")
    if sonar_type == "EK80" and freq is None:
        raise ValueError("'freq' is required for calibrating EK80-style data.")
    if sonar_type == "EK60":
        freq = beam["frequency_nominal"]

    out = _sanitize_user_env_dict(user_dict or {}, beam["channel"])

    if out["formula_absorption"] not in (None, "AM", "FG"):
        raise ValueError("'formula_absorption' has to be None, 'FG' or 'AM' for EK echosounders.")
    if out["formula_sound_speed"] not in (None, "Mackenzie"):
        raise ValueError("'formula_sound_speed' has to be None or 'Mackenzie' for EK echosounders.")

    tspa_all_exist = all(
        out[p] is not None for p in ("temperature", "salinity", "pressure", "pH")
    )

    if not tspa_all_exist and sonar_type == "EK80":
        for p_user, p_data in zip(
            ("temperature", "salinity", "pressure", "pH"),
            ("temperature", "salinity", "depth", "acidity"),
        ):
            if out[p_user] is None and p_data in env:
                out[p_user] = env[p_data]

    if out["sound_speed"] is None:
        if not tspa_all_exist:
            out["sound_speed"] = env["sound_speed_indicative"]
            out.pop("formula_sound_speed")
        else:
            if out["formula_sound_speed"] is None:
                out["formula_sound_speed"] = "Mackenzie"
            out["sound_speed"] = uwa.calc_sound_speed(
                temperature=out["temperature"],
                salinity=out["salinity"],
                pressure=out["pressure"],
                formula_source=out["formula_sound_speed"],
            )
    else:
        out.pop("formula_sound_speed")

    if out["sound_absorption"] is None:
        if not tspa_all_exist and sonar_type != "EK80":
            out["sound_absorption"] = env["absorption_indicative"]
            out.pop("formula_absorption")
        else:
            if out["formula_absorption"] is None:
                out["formula_absorption"] = "FG"
            out["sound_absorption"] = uwa.calc_absorption(
                frequency=freq,
                temperature=out["temperature"],
                salinity=out["salinity"],
                pressure=out["pressure"],
                pH=out["pH"],
                sound_speed=out["sound_speed"],
                formula_source=out["formula_absorption"],
            )
    else:
        out.pop("formula_absorption")

    if not ("formula_sound_speed" in out or "formula_absorption" in out):
        for p in ("temperature", "salinity", "pressure", "pH"):
            out.pop(p, None)

    for p in list(out.keys()):
        out[p] = harmonize_env_param_time(out[p], ping_time=beam.coords.get("ping_time"))
    return out


def get_env_params_AZFP(echodata, user_dict=None):
    """AZFP env params require user temperature(optional)/salinity/pressure
    (env_params.py:160-221)."""
    env = echodata["Environment"]
    user_dict = dict(user_dict or {})
    out = {p: user_dict.get(p) for p in ENV_PARAMS}
    if out["temperature"] is None and "temperature" in env:
        out["temperature"] = env["temperature"]
    for p in ("salinity", "pressure"):
        if out[p] is None:
            raise ReferenceError(f"AZFP calibration requires user-specified {p}")
    if out["sound_speed"] is None:
        out["sound_speed"] = uwa.calc_sound_speed(
            temperature=out["temperature"],
            salinity=out["salinity"],
            pressure=out["pressure"],
            formula_source="AZFP",
        )
    if out["sound_absorption"] is None:
        freq = echodata["Sonar/Beam_group1"]["frequency_nominal"]
        out["sound_absorption"] = uwa.calc_absorption(
            frequency=freq,
            temperature=out["temperature"],
            salinity=out["salinity"],
            pressure=out["pressure"],
            formula_source="AZFP",
        )
    ping_time = echodata["Sonar/Beam_group1"].coords.get("ping_time")
    for p in list(out.keys()):
        if isinstance(out[p], DataArray):
            out[p] = harmonize_env_param_time(out[p], ping_time=ping_time)
    return {k: v for k, v in out.items() if v is not None}


def sanitize_user_env_dict(user_dict, channel):
    """Public reference-named wrapper (reference: env_params.py sanitize_user_env_dict)."""
    return _sanitize_user_env_dict(user_dict, channel)
