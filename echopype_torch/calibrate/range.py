"""Echo range computation and TVG range correction.

Capability parity: echopype/calibrate/range.py:98-201.
"""

from __future__ import annotations

import numpy as np

from ..xrlite import DataArray

DIMENSION_ORDER = ("channel", "ping_time", "range_sample")

__all__ = ["compute_range_EK", "compute_range_AZFP", "range_mod_TVG_EK", "tvg_shift_meters"]


def compute_range_AZFP(echodata, env_params, cal_type):
    """AZFP range per the operator's manual p.86 (reference range.py:11-95).

    range = cL/(2f) + (c/4) * (((2(k+1)-1) N - 1)/f + tau) - offset
    with offset = 0 for Sv and c*tau/4 for TS.
    """
    from .env_params import harmonize_env_param_time

    if "sound_speed" not in env_params:
        raise RuntimeError("sound_speed not included in env_params")
    sound_speed = env_params["sound_speed"]
    if cal_type is None:
        raise ValueError('cal_type must be "Sv" or "TS"')

    vend = echodata["Vendor_specific"]
    beam = echodata["Sonar/Beam_group1"]
    N = vend["number_of_samples_per_average_bin"]
    f = vend["digitization_rate"]
    L = vend["lock_out_index"]
    bins_to_avg = 1

    sound_speed = harmonize_env_param_time(sound_speed, ping_time=beam.coords["ping_time"])

    if cal_type == "Sv":
        range_offset = 0
    else:
        range_offset = sound_speed * beam["transmit_duration_nominal"] / 4
    range_meter = (
        sound_speed * L / (2 * f)
        + (sound_speed / 4)
        * (
            ((2 * (beam["range_sample"] + 1) - 1) * N * bins_to_avg - 1) / f
            + beam["transmit_duration_nominal"]
        )
        - range_offset
    )
    range_meter.name = "echo_range"
    return range_meter.transpose(*[d for d in DIMENSION_ORDER if d in range_meter.dims])


def compute_range_EK(sonar_model, beam, env_params):
    """range = range_sample * sample_interval * sound_speed / 2 [m].

    Entries where backscatter is NaN become NaN (reference range.py:140-150).
    """
    if "sound_speed" not in env_params:
        raise RuntimeError("sound_speed not included in env_params")
    sound_speed = env_params["sound_speed"]
    range_meter = beam["range_sample"] * beam["sample_interval"] * sound_speed / 2
    range_meter = range_meter.transpose(
        *[d for d in DIMENSION_ORDER if d in range_meter.dims]
    )
    bs = beam["backscatter_r"]
    if "beam" in bs.dims:
        bs = bs.isel(beam=0, drop=True)
    valid = bs.notnull()
    range_meter = range_meter.where(valid)
    range_meter.name = "echo_range"
    if "time1" in range_meter.coords:
        del range_meter.coords["time1"]
    return range_meter


def tvg_shift_meters(sonar_model, beam, vend, sound_speed):
    """TVG range-correction term in meters per (channel, ping).

    Ex60 hardware: 2-sample shift = 2 * sample_interval * c / 2.
    Ex80 hardware: c * tau / 4; EK80 GPT channels additionally get the Ex60
    shift (range.py:160-201).
    """
    mod_ex60 = 2 * beam["sample_interval"] * sound_speed / 2

    if sonar_model in ("EK60", "ES70"):
        return mod_ex60

    mod_ex80 = sound_speed * beam["transmit_duration_nominal"] / 4
    if "time1" in getattr(mod_ex80, "coords", {}):
        del mod_ex80.coords["time1"]
    if "transceiver_type" in vend:
        ttype = np.asarray(vend["transceiver_type"].values)
        if "GPT" in ttype:
            vend_ch = vend.coords["channel"].values.tolist()
            beam_ch = beam.coords["channel"].values
            is_gpt = np.array([ttype[vend_ch.index(c)] == "GPT" for c in beam_ch])
            gpt_add = mod_ex60 * DataArray(
                is_gpt.astype("f8"), ("channel",), coords={"channel": beam_ch}
            )
            mod_ex80 = mod_ex80 + gpt_add
    return mod_ex80


def range_mod_TVG_EK(sonar_model, beam, vend, range_meter, sound_speed):
    """Subtract the hardware-dependent TVG correction from range."""
    shift = tvg_shift_meters(sonar_model, beam, vend, sound_speed)
    return range_meter - shift
