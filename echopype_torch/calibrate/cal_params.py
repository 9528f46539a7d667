"""Calibration parameter resolution.

Capability parity: echopype/calibrate/cal_params.py — per-model allowlists,
user-dict sanitization, vendor power-table matching by transmit duration,
EK80 defaults.
"""

from __future__ import annotations

import numpy as np

from ..xrlite import DataArray

CAL_PARAMS = {
    "EK60": (
        "sa_correction",
        "gain_correction",
        "equivalent_beam_angle",
        "angle_offset_alongship",
        "angle_offset_athwartship",
        "angle_sensitivity_alongship",
        "angle_sensitivity_athwartship",
        "beamwidth_alongship",
        "beamwidth_athwartship",
    ),
    "EK80": (
        "sa_correction",
        "gain_correction",
        "equivalent_beam_angle",
        "angle_offset_alongship",
        "angle_offset_athwartship",
        "angle_sensitivity_alongship",
        "angle_sensitivity_athwartship",
        "beamwidth_alongship",
        "beamwidth_athwartship",
        "impedance_transducer",
        "impedance_transceiver",
        "receiver_sampling_frequency",
    ),
    "AZFP": ("EL", "DS", "TVR", "VTX0", "equivalent_beam_angle", "Sv_offset"),
}

EK80_DEFAULT_PARAMS = {
    "impedance_transducer": 75,
    "impedance_transceiver": 1000,
    "receiver_sampling_frequency": {
        "default": 1500000,
        "GPT": 500000,
        "SBT": 50000,
        "WBAT": 1500000,
        "WBT TUBE": 1500000,
        "WBT MINI": 1500000,
        "WBT": 1500000,
        "WBT HP": 187500,
        "WBT LF": 93750,
    },
}

# beam-group name -> cal-param name remaps (cal_params.py, get_cal_params_EK)
PARAM_BEAM_NAME_MAP = {
    "beamwidth_alongship": "beamwidth_twoway_alongship",
    "beamwidth_athwartship": "beamwidth_twoway_athwartship",
}

__all__ = [
    "CAL_PARAMS",
    "EK80_DEFAULT_PARAMS",
    "param2da",
    "sanitize_user_cal_dict",
    "get_vend_cal_params_power",
    "get_cal_params_EK",
    "get_cal_params_AZFP",
]


def param2da(p_val, channel) -> DataArray:
    """Scalar or per-channel list -> DataArray on the channel coord."""
    ch_vals = channel.values if isinstance(channel, DataArray) else np.asarray(channel)
    if isinstance(p_val, (int, float)):
        vals = np.full(len(ch_vals), float(p_val))
    elif isinstance(p_val, list):
        if len(p_val) != len(ch_vals):
            raise ValueError("The lengths of 'p_val' and 'channel' should be identical")
        vals = np.asarray(p_val, dtype="f8")
    else:
        raise ValueError("'p_val' needs to be one of type int, float, or list")
    return DataArray(vals, ("channel",), coords={"channel": ch_vals})


def sanitize_user_cal_dict(sonar_type, user_dict, channel):
    """Keep only allowed params; normalize scalars/lists to channel arrays."""
    if sonar_type not in CAL_PARAMS:
        raise ValueError("'sonar_type' has to be one of: 'EK60', 'EK80', or 'AZFP'")
    out = {p: None for p in CAL_PARAMS[sonar_type]}
    if not user_dict:
        return out
    if not isinstance(user_dict, dict):
        raise TypeError("cal_params must be a dict")
    for k, v in user_dict.items():
        if k not in out:
            continue
        if isinstance(v, (int, float, list)):
            out[k] = param2da(v, channel)
        elif isinstance(v, DataArray):
            if "channel" not in v.dims and "cal_frequency" not in v.dims:
                raise ValueError(f"cal param {k!r} DataArray needs a channel coordinate")
            out[k] = v
        else:
            raise ValueError(f"cal param {k!r} has unsupported type {type(v)}")
    return out


def get_vend_cal_params_power(beam, vend, param: str) -> DataArray:
    """Match vendor table entries to each ping's transmit duration.

    Mirrors cal_params.py:261-324: select the pulse_length_bin whose
    ``pulse_length`` is nearest each ping's ``transmit_duration_nominal``.
    Returns [channel, ping_time].
    """
    if param not in ("sa_correction", "gain_correction"):
        raise ValueError(f"Unknown parameter {param}")
    if param not in vend:
        raise ValueError(f"{param} does not exist in the Vendor_specific group!")

    # align vendor channels to beam channel order
    beam_ch = beam.coords["channel"].values
    vend_ch = vend.coords["channel"].values.tolist()
    order = [vend_ch.index(c) for c in beam_ch]

    tdn = beam["transmit_duration_nominal"].values  # [C, P] (or [P] per chan)
    plen = vend["pulse_length"].values[order]  # [C, B]
    table = vend[param].values[order]  # [C, B]

    tdn2 = np.atleast_2d(tdn)
    isnull = np.isnan(tdn2)
    safe = np.where(isnull, 0.0, tdn2)
    # NaN-padded table entries must never win the match (xarray idxmin skips NaN)
    plen_safe = np.where(np.isnan(plen), np.inf, plen)
    idx = np.abs(safe[:, :, None] - plen_safe[:, None, :]).argmin(axis=2)  # [C, P]
    out = np.take_along_axis(table, idx, axis=1).astype("f8")
    out[isnull] = np.nan
    return DataArray(
        out,
        ("channel", "ping_time"),
        coords={"channel": beam_ch, "ping_time": beam.coords["ping_time"]},
        name=param,
    )


def _get_interp_da(da_param, freq_center, alternative, BB_factor=1):
    """Frequency-interpolated parameter per channel (cal_params.py:165-258).

    da_param: vendor cal-curve DataArray (cal_channel_id, cal_frequency) or None.
    freq_center: DataArray [channel] or [channel, ping_time].
    alternative: scalar or DataArray on channel, scaled by BB_factor when used.
    """
    ch_vals = freq_center.coords["channel"].values
    has_ping = "ping_time" in freq_center.dims
    n_ping = freq_center.sizes.get("ping_time", 1)
    out = np.full((len(ch_vals), n_ping), np.nan)
    cal_ids = (
        [str(c) for c in da_param.coords["cal_channel_id"].values]
        if da_param is not None and "cal_channel_id" in da_param.coords
        else []
    )
    for i, ch in enumerate(ch_vals):
        fc = np.atleast_1d(np.asarray(freq_center.sel(channel=ch).values, dtype="f8"))
        if str(ch) in cal_ids:
            row = da_param.sel(cal_channel_id=str(ch))
            xs = np.asarray(row.coords["cal_frequency"].values, dtype="f8")
            ys = np.asarray(row.values, dtype="f8")
            good = ~np.isnan(ys)
            if good.sum() >= 2:
                xg, yg = xs[good], ys[good]
                res = np.interp(fc, xg, yg)
                # xarray interp semantics: NaN outside the curve's frequency
                # range (np.interp would clamp to the edge values) — e.g. a
                # channel whose center frequency lies outside its own BB cal
                # table gets NaN gain, not the nearest table entry
                res = np.where((fc < xg[0]) | (fc > xg[-1]), np.nan, res)
                out[i] = res
                continue
        bb = (
            float(BB_factor.sel(channel=ch).values)
            if isinstance(BB_factor, DataArray)
            else BB_factor
        )
        if isinstance(alternative, DataArray):
            alt = np.asarray(alternative.sel(channel=ch).values, dtype="f8").squeeze() * bb
        else:
            alt = float(alternative) * bb
        out[i] = alt if np.ndim(alt) == 0 else np.broadcast_to(np.atleast_1d(alt), (n_ping,))
    if has_ping:
        return DataArray(
            out,
            ("channel", "ping_time"),
            coords={"channel": ch_vals, "ping_time": freq_center.coords["ping_time"]},
        )
    return DataArray(out[:, 0], ("channel",), coords={"channel": ch_vals})


def get_cal_params_EK(waveform_mode, freq_center, beam, vend, user_dict=None, sonar_type="EK60"):
    """Assemble the full EK cal-param dict (cal_params.py:365-522).

    Priority: user dict > vendor cal curves (BB interp at center frequency) /
    vendor narrowband tables > beam-group defaults.
    """
    out = sanitize_user_cal_dict(sonar_type, user_dict or {}, beam["channel"])

    for p in list(out.keys()):
        if out[p] is not None:
            continue
        if p == "sa_correction":
            out[p] = get_vend_cal_params_power(beam, vend, p)
        elif p == "impedance_transceiver":
            out[p] = (
                vend["impedance_transceiver"]
                if "impedance_transceiver" in vend
                else param2da(EK80_DEFAULT_PARAMS["impedance_transceiver"], beam["channel"])
            )
        elif p == "receiver_sampling_frequency":
            out[p] = _default_receiver_fs(beam, vend)
        elif waveform_mode == "CW" or waveform_mode is None:
            if p == "gain_correction":
                if "gain_correction" in vend:
                    out[p] = get_vend_cal_params_power(beam, vend, p)
                elif "gain_correction" in beam:
                    out[p] = beam["gain_correction"]
                else:
                    out[p] = param2da(0.0, beam["channel"])
            elif p == "impedance_transducer":
                out[p] = _get_interp_da(
                    vend.get("impedance_transducer"),
                    _as_channel_da(freq_center, beam),
                    EK80_DEFAULT_PARAMS["impedance_transducer"],
                )
            else:
                beam_name = PARAM_BEAM_NAME_MAP.get(p, p)
                out[p] = beam[beam_name] if beam_name in beam else param2da(0.0, beam["channel"])
        else:  # BB mode: interpolate cal curves at the center frequency
            if p in PARAM_BEAM_NAME_MAP or p in (
                "angle_offset_alongship",
                "angle_offset_athwartship",
                "angle_sensitivity_alongship",
                "angle_sensitivity_athwartship",
            ):
                if p in ("angle_sensitivity_alongship", "angle_sensitivity_athwartship"):
                    BB_factor = freq_center / beam["frequency_nominal"]
                elif p in ("beamwidth_alongship", "beamwidth_athwartship"):
                    BB_factor = beam["frequency_nominal"] / freq_center
                else:
                    BB_factor = 1
                if isinstance(BB_factor, DataArray) and "ping_time" in BB_factor.dims:
                    BB_factor = BB_factor.isel(ping_time=0)
                beam_name = PARAM_BEAM_NAME_MAP.get(p, p)
                out[p] = _get_interp_da(
                    vend.get(p),
                    freq_center,
                    beam[beam_name] if beam_name in beam else 0.0,
                    BB_factor=BB_factor,
                )
            elif p == "equivalent_beam_angle":
                out[p] = beam[p] + 20 * np.log10(beam["frequency_nominal"] / freq_center)
            elif p == "gain_correction":
                out[p] = _get_interp_da(
                    vend.get("gain"),
                    freq_center,
                    get_vend_cal_params_power(beam, vend, p),
                )
            elif p == "impedance_transducer":
                out[p] = _get_interp_da(
                    vend.get("impedance_transducer"),
                    freq_center,
                    EK80_DEFAULT_PARAMS["impedance_transducer"],
                )
            else:
                raise ValueError(f"{p} not in the defined set of calibration parameters.")
    return out


def _as_channel_da(freq_center, beam):
    if isinstance(freq_center, DataArray):
        return freq_center
    return beam["frequency_nominal"]


def _default_receiver_fs(beam, vend):
    """Receiver sampling frequency from vendor fs or transceiver-type defaults."""
    ch = beam.coords["channel"].values
    if "receiver_sampling_frequency" in vend:
        fs = vend["receiver_sampling_frequency"]
        vals = np.asarray(fs.values, dtype="f8")
        if not np.all(np.isnan(vals)) and not np.all(vals == 0):
            vend_ch = vend.coords["channel"].values.tolist()
            order = [vend_ch.index(c) for c in ch]
            return DataArray(vals[order], ("channel",), coords={"channel": ch})
    table = EK80_DEFAULT_PARAMS["receiver_sampling_frequency"]
    if "transceiver_type" in vend:
        vend_ch = vend.coords["channel"].values.tolist()
        order = [vend_ch.index(c) for c in ch]
        ttypes = np.asarray(vend["transceiver_type"].values)[order]
        vals = np.asarray([table.get(str(t), table["default"]) for t in ttypes], dtype="f8")
    else:
        vals = np.full(len(ch), float(table["default"]))
    return DataArray(vals, ("channel",), coords={"channel": ch})


def get_cal_params_AZFP(beam, vend, user_dict=None):
    """AZFP cal params from the Vendor group (cal_params.py:327-362)."""
    out = sanitize_user_cal_dict("AZFP", user_dict or {}, beam["channel"])
    for p in list(out.keys()):
        if out[p] is not None:
            continue
        if p == "equivalent_beam_angle":
            out[p] = beam[p] if p in beam else param2da(0.0, beam["channel"])
        elif p in vend:
            out[p] = vend[p]
        else:
            raise ValueError(f"AZFP cal param {p} missing from Vendor_specific group")
    return out
