"""compute_Sv / compute_TS for EK60/ES70 and EK80/ES80/EA640 data.

Counterpart of ``echopype_tpu/calibrate/api.py`` (reference
echopype/calibrate/api.py:23-449): calibrator dispatch by sonar model,
EK80 waveform/encode validation, multi-``filter_time`` epochs, output
attrs, provenance and water_level.  AZFP/AZFP6 and ``ecs_file`` are not
ported yet and raise ``NotImplementedError`` (ROADMAP Queue 1 item 11).
"""

from __future__ import annotations

import numpy as np

from ..utils.prov import echopype_prov_attrs, source_files_vars
from ..xrlite import Dataset

__all__ = ["compute_Sv", "compute_TS", "epoch_slice_dicts"]

_EK80_MODELS = ("EK80", "ES80", "EA640")


def _calibrator_map():
    from .ek import CalibrateEK60
    from .ek80 import CalibrateEK80

    return {
        "EK60": CalibrateEK60,
        "ES70": CalibrateEK60,
        "EK80": CalibrateEK80,
        "ES80": CalibrateEK80,
        "EA640": CalibrateEK80,
    }


def epoch_slice_dicts(beam, vend):
    """Per-(channel, filter-epoch) slice dicts for multi-``filter_time`` EK80
    files (reference calibrate/api.py:96-197): each channel's valid ping
    range is partitioned at the recorded filter timestamps; a slice selects
    one channel, one filter set, and the ping interval it governs.

    Shared by compute_Sv and both complex survey streamers
    (parallel/survey.py) so all three take identical epoch partitions.
    """
    ftimes_all = np.sort(np.asarray(vend.coords["filter_time"].values))
    pt = np.asarray(beam.coords["ping_time"].values)
    tdn = beam["transmit_duration_nominal"]
    out = []
    for ci, ch in enumerate(beam.coords["channel"].values):
        vals = np.asarray(tdn.values)[ci]
        valid_pt = pt[~np.isnan(vals)]
        f_times = np.intersect1d(valid_pt, ftimes_all)
        if len(f_times) == 0:
            f_times = ftimes_all[:1]
        nexts = np.append(f_times[1:], np.datetime64("NaT")).astype("datetime64[ns]")
        for start, nxt in zip(f_times, nexts):
            end = None if np.isnat(nxt) else nxt - np.timedelta64(1, "ns")
            out.append(
                {
                    "filter_time": start,
                    "channel": str(ch),
                    "beam_group_start_time": start,
                    "beam_group_end_time": end,
                }
            )
    return out


def _compute_cal(
    cal_type,
    echodata,
    env_params=None,
    cal_params=None,
    ecs_file=None,
    waveform_mode=None,
    encode_mode=None,
    assume_single_filter_time=None,
    device="cuda",
    **kwargs,
) -> Dataset:
    model = echodata.sonar_model
    if model in ("AZFP", "AZFP6"):
        raise NotImplementedError(
            f"compute_{cal_type} for {model} is not ported to echopype_torch yet "
            "(ROADMAP Queue 1 item 11); use echopype_tpu"
        )
    cal_map = _calibrator_map()
    if model not in cal_map:
        raise ValueError(f"Unsupported sonar model for calibration: {model}")

    # EK80-style waveform/encode validation (echodata/simrad.py:12)
    if model in _EK80_MODELS:
        from ..echodata.simrad import check_input_args_combination

        waveform_mode, encode_mode = check_input_args_combination(waveform_mode, encode_mode)
    else:
        if waveform_mode is not None and waveform_mode != "CW":
            raise ValueError("EK60-style data can only be calibrated with waveform_mode='CW'")
        if encode_mode is not None and encode_mode != "power":
            raise ValueError("EK60-style data can only be calibrated with encode_mode='power'")
    if (model not in _EK80_MODELS or encode_mode != "complex") and (
        assume_single_filter_time is not None
    ):
        raise ValueError("assume_single_filter_time can only be used on complex EK80 data.")

    def _one(slice_dict):
        cal_obj = cal_map[model](
            echodata,
            env_params=env_params,
            cal_params=cal_params,
            ecs_file=ecs_file,
            waveform_mode=waveform_mode,
            encode_mode=encode_mode,
            slice_dict=slice_dict,
            device=device,
            **kwargs,
        )
        cal_obj._check_echodata_backscatter_size()
        return getattr(cal_obj, f"compute_{cal_type}")()

    # multi-filter_time EK80 epochs (reference calibrate/api.py:96-197)
    vend = echodata.get("Vendor_specific")
    n_filter_times = vend.sizes.get("filter_time", 1) if vend is not None else 1
    if model in _EK80_MODELS and n_filter_times > 1:
        from ..echodata.simrad import retrieve_correct_beam_group

        beam = echodata[retrieve_correct_beam_group(echodata, waveform_mode, encode_mode)]
        tdn = np.asarray(beam["transmit_duration_nominal"].values)
        if assume_single_filter_time:
            pt = np.asarray(beam.coords["ping_time"].values)
            first_valid = {}
            for ci, ch in enumerate(beam.coords["channel"].values):
                good = np.nonzero(~np.isnan(tdn[ci]))[0]
                first_valid[str(ch)] = pt[good[0]] if len(good) else pt[0]
            cal_ds = _one({"first_valid_filter_time_per_channel": first_valid})
        else:
            pieces = [_one(sd) for sd in epoch_slice_dicts(beam, vend)]
            cal_ds = _merge_epoch_outputs(pieces, cal_type)
    else:
        cal_ds = _one({})

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
    if model in _EK80_MODELS:
        cal_ds.data_vars[cal_type].attrs.update(
            {"waveform_mode": waveform_mode, "encode_mode": encode_mode}
        )

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


def _merge_epoch_outputs(pieces, cal_type) -> Dataset:
    """Outer-merge per-(channel, epoch) calibration outputs
    (the xr.merge at reference calibrate/api.py:190-196)."""
    chans = []
    for p in pieces:
        for c in p.coords["channel"].values:
            if c not in chans:
                chans.append(c)
    all_pt = np.unique(np.concatenate([p.coords["ping_time"].values for p in pieces]))
    max_r = max(p.sizes["range_sample"] for p in pieces)
    out = Dataset(
        coords={
            "channel": np.asarray(chans, dtype=object),
            "ping_time": all_pt,
            "range_sample": np.arange(max_r),
        }
    )
    names_3d = [cal_type, "echo_range"]
    for name in names_3d:
        buf = np.full((len(chans), len(all_pt), max_r), np.nan)
        for p in pieces:
            rows = np.searchsorted(all_pt, p.coords["ping_time"].values)
            for ci_local, ch in enumerate(p.coords["channel"].values):
                vals = np.asarray(p[name].values)[ci_local]
                buf[chans.index(ch), rows, : vals.shape[1]] = vals
        out[name] = (("channel", "ping_time", "range_sample"), buf)
    # per-(channel, ping) params: take from pieces where present
    first = pieces[0]
    for name, var in first.data_vars.items():
        if name in names_3d or name in out:
            continue
        if var.dims == ("channel", "ping_time"):
            buf = np.full((len(chans), len(all_pt)), np.nan)
            for p in pieces:
                if name not in p:
                    continue
                rows = np.searchsorted(all_pt, p.coords["ping_time"].values)
                for ci_local, ch in enumerate(p.coords["channel"].values):
                    buf[chans.index(ch), rows] = np.asarray(p[name].values)[ci_local]
            out[name] = (("channel", "ping_time"), buf)
        elif var.dims == ("channel",):
            buf = np.full(len(chans), np.nan)
            for p in pieces:
                if name not in p:
                    continue
                for ci_local, ch in enumerate(p.coords["channel"].values):
                    buf[chans.index(ch)] = np.asarray(p[name].values)[ci_local]
            out[name] = (("channel",), buf)
        else:
            out[name] = var
    out.attrs.update(first.attrs)
    return out


def compute_Sv(
    echodata, env_params=None, cal_params=None, ecs_file=None,
    waveform_mode=None, encode_mode=None, device="cuda", **kwargs,
) -> Dataset:
    """Volume backscattering strength Sv from EK60/ES70 or EK80/ES80/EA640
    raw data.

    Parameters mirror ``echopype_tpu.calibrate.compute_Sv``: ``env_params``,
    ``cal_params``, for EK80 ``waveform_mode`` {"CW", "BB", "FM"} and
    ``encode_mode`` {"complex", "power"}, and the keywords ``precision``
    ("float32" by default: the BB matched filter and the power-mode sonar
    equation run in float32 on ``device``; "float64" runs them in host
    numpy), ``drop_last_hanning_zero`` and ``assume_single_filter_time``.
    ``device`` is "cuda" by default, "cpu" for the plain PyTorch path.
    ``ecs_file`` raises ``NotImplementedError`` (ROADMAP Queue 1 item 11).
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
    """Target strength TS; the arguments of :func:`compute_Sv`."""
    return _compute_cal(
        "TS", echodata, env_params=env_params, cal_params=cal_params,
        ecs_file=ecs_file, waveform_mode=waveform_mode, encode_mode=encode_mode,
        device=device, **kwargs,
    )
