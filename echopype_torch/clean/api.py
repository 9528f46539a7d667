"""clean: noise removal masks and background noise estimation.

Counterpart of ``echopype_tpu/clean/api.py`` (capability parity:
echopype/clean/api.py:30-655; Ryan et al. 2015, De Robertis & Higginbottom
2007; echopy-derived kernels).  The three masks take ``device=`` ("cuda" by
default, "cpu" for the plain path) for their window programs
(``ops/windows.py``); the background-noise estimate and the transient
detectors are host float64, as in the JAX package.
"""

from __future__ import annotations

import numpy as np

from ..commongrid.utils import _parse_x_bin
from ..utils.compute import _lin2log, _log2lin
from ..utils.log import _init_logger
from ..utils.prov import add_processing_level, echopype_prov_attrs, insert_input_processing_level
from ..xrlite import DataArray, Dataset
from . import utils as cu

logger = _init_logger(__name__)

__all__ = [
    "mask_transient_noise",
    "mask_impulse_noise",
    "mask_attenuated_signal",
    "estimate_background_noise",
    "remove_background_noise",
    "detect_transient",
]


def _host(t):
    return t.cpu().numpy()


def _check_range_var(ds_Sv, range_var):
    if range_var not in ("echo_range", "depth"):
        raise ValueError("`range_var` must be either `echo_range` or `depth`.")
    if range_var not in ds_Sv.data_vars:
        raise ValueError(f"This function requires `{range_var}` data variable in `ds_Sv`.")


def _range_values(ds_Sv, range_var, shape):
    rv = ds_Sv[range_var]
    vals = np.asarray(rv.values, dtype="f8")
    if vals.shape != shape:
        # broadcast [R]- or [C,R]-shaped range vars against [C,P,R]
        da = rv
        sv_dims = ds_Sv["Sv"].dims
        out = vals
        for i, d in enumerate(sv_dims):
            if d not in da.dims:
                out = np.expand_dims(out, i)
        vals = np.broadcast_to(out, shape).copy()
    return vals


def mask_transient_noise(
    ds_Sv: Dataset,
    func: str = "nanmean",
    depth_bin: str = "10m",
    num_side_pings: int = 25,
    exclude_above: str = "250.0m",
    transient_noise_threshold: str = "12.0dB",
    range_var: str = "depth",
    use_index_binning: bool = False,
    chunk_dict: dict = {},
    device="cuda",
) -> DataArray:
    """Transient-noise mask via pooled-Sv comparison (clean/api.py:30-168).

    ``nanmean`` on a ping-invariant grid pools on ``device`` and reads the
    mask back bit-packed; a grid that varies by ping pools on the host in
    float64, ``nanmedian`` and ``use_index_binning`` on the host."""
    _check_range_var(ds_Sv, range_var)
    if func not in ("nanmean", "nanmedian"):
        raise ValueError(f"Input `func` is `{func}`. `func` must be `nanmean` or `nanmedian`.")
    thr = cu.extract_dB(transient_noise_threshold)
    depth_bin_m = _parse_x_bin(depth_bin, "range_bin")
    exclude_above_m = _parse_x_bin(exclude_above, "range_bin")

    sv = np.asarray(ds_Sv["Sv"].values, dtype="f8")
    depth = _range_values(ds_Sv, range_var, sv.shape)
    if use_index_binning:
        # index-window image filter over the echogram (assumes uniform depth
        # step per channel), reference: clean/api.py:158-163, utils.py:109-181
        pooled = cu.index_binning_pool_Sv(
            sv, depth, func, depth_bin_m, num_side_pings, exclude_above_m
        )
        with np.errstate(invalid="ignore"):
            mask_vals = (sv - pooled) > thr
        out = DataArray(mask_vals, ds_Sv["Sv"].dims, name="mask_transient_noise")
        out.coords = dict(ds_Sv["Sv"].coords)
        return out
    grid = cu.uniform_grid(depth) if func == "nanmean" else None
    members = None
    if grid is not None:
        from ..ops.windows import (
            grid_window_halo,
            grid_window_members,
            transient_mask_grid_idx_packed,
            transient_mask_grid_packed,
        )

        members = grid_window_members(grid, depth_bin_m, exclude_above_m)
    if grid is not None and members is not None:
        # host float64 membership runs; pooling and the dB compare on the
        # device, bit-packed readback
        lo, hi, v_r, halo = members
        packed = _host(
            transient_mask_grid_idx_packed(
                np.asarray(sv, dtype="f4"),
                np.isfinite(np.asarray(grid, dtype="f8")).astype("f4"),
                lo, hi, v_r,
                int(num_side_pings),
                float(thr),
                range_halo=halo,
                device=device,
            )
        )
        mask_vals = np.unpackbits(packed, axis=-1, count=sv.shape[2]).astype(bool)
    elif grid is not None:
        # non-monotone grid: order-free float32 value bands
        packed = _host(
            transient_mask_grid_packed(
                np.asarray(sv, dtype="f4"),
                np.asarray(grid, dtype="f4"),
                float(depth_bin_m),
                int(num_side_pings),
                float(exclude_above_m),
                float(thr),
                range_halo=grid_window_halo(grid, depth_bin_m),
                device=device,
            )
        )
        mask_vals = np.unpackbits(packed, axis=-1, count=sv.shape[2]).astype(bool)
    elif func == "nanmean":
        pooled = cu.pool_Sv_nanmean(sv, depth, depth_bin_m, num_side_pings, exclude_above_m,
                                    device=device)
        mask_vals = (sv - pooled) > thr
    else:
        logger.warning("`func=nanmedian` is a slow operation due to the sorting overhead.")
        pooled = cu.pool_Sv_nanmedian(sv, depth, depth_bin_m, num_side_pings, exclude_above_m)
        mask_vals = (sv - pooled) > thr
    out = DataArray(mask_vals, ds_Sv["Sv"].dims, name="mask_transient_noise")
    out.coords = dict(ds_Sv["Sv"].coords)
    return out


def mask_impulse_noise(
    ds_Sv: Dataset,
    depth_bin: str = "5m",
    num_side_pings: int = 2,
    impulse_noise_threshold: str = "10.0dB",
    range_var: str = "depth",
    use_index_binning: bool = False,
    device="cuda",
) -> DataArray:
    """Impulse-noise mask via two-sided ping comparison (clean/api.py:171-266).

    A ping-invariant grid runs down/up-sampling and the compare on
    ``device`` (bit-packed readback); otherwise the depth binning runs on
    ``device`` and the compare on the host."""
    _check_range_var(ds_Sv, range_var)
    thr = cu.extract_dB(impulse_noise_threshold)
    depth_bin_m = _parse_x_bin(depth_bin, "range_bin")

    sv = np.asarray(ds_Sv["Sv"].values, dtype="f8")
    depth = _range_values(ds_Sv, range_var, sv.shape)
    C, P, _ = sv.shape
    grid = cu.uniform_grid(depth)
    if grid is not None and P > num_side_pings:
        # down/up-sample + two-sided compare on the device, packed out
        from ..ops.windows import impulse_mask_grid_packed

        d_min, d_max = np.nanmin(depth), np.nanmax(depth)
        edges = np.arange(d_min, d_max + depth_bin_m, depth_bin_m)
        n_b = max(len(edges) - 1, 1)
        idx_grid = np.clip(np.digitize(grid, edges) - 1, 0, n_b - 1).astype("i4")
        packed = _host(
            impulse_mask_grid_packed(
                np.asarray(sv, dtype="f4"), idx_grid, int(n_b), int(num_side_pings), float(thr),
                device=device,
            )
        )
        mask_vals = np.unpackbits(packed, axis=-1, count=sv.shape[2]).astype(bool)
    else:
        _, upsampled, _ = cu.downsample_upsample_along_depth(sv, depth, depth_bin_m,
                                                             device=device)
        mask_vals = np.stack(
            [cu.echopy_impulse_noise_mask(upsampled[c], num_side_pings, thr) for c in range(C)]
        )
    out = DataArray(mask_vals, ds_Sv["Sv"].dims, name="mask_impulse_noise")
    out.coords = dict(ds_Sv["Sv"].coords)
    return out


def mask_attenuated_signal(
    ds_Sv: Dataset,
    upper_limit_sl: str = "400.0m",
    lower_limit_sl: str = "500.0m",
    num_side_pings: int = 15,
    attenuation_signal_threshold: str = "8.0dB",
    range_var: str = "depth",
    device="cuda",
) -> DataArray:
    """Attenuated-signal mask via ping-vs-block median (clean/api.py:269-359).

    A ping-invariant grid takes the slab medians on ``device`` (per-ping
    flags read back); a grid that varies by ping runs on the host."""
    _check_range_var(ds_Sv, range_var)
    thr = cu.extract_dB(attenuation_signal_threshold)
    lower_m = _parse_x_bin(lower_limit_sl, "range_bin")
    upper_m = _parse_x_bin(upper_limit_sl, "range_bin")
    if upper_m > lower_m:
        raise ValueError("Minimum range has to be shorter than maximum range")

    sv = np.asarray(ds_Sv["Sv"].values, dtype="f8")
    depth = _range_values(ds_Sv, range_var, sv.shape)

    if upper_m > np.nanmax(depth) or lower_m < np.nanmin(depth):
        out = DataArray(np.zeros(sv.shape, dtype=bool), ds_Sv["Sv"].dims)
        out.coords = dict(ds_Sv["Sv"].coords)
        return out

    C = sv.shape[0]
    grid = cu.uniform_grid(depth)
    if grid is not None:
        # contiguous-slab medians on the device, per-ping flags read back
        from ..ops.windows import attenuated_ping_mask_grid_device

        # plain argmin: NaN-holed rows resolve to the first NaN index on
        # both bounds (empty slab, no masking) — the reference's own
        # np.argmin quirk (clean/utils.py:349-350)
        up_idx = np.argmin(np.abs(grid - upper_m), axis=1).astype("i4")
        lw_idx = np.argmin(np.abs(grid - lower_m), axis=1).astype("i4")
        widths = np.maximum(lw_idx - up_idx, 0).astype("i4")
        s_max = max(int(widths.max()), 1)
        ping_mask = _host(
            attenuated_ping_mask_grid_device(
                np.asarray(sv, dtype="f4"), up_idx, widths, s_max, int(num_side_pings), float(thr),
                device=device,
            )
        )
        mask_vals = np.broadcast_to(ping_mask[:, :, None], sv.shape).copy()
    else:
        mask_vals = np.stack(
            [
                cu.echopy_attenuated_signal_mask(
                    sv[c], depth[c], upper_m, lower_m, num_side_pings, thr
                )
                for c in range(C)
            ]
        )
    out = DataArray(mask_vals, ds_Sv["Sv"].dims, name="mask_attenuated_signal")
    out.coords = dict(ds_Sv["Sv"].coords)
    return out


def estimate_background_noise(
    ds_Sv: Dataset, ping_num: int, range_sample_num: int, background_noise_max: str = None
) -> DataArray:
    """Background noise estimate (De Robertis & Higginbottom 2007;
    clean/api.py:362-433): min over range of block-averaged TVG-removed power,
    upsampled back (ffill) and re-TVG'd."""
    if background_noise_max is not None:
        background_noise_max = cu.extract_dB(background_noise_max)

    sv = np.asarray(ds_Sv["Sv"].values, dtype="f8")
    er = _range_values(ds_Sv, "echo_range", sv.shape)
    alpha = ds_Sv["sound_absorption"]
    alpha_vals = np.asarray(alpha.values, dtype="f8")
    sv_dims = ds_Sv["Sv"].dims
    for i, d in enumerate(sv_dims):
        if d not in alpha.dims:
            alpha_vals = np.expand_dims(alpha_vals, i)
    alpha_b = np.broadcast_to(alpha_vals, sv.shape)

    spreading_loss = 20 * np.log10(np.maximum(er, 1.0))
    absorption_loss = 2 * alpha_b * er
    power_cal_db = sv - spreading_loss - absorption_loss
    power_cal = _log2lin(power_cal_db)

    C, P, R = sv.shape
    n_pb, n_rb = -(-P // ping_num), -(-R // range_sample_num)
    pad_p, pad_r = n_pb * ping_num - P, n_rb * range_sample_num - R
    pc = np.pad(power_cal, ((0, 0), (0, pad_p), (0, pad_r)), constant_values=np.nan)
    import warnings

    with warnings.catch_warnings():
        warnings.simplefilter("ignore", category=RuntimeWarning)
        blocks = _lin2log(
            np.nanmean(pc.reshape(C, n_pb, ping_num, n_rb, range_sample_num), axis=(2, 4))
        )
        noise = np.nanmin(blocks, axis=2)  # [C, n_pb]
    if background_noise_max is not None:
        noise = np.minimum(noise, background_noise_max)

    # upsample (ffill) to original pings, then add TVG back
    noise_full = np.repeat(noise, ping_num, axis=1)[:, :P]
    sv_noise = noise_full[:, :, None] + spreading_loss + absorption_loss
    out = DataArray(sv_noise, ds_Sv["Sv"].dims, name="Sv_noise")
    out.coords = dict(ds_Sv["Sv"].coords)
    return out


@add_processing_level("L*B")
def remove_background_noise(
    ds_Sv: Dataset,
    ping_num: int,
    range_sample_num: int,
    background_noise_max: str = None,
    SNR_threshold: str = "3.0dB",
) -> Dataset:
    """Subtract background noise estimate; NaN where SNR below threshold
    (clean/api.py:437-511)."""
    snr_thr = cu.extract_dB(SNR_threshold) if SNR_threshold is not None else None

    sv_noise = estimate_background_noise(
        ds_Sv, ping_num, range_sample_num, background_noise_max=background_noise_max
    )
    sv = np.asarray(ds_Sv["Sv"].values, dtype="f8")
    lin_corr = _log2lin(sv) - _log2lin(sv_noise.values)
    import warnings

    with warnings.catch_warnings():
        warnings.simplefilter("ignore", category=RuntimeWarning)
        corrected = _lin2log(np.where(lin_corr > 0, lin_corr, np.nan))
        if snr_thr is not None:
            corrected = np.where(corrected - sv_noise.values > snr_thr, corrected, np.nan)

    out = ds_Sv.copy()
    base_attrs = {
        "units": "dB",
        "noise_ping_num": ping_num,
        "noise_range_sample_num": range_sample_num,
        "SNR_threshold": snr_thr,
        "noise_max": background_noise_max,
    }
    out["Sv_noise"] = (
        ds_Sv["Sv"].dims,
        sv_noise.values,
        {"long_name": "Volume backscattering strength, noise (Sv re 1 m-1)", **base_attrs},
    )
    out["Sv_corrected"] = (
        ds_Sv["Sv"].dims,
        corrected,
        {"long_name": "Volume backscattering strength, corrected (Sv re 1 m-1)", **base_attrs},
    )
    prov = echopype_prov_attrs("processing")
    prov["processing_function"] = "clean.remove_background_noise"
    out.attrs.update(prov)
    return insert_input_processing_level(out, input_ds=ds_Sv)


def detect_transient(ds: Dataset, method: str = "fielding", params: dict = None):
    """Transient-noise detection, method in {'fielding', 'matecho'}
    (clean/api.py:521-655)."""
    from .transient_noise import transient_noise_fielding, transient_noise_matecho

    methods = {"fielding": transient_noise_fielding, "matecho": transient_noise_matecho}
    if method not in methods:
        raise ValueError(f"Unknown transient detection method {method!r}")
    return methods[method](ds, **(params or {}))
