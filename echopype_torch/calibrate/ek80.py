"""EK80 calibration: CW power, CW complex, and BB complex (pulse-compressed).

Counterpart of ``echopype_tpu/calibrate/ek80.py`` (reference
echopype/calibrate/calibrate_ek.py:268-710): received power from beam-sector
means with impedance scaling, BB gain interpolated at the center frequency
minus the empirical beampattern fit B(theta, phi), TVG on the modified
range, tau_effective from the replica autocorrelation.

``device`` is where the float32 work runs: the power-mode sonar equation,
and the BB matched filter (``ops/matched_filter.py``); the rest of the
complex path is host float64 numpy, as in the JAX package.
``precision="float64"`` runs the matched filter on the host too.
Multi-``filter_time`` files arrive through ``slice_dict``: one (channel,
filter epoch) slice, or the first valid filter set per channel
(``assume_single_filter_time``; ``calibrate/api.py``).
"""

from __future__ import annotations

import numpy as np

from ..echodata.simrad import retrieve_correct_beam_group
from ..utils.log import _init_logger
from ..xrlite import DataArray, Dataset
from .cal_params import get_cal_params_EK
from .ek import CalibrateEK
from .ek80_complex import (
    compress_pulse,
    get_filter_coeff,
    get_norm_fac,
    get_tau_effective,
    get_transmit_signal,
)
from .env_params import get_env_params_EK
from .range import tvg_shift_meters

logger = _init_logger(__name__)

__all__ = ["CalibrateEK80"]


def _collapse_vend_filters(vend, first_valid_filter_time_per_channel):
    """Collapse the filter_time dim using each channel's first valid filter
    set (the reference's assume_single_filter_time path, calibrate_ek.py:37)."""
    if "filter_time" not in vend.sizes:
        return vend
    ftimes = np.asarray(vend.coords["filter_time"].values)
    out = vend.copy()
    filter_vars = [v for v in vend.data_vars if "filter_time" in vend.data_vars[v].dims]
    ch_list = list(vend.coords["channel"].values)
    for name in filter_vars:
        var = vend[name]
        ft_ax = var.dims.index("filter_time")
        ch_ax = var.dims.index("channel") if "channel" in var.dims else None
        vals = np.asarray(var.values)
        # pick each channel's chosen filter_time slice
        picks = []
        for ci, ch in enumerate(ch_list):
            want = first_valid_filter_time_per_channel.get(ch)
            fi = 0
            if want is not None:
                le = np.nonzero(ftimes <= np.datetime64(want, "ns"))[0]
                fi = int(le[-1]) if len(le) else 0
            sl = [slice(None)] * vals.ndim
            sl[ft_ax] = fi
            if ch_ax is not None:
                sl[ch_ax] = ci
            picks.append(vals[tuple(sl)])
        new_dims = tuple(d for d in var.dims if d != "filter_time")
        if ch_ax is not None:
            stacked = np.stack(picks, axis=0)
            ch_pos = new_dims.index("channel")
            stacked = np.moveaxis(stacked, 0, ch_pos)
        else:
            stacked = picks[0]
        out.data_vars[name] = type(var)(stacked, new_dims, attrs=var.attrs, name=name)
    if "filter_time" in out.coords:
        del out.coords["filter_time"]
    return out


class CalibrateEK80(CalibrateEK):
    def __init__(
        self,
        echodata,
        env_params=None,
        cal_params=None,
        ecs_file=None,
        waveform_mode=None,
        encode_mode=None,
        drop_last_hanning_zero=False,
        slice_dict=None,
        **kw,
    ):
        super().__init__(echodata, env_params, cal_params, ecs_file, **kw)
        self.sonar_type = "EK80"
        self.waveform_mode = waveform_mode
        self.encode_mode = encode_mode
        self.drop_last_hanning_zero = drop_last_hanning_zero
        self.slice_dict = slice_dict or {}

        self.ed_beam_group = retrieve_correct_beam_group(
            echodata=echodata, waveform_mode=waveform_mode, encode_mode=encode_mode
        )
        self.beam = echodata[self.ed_beam_group]
        vend = echodata["Vendor_specific"]

        # multi-filter_time epoch handling (reference calibrate/api.py:96-197)
        if "channel" in self.slice_dict:
            # one (channel, filter epoch): slice beam pings and select filter
            ch = self.slice_dict["channel"]
            start = self.slice_dict["beam_group_start_time"]
            end = self.slice_dict["beam_group_end_time"]
            pt = np.asarray(self.beam.coords["ping_time"].values)
            keep = pt >= np.datetime64(start, "ns")
            if end is not None:
                keep &= pt <= np.datetime64(end, "ns")
            self.beam = self.beam.sel(channel=[ch]).isel(ping_time=np.nonzero(keep)[0])
            vend = vend.sel(filter_time=self.slice_dict["filter_time"])
            if "filter_time" in vend.coords and vend.coords["filter_time"].ndim == 0:
                del vend.coords["filter_time"]
        elif "first_valid_filter_time_per_channel" in self.slice_dict:
            vend = _collapse_vend_filters(
                vend, self.slice_dict["first_valid_filter_time_per_channel"]
            )

        # select only the channels in this beam group
        beam_chs = list(self.beam.coords["channel"].values)
        self.vend = vend.sel(channel=beam_chs)

        if self.waveform_mode == "BB":
            self.freq_center = (
                self.beam["transmit_frequency_start"] + self.beam["transmit_frequency_stop"]
            ) / 2
        else:
            self.freq_center = self.beam["frequency_nominal"]

        self.env_params = get_env_params_EK(
            sonar_type="EK80",
            beam=self.beam,
            env=echodata["Environment"],
            user_dict=self.env_params,
            freq=self.freq_center,
        )
        self.cal_params = get_cal_params_EK(
            waveform_mode=self.waveform_mode,
            freq_center=self.freq_center,
            beam=self.beam,
            vend=self.vend,
            user_dict=self.cal_params,
            sonar_type="EK80",
        )

    # ------------------------------------------------------------ complex cal
    def _get_B_theta_phi_m(self):
        """Empirical beampattern fit for BB gain compensation
        (calibrate_ek.py:507-530)."""
        fac_along = (
            np.abs(-self.cal_params["angle_offset_alongship"])
            / (self.cal_params["beamwidth_alongship"] / 2)
        ) ** 2
        fac_athwart = (
            np.abs(-self.cal_params["angle_offset_athwartship"])
            / (self.cal_params["beamwidth_athwartship"] / 2)
        ) ** 2
        B = 0.5 * 6.0206 * (fac_along + fac_athwart - 0.18 * fac_along * fac_athwart)
        return B.fillna(0)

    def _get_power_from_complex(self, beam, chirp, z_et, z_er):
        """prx from beam-sector mean with impedance scaling
        (calibrate_ek.py:456-505)."""
        n_beam = beam.sizes.get("beam", 1)
        bs = (
            np.asarray(beam["backscatter_r"].values, dtype="f8")
            + 1j * np.asarray(beam["backscatter_i"].values, dtype="f8")
        )  # [C, P, R, B]
        if self.waveform_mode == "BB":
            bs_da = DataArray(
                bs,
                beam["backscatter_r"].dims,
                coords={"channel": beam.coords["channel"]},
                name="bs",
            )
            pc = compress_pulse(bs_da, chirp, precision=self.precision, device=self.device)
            norm = get_norm_fac(chirp)
            ch_order = [str(c) for c in beam.coords["channel"].values]
            norm_vals = np.array(
                [float(norm.sel(channel=c).values) for c in ch_order]
            )
            sig = pc.values / norm_vals[:, None, None, None]
        else:
            sig = bs

        mean_sig = np.nanmean(sig, axis=-1)  # mean over beam sectors
        z_et_v = self._to_cp_like(z_et, beam)
        z_er_v = self._to_cp_like(z_er, beam)
        import warnings

        with warnings.catch_warnings():
            warnings.simplefilter("ignore", category=RuntimeWarning)
            prx = (
                n_beam
                * np.abs(mean_sig) ** 2
                / (2 * np.sqrt(2)) ** 2
                * (np.abs(z_er_v + z_et_v) / z_er_v) ** 2
                / z_et_v
            )
        return prx  # [C, P, R]

    def _to_cp_like(self, val, beam):
        """Broadcast a param to [C, P, 1] for range math."""
        n_ch, n_ping = beam.sizes["channel"], beam.sizes["ping_time"]
        return self._to_cp(val, n_ch, n_ping)[:, :, None]

    def _tau_effective_cp(self, tx, tx_time, n_ch, n_ping):
        """tau_effective as a dense [C, P] array with the GPT override."""
        beam, vend = self.beam, self.vend
        try:
            tau_eff_da = get_tau_effective(
                ytx_dict=tx,
                fs_deci_dict={k: 1 / np.diff(v[:2]) for k, v in tx_time.items()},
                waveform_mode=self.waveform_mode,
                channel=beam["channel"],
                ping_time=beam.coords["ping_time"],
            )
            tau_eff = self._to_cp(tau_eff_da, n_ch, n_ping)
        except Exception as e:  # noqa: BLE001 - fallback mirrors reference
            logger.warning(
                "Could not compute tau_effective from transmit signal; "
                "falling back to transmit_duration_nominal. Error: %r",
                e,
            )
            tau_eff = self._to_cp(beam["transmit_duration_nominal"], n_ch, n_ping)
        # GPT channels use nominal duration
        if "transceiver_type" in vend:
            ttype = np.asarray(vend["transceiver_type"].values)
            is_gpt = ttype == "GPT"
            tdn = self._to_cp(beam["transmit_duration_nominal"], n_ch, n_ping)
            tau_eff = np.where(is_gpt[:, None], tdn[:, :1], tau_eff)
        return tau_eff

    def _complex_sv_scalars(self):
        """Host-resolved inputs for the fused complex-Sv device path.

        Returns a dict with the transmit replicas plus dense [C, P] arrays:
        everything of the complex Sv equation except the sample sweep itself
        (Sv = 10log10(prx) + 20log10(r_tvg) + 2*alpha*r_tvg + offset, with
        echo_range affine r = k*dr).  Shared with _cal_complex_samples.
        """
        beam, vend = self.beam, self.vend
        n_ch, n_ping = beam.sizes["channel"], beam.sizes["ping_time"]

        tx_coeff = get_filter_coeff(vend)
        fs = self.cal_params["receiver_sampling_frequency"]
        tx, tx_time = get_transmit_signal(
            beam, tx_coeff, self.waveform_mode, fs, self.drop_last_hanning_zero
        )

        z_er = self.cal_params["impedance_transceiver"]
        z_et = self.cal_params["impedance_transducer"]
        gain = self.cal_params["gain_correction"]
        if self.waveform_mode == "BB":
            gain = gain - self._get_B_theta_phi_m()

        sound_speed = self.env_params["sound_speed"]
        absorption = self.env_params["sound_absorption"]
        c_cp = self._to_cp(sound_speed, n_ch, n_ping)
        alpha_cp = self._to_cp(absorption, n_ch, n_ping)
        wavelength = c_cp / self._to_cp(self.freq_center, n_ch, n_ping)
        pt = self._to_cp(beam["transmit_power"], n_ch, n_ping)
        gain_cp = self._to_cp(gain, n_ch, n_ping)
        shift = self._to_cp(
            tvg_shift_meters("EK80", beam, vend, sound_speed), n_ch, n_ping
        )
        dr = self._to_cp(beam["sample_interval"], n_ch, n_ping) * c_cp / 2.0

        tau_eff = self._tau_effective_cp(tx, tx_time, n_ch, n_ping)
        psifc = self._to_cp(self.cal_params["equivalent_beam_angle"], n_ch, n_ping)
        with np.errstate(invalid="ignore", divide="ignore"):
            offset = -(
                10 * np.log10(wavelength**2 * pt * c_cp / (32 * np.pi**2))
                + 2 * gain_cp
                + 10 * np.log10(tau_eff)
                + psifc
            )
            if self.waveform_mode == "CW":
                sa = self._to_cp(self.cal_params["sa_correction"], n_ch, n_ping)
                offset = offset - 2 * sa
        return {
            "tx": tx,
            "tx_time": tx_time,
            "z_er": z_er,
            "z_et": z_et,
            "dr": dr,
            "shift": shift,
            "alpha": alpha_cp,
            "offset": offset,
            "tau_eff": tau_eff,
        }

    def _cal_complex_samples(self, cal_type: str) -> Dataset:
        beam, vend = self.beam, self.vend
        n_ch, n_ping = beam.sizes["channel"], beam.sizes["ping_time"]

        scal = self._complex_sv_scalars()
        tx, z_er, z_et = scal["tx"], scal["z_er"], scal["z_et"]
        alpha_cp, shift, tau_eff = scal["alpha"], scal["shift"], scal["tau_eff"]

        # TVG-modified range
        er = np.asarray(self.range_meter.values, dtype="f8")  # [C,P,R]
        import warnings

        with warnings.catch_warnings():
            warnings.simplefilter("ignore", category=RuntimeWarning)
            r_tvg = er - shift[:, :, None]
            r_tvg = np.where(r_tvg > 0, r_tvg, np.nan)
            spreading_loss = 20 * np.log10(r_tvg)
            absorption_loss = 2 * alpha_cp[:, :, None] * r_tvg

            prx = self._get_power_from_complex(beam, tx, z_et, z_er)
            prx = np.where(prx > 0, prx, np.nan)

            if cal_type == "Sv":
                out_vals = (
                    10 * np.log10(prx)
                    + spreading_loss
                    + absorption_loss
                    + scal["offset"][:, :, None]
                )
                name = "Sv"
            else:
                sound_speed = self.env_params["sound_speed"]
                c_cp = self._to_cp(sound_speed, n_ch, n_ping)
                wavelength = c_cp / self._to_cp(self.freq_center, n_ch, n_ping)
                pt = self._to_cp(beam["transmit_power"], n_ch, n_ping)
                gain = self.cal_params["gain_correction"]
                if self.waveform_mode == "BB":
                    gain = gain - self._get_B_theta_phi_m()
                gain_cp = self._to_cp(gain, n_ch, n_ping)
                out_vals = (
                    10 * np.log10(prx)
                    + 2 * spreading_loss
                    + absorption_loss
                    - (10 * np.log10(wavelength**2 * pt / (16 * np.pi**2)))[:, :, None]
                    - (2 * gain_cp)[:, :, None]
                )
                name = "TS"

        coords = {
            "channel": beam.coords["channel"],
            "ping_time": beam.coords["ping_time"],
            "range_sample": beam.coords["range_sample"],
        }
        ds = Dataset(coords=coords)
        ds[name] = (("channel", "ping_time", "range_sample"), out_vals)
        ds["echo_range"] = (("channel", "ping_time", "range_sample"), er)
        if cal_type == "Sv":
            ds["tau_effective"] = (
                ("channel", "ping_time"),
                tau_eff,
                {
                    "long_name": "Effective pulse length",
                    "units": "s",
                    "description": "Effective pulse length used for Sv. "
                    "GPT uses transmit_duration_nominal.",
                },
            )
        ds["frequency_nominal"] = beam["frequency_nominal"]
        return self._add_params_to_output(ds)

    def _compute_cal(self, cal_type):
        flag_complex = self.waveform_mode == "BB" or self.encode_mode == "complex"
        if flag_complex:
            return self._cal_complex_samples(cal_type)
        return self._cal_power_samples(cal_type)

    def _ek80_power_tau_effective(self, tau_eff, tdn):
        """Power-mode EK80: non-GPT channels get tau from the transmit replica."""
        try:
            tx_coeff = get_filter_coeff(self.vend)
            fs = self.cal_params["receiver_sampling_frequency"]
            tx, tx_time = get_transmit_signal(self.beam, tx_coeff, self.waveform_mode, fs)
            tau = get_tau_effective(
                ytx_dict=tx,
                fs_deci_dict={k: 1 / np.diff(v[:2]) for k, v in tx_time.items()},
                waveform_mode=self.waveform_mode,
                channel=self.beam["channel"],
                ping_time=self.beam.coords["ping_time"],
            )
            n_ch, n_ping = tau_eff.shape
            tau_cp = self._to_cp(tau, n_ch, n_ping)
            if "transceiver_type" in self.vend:
                is_gpt = np.asarray(self.vend["transceiver_type"].values) == "GPT"
                return np.where(is_gpt[:, None], tau_eff, tau_cp)
            return tau_cp
        except Exception as e:  # noqa: BLE001
            logger.warning("tau_effective fallback to nominal duration: %r", e)
            return tau_eff

    def compute_Sv(self, **kw):
        return self._compute_cal("Sv")

    def compute_TS(self, **kw):
        return self._compute_cal("TS")
