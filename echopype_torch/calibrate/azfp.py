"""AZFP calibration: EL - SL + TVG formulas from the operator's manual.

Capability parity: echopype/calibrate/calibrate_azfp.py:10-117 (eq. 2/5/9/10
of GU-100-AZFP-01-R50 Appendix G, incl. the frequency/pulse-length Sv_offset).
Host float64 numpy, bit-identical to ``echopype_tpu/calibrate/azfp.py``: the
formulas have no device program there either.  ``device`` is resolved (so
"cuda" raises without a card) and named in the output's ``attrs["device"]``;
the AZFP survey streamer runs its float32 window step on it.
"""

from __future__ import annotations

import numpy as np

from ..device import device_name, resolve_device
from ..xrlite import DataArray, Dataset
from .cal_params import get_cal_params_AZFP
from .ek import CalibrateBase
from .env_params import get_env_params_AZFP
from .range import compute_range_AZFP

__all__ = ["CalibrateAZFP"]


class CalibrateAZFP(CalibrateBase):
    def __init__(self, echodata, env_params=None, cal_params=None, ecs_file=None, **kw):
        super().__init__(echodata, env_params, cal_params, ecs_file, **kw)
        self._dev = resolve_device(self.device)
        self.sonar_type = "AZFP"
        self.beam = echodata["Sonar/Beam_group1"]
        self.vend = echodata["Vendor_specific"]
        if self.ecs_file is not None:
            raise ValueError("Using ECS file for calibration is not currently supported for AZFP!")
        self.env_params = get_env_params_AZFP(echodata=echodata, user_dict=self.env_params)
        self.cal_params = get_cal_params_AZFP(
            beam=echodata["Sonar/Beam_group1"],
            vend=echodata["Vendor_specific"],
            user_dict=self.cal_params,
        )

    def compute_echo_range(self, cal_type):
        self.range_meter = compute_range_AZFP(
            echodata=self.echodata, env_params=self.env_params, cal_type=cal_type
        )

    def _cal_power_samples(self, cal_type, **kw):
        self.compute_echo_range(cal_type=cal_type)
        beam = self.echodata["Sonar/Beam_group1"]

        spreading_loss = 20 * np.log10(self.range_meter)
        absorption_loss = 2 * self.env_params["sound_absorption"] * self.range_meter
        SL = self.cal_params["TVR"] + 20 * np.log10(self.cal_params["VTX0"])  # eq.(2)
        a = self.cal_params["DS"]
        EL = self.cal_params["EL"] - 2.5 / a + beam["backscatter_r"] / (26214 * a)  # eq.(5)

        if cal_type == "Sv":
            out = (
                EL
                - SL
                + spreading_loss
                + absorption_loss
                - 10
                * np.log10(
                    0.5
                    * self.env_params["sound_speed"]
                    * beam["transmit_duration_nominal"]
                    * self.cal_params["equivalent_beam_angle"]
                )
                + self.cal_params["Sv_offset"]
            )  # eq.(9) + p.90-91 offset
            name = "Sv"
        elif cal_type == "TS":
            out = EL - SL + 2 * spreading_loss + absorption_loss  # eq.(10)
            name = "TS"
        else:
            raise ValueError("cal_type not recognized!")

        from ..xrlite import broadcast_arrays

        template = DataArray(
            np.zeros_like(np.asarray(beam["backscatter_r"].values, dtype="f8")),
            beam["backscatter_r"].dims,
        )
        out3, _ = broadcast_arrays(out, template)
        er3, _ = broadcast_arrays(self.range_meter, template)
        out3 = out3.transpose("channel", "ping_time", "range_sample")
        er3 = er3.transpose("channel", "ping_time", "range_sample")
        ds = Dataset(
            coords={
                "channel": beam.coords["channel"],
                "ping_time": beam.coords["ping_time"],
                "range_sample": beam.coords["range_sample"],
            }
        )
        ds[name] = (("channel", "ping_time", "range_sample"), out3.values)
        ds["echo_range"] = (("channel", "ping_time", "range_sample"), er3.values)
        ds["frequency_nominal"] = beam["frequency_nominal"]
        ds.attrs["device"] = device_name(self._dev)
        return self._add_params_to_output(ds)

    def _power_cal_inputs(self, cal_type: str):
        """Fused-kernel inputs for the raw->MVBS streamer.

        AZFP echo_range is affine in the sample index, r = A + k*B with
        B = c*N/(2f) and A = cL/(2f) + (c/4f)(N-1) + c*tau/4 (Sv), and
        Sv = power/(26214*DS) + K + 20log10(r) + 2*alpha*r where K folds
        EL0 - 2.5/DS - SL - 10log10(0.5*c*tau*psi) + Sv_offset — the same
        shape the closed-counts core computes (r0=A, dr=B, tvg_shift=0).
        """
        if cal_type != "Sv":
            raise ValueError("streamer inputs are Sv-only")
        from .env_params import harmonize_env_param_time

        beam = self.echodata["Sonar/Beam_group1"]
        vend = self.echodata["Vendor_specific"]
        n_ch = beam.sizes["channel"]
        n_ping = beam.sizes["ping_time"]
        to_cp = self._to_cp

        c = to_cp(
            harmonize_env_param_time(
                self.env_params["sound_speed"], ping_time=beam.coords.get("ping_time")
            ),
            n_ch,
            n_ping,
        )
        alpha = to_cp(
            harmonize_env_param_time(
                self.env_params["sound_absorption"], ping_time=beam.coords.get("ping_time")
            ),
            n_ch,
            n_ping,
        )
        N = to_cp(vend["number_of_samples_per_average_bin"], n_ch, n_ping)
        f = to_cp(vend["digitization_rate"], n_ch, n_ping)
        lock = to_cp(vend["lock_out_index"], n_ch, n_ping)
        tau = to_cp(beam["transmit_duration_nominal"], n_ch, n_ping)

        B = c * N / (2.0 * f)
        A = c * lock / (2.0 * f) + (c / (4.0 * f)) * (N - 1.0) + c * tau / 4.0

        ds_par = to_cp(self.cal_params["DS"], n_ch, n_ping)
        el = to_cp(self.cal_params["EL"], n_ch, n_ping)
        sl = to_cp(self.cal_params["TVR"], n_ch, n_ping) + 20.0 * np.log10(
            to_cp(self.cal_params["VTX0"], n_ch, n_ping)
        )
        psi = to_cp(self.cal_params["equivalent_beam_angle"], n_ch, n_ping)
        sv_off = to_cp(self.cal_params["Sv_offset"], n_ch, n_ping)
        K = el - 2.5 / ds_par - sl - 10.0 * np.log10(0.5 * c * tau * psi) + sv_off

        counts = np.asarray(beam["backscatter_r"].values, dtype="f8")
        power = (counts / (26214.0 * ds_par[:, :, None])).astype("f4")
        return power, B, np.zeros_like(B), alpha, K, A

    def compute_Sv(self, **kw):
        return self._cal_power_samples("Sv")

    def compute_TS(self, **kw):
        return self._cal_power_samples("TS")
