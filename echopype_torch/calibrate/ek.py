"""EK60/EK80 calibrators: host parameter resolution -> torch sonar-equation pass.

Counterpart of ``echopype_tpu/calibrate/ek.py`` (reference
echopype/calibrate/calibrate_ek.py).  Parameter resolution is the port's
copy of the JAX package's host-only resolvers; ``_power_cal_inputs`` is
carried over unchanged, so the compute_Sv path and the survey streamer fold
the same float64 [C, P] inputs as the JAX package.  EK80 (``ek80.py``)
builds on :class:`CalibrateEK`.
"""

from __future__ import annotations

import numpy as np

from ..ops.calibration import ek_power_cal
from ..utils.log import _init_logger
from ..utils.profiling import stage
from ..xrlite import DataArray, Dataset
from .cal_params import get_cal_params_EK
from .env_params import get_env_params_EK
from .range import compute_range_EK, tvg_shift_meters

logger = _init_logger(__name__)

__all__ = ["CalibrateBase", "CalibrateEK", "CalibrateEK60"]


class CalibrateBase:
    """Holds echodata + resolved env/cal params for one calibration run.

    ``device`` is where the float32 sonar-equation pass runs ("cuda" by
    default; "cpu" for the plain path).  ``precision="float64"`` runs on the
    host in numpy and ignores ``device``.
    """

    def __init__(self, echodata, env_params=None, cal_params=None, ecs_file=None, **kw):
        self.echodata = echodata
        # None | dict only (reference calibrate_base.py:35-47).  With an ECS
        # file the type check is skipped: the ECS file takes precedence and
        # env_params/cal_params are discarded (reference :20-32).
        if ecs_file is None:
            if env_params is not None and not isinstance(env_params, dict):
                raise ValueError("'env_params' has to be None or a dict")
            if cal_params is not None and not isinstance(cal_params, dict):
                raise ValueError("'cal_params' has to be None or a dict")
            self.env_params = env_params or {}
            self.cal_params = cal_params or {}
        else:
            self.env_params = {}
            self.cal_params = {}
        self.ecs_file = ecs_file
        self.ecs_dict = {}
        self.precision = kw.get("precision", "float32")
        if ecs_file is not None and (env_params or cal_params):
            logger.warning(
                "The ECS file takes precedence when it conflicts with env_params or cal_params"
            )
        self.device = kw.get("device", "cuda")
        self._range_meter = None

    @property
    def range_meter(self):
        """echo_range [C, P, R] float64, computed on first access (the
        survey streamers derive range from (dr, shift) and never need it)."""
        if self._range_meter is None:
            self.compute_echo_range()
        return self._range_meter

    @range_meter.setter
    def range_meter(self, value):
        self._range_meter = value

    def _check_echodata_backscatter_size(self, threshold_gib: float = 2.0):
        """Warn when backscatter exceeds the memory-pressure threshold
        (calibrate_base.py:95-128) and recommend the survey runner."""
        beam = getattr(self, "beam", None)
        if beam is None or "backscatter_r" not in beam:
            return
        nbytes = beam["backscatter_r"].nbytes
        if "backscatter_i" in beam:
            nbytes *= 2
        if nbytes > threshold_gib * 2**30:
            logger.warning(
                "The Echodata backscatter data is %.2f GiB, which exceeds %.1f GiB. "
                "Consider using the survey runner (parallel.run_survey_mvbs_from_raw).",
                nbytes / 2**30,
                threshold_gib,
            )

    def _to_cp(self, val, n_ch, n_ping):
        """Broadcast a resolved parameter to a dense [C, P] float64 array."""
        if isinstance(val, DataArray):
            dims = val.dims
            v = np.asarray(val.values, dtype="f8")
            if dims == ("channel", "ping_time"):
                return v
            if dims == ("ping_time", "channel"):
                return v.T
            if dims == ("channel",):
                return np.broadcast_to(v[:, None], (n_ch, n_ping)).copy()
            if dims == ("ping_time",):
                return np.broadcast_to(v[None, :], (n_ch, n_ping)).copy()
            if dims == ():
                return np.full((n_ch, n_ping), float(v))
            raise ValueError(f"cannot broadcast param with dims {dims} to [channel, ping_time]")
        return np.full((n_ch, n_ping), float(val))

    def _add_params_to_output(self, ds: Dataset) -> Dataset:
        """Attach resolved env/cal params as output variables
        (calibrate_base.py:83-93)."""
        for name, val in {**self.env_params, **self.cal_params}.items():
            if name in ds:
                continue
            if isinstance(val, DataArray):
                ds[name] = val
            elif isinstance(val, (int, float, np.floating, np.integer)):
                ds[name] = ((), np.float64(val))
            elif isinstance(val, str):
                ds.attrs[name] = val
        return ds


class CalibrateEK(CalibrateBase):
    def compute_echo_range(self):
        self.range_meter = compute_range_EK(
            sonar_model=self.echodata.sonar_model,
            beam=self.beam,
            env_params=self.env_params,
        )

    def _power_cal_inputs(self, cal_type: str):
        """Assemble the sonar-equation inputs (power, dr, tvg_shift, alpha,
        offset, tau_eff) from resolved env/cal params.  Shared by the
        compute_Sv path and the raw->MVBS survey streamer
        (parallel/survey.py)."""
        beam, vend = self.beam, self.vend
        n_ch = beam.sizes["channel"]
        n_ping = beam.sizes["ping_time"]

        sound_speed = self.env_params["sound_speed"]
        absorption = self.env_params["sound_absorption"]
        c_cp = self._to_cp(sound_speed, n_ch, n_ping)
        alpha_cp = self._to_cp(absorption, n_ch, n_ping)

        dr = self._to_cp(beam["sample_interval"], n_ch, n_ping) * c_cp / 2.0
        shift = tvg_shift_meters(self.echodata.sonar_model, beam, vend, sound_speed)
        shift_cp = self._to_cp(shift, n_ch, n_ping)

        freq = np.asarray(beam["frequency_nominal"].values, dtype="f8")
        wavelength = c_cp / freq[:, None]

        # Effective pulse length: GPT channels use nominal transmit duration
        # (calibrate_ek.py:112-155); for EK60 all channels are GPT.
        tdn = self._to_cp(beam["transmit_duration_nominal"], n_ch, n_ping)
        tau_eff = np.broadcast_to(tdn[:, :1], (n_ch, n_ping)).copy()
        if self.sonar_type == "EK80":
            tau_eff = self._ek80_power_tau_effective(tau_eff, tdn)

        gain = self._to_cp(self.cal_params["gain_correction"], n_ch, n_ping)
        pt = self._to_cp(beam["transmit_power"], n_ch, n_ping)
        eba = self._to_cp(self.cal_params["equivalent_beam_angle"], n_ch, n_ping)

        if cal_type == "Sv":
            csv = (
                10 * np.log10(pt)
                + 2 * gain
                + eba
                + 10 * np.log10(wavelength**2 * tau_eff * c_cp / (32 * np.pi**2))
            )
            sa = self._to_cp(self.cal_params["sa_correction"], n_ch, n_ping)
            offset = -(csv + 2 * sa)
        else:
            csp = 10 * np.log10(pt) + 2 * gain + 10 * np.log10(wavelength**2 / (16 * np.pi**2))
            offset = -csp

        power = np.asarray(beam["backscatter_r"].values, dtype="f4")
        if power.ndim == 4:  # has beam dim; power data has no real beam axis
            power = power[..., 0]
        return power, dr, shift_cp, alpha_cp, offset, tau_eff

    def _cal_power_samples(self, cal_type: str) -> Dataset:
        """EK60/EK80 power-mode calibration via the torch sonar-equation pass."""
        beam = self.beam
        with stage("cal_inputs"):
            power, dr, shift_cp, alpha_cp, offset, tau_eff = self._power_cal_inputs(cal_type)
        out_vals, echo_range = ek_power_cal(
            power, dr, shift_cp, alpha_cp, offset, cal_type,
            precision=self.precision, device=self.device,
        )
        with stage("sv_assemble"):
            coords = {
                "channel": beam.coords["channel"],
                "ping_time": beam.coords["ping_time"],
                "range_sample": beam.coords["range_sample"],
            }
            ds = Dataset(coords=coords)
            ds[cal_type] = (("channel", "ping_time", "range_sample"), out_vals)
            # mask echo_range by backscatter NaN (range.py:140-150)
            ds["echo_range"] = (("channel", "ping_time", "range_sample"), echo_range)
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
            ds = self._add_params_to_output(ds)
            return ds

    def _ek80_power_tau_effective(self, tau_eff, tdn):
        """Base hook; CalibrateEK80 overrides it with the replica-derived tau
        of non-GPT channels (calibrate_ek.py:112-151)."""
        return tau_eff


class CalibrateEK60(CalibrateEK):
    def __init__(self, echodata, env_params=None, cal_params=None, ecs_file=None, **kw):
        super().__init__(echodata, env_params, cal_params, ecs_file, **kw)
        self.sonar_type = "EK60"
        self.waveform_mode = "CW"
        self.encode_mode = "power"

        self.ed_beam_group = "Sonar/Beam_group1"
        self.beam = echodata[self.ed_beam_group]
        self.vend = echodata["Vendor_specific"]

        with stage("cal_inputs"):
            if self.ecs_file is not None:
                from .ecs import ecs_to_params

                self.env_params, self.cal_params = ecs_to_params(
                    self.ecs_file, "EK60", self.beam["frequency_nominal"]
                )

            self.env_params = get_env_params_EK(
                sonar_type=self.sonar_type,
                beam=self.beam,
                env=echodata["Environment"],
                user_dict=self.env_params,
            )
            self.cal_params = get_cal_params_EK(
                waveform_mode=self.waveform_mode,
                freq_center=self.beam["frequency_nominal"],
                beam=self.beam,
                vend=self.vend,
                user_dict=self.cal_params,
                sonar_type=self.sonar_type,
            )

    def compute_Sv(self, **kw):
        return self._cal_power_samples("Sv")

    def compute_TS(self, **kw):
        return self._cal_power_samples("TS")
