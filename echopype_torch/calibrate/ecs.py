"""Echoview ECS calibration-supplement file support.

Capability parity target: the reference's ECS feature set
(echopype/calibrate/ecs.py — LocalCal > SourceCal > Fileset precedence,
Echoview->echopype parameter naming, frequency-matched channel conformance,
broadband table assembly).

The parser here is an independent design: the file is tokenized line-by-line
into a flat token stream (rulers, banners, version stamps, group openers,
assignments), and a single-pass state machine folds the stream into an
``EcsDocument``.  Values are typed at tokenization time.  This replaces the
reference's seek/peek file-object block reader.
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field
from datetime import datetime
from typing import Optional

import numpy as np

from ..utils.log import _init_logger
from ..xrlite import DataArray, Dataset

logger = _init_logger(__name__)

__all__ = ["ECSParser", "EcsDocument", "parse_ecs", "ecs_ev2ep", "ecs_ds2dict", "conform_channel_order", "ecs_to_params"]


# ---------------------------------------------------------------------------
# Echoview <-> echopype parameter naming, one flat table:
#   (ECS name, echopype name, model scope, role)
# scope "EK60" entries apply to all EK-family models; "EK80" entries are
# wideband/environment extras.  role: env (environment), cal (scalar cal
# param), bb (frequency-dependent wideband table).
# ---------------------------------------------------------------------------
_PARAM_TABLE = (
    ("AbsorptionCoefficient", "sound_absorption", "EK60", "env"),
    ("SoundSpeed", "sound_speed", "EK60", "env"),
    ("Frequency", "frequency_nominal", "EK60", "cal"),
    ("MajorAxis3dbBeamAngle", "beamwidth_athwartship", "EK60", "cal"),
    ("MajorAxisAngleOffset", "angle_offset_athwartship", "EK60", "cal"),
    ("MajorAxisAngleSensitivity", "angle_sensitivity_athwartship", "EK60", "cal"),
    ("MinorAxis3dbBeamAngle", "beamwidth_alongship", "EK60", "cal"),
    ("MinorAxisAngleOffset", "angle_offset_alongship", "EK60", "cal"),
    ("MinorAxisAngleSensitivity", "angle_sensitivity_alongship", "EK60", "cal"),
    ("PulseDuration", "transmit_duration_nominal", "EK60", "cal"),
    ("SaCorrectionFactor", "sa_correction", "EK60", "cal"),
    ("EK60SaCorrection", "sa_correction", "EK60", "cal"),
    ("TransducerGain", "gain_correction", "EK60", "cal"),
    ("Ek60TransducerGain", "gain_correction", "EK60", "cal"),
    ("TransmittedPower", "transmit_power", "EK60", "cal"),
    ("TwoWayBeamAngle", "equivalent_beam_angle", "EK60", "cal"),
    ("AbsorptionDepth", "pressure", "EK80", "env"),
    ("Acidity", "pH", "EK80", "env"),
    ("Salinity", "salinity", "EK80", "env"),
    ("Temperature", "temperature", "EK80", "env"),
    ("EffectivePulseDuration", "tau_effective", "EK80", "cal"),
    ("SamplingFrequency", "sampling_frequency", "EK80", "cal"),
    ("TransceiverImpedance", "impedance_transceiver", "EK80", "cal"),
    ("TransceiverSamplingFrequency", "receiver_sampling_frequency", "EK80", "cal"),
    ("NumberOfTransducerSegments", "n_sector", "EK80", "cal"),
    ("PulseCompressedEffectivePulseDuration", "tau_effective_pc", "EK80", "cal"),
    ("FrequencyTableWideband", "frequency_BB", "EK80", "bb"),
    ("GainTableWideband", "gain_correction", "EK80", "bb"),
    ("MajorAxisAngleOffsetTableWideband", "angle_offset_athwartship", "EK80", "bb"),
    ("MajorAxisBeamWidthTableWideband", "beamwidth_athwartship", "EK80", "bb"),
    ("MinorAxisAngleOffsetTableWideband", "angle_offset_alongship", "EK80", "bb"),
    ("MinorAxisBeamWidthTableWideband", "beamwidth_alongship", "EK80", "bb"),
)

EV_EP_MAP = {
    scope: {ev: ep for ev, ep, s, _ in _PARAM_TABLE if s == scope}
    for scope in ("EK60", "EK80")
}
ENV_PARAMS = [ev for ev, _, _, role in _PARAM_TABLE if role == "env"]
CAL_PARAMS_BB = tuple(ev for ev, _, _, role in _PARAM_TABLE if role == "bb")

TVG_RANGE_CORRECTION_VALUES = frozenset(
    "None BySamples SimradEx500 SimradEx60 BioSonics Kaijo "
    "PulseLength Ex500Forced SimradEK80 Standard".split()
)

# Parameters whose value is meaningful even when Echoview writes the line
# commented out (templates comment out the informational Frequency line).
_KEEP_WHEN_COMMENTED = frozenset({"Frequency"})


# ---------------------------------------------------------------------------
# Line classification
# ---------------------------------------------------------------------------
_LINE_RULER = re.compile(r"^#=+#\s*$")
_LINE_TITLE = re.compile(r"^#\s*(?P<title>FILESET|SOURCECAL|LOCALCAL)\s+SETTINGS\s*#\s*$", re.I)
_LINE_FILEHEAD = re.compile(
    r"^#\s*ECHOVIEW CALIBRATION SUPPLEMENT \(\.ECS\) FILE \((?P<dtype>[^)]+)\)\s*#\s*$"
)
_LINE_STAMP = re.compile(
    r"^#\s*(?P<mdY>\d{1,2}/\d{1,2}/\d{4})\s+(?P<hms>\d{1,2}:\d{2}:\d{2})(?:\.\d+)?\s*#\s*$"
)
_LINE_VERSION = re.compile(r"^\s*Version\s+(?P<ver>\d+(?:\.\d+)?)\s*$", re.I)
_LINE_GROUP = re.compile(r"^\s*(?P<kind>SourceCal|LocalCal)\s+(?P<name>\w+)\s*$", re.I)
_LINE_ASSIGN = re.compile(
    r"^\s*(?P<commented>#)?\s*(?P<name>[A-Za-z]\w*)\s*=\s*(?P<rhs>[^#\r\n]*)(?:#.*)?$"
)
_NUMBER = re.compile(r"-?\d+(?:\.\d+)?(?:[eE][+-]?\d+)?")


def _typed_value(name: str, rhs: str):
    """Type an assignment's right-hand side: float, float vector, bool, or str."""
    rhs = rhs.strip()
    if name == "TvgRangeCorrection":
        if rhs not in TVG_RANGE_CORRECTION_VALUES:
            raise ValueError(f"TvgRangeCorrection has unexpected value {rhs!r}")
        return rhs
    if name == "TransducerModeActive":
        return rhs.lower() in ("true", "1", "yes", "active")
    numbers = _NUMBER.findall(rhs)
    if numbers and "".join(_NUMBER.split(rhs)).strip() == "":
        # the RHS is purely numeric tokens
        if len(numbers) == 1:
            return float(numbers[0])
        return np.asarray(numbers, dtype="f8")
    return rhs if rhs else None


@dataclass
class EcsDocument:
    """Typed result of parsing one .ecs file."""

    data_type: Optional[str] = None
    version: Optional[str] = None
    file_creation_time: Optional[datetime] = None
    fileset: dict = field(default_factory=dict)
    sourcecal: dict = field(default_factory=dict)  # name -> {param: value}
    localcal: dict = field(default_factory=dict)  # name -> {param: value}

    def consolidated(self, localcal_name: Optional[str] = None) -> dict:
        """Per-source params with LocalCal > SourceCal > Fileset precedence.

        Overrides REINSERT the key (pop + set) instead of dict.update: plain
        update keeps the overridden key's original insertion position, which
        would make a LocalCal override of a SourceCal param sit EARLIER in
        the dict than a SourceCal alias of the same echopype param — and
        ecs_ev2ep's alias resolution is by-position (last assignment wins).
        With reinsertion, dict order == precedence order == file order
        within each layer (review finding, pinned in tests/test_ecs.py::
        test_localcal_alias_precedence).
        """
        def layered(dst, src):
            for k, v in src.items():
                dst.pop(k, None)
                dst[k] = v

        out = {}
        for src, params in self.sourcecal.items():
            merged = {}
            layered(merged, self.fileset)
            layered(merged, params)
            out[src] = merged
        if self.localcal:
            if localcal_name is None:
                localcal_name = next(iter(self.localcal))
            overrides = self.localcal[localcal_name]
            for merged in out.values():
                layered(merged, overrides)
        return out


def parse_ecs(path) -> EcsDocument:
    """Parse an Echoview .ecs file into an :class:`EcsDocument`.

    Grammar (single pass, no backtracking): ``#===#`` ruler lines are pure
    separators; banner comments carry the file header, timestamp, and section
    titles; ``Version N.NN`` stamps the format version; ``SourceCal NAME`` /
    ``LocalCal NAME`` open a parameter group; ``Name = value`` lines assign
    into the open group (or the fileset when inside FILESET SETTINGS).
    Commented-out assignments are dropped except the informational
    ``Frequency`` line, which Echoview templates keep commented.
    """
    doc = EcsDocument()
    section = None  # None | "fileset" | "sourcecal" | "localcal"
    group: Optional[dict] = None  # open parameter group receiving assignments

    with open(path, encoding="utf-8-sig") as fh:
        for lineno, raw in enumerate(fh, start=1):
            line = raw.rstrip("\r\n")
            if not line.strip():
                continue
            if _LINE_RULER.match(line):
                continue

            m = _LINE_TITLE.match(line)
            if m:
                section = m["title"].lower()
                group = doc.fileset if section == "fileset" else None
                continue
            m = _LINE_FILEHEAD.match(line)
            if m:
                doc.data_type = m["dtype"].strip()
                continue
            m = _LINE_STAMP.match(line)
            if m and doc.file_creation_time is None:
                doc.file_creation_time = datetime.strptime(
                    f"{m['mdY']} {m['hms']}", "%m/%d/%Y %H:%M:%S"
                )
                continue
            m = _LINE_GROUP.match(line)
            if m:
                table = doc.sourcecal if m["kind"].lower() == "sourcecal" else doc.localcal
                group = table.setdefault(m["name"], {})
                continue
            m = _LINE_ASSIGN.match(line)
            if m:
                if m["commented"] and m["name"] not in _KEEP_WHEN_COMMENTED:
                    continue
                if group is None:
                    if line.lstrip().startswith("#"):
                        continue  # commented assignment outside any group
                    raise ValueError(
                        f"ECS line {lineno}: assignment {m['name']!r} outside any "
                        "FILESET/SourceCal/LocalCal group"
                    )
                value = _typed_value(m["name"], m["rhs"])
                if value is not None:
                    group[m["name"]] = value
                continue
            m = _LINE_VERSION.match(line)
            if m:
                doc.version = m["ver"]
                continue
            if line.lstrip().startswith("#"):
                continue  # decorative banner / diagram comment
            raise ValueError(f"ECS line {lineno}: unrecognized content: {line.strip()!r}")

    return doc


class ECSParser:
    """API-compatible facade over :func:`parse_ecs`.

    Mirrors the reference's public surface (``parse``, ``get_cal_params``,
    ``data_type``/``version``/``file_creation_time``/``parsed_params``).
    """

    def __init__(self, input_file=None):
        self.input_file = input_file
        self._doc: Optional[EcsDocument] = None

    def parse(self) -> None:
        self._doc = parse_ecs(self.input_file)

    @property
    def data_type(self):
        return self._doc.data_type if self._doc else None

    @property
    def version(self):
        return self._doc.version if self._doc else None

    @property
    def file_creation_time(self):
        return self._doc.file_creation_time if self._doc else None

    @property
    def parsed_params(self):
        if self._doc is None:
            return None
        return {
            "fileset": self._doc.fileset,
            "sourcecal": self._doc.sourcecal,
            "localcal": self._doc.localcal,
        }

    def get_cal_params(self, localcal_name=None) -> dict:
        """Consolidate with the LocalCal > SourceCal > Fileset hierarchy."""
        if self._doc is None:
            self.parse()
        return self._doc.consolidated(localcal_name)


# ---------------------------------------------------------------------------
# ECS -> echopype parameter datasets
# ---------------------------------------------------------------------------
def ecs_ev2ep(ev_dict, sonar_type):
    """Consolidated ECS dict -> (env Dataset, cal Dataset, BB cal Dataset|None)."""
    PARAM_MAP = dict(EV_EP_MAP["EK60"])
    if sonar_type == "EK80":
        PARAM_MAP.update(EV_EP_MAP["EK80"])
    cal_names = set(PARAM_MAP) - set(ENV_PARAMS) - set(CAL_PARAMS_BB)

    def get_param_ds(param_names):
        # EV alias resolution: several EV names map to one echopype param
        # (TransducerGain/Ek60TransducerGain -> gain_correction, ...).  We
        # resolve PER CHANNEL to the LAST assignment in the file — the same
        # downstream-overrides-upstream rule ECS uses everywhere else.  The
        # reference instead iterates a Python SET of EV names here
        # (ecs.py ecs_ev2ep), so with duplicate aliases its winner follows
        # PYTHONHASHSEED: the same ECS file can calibrate to different Sv
        # between processes (verified across hash seeds; pinned in
        # tests/test_ecs.py::test_duplicate_alias_last_in_file_wins).
        wanted = {n: PARAM_MAP[n] for n in param_names if n in PARAM_MAP}
        per_ep, ep_order = {}, []
        for ch_i, src in enumerate(ev_dict.values()):
            for p_name, v in src.items():
                ep_name = wanted.get(p_name)
                if ep_name is None:
                    continue
                if ep_name not in per_ep:
                    per_ep[ep_name] = [np.nan] * len(ev_dict)
                    ep_order.append(ep_name)
                per_ep[ep_name][ch_i] = v  # later file entries overwrite
        ds = Dataset(coords={"channel": np.arange(len(ev_dict))})
        for ep_name in ep_order:
            # per-ELEMENT coercion: one channel's malformed (non-numeric)
            # value becomes NaN for that channel only — converting the whole
            # merged list at once would drop the param for every channel
            # (review finding; the reference crashes on np.isnan(list-with-
            # str) here, so this region's semantics are ours to define)
            arr = np.full(len(ev_dict), np.nan)
            for k, v in enumerate(per_ep[ep_name]):
                try:
                    arr[k] = float(v)
                except (TypeError, ValueError):
                    pass
            if not np.isnan(arr).all():
                ds[ep_name] = (("channel",), arr)
        return ds

    ds_env = get_param_ds(ENV_PARAMS)
    ds_cal = get_param_ds(sorted(cal_names))
    if "frequency_nominal" in ds_cal:
        ds_env["frequency_nominal"] = ds_cal["frequency_nominal"]

    # frequency-dependent BB tables
    bb_sources = [
        (src, d) for src, d in ev_dict.items() if "FrequencyTableWideband" in d
    ]
    ds_cal_BB = None
    if bb_sources:
        freqs = sorted(
            set(np.concatenate([np.atleast_1d(d["FrequencyTableWideband"]) for _, d in bb_sources]))
        )
        freqs = np.asarray(freqs, dtype="f8")
        ds_cal_BB = Dataset(
            coords={
                # table frequencies stay AS LISTED in the ECS file — the
                # reference performs no unit conversion on the wideband
                # frequency axis (ecs.py:383-388 converts only
                # frequency_nominal/sampling/receiver), so working Echoview
                # EK80 tables carry Hz; a kHz-axis table interps to NaN at
                # the Hz center frequency on both sides
                "cal_frequency": (
                    ("cal_frequency",),
                    freqs,
                    {"long_name": "Frequency of calibration parameter", "units": "Hz"},
                ),
                "cal_channel_id": np.asarray(
                    [str(d["Frequency"]) for _, d in bb_sources], dtype=object
                ),
            }
        )
        for p_name in CAL_PARAMS_BB[1:]:
            vals = np.full((len(bb_sources), len(freqs)), np.nan)
            found = False
            for i, (_, d) in enumerate(bb_sources):
                if p_name in d:
                    found = True
                    idx = np.searchsorted(freqs, np.atleast_1d(d["FrequencyTableWideband"]))
                    vals[i, idx] = np.atleast_1d(d[p_name])
            if found:
                ds_cal_BB[PARAM_MAP[p_name]] = (("cal_channel_id", "cal_frequency"), vals)
        ds_cal_BB["frequency_nominal"] = (
            ("cal_channel_id",),
            np.asarray([d["Frequency"] for _, d in bb_sources], dtype="f8") * 1000,
        )

    # kHz -> Hz
    for p_name in ("frequency_nominal", "sampling_frequency", "receiver_sampling_frequency"):
        for ds in (ds_env, ds_cal):
            if p_name in ds:
                ds[p_name] = (("channel",), np.asarray(ds[p_name].values) * 1000)
    return ds_env, ds_cal, ds_cal_BB


def ecs_ds2dict(ds) -> dict:
    if ds is None:
        return {}
    return {name: ds[name] for name in ds.data_vars}


def conform_channel_order(ds_in, freq_ref):
    """Reorder ECS channels to match the data's channel order by frequency."""
    if ds_in is None:
        return None
    if not isinstance(freq_ref, DataArray):
        raise ValueError("'freq_ref' must be a DataArray")
    if "channel" not in freq_ref.coords:
        raise ValueError("'freq_ref' must carry a 'channel' coordinate")
    if "frequency_nominal" not in ds_in:
        return None
    ecs_freqs = np.asarray(ds_in["frequency_nominal"].values, dtype="f8")
    ref_freqs = np.asarray(freq_ref.values, dtype="f8")
    overlap = [f for f in ref_freqs if f in set(ecs_freqs)]
    if not overlap:
        return None
    sel_idx = [int(np.nonzero(ecs_freqs == f)[0][0]) for f in overlap]
    ref_idx = [int(np.nonzero(ref_freqs == f)[0][0]) for f in overlap]
    out = Dataset()
    out.coords["channel"] = DataArray(
        np.asarray(freq_ref.coords["channel"].values)[ref_idx], ("channel",), name="channel"
    )
    for name, var in ds_in.data_vars.items():
        if name == "frequency_nominal":
            continue
        if "channel" in var.dims:
            out[name] = (("channel",), np.asarray(var.values)[sel_idx])
        else:
            out[name] = var
    return out


def _interp_union_grid(xp, yp, x):
    """Linear interp over a (possibly NaN-padded) union frequency grid with
    xarray semantics: NaN outside [xp[0], xp[-1]], NaN bracketing values
    propagate, exact grid hits return the stored value."""
    xp = np.asarray(xp, dtype="f8")
    yp = np.asarray(yp, dtype="f8")
    x = np.atleast_1d(np.asarray(x, dtype="f8"))
    out = np.interp(x, xp, yp)
    out = np.where((x < xp[0]) | (x > xp[-1]), np.nan, out)
    exact = np.isin(x, xp)
    if exact.any():
        idx = np.searchsorted(xp, x[exact])
        out[exact] = yp[idx]
    return out


def assimilate_bb_cal_params(ds_cal_BB, cal, frequency_nominal, freq_center):
    """Fold frequency-dependent ECS tables into the cal dict at freq_center
    (reference: calibrate_ek.py:406-456 -> cal_params.py:165-258).

    Channels with a table interp at their per-ping center frequency; the
    rest keep the narrowband value.  The reference requires the narrowband
    value to exist for every table channel — same ValueError here.
    """
    if ds_cal_BB is None or freq_center is None:
        return cal
    ecs_fn = np.asarray(ds_cal_BB["frequency_nominal"].values, dtype="f8")
    data_fn = np.asarray(frequency_nominal.values, dtype="f8")
    chan_names = [str(c) for c in frequency_nominal.coords["channel"].values]
    # map each table row to the data channel with matching nominal frequency
    row_of = {}
    for i, ch in enumerate(chan_names):
        hits = np.nonzero(ecs_fn == data_fn[i])[0]
        if len(hits):
            row_of[ch] = int(hits[0])
    if not row_of:
        return cal
    fc = freq_center
    fc_vals = np.asarray(fc.values, dtype="f8")
    if fc_vals.ndim == 1:  # [channel] -> [channel, 1]
        fc_vals = fc_vals[:, None]
    n_ping = fc_vals.shape[1]
    grid = np.asarray(ds_cal_BB.coords["cal_frequency"].values, dtype="f8")
    for name, table in ds_cal_BB.data_vars.items():
        if name == "frequency_nominal":
            continue
        nb = cal.get(name)
        nb_chans = (
            [str(c) for c in nb.coords.get("channel", nb).values]
            if nb is not None
            else []
        )
        # channels WITHOUT a table keep the narrowband value — so it must
        # exist for every data channel we materialize, not just the table
        # ones (a partial-coverage ECS previously mis-indexed positionally,
        # IndexError — round-5 ecs80 soak; the reference crashes on the
        # same inputs with a raw KeyError at its .sel)
        need = set(row_of) | set(chan_names)
        if nb is None or not need <= set(nb_chans):
            raise ValueError(
                f"Narrowband (CW mode) parameter {name} should exist "
                "for all channels with frequency-dependent parameter values."
            )
        nb_vals = np.asarray(nb.values, dtype="f8")
        nb_pos = {ch: k for k, ch in enumerate(nb_chans)}
        out = np.empty((len(chan_names), n_ping))
        for i, ch in enumerate(chan_names):
            if ch in row_of:
                out[i] = _interp_union_grid(
                    grid, np.asarray(table.values)[row_of[ch]], fc_vals[i]
                )
            else:
                out[i] = nb_vals[nb_pos[ch]]
        cal[name] = DataArray(
            out,
            ("channel", "ping_time"),
            coords={
                "channel": np.asarray(chan_names, dtype=object),
                **(
                    {"ping_time": fc.coords["ping_time"]}
                    if "ping_time" in fc.coords
                    else {}
                ),
            },
            name=name,
        )
    return cal


def ecs_to_params(ecs_file, sonar_type, frequency_nominal, freq_center=None):
    """Parse an ECS file into (env_params, cal_params) dicts for a calibrator.

    ``freq_center`` (EK80 BB): per-channel(/ping) center frequency at which
    frequency-dependent ECS tables interpolate into the cal dict.
    """
    doc = parse_ecs(ecs_file)
    ds_env, ds_cal, ds_cal_BB = ecs_ev2ep(doc.consolidated(), sonar_type)
    if "frequency_nominal" not in ds_cal and (
        len(ds_cal.data_vars) or len(ds_env.data_vars) or ds_cal_BB is not None
    ):
        # Channel mapping needs a Frequency line (a commented one counts —
        # Echoview templates keep it commented and both parsers special-case
        # it) in at least one SourceCal block.  The reference crashes with a
        # bare KeyError('frequency_nominal') here (reference ecs.py:355);
        # silently dropping the file's parameters would be worse, so raise
        # the condition explicitly (pinned in tests/test_ecs.py::
        # test_missing_frequency_raises).
        raise ValueError(
            "ECS file defines calibration/environment parameters but no "
            "'Frequency' line in any SourceCal block; frequencies are "
            "required to map ECS transducer blocks onto data channels."
        )
    env_conf = conform_channel_order(ds_env, frequency_nominal)
    cal_conf = conform_channel_order(ds_cal, frequency_nominal)
    if freq_center is not None:
        # EK80 complex chain: its per-channel scalar assembly requires ECS
        # coverage of EVERY data channel — a partial-coverage file crashed
        # the chain downstream with raw shape errors (and crashes the
        # reference at several distinct sites: conform(None) AttributeError,
        # .sel KeyError — round-5 ecs80 soak).  Refuse descriptively.
        n_data = len(np.atleast_1d(np.asarray(frequency_nominal.values)))
        for label, conf in (("environment", env_conf), ("calibration", cal_conf)):
            if (
                conf is not None
                and len(conf.data_vars)
                and len(np.atleast_1d(conf.coords["channel"].values)) < n_data
            ):
                n_cov = len(np.atleast_1d(conf.coords["channel"].values))
                raise ValueError(
                    f"ECS file provides {label} parameters for {n_cov} of "
                    f"{n_data} data channels; the EK80 complex calibration "
                    "chain requires ECS coverage of every channel — add "
                    "SourceCal blocks for the missing channels or drop the "
                    "ECS file."
                )
    env = ecs_ds2dict(env_conf)
    cal = ecs_ds2dict(cal_conf)
    # strip params that are not calibration inputs
    cal.pop("transmit_duration_nominal", None)
    cal.pop("transmit_power", None)
    cal.pop("tau_effective", None)
    cal = assimilate_bb_cal_params(ds_cal_BB, cal, frequency_nominal, freq_center)
    return env, cal
