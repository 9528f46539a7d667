"""Simrad EK80 ``.raw`` files of broadband (FM) complex samples, written from a seed.

The datagram layout is a frozen copy of ``tests/synth_ek80.py``'s (XML0
configuration, environment and parameter; FIL1; RAW3 with complex float32
samples, data type bit 3; NME0 GGA), assembled with NumPy structured
arrays: every ping is one fixed-size record ``(XML0 parameter, RAW3) x C,
NME0``, so a file of 1,000 pings x 4 channels x 8,192 samples x 4 sectors
(1.05 GB) is one ``tofile`` call.

The samples are drawn on ``device`` with a seeded ``torch.Generator``, one
channel of a file at a time.  Recipe, per channel:

* scattering layers (``scattering.layers``): each file draws a layer's
  centre depth uniformly in its ``depth_m`` range, and the centre moves by
  ``depth_drift_m`` times a sine over the file's pings; the layer's
  amplitude profile is a Gaussian of ``width_m`` at ``snr_db`` over the
  noise, times ``reference_range_m / r`` past that range (spherical
  spreading);
* the scatterers are a complex Gaussian amplitude a sample, scaled by the
  summed profiles and divided by the transmit chirp's norm, so that the
  echo's rms at a layer's centre is its profile there;
* the echo is the scatterers convolved (FFT, complex64) with the channel's
  own transmitted chirp: the Hann-tapered linear sweep from
  ``frequency_start`` to ``frequency_end`` over ``pulse_duration``, as an
  analytic signal at the channel's sample rate;
* each sector receives the echo turned by its own phase, uniform within
  ``sector_phase_rad`` (a target off the beam axis), plus complex Gaussian
  noise of ``noise_volts`` rms a component.

Pulse compression by the replica the processing rebuilds concentrates each
layer's energy as on real broadband data.  The FIL1 coefficients are
Hann-windowed sinc band-pass filters over each transducer's band
(:func:`filter_coefficients`), stored as complex64.  Ping times sit half a
second past whole seconds, so the rounding of NT time on decode never moves
a ping across a ping-time bin edge.
"""

from __future__ import annotations

import struct
from pathlib import Path

import numpy as np
import torch

__all__ = ["NT_UNIX_DELTA_S", "filter_coefficients", "write_files"]

NT_UNIX_DELTA_S = 11644473600
_STAGES = {1: "wbt_filter", 2: "pc_filter"}


def _nt_ticks(ns):
    """int64 ns since the Unix epoch -> (low, high) 100 ns NT ticks."""
    ticks = np.asarray(ns, dtype="i8") // 100 + NT_UNIX_DELTA_S * 10_000_000
    return (ticks & 0xFFFFFFFF).astype("<u4"), (ticks >> 32).astype("<u4")


def _frame(body: bytes) -> bytes:
    return struct.pack("<l", len(body)) + body + struct.pack("<l", len(body))


def _num(v):
    """A number as XML text that parses back to the same float64."""
    return repr(float(v))


def _list(vals):
    return ";".join(_num(v) for v in vals)


def config_xml(config):
    """The configuration XML0 text (tests/synth_ek80.py:config_xml's layout)."""
    tcvrs = []
    for i, ch in enumerate(config["channels"]):
        cal = ch["calibration"]
        pars = "".join(
            f'<FrequencyPar Frequency="{int(f)}" Gain="{_num(g)}" Impedance="{_num(z)}" '
            f'Phase="{_num(ph)}" BeamWidthAlongship="{_num(ba)}" '
            f'BeamWidthAthwartship="{_num(bt)}" AngleOffsetAlongship="{_num(oa)}" '
            f'AngleOffsetAthwartship="{_num(ot)}"/>'
            for f, g, z, ph, ba, bt, oa, ot in zip(
                cal["frequency"], cal["gain"], cal["impedance"], cal["phase"],
                cal["beamwidth_alongship"], cal["beamwidth_athwartship"],
                cal["angle_offset_alongship"], cal["angle_offset_athwartship"]))
        intervals = [t / 32.0 for t in ch["pulse_duration_table"]]
        tcvrs.append(
            f'<Transceiver TransceiverNumber="{i + 1}" TransceiverType="WBT" Version="1.2" '
            f'IPAddress="10.0.0.{i + 1}" Impedance="{int(config["transceiver_impedance"])}" '
            f'RxSampleFrequency="{int(config["receiver_sampling_frequency"])}"><Channels>'
            f'<Channel ChannelID="{ch["channel_id"]}" MaxTxPowerTransceiver="4000" '
            f'PulseDuration="{_list(ch["pulse_duration_table"])}" '
            f'SampleInterval="{_list(intervals)}" HWChannelConfiguration="1">'
            f'<Transducer TransducerName="{ch["transducer"]}" SerialNumber="{100 + i}" '
            f'Frequency="{_num(ch["frequency"])}" '
            f'FrequencyMinimum="{_num(ch["frequency_start"])}" '
            f'FrequencyMaximum="{_num(ch["frequency_end"])}" BeamType="1" '
            f'Gain="{_list(ch["gain_table"])}" SaCorrection="{_list(ch["sa_correction_table"])}" '
            f'EquivalentBeamAngle="{_num(ch["equivalent_beam_angle"])}" '
            f'BeamWidthAlongship="{_num(ch["beamwidth_alongship"])}" '
            f'BeamWidthAthwartship="{_num(ch["beamwidth_athwartship"])}" '
            f'AngleSensitivityAlongship="{_num(ch["angle_sensitivity_alongship"])}" '
            f'AngleSensitivityAthwartship="{_num(ch["angle_sensitivity_athwartship"])}" '
            f'AngleOffsetAlongship="{_num(ch["angle_offset_alongship"])}" '
            f'AngleOffsetAthwartship="{_num(ch["angle_offset_athwartship"])}" '
            f'TransducerOffsetX="0.0" TransducerOffsetY="0.0" TransducerOffsetZ="0.0">'
            f'{pars}</Transducer></Channel></Channels></Transceiver>')
    return ('<Configuration><Header Copyright="c" ApplicationName="EK80" Version="21.15.0"/>'
            "<Transceivers>" + "".join(tcvrs) + "</Transceivers></Configuration>")


def environment_xml(config):
    env = config["environment"]
    c = _num(env["sound_speed"])
    return (f'<Environment Depth="{_num(env["depth"])}" Acidity="{_num(env["acidity"])}" '
            f'Salinity="{_num(env["salinity"])}" SoundSpeed="{c}" '
            f'Temperature="{_num(env["temperature"])}" Latitude="44.5" DropKeelOffset="0.0" '
            f'DropKeelOffsetIsManual="0" WaterLevelDraft="0.0" WaterLevelDraftIsManual="0" '
            f'SoundVelocityProfile="1.0;{c};100.0;{c}" SoundVelocitySource="Manual"/>')


def parameter_xml(ch):
    """One channel's parameter XML0 text: an LFM pulse (PulseForm 1)."""
    return (f'<Parameter><Channel ChannelID="{ch["channel_id"]}" ChannelMode="0" PulseForm="1" '
            f'FrequencyStart="{_num(ch["frequency_start"])}" '
            f'FrequencyEnd="{_num(ch["frequency_end"])}" '
            f'PulseDuration="{_num(ch["pulse_duration"])}" '
            f'SampleInterval="{_num(ch["sample_interval"])}" '
            f'TransmitPower="{_num(ch["transmit_power"])}" Slope="{_num(ch["slope"])}"/>'
            "</Parameter>")


def filter_coefficients(config, ch, stage):
    """complex64 taps of a channel's WBT (``stage`` 1) or PC (2) filter:
    a Hann-windowed sinc low-pass of half-width 0.6 x the band, moved to
    the band's centre, at the stage's input rate (the receiver's rate, or
    that over the WBT decimation)."""
    spec = ch[_STAGES[stage]]
    fs = float(config["receiver_sampling_frequency"])
    if stage == 2:
        fs /= ch["wbt_filter"]["decimation"]
    n = int(spec["taps"])
    lo, hi = float(ch["frequency_start"]), float(ch["frequency_end"])
    half = 0.6 * (hi - lo) / fs
    k = np.arange(n) - (n - 1) / 2.0
    h = 2.0 * half * np.sinc(2.0 * half * k) * np.hanning(n + 2)[1:-1]
    return (h * np.exp(2j * np.pi * (lo + hi) / 2.0 / fs * np.arange(n))).astype("c8")


def _xml0(t_ns, text):
    low, high = _nt_ticks([t_ns])
    return _frame(struct.pack("<4sLL", b"XML0", int(low[0]), int(high[0])) + text.encode()
                  + b"\x00")


def _fil1(t_ns, ch_id, stage, coeffs, decimation):
    low, high = _nt_ticks([t_ns])
    body = struct.pack("<4sLLh2s128shh", b"FIL1", int(low[0]), int(high[0]), stage, b"",
                       ch_id.encode(), len(coeffs), decimation)
    return _frame(body + np.asarray(coeffs, dtype="<c8").tobytes())


def _record_dtype(config):
    R, B = int(config["samples_per_ping"]), int(config["sectors"])
    fields = []
    for i, ch in enumerate(config["channels"]):
        text = len(parameter_xml(ch)) + 1
        fields.append((f"x{i}", [("len1", "<i4"), ("type", "S4"), ("low", "<u4"),
                                 ("high", "<u4"), ("text", f"S{text}"), ("len2", "<i4")]))
        fields.append((f"r{i}", [("len1", "<i4"), ("type", "S4"), ("low", "<u4"),
                                 ("high", "<u4"), ("channel", "S128"), ("data_type", "<i2"),
                                 ("spare", "S2"), ("offset", "<i4"), ("count", "<i4"),
                                 ("samples", "<c8", (R, B)), ("len2", "<i4")]))
    fields.append(("n", [("len1", "<i4"), ("type", "S4"), ("low", "<u4"), ("high", "<u4"),
                         ("text", f"S{len(_gga(0.0, 0.0))}"), ("len2", "<i4")]))
    return np.dtype(fields)


def _gga(lat, lon):
    la, lo = int(lat), int(lon)
    return (f"$GPGGA,120000,{la:02d}{(lat - la) * 60:07.4f},N,"
            f"{lo:03d}{(lon - lo) * 60:07.4f},W,1,08,0.9,5.0,M,,M,,")


def _chirp(config, ch):
    """The transmitted chirp as an analytic signal at the channel's sample
    rate, Hann-tapered over ``slope`` of its length at each end: complex128."""
    si, tau = float(ch["sample_interval"]), float(ch["pulse_duration"])
    n = int(round(tau / si))
    t = np.arange(n) * si
    f0, f1 = float(ch["frequency_start"]), float(ch["frequency_end"])
    y = np.exp(1j * (np.pi * (f1 - f0) / tau * t * t + 2 * np.pi * f0 * t))
    m = max(2, int(round(n * float(ch["slope"]) * 2)))
    w = np.hanning(m)
    y[: m // 2] *= w[: m // 2]
    y[n - (m - m // 2):] *= w[m // 2:]
    return y


def _echoes(config, ch, n_pings, g, device):
    """complex64 [P, R, B] samples of one channel of one file (module docstring)."""
    sc, env = config["scattering"], config["environment"]
    R, B = int(config["samples_per_ping"]), int(config["sectors"])
    dr = float(ch["sample_interval"]) * float(env["sound_speed"]) / 2.0
    r = torch.arange(R, dtype=torch.float64, device=device) * dr
    ping = torch.arange(n_pings, dtype=torch.float64, device=device)
    noise = float(sc["noise_volts"])
    r_ref = float(sc["reference_range_m"])
    prof = torch.zeros((n_pings, R), dtype=torch.float64, device=device)
    for layer in sc["layers"]:
        lo, hi = layer["depth_m"]
        u = torch.rand((2,), generator=g, device=device, dtype=torch.float64)
        centre = lo + (hi - lo) * u[0] + float(sc["depth_drift_m"]) * torch.sin(
            2 * np.pi * (ping / max(n_pings, 1) + u[1]))
        prof += (10 ** (layer["snr_db"] / 20.0) * noise
                 * torch.exp(-(((r[None, :] - centre[:, None]) / layer["width_m"]) ** 2)))
    prof *= r_ref / torch.clamp_min(r, r_ref)[None, :]
    chirp = _chirp(config, ch)
    N = 1 << int(np.ceil(np.log2(R + len(chirp) - 1)))
    amp = torch.randn((n_pings, R, 2), generator=g, device=device, dtype=torch.float32)
    scat = torch.view_as_complex(amp) * (prof / np.sqrt(2.0) / np.linalg.norm(chirp)).float()
    c = torch.from_numpy(chirp.astype("c8")).to(device)
    echo = torch.fft.ifft(torch.fft.fft(scat, N) * torch.fft.fft(c, N))[:, :R]
    phase = (2 * torch.rand((n_pings, 1, B), generator=g, device=device) - 1) \
        * float(sc["sector_phase_rad"])
    x = echo[:, :, None] * torch.polar(torch.ones_like(phase), phase)
    n = torch.randn((n_pings, R, B, 2), generator=g, device=device, dtype=torch.float32)
    return x + torch.view_as_complex(n) * np.float32(noise / np.sqrt(2.0))


def write_file(path, config, spec, t0_ns, seed, device):
    """Write the file of traffic entry ``spec``; returns its truth: complex
    samples per channel ([P, R, B] complex64 views of what was written),
    ping times [P] int64 ns, and each channel's (WBT, PC) FIL1 taps by
    channel id."""
    chans = config["channels"]
    n_pings = int(spec["pings"])
    g = torch.Generator(device=device)
    g.manual_seed(int(seed))
    t_ns = t0_ns + np.arange(n_pings, dtype="i8") * int(config["ping_interval_ns"]) \
        + int(config["ping_offset_ns"])
    low, high = _nt_ticks(t_ns)
    rec = np.zeros(n_pings, dtype=_record_dtype(config))
    B = int(config["sectors"])
    for i, ch in enumerate(chans):
        x = rec[f"x{i}"]
        x["len1"] = x["len2"] = x.dtype.itemsize - 8
        x["type"], x["low"], x["high"] = b"XML0", low, high
        x["text"] = parameter_xml(ch).encode()
        r = rec[f"r{i}"]
        r["len1"] = r["len2"] = r.dtype.itemsize - 8
        r["type"], r["low"], r["high"] = b"RAW3", low, high
        r["channel"] = ch["channel_id"].encode()
        r["data_type"] = 0b1000 | (B << 8)  # complex float32, B sectors
        r["count"] = int(config["samples_per_ping"])
        r["samples"] = _echoes(config, ch, n_pings, g, device).cpu().numpy()
    n = rec["n"]
    n["len1"] = n["len2"] = n.dtype.itemsize - 8
    n["type"], n["low"], n["high"] = b"NME0", low, high
    pos = np.arange(n_pings, dtype="f8")
    n["text"] = np.asarray([_gga(45.0 + p * 1e-5, 124.0 + p * 1e-5) for p in pos], dtype="S")
    head = [_xml0(t0_ns, config_xml(config)), _xml0(t0_ns, environment_xml(config))]
    filters = {ch["channel_id"]: [filter_coefficients(config, ch, s) for s in _STAGES]
               for ch in chans}
    for ch in chans:
        for (stage, key), taps in zip(_STAGES.items(), filters[ch["channel_id"]]):
            head.append(_fil1(t0_ns, ch["channel_id"], stage, taps, ch[key]["decimation"]))
    with open(path, "wb") as fh:
        fh.write(b"".join(head))
        rec.tofile(fh)
    return {"complex": [rec[f"r{i}"]["samples"] for i in range(len(chans))],
            "ping_time_ns": t_ns, "filters": filters}


def write_files(config, traffic, seed, out_dir, device):
    """The traffic's files in ``out_dir``, each from its own stream of
    ``seed``; consecutive in time.  Returns [(path, truth)]."""
    out_dir = Path(out_dir)
    t_ns = int(np.datetime64(config["start_time"], "ns").astype("i8"))
    made = []
    for i, spec in enumerate(traffic["files"]):
        path = out_dir / spec["name"]
        truth = write_file(path, config, spec, t_ns, (int(seed) * 1_000_003 + i) % 2**62,
                           device)
        made.append((str(path), truth))
        t_ns += int(spec["pings"]) * int(config["ping_interval_ns"])
    return made
