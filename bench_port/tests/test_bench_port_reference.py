"""The plain references against hand-worked cases and against the port's CPU path.

Run: ``python -m pytest bench_port/tests -q`` (CPU; not part of ``tests/``).
"""

import math

import numpy as np
import pytest
import torch
from tiny import tiny_bench

from bench_port.harness import main
from bench_port.reference import azfp, ek60
from bench_port.synth import ek60 as synth_ek60


def _ek60_config():
    return {"channels": [{
        "channel_id": "GPT  38 kHz x", "frequency": 38000.0, "transmit_power": 1000.0,
        "pulse_length": 1.024e-3, "sample_interval": 2.56e-4, "absorption_coefficient": 0.01,
        "equivalent_beam_angle": -20.0, "pulse_length_table": [5.12e-4, 1.024e-3],
        "gain_table": [24.0, 25.0], "sa_correction_table": [-0.5, -0.25]}]}


def _ek60_sv_by_hand(idx, k, c=1500.0):
    """The EK60 sonar equation for one sample, every term written out."""
    f32 = lambda v: float(np.float32(v))  # noqa: E731 - the files store float32
    si, f, pt, tau = f32(2.56e-4), 38000.0, 1000.0, f32(1.024e-3)
    dr = si * c / 2
    r = k * dr - 2 * dr
    lam = c / f
    csv = 10 * math.log10(pt) + 2 * 25.0 + (-20.0) + 10 * math.log10(lam**2 * tau * c / (32 * math.pi**2))
    p_db = idx * 10 * math.log10(2) / 256
    return p_db + 20 * math.log10(r) + 2 * f32(0.01) * r - (csv + 2 * -0.25)


def test_ek60_reference_against_hand_worked_case():
    power = np.array([[[-5000, -6000, -7000, -8000, -9000, -10000]]], dtype="i2")
    truth = {"power": power, "sound_speed": np.array([1500.0], dtype="f4"),
             "ping_time_ns": np.array([10_500_000_000])}
    out = ek60.chain_file(_ek60_config(), truth, range_bin_m=0.2, ping_bin_s=20)
    sv = out["Sv_samples"][0, 0]
    assert np.isnan(sv[:3]).all()  # k dr <= the two-sample TVG shift
    want = [_ek60_sv_by_hand(-7000 - 1000 * (k - 2), k) for k in range(3, 6)]
    np.testing.assert_allclose(sv[3:], want, rtol=0, atol=1e-9)
    # dr = 0.192 m: samples 3 and 4 lie in [0.4, 0.6) and [0.6, 0.8), sample 5 in [0.8, 1.0)
    lin = 10 ** (np.asarray(want) / 10)
    np.testing.assert_allclose(out["Sv"][0, 0, 2:5], 10 * np.log10(lin), atol=1e-9)
    assert np.isnan(out["Sv"][0, 0, 0])  # samples 0 and 1: NaN Sv, no mean


def test_ek60_survey_reference_bins_by_the_chunk_first_ping():
    """With dr by ping, a chunk's bins follow its first ping's dr."""
    cfg = _ek60_config()
    power = np.full((1, 2, 8), -6000, dtype="i2")
    truth = {"power": power, "sound_speed": np.array([1500.0, 1600.0], dtype="f4"),
             "ping_time_ns": np.array([10_500_000_000, 11_500_000_000])}
    out = ek60.survey_mvbs(cfg, [("f", truth)], range_bin_m=0.5, ping_bin_s=20, chunk_pings=2)
    dr0 = float(np.float32(2.56e-4 * 1500 / 2))
    dr1 = float(np.float32(2.56e-4 * 1600 / 2))
    sums, counts = np.zeros(4), np.zeros(4)
    for dr_p, c in ((dr0, 1500.0), (dr1, 1600.0)):
        for k in range(8):
            if np.float32(k) * np.float32(dr_p) <= np.float32(2 * dr_p):
                continue
            b = int(np.float32(k) * np.float32(dr0) // 0.5)  # the first ping's grid
            sums[b] += 10 ** (_ek60_sv_by_hand(-6000, k, c) / 10)
            counts[b] += 1
    with np.errstate(divide="ignore"):
        want = np.where(counts > 0, 10 * np.log10(sums / np.maximum(counts, 1)), np.nan)
    np.testing.assert_allclose(out["Sv"][0, 0], want[: out["Sv"].shape[2]], atol=1e-9)


def test_ek60_survey_reference_per_sample_bins_each_ping_by_its_own_dr():
    """``per_sample``: compute_MVBS's rule, each ping on its own grid."""
    cfg = _ek60_config()
    power = np.full((1, 2, 8), -6000, dtype="i2")
    truth = {"power": power, "sound_speed": np.array([1500.0, 1600.0], dtype="f4"),
             "ping_time_ns": np.array([10_500_000_000, 11_500_000_000])}
    out = ek60.survey_mvbs(cfg, [("f", truth)], range_bin_m=0.5, ping_bin_s=20, chunk_pings=2,
                           per_sample=True)
    sums, counts = np.zeros(4), np.zeros(4)
    for c in (1500.0, 1600.0):
        dr_p = float(np.float32(2.56e-4 * c / 2))
        for k in range(8):
            if np.float32(k) * np.float32(dr_p) <= np.float32(2 * dr_p):
                continue
            b = int(np.float32(k) * np.float32(dr_p) // 0.5)  # the ping's own grid
            sums[b] += 10 ** (_ek60_sv_by_hand(-6000, k, c) / 10)
            counts[b] += 1
    with np.errstate(divide="ignore"):
        want = np.where(counts > 0, 10 * np.log10(sums / np.maximum(counts, 1)), np.nan)
    np.testing.assert_allclose(out["Sv"][0, 0], want[: out["Sv"].shape[2]], atol=1e-9)
    first = ek60.survey_mvbs(cfg, [("f", truth)], range_bin_m=0.5, ping_bin_s=20,
                             chunk_pings=2)
    assert not np.allclose(first["Sv"], out["Sv"], equal_nan=True)  # the rules differ here


def test_ek60_writer_odd_file_and_ctd_update():
    """An odd number of pings, and one sound-speed change from the update ping on."""
    cfg = dict(_ek60_config(), ctd_update_sound_speed_range=[1475.0, 1495.0])
    spec = {"sound_speed": 1480.0, "ctd_update_ping": 3}
    c = synth_ek60.sound_speeds(cfg, spec, 7, np.random.default_rng(5))
    assert (c[:3] == np.float32(1480.0)).all() and len(set(c[3:].tolist())) == 1
    assert 1475.0 <= c[3] <= 1495.0 and c[3] != np.float32(1480.0)


def test_azfp_reference_against_hand_worked_case():
    cfg = {"header": {"dig_rate": 64000, "lockout": 8, "samples_per_bin": 8},
           "channels": [{"channel_id": "AZFP 1 38000", "frequency_khz": 38, "bins": 4,
                         "pulse_us": 1000}],
           "xml": {"ka": 0.001, "kb": 5000.0, "kc": 5.0, "A": 0.00148, "B": 0.000234,
                   "C": 1.1e-7, "DS": [0.0242], "EL": [140.2], "TVR": [167.3],
                   "VTX0": [90.1], "BP": [0.0088]}}
    env = {"salinity": 32.0, "pressure": 60.0}
    r0, dr, alpha, K, scale = azfp.ping_terms(cfg, env, [60000])
    v = 2.5 * 60000 / 65535
    R = (0.001 + 5000 * v) / (5 - v)
    T = 1 / (0.00148 + 0.000234 * math.log(R) + 1.1e-7 * math.log(R) ** 3) - 273
    z = T / 10
    c = 1449.05 + z * (45.7 + z * (-5.21 + 0.23 * z)) + (1.333 + z * (-0.126 + z * 0.009)) * -3 \
        + 0.06 * (16.3 + 0.18 * 0.06)
    assert r0[0, 0] == pytest.approx(c * 8 / 128000 + (c / 4) * (7 / 64000 + 1e-3), rel=1e-14)
    assert dr[0, 0] == pytest.approx(c * 8 / 128000, rel=1e-14)
    K_hand = 140.2 - 2.5 / 0.0242 - (167.3 + 20 * math.log10(90.1)) \
        - 10 * math.log10(0.5 * c * 1e-3 * 0.0088) + 0.7
    assert K[0, 0] == pytest.approx(K_hand, rel=1e-14)
    assert scale[0] == pytest.approx(1 / (26214 * 0.0242), rel=1e-14)
    counts = np.array([[10000, 20000, 30000, 40000]], dtype="i4")
    sv = azfp._sv_rows(counts, scale[0], r0[0], dr[0], alpha[0], K[0], torch.float64, "cpu")
    r = r0[0, 0] + np.arange(4) * dr[0, 0]
    want = counts[0] / (26214 * 0.0242) + K_hand + 20 * np.log10(r) + 2 * alpha[0, 0] * r
    np.testing.assert_allclose(sv[0].numpy(), want, atol=1e-9)


@pytest.mark.parametrize("cell", ["ek60_survey", "azfp_ooi_survey", "ek60_sv_chain"])
def test_reference_agrees_with_the_port_on_the_cpu(tmp_path, cell):
    """A whole run of each cell at a tiny size, the port on its CPU path."""
    res = main(["--workload", cell, "--seed", "2147483659", "--seconds", "0.5"],
               device="cpu", bench_dir=tiny_bench(tmp_path))
    assert res["correct"], res["checks"]
    for name, c in res["checks"].items():
        assert c["value"] <= (1e-4 if name.endswith("_db") else 0), (name, c)
