"""Seawater acoustic property formulas.

Implements the published equations the reference uses (see
echopype/utils/uwa.py:8-189 for the capability contract):

- sound speed: Mackenzie (1981) nine-term equation; AZFP vendor formula
- absorption: Ainslie & McColm (1998) "AM"; Francois & Garrison (1982) "FG";
  AZFP vendor formula

All functions are plain arithmetic over numpy/xrlite/jax arrays, so they jit
cleanly when called on device values.
"""

import numpy as np

__all__ = ["calc_sound_speed", "calc_absorption"]


def calc_sound_speed(temperature=27, salinity=35, pressure=10, formula_source="Mackenzie"):
    """Sound speed in seawater [m/s].

    temperature [deg C], salinity [PSU], pressure [dbar].
    """
    t, s, p = temperature, salinity, pressure
    if formula_source == "Mackenzie":
        # Mackenzie KV (1981), JASA 70(3):807-812.
        ss = 1448.96 + 4.591 * t - 5.304e-2 * t**2 + 2.374e-4 * t**3
        ss = ss + 1.340 * (s - 35) + 1.630e-2 * p + 1.675e-7 * p**2
        ss = ss - 1.025e-2 * t * (s - 35) - 7.139e-13 * t * p**3
        return ss
    if formula_source == "AZFP":
        # ASL AZFP operator manual formula.
        z = t / 10
        return (
            1449.05
            + z * (45.7 + z * (-5.21 + 0.23 * z))
            + (1.333 + z * (-0.126 + z * 0.009)) * (s - 35.0)
            + (p / 1000) * (16.3 + 0.18 * (p / 1000))
        )
    raise ValueError(f"Unknown formula source {formula_source!r}")


def calc_absorption(
    frequency,
    temperature=27,
    salinity=35,
    pressure=10,
    pH=8.1,
    sound_speed=None,
    formula_source="AM",
):
    """Seawater absorption [dB/m] at ``frequency`` [Hz]."""
    t, s, p = temperature, salinity, pressure
    if formula_source == "AM":
        # Ainslie MA, McColm JG (1998), JASA 103(3):1671-1672.
        freq = frequency / 1000  # kHz
        depth_km = p / 1000
        f1 = 0.78 * np.sqrt(s / 35) * np.exp(t / 26)
        f2 = 42 * np.exp(t / 17)
        a1 = 0.106 * (f1 * freq**2) / (f1**2 + freq**2) * np.exp((pH - 8) / 0.56)
        a2 = (
            0.52
            * (1 + t / 43)
            * (s / 35)
            * (f2 * freq**2)
            / (f2**2 + freq**2)
            * np.exp(-depth_km / 6)
        )
        a3 = 0.00049 * freq**2 * np.exp(-(t / 27 + depth_km))
        return (a1 + a2 + a3) / 1000  # dB/km -> dB/m

    if formula_source == "FG":
        # Francois RE, Garrison GR (1982), JASA 72(6):1879-1890.
        f = frequency / 1000.0  # kHz
        c = (1412.0 + 3.21 * t + 1.19 * s + 0.0167 * p) if sound_speed is None else sound_speed
        A1 = 8.86 / c * 10 ** (0.78 * pH - 5)
        P1 = 1.0
        f1 = 2.8 * np.sqrt(s / 35) * 10 ** (4 - 1245 / (t + 273))
        A2 = 21.44 * s / c * (1 + 0.025 * t)
        P2 = 1.0 - 1.37e-4 * p + 6.2e-9 * p**2
        f2 = 8.17 * 10 ** (8 - 1990 / (t + 273)) / (1 + 0.0018 * (s - 35))
        P3 = 1.0 - 3.83e-5 * p + 4.9e-10 * p**2
        # A3 branches on the 20degC boundary per the published equation set
        if np.all(np.asarray(t) < 20):
            A3 = 4.937e-4 - 2.59e-5 * t + 9.11e-7 * t**2 - 1.5e-8 * t**3
        else:
            A3 = 3.964e-4 - 1.146e-5 * t + 1.45e-7 * t**2 - 6.5e-10 * t**3
        a = (
            A1 * P1 * f1 * f**2 / (f**2 + f1**2)
            + A2 * P2 * f2 * f**2 / (f**2 + f2**2)
            + A3 * P3 * f**2
        )
        return a / 1000  # dB/km -> dB/m

    if formula_source == "AZFP":
        temp_k = t + 273.0
        f1 = 1320.0 * temp_k * np.exp(-1700 / temp_k)
        f2 = 1.55e7 * temp_k * np.exp(-3052 / temp_k)
        k = 1 + p / 10.0
        a = 8.95e-8 * (1 + t * (2.29e-2 - 5.08e-4 * t))
        b = (s / 35.0) * 4.88e-7 * (1 + 0.0134 * t) * (1 - 0.00103 * k + 3.7e-7 * k**2)
        c = (
            4.86e-13
            * (1 + t * (-0.042 + t * (8.53e-4 - t * 6.23e-6)))
            * (1 + k * (-3.84e-4 + k * 7.57e-8))
        )
        if np.all(np.asarray(s) == 0):
            return c * frequency**2
        return (
            (a * f1 * frequency**2) / (f1**2 + frequency**2)
            + (b * f2 * frequency**2) / (f2**2 + frequency**2)
            + c * frequency**2
        )
    raise ValueError(f"Unknown formula source {formula_source!r}")
