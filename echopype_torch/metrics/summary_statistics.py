"""Echo-metrics (Urmy et al. 2012, ICES JMS 69(2):184-196).

Capability parity: echopype/metrics/summary_statistics.py:51-151 — linear-
domain integrals of sv over range: abundance (Sa), center of mass,
dispersion (inertia), evenness (equivalent area), index of aggregation.
"""

from __future__ import annotations

import numpy as np

from ..xrlite import DataArray

__all__ = ["delta_z", "abundance", "center_of_mass", "dispersion", "evenness", "aggregation"]


def delta_z(ds, range_label="echo_range") -> DataArray:
    """First difference of the range variable; zeros -> NaN."""
    if range_label not in ds:
        raise ValueError(f"{range_label} not in the input Dataset!")
    dz = ds[range_label].diff("range_sample")
    return dz.where(dz != 0, other=np.nan)


def _sv_lin(ds, Sv_label="Sv"):
    return 10 ** (ds[Sv_label] / 10)


def _aligned(ds, range_label):
    """(sv, dz, range) on the diff's upper-label samples 1..R-1.

    Mirrors xarray's label alignment: diff() carries labels 1..R-1, so the
    products sv*dz pair sample k's Sv with (range_k - range_{k-1}).
    """
    dz = delta_z(ds, range_label)
    sv = _sv_lin(ds).isel(range_sample=slice(1, None))
    rng = ds[range_label].isel(range_sample=slice(1, None))
    return sv, dz, rng


def abundance(ds, range_label="echo_range") -> DataArray:
    """Sa = 10 log10( integral of sv dz )."""
    sv, dz, _ = _aligned(ds, range_label)
    out = 10 * np.log10((sv * dz).sum("range_sample"))
    out.name = "abundance"
    return out


def center_of_mass(ds, range_label="echo_range") -> DataArray:
    """Backscatter-weighted mean range."""
    sv, dz, rng = _aligned(ds, range_label)
    out = (rng * sv * dz).sum("range_sample") / (sv * dz).sum("range_sample")
    out.name = "center_of_mass"
    return out


def dispersion(ds, range_label="echo_range") -> DataArray:
    """Inertia: backscatter-weighted variance about the center of mass."""
    sv, dz, rng = _aligned(ds, range_label)
    cm = center_of_mass(ds, range_label)
    out = ((rng - cm) ** 2 * sv * dz).sum("range_sample") / (sv * dz).sum("range_sample")
    out.name = "dispersion"
    return out


def evenness(ds, range_label="echo_range") -> DataArray:
    """Equivalent area EA = (integral sv dz)^2 / integral sv^2 dz."""
    sv, dz, _ = _aligned(ds, range_label)
    out = ((sv * dz).sum("range_sample")) ** 2 / (sv**2 * dz).sum("range_sample")
    out.name = "evenness"
    return out


def aggregation(ds, range_label="echo_range") -> DataArray:
    """Index of aggregation IA = 1 / EA."""
    out = 1 / evenness(ds, range_label)
    out.name = "aggregation"
    return out


def convert_to_linear(ds, Sv_label="Sv") -> DataArray:
    """Sv (dB) -> linear sv (reference: summary_statistics.py convert_to_linear)."""
    return 10 ** (ds[Sv_label] / 10)
