"""Location variable selection & validity checks.

Capability parity: echopype/consolidate/loc_utils.py:26-147.
"""

from __future__ import annotations

import numpy as np

from ..utils.log import _init_logger
from ..xrlite import DataArray

logger = _init_logger(__name__)

__all__ = ["sel_nmea", "check_loc_vars_validity"]


def sel_nmea(echodata, loc_name, nmea_sentence=None, datagram_type=None) -> DataArray:
    """Select a location variable, optionally filtered by NMEA sentence type."""
    if nmea_sentence and datagram_type is not None:
        raise ValueError(
            "If datagram_type is not `None`, then `nmea_sentence` cannot be specified."
        )
    plat = echodata["Platform"]
    da = plat[loc_name]
    if nmea_sentence and datagram_type is None:
        sel = np.asarray(plat["sentence_type"].values) == nmea_sentence
        time_dim = da.dims[0]
        return da.isel({time_dim: np.nonzero(sel)[0]})
    return da


def check_loc_vars_validity(echodata, lat_name, lon_name, datagram_type, check: str):
    """Missing / all-NaN raise; some-NaN / some-zero warn (loc_utils.py:26)."""
    plat = echodata["Platform"]
    if check == "missing":
        if lat_name not in plat or lon_name not in plat:
            raise ValueError(
                f"Coordinate variables {lat_name}/{lon_name} not present in the "
                f"Platform group (datagram_type={datagram_type})."
            )
        return
    lat = np.asarray(plat[lat_name].values, dtype="f8")
    lon = np.asarray(plat[lon_name].values, dtype="f8")
    if check == "all_nan":
        if lat.size == 0 or np.all(np.isnan(lat)) or np.all(np.isnan(lon)):
            raise ValueError(
                f"Coordinate variables {lat_name}/{lon_name} are all NaN; "
                "location cannot be added."
            )
    elif check == "some_nan":
        if np.any(np.isnan(lat)) or np.any(np.isnan(lon)):
            logger.warning("Some lat/lon values are NaN; interpolation will skip them.")
    elif check == "some_zero":
        if np.any(lat == 0) or np.any(lon == 0):
            logger.warning("Some lat/lon values are exactly 0; check your position data.")


def compute_invalid_check(lat_var, lon_var, validity_check: str):
    """Four-way lat/lon invalidity probe (reference: loc_utils.py:15-27)."""
    if validity_check == "missing":
        return (lat_var is None) or (lon_var is None)
    elif lat_var is not None and lon_var is not None and validity_check == "all_nan":
        return bool(np.isnan(np.asarray(lat_var.values, dtype="f8")).all()
                    or np.isnan(np.asarray(lon_var.values, dtype="f8")).all())
    elif lat_var is not None and lon_var is not None and validity_check == "some_nan":
        return bool(np.isnan(np.asarray(lat_var.values, dtype="f8")).any()
                    or np.isnan(np.asarray(lon_var.values, dtype="f8")).any())
    elif lat_var is not None and lon_var is not None and validity_check == "some_zero":
        return bool((np.asarray(lat_var.values) == 0).any()
                    or (np.asarray(lon_var.values) == 0).any())
    else:
        return True


def check_loc_time_dim_duplicates(da, time_dim_name: str) -> None:
    """Raise when a location variable's time dim holds duplicate stamps
    (reference: loc_utils.py:110-117)."""
    vals = np.asarray(da[time_dim_name].values)
    if len(np.unique(vals)) != len(vals):
        raise ValueError(
            f'Data contains duplicate time values in time_dim_name "{time_dim_name}". '
            "Downstream interpolation on the position variables requires unique time values."
        )
