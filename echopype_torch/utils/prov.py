"""Provenance attributes and the L0-L4 processing-level system.

Capability parity: echopype/utils/prov.py:24-308 — every pipeline output is
stamped with software name/version/time and a processing level; wildcard
levels (L2*, L3*) resolve to A/B sublevels depending on location validity.
"""

import functools
from datetime import datetime, timezone

from ..xrlite import DataArray, Dataset

ECHOPYPE_TPU_VERSION = "0.1.0"

PROCESSING_LEVELS = {
    "L0": "Level 0",
    "L1A": "Level 1A",
    "L1B": "Level 1B",
    "L2A": "Level 2A",
    "L2B": "Level 2B",
    "L3A": "Level 3A",
    "L3B": "Level 3B",
    "L4": "Level 4",
}


def _utcnow_str():
    return datetime.now(timezone.utc).strftime("%Y-%m-%dT%H:%M:%SZ")


def echopype_prov_attrs(process_type: str) -> dict:
    """Provenance attrs for a given process type (conversion/calibration/...)."""
    return {
        f"{process_type}_software_name": "echopype_tpu",
        f"{process_type}_software_version": ECHOPYPE_TPU_VERSION,
        f"{process_type}_time": _utcnow_str(),
    }


def source_files_vars(source_paths) -> dict:
    """Provenance variables describing the source files."""
    import numpy as np

    paths = [source_paths] if isinstance(source_paths, str) else list(source_paths)
    files = np.array([str(p) for p in paths])
    return {
        "source_filenames": DataArray(
            files,
            ("filenames",),
            coords={"filenames": np.arange(len(files))},
            attrs={"long_name": "Source filenames"},
        )
    }


def _valid_latlon(ds) -> bool:
    import numpy as np

    for lat_name, lon_name in (("latitude", "longitude"), ("lat", "lon")):
        if lat_name in ds and lon_name in ds:
            lat = np.asarray(ds[lat_name].values, dtype="f8")
            lon = np.asarray(ds[lon_name].values, dtype="f8")
            if lat.size and not (np.all(np.isnan(lat)) or np.all(np.isnan(lon))):
                if not (np.all(lat == 0) and np.all(lon == 0)):
                    return True
    return False


def add_processing_level(processing_level_code: str, is_echodata: bool = False):
    """Decorator stamping the processing level on the returned Dataset/EchoData.

    Wildcard codes (``L2*``, ``L3*``) resolve to the A sublevel when valid
    lat/lon exists on the output, else B (reference: utils/prov.py:181-308).
    """

    def _stamp(target, code):
        target.attrs["processing_level"] = PROCESSING_LEVELS[code]
        target.attrs["processing_level_url"] = (
            "https://echopype.readthedocs.io/en/stable/processing-levels.html"
        )

    def wrapper(func):
        @functools.wraps(func)
        def inner(*args, **kwargs):
            out = func(*args, **kwargs)
            code = processing_level_code
            if isinstance(out, Dataset):
                ds = out
                # every stamp is gated on valid location data (prov.py:260-296)
                if not _valid_latlon(ds):
                    ds.attrs.pop("input_processing_level", None)
                    return out
                if code in PROCESSING_LEVELS:
                    _stamp(ds, code)
                elif "*" in code:
                    lvl_in = ds.attrs.pop("input_processing_level", None)
                    if lvl_in is None:
                        raise RuntimeError(
                            f"Processing level {code!r} cannot be resolved: the "
                            f"producing function must call insert_input_processing_level"
                        )
                    if code.endswith("*"):
                        # L3* -> level from code, sublevel propagated from input
                        resolved = f"L{code[1]}{lvl_in[-1]}"
                    else:
                        # L*B -> sublevel from code, level propagated from input
                        resolved = f"L{lvl_in[-2]}{code[-1]}"
                    if resolved in PROCESSING_LEVELS:
                        _stamp(ds, resolved)
            elif hasattr(out, "__getitem__") and hasattr(out, "group_paths"):
                # EchoData: location lives in Platform, attrs on Top-level
                try:
                    platform = out["Platform"]
                    top = out["Top-level"]
                except Exception:
                    return out
                if _valid_latlon(platform) and code in PROCESSING_LEVELS:
                    _stamp(top, code)
            return out

        return inner

    return wrapper


def insert_input_processing_level(ds: Dataset, input_ds) -> Dataset:
    """Copy the input's processing level onto the output as input_processing_level."""
    lvl = getattr(input_ds, "attrs", {}).get("processing_level")
    if lvl:
        ds.attrs["input_processing_level"] = lvl
    return ds
