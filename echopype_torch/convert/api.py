"""open_raw: raw instrument file -> standardized EchoData.

Capability parity: echopype/convert/api.py:346-546 — file/sidecar validation,
parser dispatch via the SONAR_MODELS registry, group assembly in convention
order, per-group serialization in to_file.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from ..core import SONAR_MODELS, validate_ext
from ..echodata.echodata import EchoData
from ..utils.log import _init_logger
from ..utils.prov import add_processing_level

logger = _init_logger(__name__)

__all__ = ["open_raw", "to_file"]

# Explicit group save order (convert/api.py:102 in the reference)
GROUP_ORDER = [
    "Top-level",
    "Environment",
    "Platform",
    "Platform/NMEA",
    "Provenance",
    "Sonar",
    "Vendor_specific",
]


def _check_file(
    raw_file, sonar_model, xml_path=None, include_bot=False, include_idx=False,
    storage_options=None,
):
    from ..utils.io import source_exists

    raw_str = str(raw_file)
    if not source_exists(raw_str, storage_options):
        raise FileNotFoundError(raw_str)
    validate_ext(raw_str, sonar_model)
    if SONAR_MODELS[sonar_model]["xml"]:
        if not xml_path:
            raise ValueError(f"sonar_model={sonar_model} requires xml_path")
        if not source_exists(xml_path, storage_options):
            raise FileNotFoundError(str(xml_path))
    stem = raw_str.rsplit(".", 1)[0]
    bot_file = idx_file = ""
    if include_bot:
        cand = stem + ".bot"
        if not source_exists(cand, storage_options):
            raise FileNotFoundError(f"include_bot=True but {cand} does not exist")
        bot_file = cand
    if include_idx:
        cand = stem + ".idx"
        if not source_exists(cand, storage_options):
            raise FileNotFoundError(f"include_idx=True but {cand} does not exist")
        idx_file = cand
    return raw_str, bot_file, idx_file


@add_processing_level("L1A", is_echodata=True)
def open_raw(
    raw_file,
    sonar_model: str,
    xml_path=None,
    include_bot: bool = False,
    include_idx: bool = False,
    convert_params: dict | None = None,
    storage_options: dict | None = None,
    use_swap="auto",
    max_chunk_size: str = "100MB",
    **kwargs,
) -> EchoData:
    """Convert a raw instrument file into a standardized EchoData object."""
    if sonar_model not in SONAR_MODELS:
        raise ValueError(
            f"Unsupported sonar_model {sonar_model!r}; must be one of {sorted(SONAR_MODELS)}"
        )
    raw_file, bot_file, idx_file = _check_file(
        raw_file, sonar_model, xml_path, include_bot, include_idx,
        storage_options=storage_options,
    )

    parser_cls = SONAR_MODELS[sonar_model]["parser"]()
    parser = parser_cls(
        raw_file,
        bot_file=bot_file,
        idx_file=idx_file,
        storage_options=storage_options,
        sonar_model=sonar_model,
        xml_path=xml_path,
    )
    parser.parse_raw()
    parser.rectangularize_data()

    setgrouper_cls = SONAR_MODELS[sonar_model]["set_groups"]()
    sg = setgrouper_cls(parser, input_file=raw_file, sonar_model=sonar_model, params=convert_params)

    # beam groups first: EK80's Sonar group records the resulting group split
    beam_groups = sg.set_beam()
    tree = {
        "Top-level": sg.set_toplevel(),
        "Environment": sg.set_env(),
        "Platform": sg.set_platform(),
        "Platform/NMEA": sg.set_nmea(),
        "Provenance": sg.set_provenance(),
        "Sonar": sg.set_sonar(),
        "Vendor_specific": sg.set_vendor(),
    }
    for i, bg in enumerate(beam_groups, start=1):
        tree[f"Sonar/Beam_group{i}"] = bg

    ed = EchoData(tree=tree, source_file=raw_file, sonar_model=sonar_model)
    if _should_swap(use_swap, ed):
        _spill_to_swap(ed)
    return ed


def _should_swap(use_swap, ed) -> bool:
    """Resolve the ``use_swap`` tri-state (convert/api.py:354, parse_base.py:129).

    ``auto`` spills when the in-memory tree exceeds 40% of available RAM,
    mirroring the reference's psutil threshold.
    """
    if use_swap is True:
        return True
    if use_swap in (False, None):
        return False
    if use_swap != "auto":
        raise ValueError(f"use_swap must be True, False or 'auto'; got {use_swap!r}")
    try:
        import psutil

        avail = psutil.virtual_memory().available
    except Exception:  # noqa: BLE001 - psutil optional
        import os

        avail = os.sysconf("SC_AVPHYS_PAGES") * os.sysconf("SC_PAGE_SIZE")
    return ed.nbytes > 0.4 * avail


def _spill_to_swap(ed, min_bytes: int = 16_384):
    """Back large sample arrays with disk memmaps to bound host RAM.

    TPU-native out-of-core tier (parse_base.py:202 equivalent): instead of
    temp-zarr + dask handles, large variables become ``np.memmap`` views so
    downstream group access streams from disk; EchoData owns the files and
    deletes them via cleanup_swap_files()/__del__.
    """
    import tempfile

    swap_dir = Path(tempfile.mkdtemp(prefix="echopype_tpu_swap_"))
    files = []
    for path, ds in ed._tree.items():
        for name, da in ds.data_vars.items():
            v = da.values
            if v.nbytes < min_bytes or v.dtype.kind in ("O", "U"):
                continue
            f = swap_dir / f"{path.replace('/', '_')}__{name}.npy"
            mm = np.lib.format.open_memmap(f, mode="w+", dtype=v.dtype, shape=v.shape)
            mm[...] = v
            mm.flush()
            da.values = mm
            files.append(f)
    ed.swap_files = files
    ed.swap_dir = swap_dir


def to_file(
    echodata: EchoData, engine: str, save_path=None, compress=True,
    overwrite=False, parallel: bool = False, **kw,
):
    """Serialize an EchoData object as zarr or netCDF4 (reference convert/api.py:26)."""
    if parallel:
        # same gate as the reference (convert/api.py:60-61)
        raise NotImplementedError("parallel save is not yet implemented")
    if engine not in ("zarr", "netcdf4"):
        raise ValueError(f"Unsupported engine {engine!r}; use 'zarr' or 'netcdf4'")
    from ..utils.io import validate_output_path

    out = validate_output_path(echodata.source_file or "converted", engine, save_path=save_path)
    if engine == "netcdf4":
        return echodata.to_netcdf(out, overwrite=overwrite, compress=compress)
    return echodata.to_zarr(out, overwrite=overwrite, compress=compress)
