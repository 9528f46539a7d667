"""The host-only modules of ``echopype_tpu`` that the port reuses.

Conversion (``convert``), ``xrlite``, the native ingest, calibration
parameter resolution, geodesy and the logging/io/provenance helpers are
numpy code with no device part, so the port imports them from the JAX
package instead of copying them.  Every such import goes through this
module.

``echopype_tpu/__init__.py`` imports its JAX device modules, so a plain
``import echopype_tpu`` fails where JAX is not installed (the GPU machine
has torch but no jax and no pandas).  There the package is registered in
``sys.modules`` as a *bare* package: a module whose ``__path__`` is the
package directory and whose ``__init__`` never runs.  Its submodules then
import on demand, and only host-only ones are asked for.

Where JAX is installed the package is imported normally.  Both branches are
needed: a bare package left in a process that also runs the JAX package
(the parity tests, one pytest worker importing many test files) would hide
``echopype_tpu.open_raw`` and the other names its ``__init__`` exports.
"""

from __future__ import annotations

import importlib
import importlib.util
import sys

_PKG = "echopype_tpu"


def _jax_importable() -> bool:
    try:
        return importlib.util.find_spec("jax") is not None
    except ImportError:  # an import hook refuses jax outright
        return False


def _register_package():
    if _PKG in sys.modules:
        return sys.modules[_PKG]
    if _jax_importable():
        return importlib.import_module(_PKG)
    spec = importlib.util.find_spec(_PKG)
    if spec is None or not spec.submodule_search_locations:
        raise ImportError(f"{_PKG} (the reference package) is not importable")
    pkg = importlib.util.module_from_spec(spec)  # __path__ set, __init__ not run
    sys.modules[_PKG] = pkg
    return pkg


_register_package()

from echopype_tpu import native  # noqa: E402
from echopype_tpu.calibrate.cal_params import get_cal_params_EK  # noqa: E402
from echopype_tpu.calibrate.env_params import get_env_params_EK  # noqa: E402
from echopype_tpu.calibrate.range import tvg_shift_meters  # noqa: E402
from echopype_tpu.convert.api import open_raw  # noqa: E402
from echopype_tpu.convert.simrad.decode import INDEX2POWER  # noqa: E402
from echopype_tpu.convert.simrad.framing import (  # noqa: E402
    CorruptDatagramError,
    scan_ek_extent,
)
from echopype_tpu.utils.geodesy import pairwise_distance_nmi  # noqa: E402
from echopype_tpu.utils.io import is_remote_path  # noqa: E402
from echopype_tpu.utils.log import _init_logger  # noqa: E402
from echopype_tpu.utils.prov import (  # noqa: E402
    add_processing_level,
    echopype_prov_attrs,
    insert_input_processing_level,
    source_files_vars,
)
from echopype_tpu.xrlite import DataArray, Dataset  # noqa: E402


__all__ = [
    "CorruptDatagramError",
    "DataArray",
    "Dataset",
    "INDEX2POWER",
    "_init_logger",
    "add_processing_level",
    "echopype_prov_attrs",
    "get_cal_params_EK",
    "get_env_params_EK",
    "insert_input_processing_level",
    "is_remote_path",
    "native",
    "open_raw",
    "pairwise_distance_nmi",
    "scan_ek_extent",
    "source_files_vars",
    "tvg_shift_meters",
]
