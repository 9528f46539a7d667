"""echopype_torch: the PyTorch / CUDA port of echopype_tpu.

EK60/ES70 and EK80/ES80/EA640 files convert here.  The survey path: raw
files -> ``open_raw`` -> power-mode calibration -> MVBS, with the fused
window step as hand-written CUDA kernels for Hopper
(``ops/window_partials.py``); EK80 complex / broadband channels calibrate
with the matched filter on the device (``ops/matched_filter.py``) and
stream chunked or fused (``ops/bb_pipeline.py``).  The Sv path:
``calibrate.compute_Sv`` -> ``commongrid.compute_MVBS`` / ``compute_NASC``,
the fused survey-processing step ``parallel.survey_pipeline_step``
(power -> Sv and MVBS in one pass, on the CUDA kernels of
``ops/sv_bin_partials.py``), ``consolidate.add_depth`` / ``add_location`` /
``add_splitbeam_angle``, the Sv-store survey streamers
``run_survey_mvbs`` / ``run_survey_nasc``, and ``clean`` / ``mask`` (noise
masks on the device programs of ``ops/windows.py``, frequency
differencing; the streamers' ``freq_diff=`` / ``noise_masks=``).  The host-only layer (``convert``,
``echodata``, ``xrlite``, ``storage``, ``native``, calibration parameter
resolution, ``utils``) is the port's own copy of the reference package's,
in the same layout; the port imports nothing of ``echopype_tpu``.  Entry
points take ``device=`` ("cuda" by default; "cpu" runs the plain PyTorch
twins of the kernels).
"""

from . import calibrate, clean, commongrid, consolidate, mask  # noqa: F401
from .commongrid import compute_MVBS, compute_MVBS_index_binning, compute_NASC  # noqa: F401
from .convert.api import open_raw  # noqa: F401
from .echodata.api import open_converted  # noqa: F401
from .echodata.echodata import EchoData  # noqa: F401
from .parallel import survey_pipeline_step  # noqa: F401
from .parallel.survey import (  # noqa: F401
    run_survey_mvbs,
    run_survey_mvbs_from_raw,
    run_survey_nasc,
)

__all__ = [
    "EchoData",
    "calibrate",
    "clean",
    "commongrid",
    "consolidate",
    "mask",
    "compute_MVBS",
    "compute_MVBS_index_binning",
    "compute_NASC",
    "open_converted",
    "open_raw",
    "run_survey_mvbs",
    "run_survey_mvbs_from_raw",
    "run_survey_nasc",
    "survey_pipeline_step",
]
