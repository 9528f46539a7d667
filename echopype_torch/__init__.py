"""echopype_torch: the PyTorch / CUDA port of echopype_tpu.

EK60/ES70, EK80/ES80/EA640, AZFP/AZFP6 and AD2CP files convert here;
``calibrate.compute_Sv`` / ``compute_TS`` take EK60, EK80 and AZFP data,
and an Echoview ECS file (``ecs_file=``, EK60/EK80).  The survey path: raw
files -> ``open_raw`` -> power-mode calibration -> MVBS, with the fused
window step as hand-written CUDA kernels for Hopper
(``ops/window_partials.py``: int16 EK power, float32 dB AZFP power with
its echo_range intercept); EK80 complex / broadband channels calibrate
with the matched filter on the device (``ops/matched_filter.py``) and
stream chunked or fused (``ops/bb_pipeline.py``).  The Sv path:
``calibrate.compute_Sv`` -> ``commongrid.compute_MVBS`` / ``compute_NASC``,
the fused survey-processing step ``parallel.survey_pipeline_step``
(power -> Sv and MVBS in one pass, on the CUDA kernels of
``ops/sv_bin_partials.py``), ``consolidate.add_depth`` / ``add_location`` /
``add_splitbeam_angle``, the Sv-store survey streamers
``run_survey_mvbs`` / ``run_survey_nasc``, and ``clean`` / ``mask`` (noise
masks on the device programs of ``ops/windows.py``, frequency
differencing; the streamers' ``freq_diff=`` / ``noise_masks=``).  A
multi-file cruise: ``open_raw`` per file (or the raw survey's
``workers=`` process pool, which decodes one file a process) ->
``combine_echodata`` -> ``qc.orchestrate_reverse_time_check`` (repairs
reversed ping times, in memory or in a zarr store) -> ``compute_Sv`` ->
the grids -> ``metrics`` (abundance, center of mass, dispersion,
evenness, aggregation); ``utils.profiling.trace`` records a
``torch.profiler`` window.  Multi-device surveys: ``parallel.make_mesh``
builds a (ping, channel[, range]) grid of devices that one process drives,
and the streamers' ``mesh=`` and the ``parallel.sharded_*`` steps run each
block on its device.  The host-only layer (``convert``,
``echodata``, ``xrlite`` with its datatree stores and xarray facade,
``storage``, ``native``, calibration parameter resolution, ``qc``,
``metrics``, ``colormap``, ``utils``) is the port's own copy of the
reference package's, in the same layout; the port imports nothing of
``echopype_tpu``.  Entry points take ``device=`` ("cuda" by default;
"cpu" runs the plain PyTorch twins of the kernels).
"""

from .commongrid import compute_MVBS, compute_MVBS_index_binning, compute_NASC  # noqa: F401
from .convert.api import open_raw  # noqa: F401
from .echodata.api import open_converted  # noqa: F401
from .echodata.combine import combine_echodata  # noqa: F401
from .echodata.echodata import EchoData  # noqa: F401
from .parallel import survey_pipeline_step  # noqa: F401
from .parallel.survey import (  # noqa: F401
    run_survey_mvbs,
    run_survey_mvbs_from_raw,
    run_survey_nasc,
)
from .utils.log import verbose  # noqa: F401
from .utils.prov import ECHOPYPE_TPU_VERSION as __version__  # noqa: F401

from . import (  # noqa: F401, E402
    calibrate,
    clean,
    colormap,
    commongrid,
    consolidate,
    mask,
    metrics,
    qc,
    utils,
    xrlite,
)

__all__ = [
    "EchoData",
    "calibrate",
    "clean",
    "colormap",
    "combine_echodata",
    "commongrid",
    "consolidate",
    "mask",
    "metrics",
    "qc",
    "utils",
    "verbose",
    "xrlite",
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
