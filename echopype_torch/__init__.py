"""echopype_torch: the PyTorch / CUDA port of echopype_tpu.

The survey path runs here: EK60 ``.raw`` -> ``open_raw`` -> power-mode
calibration -> MVBS, with the fused window step as hand-written CUDA kernels
for Hopper (``ops/window_partials.py``).  Host-only pieces (conversion,
EchoData, parameter resolution) are reused from ``echopype_tpu`` without
importing JAX (``_host.py``).  Entry points take ``device=`` ("cuda" by
default; "cpu" runs the plain PyTorch twins of the kernels).
"""

from . import calibrate  # noqa: F401
from ._host import open_raw  # noqa: F401
from .parallel.survey import run_survey_mvbs_from_raw  # noqa: F401

__all__ = ["calibrate", "open_raw", "run_survey_mvbs_from_raw"]
