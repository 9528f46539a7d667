from .mesh import Mesh, make_mesh
from .pipeline import (
    sharded_binned_partials,
    sharded_mvbs_partials_closed,
    sharded_mvbs_step_closed,
    sharded_sv_mvbs_step,
    survey_pipeline_step,
    sv_mvbs_core,
    sv_mvbs_core_mxu,
    sv_mvbs_core_mxu_closed,
    sv_mvbs_window_partials,
    sv_mvbs_window_partials_uniform,
)
from .survey import run_survey_mvbs, run_survey_mvbs_from_raw, run_survey_nasc

__all__ = [
    "Mesh",
    "make_mesh",
    "run_survey_mvbs",
    "run_survey_mvbs_from_raw",
    "run_survey_nasc",
    "sharded_binned_partials",
    "sharded_mvbs_partials_closed",
    "sharded_mvbs_step_closed",
    "sharded_sv_mvbs_step",
    "survey_pipeline_step",
    "sv_mvbs_core",
    "sv_mvbs_core_mxu",
    "sv_mvbs_core_mxu_closed",
    "sv_mvbs_window_partials",
    "sv_mvbs_window_partials_uniform",
]
