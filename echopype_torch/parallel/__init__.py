from .pipeline import sharded_sv_mvbs_step, survey_pipeline_step
from .survey import run_survey_mvbs, run_survey_mvbs_from_raw, run_survey_nasc

__all__ = [
    "run_survey_mvbs",
    "run_survey_mvbs_from_raw",
    "run_survey_nasc",
    "sharded_sv_mvbs_step",
    "survey_pipeline_step",
]
