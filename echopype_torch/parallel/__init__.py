from .pipeline import sharded_sv_mvbs_step, survey_pipeline_step
from .survey import run_survey_mvbs_from_raw

__all__ = ["run_survey_mvbs_from_raw", "sharded_sv_mvbs_step", "survey_pipeline_step"]
