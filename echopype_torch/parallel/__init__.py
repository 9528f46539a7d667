from .survey import run_survey_mvbs_from_raw

__all__ = ["run_survey_mvbs_from_raw"]
