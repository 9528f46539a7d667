"""Pings of every run_survey_mvbs_from_raw call in the window over the window's wall time (host clock), from its start to the end of its last call."""


def read(rec):
    if not rec["pings"]:
        return None
    return rec["pings"] / rec["window_s"]
