"""Seconds from the process's start to the window's: imports, CUDA set-up, kernel build or load, file writing, the warm-up call."""


def read(rec):
    return rec["setup_s"]
