"""Logging: per-module loggers, stdout/stderr split, silent by default.

Capability parity: echopype/utils/log.py:18-97 — ``verbose()`` switches
console logging on; below-WARNING goes to stdout, WARNING+ to stderr.
"""

import logging
import sys

_LOGGERS = []
_VERBOSE = False
_LOGFILE_HANDLER = None


class _MaxLevelFilter(logging.Filter):
    def __init__(self, max_level):
        super().__init__()
        self.max_level = max_level

    def filter(self, record):
        return record.levelno < self.max_level


def _make_handlers():
    out = logging.StreamHandler(sys.stdout)
    out.setLevel(logging.DEBUG)
    out.addFilter(_MaxLevelFilter(logging.WARNING))
    err = logging.StreamHandler(sys.stderr)
    err.setLevel(logging.WARNING)
    fmt = logging.Formatter("%(asctime)s %(name)s %(levelname)s %(message)s")
    out.setFormatter(fmt)
    err.setFormatter(fmt)
    return [out, err]


def _init_logger(name: str) -> logging.Logger:
    logger = logging.getLogger(name)
    logger.setLevel(logging.DEBUG)
    logger.propagate = False
    _LOGGERS.append(logger)
    if _VERBOSE and not logger.handlers:
        for h in _make_handlers():
            logger.addHandler(h)
    return logger


def verbose(logfile=None, override=False):
    """Turn console logging on (or off with ``override=True``)."""
    global _VERBOSE, _LOGFILE_HANDLER
    _VERBOSE = not override
    for logger in _LOGGERS:
        for h in list(logger.handlers):
            logger.removeHandler(h)
        if _VERBOSE:
            for h in _make_handlers():
                logger.addHandler(h)
            if logfile:
                if _LOGFILE_HANDLER is None:
                    _LOGFILE_HANDLER = logging.FileHandler(logfile)
                    _LOGFILE_HANDLER.setFormatter(
                        logging.Formatter("%(asctime)s %(name)s %(levelname)s %(message)s")
                    )
                logger.addHandler(_LOGFILE_HANDLER)
