"""Frequency-differencing equation parsing.

Capability parity: echopype/mask/freq_diff.py:7-148 — parse
'"chanA" - "chanB" > 5dB' / '38kHz - 18kHz >= 10dB' criteria.
"""

from __future__ import annotations

import re

__all__ = ["_parse_freq_diff_eq"]

_OPERATORS = (">", "<", "<=", ">=", "==")


def _parse_freq_diff_eq(freqABEq=None, chanABEq=None):
    """Returns [freqAB, chanAB, operator, diff]."""
    if freqABEq is None and chanABEq is None:
        raise ValueError("Either freqAB or chanAB must be given!")
    if freqABEq is not None and chanABEq is not None:
        raise ValueError("Only one of freqAB or chanAB should be given, but not both!")

    if freqABEq is not None:
        pattern = re.compile(
            r"(?P<freqA>\d*\.?\d+)\s*(?P<unitA>\w?)Hz"
            r"\s*-\s*"
            r"(?P<freqB>\d*\.?\d+)\s*(?P<unitB>\w?)Hz"
            r"\s*(?P<cmp>\S*?)\s*"
            r"(?P<db>\d*\.?\d+)\s*dB"
        )
        m = pattern.match(freqABEq)
        if m is None:
            raise TypeError("Invalid freqAB Equation!")
        operator = m["cmp"]
        if operator not in _OPERATORS:
            raise ValueError("Invalid operator!")
        mult = {"": 1, "k": 1e3, "M": 1e6, "G": 1e9}
        freqA = float(m["freqA"]) * mult[m["unitA"]]
        freqB = float(m["freqB"]) * mult[m["unitB"]]
        if len({freqA, freqB}) != 2:
            raise ValueError("freqAB must be a list of length 2 with unique elements!")
        return [[freqA, freqB], None, operator, float(m["db"])]

    pattern = re.compile(
        r'(?P<chanA>".+")\s*'
        r"\s*-\s*"
        r'(?P<chanB>".+")\s*'
        r"\s*(?P<cmp>\S*?)\s*"
        r"(?P<db>\d*\.?\d+)\s*dB"
    )
    m = pattern.match(chanABEq)
    if m is None:
        raise TypeError("Invalid chanAB Equation!")
    operator = m["cmp"]
    if operator not in _OPERATORS:
        raise ValueError("Invalid operator!")
    chanA = m["chanA"].strip('"')
    chanB = m["chanB"].strip('"')
    if len({chanA, chanB}) != 2:
        raise ValueError("chanAB must be a list of length 2 with unique elements!")
    return [None, [chanA, chanB], operator, float(m["db"])]
