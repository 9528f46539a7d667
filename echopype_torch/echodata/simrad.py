"""EK80 waveform/encode-mode validation and beam-group selection.

Capability parity: echopype/echodata/simrad.py:12-179.
"""

from __future__ import annotations

__all__ = ["check_input_args_combination", "retrieve_correct_beam_group"]

VALID_WAVEFORM = ("CW", "BB", "FM")
VALID_ENCODE = ("complex", "power")


def check_input_args_combination(waveform_mode, encode_mode, pulse_compression=False):
    """Validate (waveform_mode, encode_mode) for EK80-style data."""
    if waveform_mode is None or encode_mode is None:
        raise ValueError(
            "waveform_mode and encode_mode must be specified for EK80-style data"
        )
    if waveform_mode == "FM":
        waveform_mode = "BB"  # FM is an alias of BB
    if waveform_mode not in ("CW", "BB"):
        raise ValueError(f"Invalid waveform_mode {waveform_mode!r}, must be 'CW', 'BB', or 'FM'")
    if encode_mode not in VALID_ENCODE:
        raise ValueError(f"Invalid encode_mode {encode_mode!r}, must be 'complex' or 'power'")
    if waveform_mode == "BB" and encode_mode == "power":
        raise ValueError("encode_mode='power' cannot be used with waveform_mode='BB'")
    if pulse_compression and (waveform_mode != "BB" or encode_mode != "complex"):
        raise ValueError(
            "Pulse compression can only be used with waveform_mode='BB' and encode_mode='complex'"
        )
    return waveform_mode, encode_mode


def retrieve_correct_beam_group(echodata, waveform_mode, encode_mode) -> str:
    """Return the Sonar/Beam_groupX path matching waveform/encode mode.

    Matches the per-beam-group ``waveform_encode_descr`` attribute written at
    conversion time for EK80 (set_groups_ek80.py:281); EK60 data always lives
    in Beam_group1.
    """
    if echodata.sonar_model in ("EK60", "ES70"):
        return "Sonar/Beam_group1"

    target = {
        ("CW", "power"): "power",
        ("CW", "complex"): "complex_CW",
        ("BB", "complex"): "complex_FM",
    }[(waveform_mode, encode_mode)]

    sonar = echodata["Sonar"]
    descr = None
    if "waveform_encode_descr" in sonar:
        descr = sonar["waveform_encode_descr"].values
        names = sonar.coords["beam_group"].values
        for name, d in zip(names, descr):
            if str(d) == target:
                return f"Sonar/{name}"
    # fallback: inspect groups for complex vs power variables
    for path in echodata.group_paths:
        if not path.startswith("Sonar/Beam_group"):
            continue
        grp = echodata[path]
        has_complex = "backscatter_i" in grp
        if encode_mode == "complex" and has_complex:
            return path
        if encode_mode == "power" and not has_complex:
            return path
    raise ValueError(
        f"No beam group matches waveform_mode={waveform_mode}, encode_mode={encode_mode}"
    )
