"""Sonar model registry.

Capability parity: echopype/core.py:44-111 — a static dispatch table mapping
sonar model name to parser/set-groups classes and file-extension validation.
EK60/ES70 and EK80/ES80/EA640 conversion is ported to echopype_torch; AZFP,
AZFP6 and AD2CP keep their extension rules and carry no parser
(``convert.api.open_raw`` raises ``NotImplementedError`` for them; ROADMAP
Queue 1 item 11).
"""

from pathlib import Path

__all__ = ["SONAR_MODELS", "validate_ext"]


def _lazy(modname, clsname):
    def load():
        import importlib

        mod = importlib.import_module(modname, package=__package__)
        return getattr(mod, clsname)

    return load


SONAR_MODELS = {
    "EK60": {
        "ext": ".raw",
        "xml": False,
        "parser": _lazy(".convert.parse_ek60", "ParseEK60"),
        "set_groups": _lazy(".convert.set_groups_ek60", "SetGroupsEK60"),
        "accepts_bot": True,
        "accepts_idx": True,
    },
    "ES70": {
        "ext": ".raw",
        "xml": False,
        "parser": _lazy(".convert.parse_ek60", "ParseEK60"),
        "set_groups": _lazy(".convert.set_groups_ek60", "SetGroupsEK60"),
        "accepts_bot": True,
        "accepts_idx": True,
    },
    "EK80": {
        "ext": ".raw",
        "xml": False,
        "parser": _lazy(".convert.parse_ek80", "ParseEK80"),
        "set_groups": _lazy(".convert.set_groups_ek80", "SetGroupsEK80"),
        "accepts_bot": True,
        "accepts_idx": True,
    },
    "ES80": {
        "ext": ".raw",
        "xml": False,
        "parser": _lazy(".convert.parse_ek80", "ParseEK80"),
        "set_groups": _lazy(".convert.set_groups_ek80", "SetGroupsEK80"),
        "accepts_bot": True,
        "accepts_idx": True,
    },
    "EA640": {
        "ext": ".raw",
        "xml": False,
        "parser": _lazy(".convert.parse_ek80", "ParseEK80"),
        "set_groups": _lazy(".convert.set_groups_ek80", "SetGroupsEK80"),
        "accepts_bot": True,
        "accepts_idx": True,
    },
    "AZFP": {
        "ext": ".01A",
        "xml": True,
        "parser": None,
        "set_groups": None,
        "accepts_bot": False,
        "accepts_idx": False,
    },
    "AZFP6": {
        "ext": ".azfp",
        "xml": False,
        "parser": None,
        "set_groups": None,
        "accepts_bot": False,
        "accepts_idx": False,
    },
    "AD2CP": {
        "ext": ".ad2cp",
        "xml": False,
        "parser": None,
        "set_groups": None,
        "accepts_bot": False,
        "accepts_idx": False,
    },
}


def validate_ext(path: str, sonar_model: str):
    ext = Path(path).suffix
    want = SONAR_MODELS[sonar_model]["ext"]
    if ext.lower() != want.lower():
        raise ValueError(
            f"Expected a {want} file for sonar_model={sonar_model}, got {ext!r}"
        )
