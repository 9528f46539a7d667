"""AZFP ULS6 group assembly (subclasses the AZFP builder).

Capability parity: echopype/convert/set_groups_azfp6.py:16.
"""

from __future__ import annotations

from .set_groups_azfp import SetGroupsAZFP


class SetGroupsAZFP6(SetGroupsAZFP):
    def set_sonar(self):
        ds = super().set_sonar()
        ds.attrs["sonar_software_name"] = "AZFP6"
        ds.attrs["sonar_software_version"] = "based on AZFP ULS6"
        return ds
