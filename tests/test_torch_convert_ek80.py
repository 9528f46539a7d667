"""Port parity: EK80 / ES80 / EA640 conversion.

``echopype_torch.open_raw`` runs the port's copy of the EK80 chain
(``convert/parse_ek80.py``, ``convert/set_groups_ek80.py``,
``convert/simrad/xml_config.py``); on the synthetic EK80 files of
``tests/synth_ek80.py`` it must give what ``echopype_tpu.open_raw`` gives:
the same groups, and in every group the same variables and coords, equal
bit for bit (NaN where NaN), with the same dims, dtypes and attrs; only the
clock stamps of the conversion may differ (``assert_same_tree``).
"""

import numpy as np
import pytest

import echopype_torch as et
import echopype_tpu as ep
from echopype_torch.xrlite import Dataset as TDataset

from synth_ek80 import CH_BB, CH_PW, write_ek80_multisector, write_ek80_raw
from test_ek80_epochs import write_two_epoch_ek80
from test_survey_epochs import write_two_epoch_bb
from test_torch_convert import assert_same_tree

VARIANTS = {
    "default": dict(),
    "extra_fm_channel": dict(extra_fm_channel=True, skip_pings={CH_BB: {2, 3}}),
    "complex_f16": dict(complex_f16=True),
    "with_raw4": dict(with_raw4=True),
    "skip_pings": dict(skip_pings={CH_BB: {1, 4}, CH_PW: {2}}),
    "duplicate_pings": dict(duplicate_pings={CH_BB: {2}, CH_PW: {3}}),
    "with_mru_both": dict(with_mru="both"),
    "jitter_config": dict(jitter_config=True),
    "nmea_types": dict(nmea_types=["GGA", "GLL", "RMC"]),
    "bb_only": dict(with_power_channel=False, with_cw_complex=False),
}


@pytest.fixture(scope="module")
def ek80_files(tmp_path_factory):
    d = tmp_path_factory.mktemp("convert_ek80")
    out = {}
    for i, (name, kw) in enumerate(VARIANTS.items()):
        path = d / f"{name}-D20210201-T000000.raw"
        write_ek80_raw(path, n_pings=7, n_samples=48, seed=40 + i, **kw)
        out[name] = str(path)
    out["two_epoch_cw"] = str(d / "EPCW-D20210201-T000000.raw")
    write_two_epoch_ek80(out["two_epoch_cw"])
    out["two_epoch_bb"] = str(d / "EPBB-D20210301-T000000.raw")
    write_two_epoch_bb(out["two_epoch_bb"], n_pings_per_epoch=3, n_samples=40)
    for bt in (17, 49, 65, 81):
        out[f"multisector_{bt}"] = str(d / f"MS{bt}-D20210201-T000000.raw")
        write_ek80_multisector(out[f"multisector_{bt}"], beam_type=bt)
    return out


CASES = [*VARIANTS, "two_epoch_cw", "two_epoch_bb", "multisector_17", "multisector_49",
         "multisector_65", "multisector_81"]


@pytest.mark.parametrize("name", CASES)
def test_open_raw_matches_jax(ek80_files, name):
    got = et.open_raw(ek80_files[name], sonar_model="EK80")
    want = ep.open_raw(ek80_files[name], sonar_model="EK80")
    assert isinstance(got["Sonar/Beam_group1"], TDataset)
    assert_same_tree(got, want)


@pytest.mark.parametrize("model", ["ES80", "EA640"])
def test_ek80_family_routes_to_the_ek80_parser(ek80_files, model):
    got = et.open_raw(ek80_files["default"], sonar_model=model)
    want = ep.open_raw(ek80_files["default"], sonar_model=model)
    assert got.sonar_model == model
    assert_same_tree(got, want)


def test_zarr_store_opens_in_jax_package(ek80_files, tmp_path):
    stores = []
    for pkg in (et, ep):
        store = str(tmp_path / f"ek80-{pkg.__name__}.zarr")
        pkg.open_raw(ek80_files["default"], sonar_model="EK80").to_zarr(store)
        stores.append(store)
    assert_same_tree(ep.open_converted(stores[0]), ep.open_converted(stores[1]))
    back = et.open_converted(stores[1])
    assert np.asarray(back["Sonar/Beam_group1"]["backscatter_i"].values).ndim == 4
