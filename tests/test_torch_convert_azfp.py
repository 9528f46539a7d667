"""Port parity: AZFP (.01A + instrument XML) and AZFP6 (.azfp) conversion.

``echopype_torch.open_raw`` runs the port's copies of ``parse_azfp``,
``parse_azfp6`` and their set-groups; on the synthetic files of
``tests/synth_azfp.py`` and ``tests/test_azfp6.py::write_azfp6_raw`` (and
``chip_smoke.py``'s four-frequency writer, whose channels have different
numbers of bins) it must give what ``echopype_tpu.open_raw`` gives: the
same groups, and in every group the same variables and coords, equal bit
for bit (NaN where NaN), with the same dims, dtypes and attrs; only the
clock stamps of the conversion may differ (``assert_same_tree``).
"""

import numpy as np
import pytest

import echopype_torch as et
import echopype_tpu as ep
from echopype_torch.xrlite import Dataset as TDataset

import chip_smoke
from synth_azfp import write_azfp_raw, write_azfp_xml, write_azfp_xml_refcompat
from test_azfp6 import write_azfp6_raw
from test_torch_convert import assert_same_tree

AZFP_CASES = {
    "plain": dict(n_pings=5),
    "averaged": dict(n_pings=4, averaged=True, seed=3),
    "long": dict(n_pings=50, seed=5),
}
AZFP6_CASES = {
    "plain": dict(n_pings=4),
    "averaged": dict(n_pings=3, averaged=True, seed=2),
    "wide": dict(n_pings=6, num_bins=120, seed=4),
    "minute_rollover": dict(n_pings=65, seed=6),
}


@pytest.fixture(scope="module")
def azfp_files(tmp_path_factory):
    d = tmp_path_factory.mktemp("convert_azfp")
    xml, xml_ref = d / "instrument.XML", d / "refcompat.XML"
    write_azfp_xml(xml)
    write_azfp_xml_refcompat(xml_ref)
    out = {}
    for i, (name, kw) in enumerate(AZFP_CASES.items()):
        path = d / f"2103151{i}.01A"
        write_azfp_raw(path, **kw)
        out[name] = (str(path), str(xml))
    out["refcompat_xml"] = (out["plain"][0], str(xml_ref))
    # four frequencies, 1,000 / 1,000 / 800 / 600 bins cut to 40 / 40 / 32 / 24
    xml4 = d / "four.XML"
    chip_smoke.write_azfp_xml4(xml4)
    ragged = d / "21031520.01A"
    chip_smoke.write_azfp_raw4(ragged, hour=20, seed=7, n_pings=9, num_bins=(40, 40, 32, 24))
    out["ragged_four_frequency"] = (str(ragged), str(xml4))
    return out


@pytest.fixture(scope="module")
def azfp6_files(tmp_path_factory):
    d = tmp_path_factory.mktemp("convert_azfp6")
    out = {}
    for i, (name, kw) in enumerate(AZFP6_CASES.items()):
        path = d / f"2207010{i}.azfp"
        write_azfp6_raw(path, **kw)
        out[name] = str(path)
    return out


@pytest.mark.parametrize("name", [*AZFP_CASES, "refcompat_xml", "ragged_four_frequency"])
def test_azfp_matches_jax(azfp_files, name):
    raw, xml = azfp_files[name]
    got = et.open_raw(raw, sonar_model="AZFP", xml_path=xml)
    want = ep.open_raw(raw, sonar_model="AZFP", xml_path=xml)
    assert isinstance(got["Sonar/Beam_group1"], TDataset)
    assert got.sonar_model == "AZFP"
    assert_same_tree(got, want)


def test_ragged_channels_are_nan_padded(azfp_files):
    """Channels of fewer bins pad with NaN past their last bin
    (set_groups_azfp.py), in ascending frequency order."""
    raw, xml = azfp_files["ragged_four_frequency"]
    bs = np.asarray(et.open_raw(raw, sonar_model="AZFP", xml_path=xml)
                    ["Sonar/Beam_group1"]["backscatter_r"].values)
    assert bs.shape == (4, 9, 40)
    assert [int(np.isfinite(bs[c, 0]).sum()) for c in range(4)] == [40, 40, 32, 24]


@pytest.mark.parametrize("name", list(AZFP6_CASES))
def test_azfp6_matches_jax(azfp6_files, name):
    got = et.open_raw(azfp6_files[name], sonar_model="AZFP6")
    want = ep.open_raw(azfp6_files[name], sonar_model="AZFP6")
    assert got.sonar_model == "AZFP6"
    assert_same_tree(got, want)


@pytest.mark.parametrize("xml", [None, ""], ids=["none", "empty"])
def test_azfp_requires_xml(tmp_path, xml):
    raw = tmp_path / "x.01A"
    raw.write_bytes(b"")
    for pkg in (et, ep):
        with pytest.raises(ValueError, match="xml_path"):
            pkg.open_raw(raw, sonar_model="AZFP", xml_path=xml)


def test_azfp_missing_xml_file_raises(tmp_path):
    raw = tmp_path / "x.01A"
    raw.write_bytes(b"")
    for pkg in (et, ep):
        with pytest.raises(FileNotFoundError):
            pkg.open_raw(raw, sonar_model="AZFP", xml_path=str(tmp_path / "absent.XML"))


@pytest.mark.parametrize("model, name", [("AZFP", "plain"), ("AZFP6", "plain")])
def test_zarr_store_opens_in_jax_package(azfp_files, azfp6_files, tmp_path, model, name):
    """A store the port writes opens in the JAX package to the same tree as
    the JAX package's own store, and the other way round."""
    kw = (dict(raw_file=azfp_files[name][0], xml_path=azfp_files[name][1]) if model == "AZFP"
          else dict(raw_file=azfp6_files[name]))
    stores = []
    for pkg in (et, ep):
        store = str(tmp_path / f"{model}-{pkg.__name__}.zarr")
        pkg.open_raw(sonar_model=model, **kw).to_zarr(store)
        stores.append(store)
    assert_same_tree(ep.open_converted(stores[0]), ep.open_converted(stores[1]))
    assert_same_tree(et.open_converted(stores[1]), ep.open_converted(stores[1]))
