"""Port parity: ``combine_echodata`` and ``check_zarr_path``.

The cases of tests/test_combine.py, each run through both packages on the
same synthetic EK60 files (``tests/synth_ek60.py``, made from a seed): every
group of ``echopype_torch.combine_echodata`` equals
``echopype_tpu.combine_echodata``'s bit for bit (NaN where NaN), with the same
dims, dtypes and attrs, the per-file Provenance attribute table included.
The provenance clock is pinned in both packages so the stamps agree.
Errors are raised with the same types; a combined store the port writes
reopens in either package to the same tree; the port's compute_Sv of a
combined tree equals its per-file Sv.
"""

import numpy as np
import pytest

import echopype_torch as et
import echopype_tpu as ep
from echopype_torch.echodata import combine as t_combine
from echopype_torch.utils import prov as t_prov
from echopype_tpu.echodata import combine as j_combine
from echopype_tpu.utils import prov as j_prov

from synth_ek60 import write_ek60_raw
from test_torch_convert import assert_same_tree

T0 = np.datetime64("2020-01-01T00:00:00", "ns")


@pytest.fixture(autouse=True)
def fixed_clock(monkeypatch):
    for mod in (t_prov, j_prov):
        monkeypatch.setattr(mod, "_utcnow_str", lambda: "2024-01-01T00:00:00Z")


def write_files(tmp_path, n_files=3, n_pings=5, n_samples=40, ragged_widths=None, **kw):
    paths = []
    for i in range(n_files):
        path = tmp_path / f"F{i}-D2020010{i + 1}-T000000.raw"
        ns = ragged_widths[i] if ragged_widths else n_samples
        write_ek60_raw(path, n_pings=n_pings, n_samples=ns,
                       t0=T0 + np.timedelta64(i * 3600, "s"), seed=i, **kw)
        paths.append(path)
    return paths


def open_both(paths):
    """(port EchoData list, JAX EchoData list) of the same files."""
    return ([et.open_raw(p, sonar_model="EK60") for p in paths],
            [ep.open_raw(p, sonar_model="EK60") for p in paths])


@pytest.mark.parametrize(
    "files_kw, combine_kw",
    [(dict(), dict()),
     (dict(ragged_widths=[30, 40, 35]), dict()),
     (dict(n_files=2), "first_channel"),
     (dict(n_files=2, n_pings=7, with_angle=False), dict()),
     (dict(n_files=4, n_pings=3, n_samples=25, with_nmea=False), dict())],
    ids=["basic", "ragged", "channel_selection", "no_angles", "four_files_no_nmea"],
)
def test_combine_matches_jax(tmp_path, files_kw, combine_kw):
    t_eds, j_eds = open_both(write_files(tmp_path, **files_kw))
    if combine_kw == "first_channel":
        ch = str(t_eds[0]["Sonar/Beam_group1"].coords["channel"].values[0])
        combine_kw = dict(channel_selection=[ch])
    got = et.combine_echodata(t_eds, **combine_kw)
    want = ep.combine_echodata(j_eds, **combine_kw)
    assert isinstance(got, et.EchoData)
    assert_same_tree(got, want)
    beam = got["Sonar/Beam_group1"]
    n_files = files_kw.get("n_files", 3)
    assert beam.sizes["ping_time"] == n_files * files_kw.get("n_pings", 5)
    assert got["Provenance"].sizes["echodata_filename"] == n_files
    if "channel_selection" in combine_kw:
        assert beam.sizes["channel"] == 1


def test_ragged_widths_pad_with_nan(tmp_path):
    t_eds, _ = open_both(write_files(tmp_path, ragged_widths=[30, 40, 35]))
    beam = et.combine_echodata(t_eds)["Sonar/Beam_group1"]
    assert beam.sizes["range_sample"] == 40
    assert np.isnan(beam["backscatter_r"].values[0, 0, 35:]).all()
    np.testing.assert_array_equal(beam["backscatter_r"].values[:, 5:10, :40],
                                  t_eds[1]["Sonar/Beam_group1"]["backscatter_r"].values)


def test_differing_group_sets_match_jax(tmp_path):
    """One file with NMEA, one without (tests/test_combine.py:163-187): the
    Provenance table keeps a row per input and the inputs stay unmutated."""
    r1, r2 = tmp_path / "GA-D20200101-T000000.raw", tmp_path / "GB-D20200101-T000000.raw"
    write_ek60_raw(r1, n_pings=6, n_samples=20, t0=T0, with_nmea=True)
    write_ek60_raw(r2, n_pings=5, n_samples=20, t0=T0 + np.timedelta64(60, "s"),
                   with_nmea=False, seed=1)
    t_eds, j_eds = open_both([r1, r2])
    before = dict(t_eds[0]["Sonar"].attrs)
    got, want = et.combine_echodata(t_eds), ep.combine_echodata(j_eds)
    assert_same_tree(got, want)
    assert dict(t_eds[0]["Sonar"].attrs) == before
    assert got["Sonar/Beam_group1"].sizes["ping_time"] == 11


def test_recombine_stores_matches_jax(tmp_path):
    """Combined stores combined again flatten to the original files
    (tests/test_combine.py:113-150); each package writes and reopens its own
    stores."""
    finals = []
    for pkg in (et, ep):
        stores = []
        for g in range(2):
            eds = []
            for i in range(2):
                raw = tmp_path / f"G{g}F{i}-D20200101-T000000-EK60.raw"
                if not raw.exists():
                    write_ek60_raw(raw, n_pings=5, n_samples=20,
                                   t0=T0 + np.timedelta64((g * 2 + i) * 5, "s"), seed=g * 2 + i)
                eds.append(pkg.open_raw(raw, sonar_model="EK60"))
            store = tmp_path / f"{pkg.__name__}_combined_{g}.zarr"
            pkg.combine_echodata(eds).to_zarr(store)
            stores.append(pkg.open_converted(store))
        finals.append(pkg.combine_echodata(stores))
    got, want = finals
    assert_same_tree(got, want)
    prov = got["Provenance"]
    for k in ("source_filenames", "echodata_filename"):
        names = [str(s) for s in np.atleast_1d(prov[k].values)]
        assert len(names) == 4 and all(s.endswith(".raw") for s in names)
    assert got["Sonar/Beam_group1"].sizes["ping_time"] == 20


@pytest.mark.parametrize("case", ["same_file", "wrong_type", "non_ascending"])
def test_errors_match_jax(tmp_path, case):
    paths = write_files(tmp_path, n_files=2)
    raised = []
    for pkg in (et, ep):
        eds = [pkg.open_raw(p, sonar_model="EK60") for p in paths]
        arg = {"same_file": [eds[0], eds[0]], "wrong_type": ["not an echodata"],
               "non_ascending": [eds[1], eds[0]]}[case]
        with pytest.raises(Exception) as info:
            pkg.combine_echodata(arg)
        raised.append(info.value)
    assert type(raised[0]) is type(raised[1])
    assert type(raised[0]) is {"same_file": ValueError, "wrong_type": TypeError,
                               "non_ascending": RuntimeError}[case]
    assert str(raised[0]) == str(raised[1])


def test_channel_check_tolerates_missing_group():
    """A later input lacking a channel-bearing group (tests/test_combine.py
    :189-221)."""
    from echopype_torch.xrlite import Dataset

    beam = Dataset(coords={"channel": np.array(["c1", "c2"], dtype=object)})

    class StubED:
        sonar_model = "EK60"

        def __init__(self, groups):
            self._g = groups

        @property
        def group_paths(self):
            return list(self._g)

        def __getitem__(self, k):
            return self._g[k]

        def get(self, k, default=None):
            return self._g.get(k, default)

    sel = t_combine._check_echodata_channels(
        [StubED({"Sonar/Beam_group1": beam, "Vendor_specific": beam}),
         StubED({"Sonar/Beam_group1": beam})])
    assert sel["Sonar/Beam_group1"] is None


def test_combined_store_roundtrip(tmp_path):
    """A combined tree the port writes reopens in both packages to the
    tree the JAX package combines."""
    t_eds, j_eds = open_both(write_files(tmp_path, n_files=2))
    got = et.combine_echodata(t_eds)
    store = tmp_path / "combined.zarr"
    got.to_zarr(store)
    want = ep.combine_echodata(j_eds)
    assert_same_tree(et.open_converted(store), ep.open_converted(store))
    np.testing.assert_array_equal(
        et.open_converted(store)["Sonar/Beam_group1"]["backscatter_r"].values,
        want["Sonar/Beam_group1"]["backscatter_r"].values)


def test_compute_sv_of_combined(tmp_path):
    """compute_Sv of the combined tree equals each file's Sv (the port, on
    the CPU) and the JAX package's within the float32 5e-5 dB of
    tests/test_torch_calibrate.py."""
    t_eds, j_eds = open_both(write_files(tmp_path))
    sv = et.calibrate.compute_Sv(et.combine_echodata(t_eds), device="cpu")["Sv"].values
    assert sv.shape[1] == 15
    for i, ed in enumerate(t_eds):
        np.testing.assert_array_equal(
            sv[:, 5 * i:5 * (i + 1)], et.calibrate.compute_Sv(ed, device="cpu")["Sv"].values)
    want = ep.calibrate.compute_Sv(ep.combine_echodata(j_eds))["Sv"].values
    np.testing.assert_array_equal(np.isnan(sv), np.isnan(want))
    np.testing.assert_allclose(sv, want, atol=5e-5, rtol=0, equal_nan=True)


@pytest.mark.parametrize("form", ["str", "path", "no_suffix", "wrong_type", "existing"])
def test_check_zarr_path_matches_jax(tmp_path, form):
    target = tmp_path / "out.zarr"
    arg = {"str": str(target), "path": target, "no_suffix": str(tmp_path / "out"),
           "wrong_type": 42, "existing": str(target)}[form]
    if form == "existing":
        target.mkdir()
    results = []
    for fn in (t_combine.check_zarr_path, j_combine.check_zarr_path):
        try:
            results.append(("ok", fn(arg)))
        except Exception as e:  # noqa: BLE001 - the two must raise alike
            results.append((type(e), str(e)))
    assert results[0] == results[1]
    if form in ("str", "path"):
        assert results[0] == ("ok", str(target))
    if form == "no_suffix":
        assert results[0][0] is ValueError
    if form == "wrong_type":
        assert results[0][0] is TypeError
