"""Port parity: EK80 / ES80 / EA640 conversion.

``echopype_torch.open_raw`` runs the port's copy of the EK80 chain
(``convert/parse_ek80.py``, ``convert/set_groups_ek80.py``,
``convert/simrad/xml_config.py``); on the synthetic EK80 files of
``tests/synth_ek80.py`` it must give what ``echopype_tpu.open_raw`` gives:
the same groups, and in every group the same variables and coords, equal
bit for bit (NaN where NaN), with the same dims, dtypes and attrs; only the
clock stamps of the conversion may differ (``assert_same_tree``).
"""

import copy

import numpy as np
import pytest

import echopype_torch as et
import echopype_tpu as ep
from echopype_torch.convert.simrad import decode as tdecode
from echopype_torch.convert.simrad import framing as tframing
from echopype_torch.xrlite import Dataset as TDataset
from echopype_tpu.convert.simrad import decode as jdecode
from echopype_tpu.convert.simrad import framing as jframing

from synth_ek80 import (
    CH_BB,
    CH_CW,
    CH_PW,
    config_xml,
    default_channels,
    environment_xml,
    make_fil1,
    make_raw3,
    make_xml0,
    parameter_xml,
    write_ek80_multisector,
    write_ek80_raw,
)
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

CH_FM2 = "WBT 5512345-15 ES200-7C"

#: files of ``_write_complex_mix``: complex channels of one group that differ
#: in samples and in sectors, so both padding fills run, over whole channels
#: and (skipped pings) over runs of pings; and FM and CW pings interleaved on
#: one channel
MIXES = {
    "ragged_channels": dict(shapes={CH_BB: (40, 4), CH_FM2: (48, 3)}),
    "ragged_channels_skip": dict(shapes={CH_BB: (40, 4), CH_FM2: (48, 3)},
                                 skip={CH_FM2: {2, 5}}),
    "fm_cw_interleaved": dict(shapes={CH_BB: (48, 4), CH_CW: (48, 4)},
                              cw_pings={CH_BB: {1, 3, 5}}),
}


def _write_complex_mix(path, shapes, skip=None, cw_pings=None, n_pings=7, seed=60):
    """An EK80 file of complex channels alone: ``shapes`` {channel id:
    (samples, sectors)}, ``skip`` {channel id: pings left out}, ``cw_pings``
    {channel id: pings a broadband channel transmits CW}."""
    by_id = {c["id"]: c for c in default_channels()}
    fm2 = copy.deepcopy(by_id[CH_BB])
    fm2.update(id=CH_FM2, frequency=200000.0, fmin=160000.0, fmax=260000.0,
               cal_freqs=np.linspace(160000, 260000, 10))
    by_id[CH_FM2] = fm2
    channels = [by_id[cid] for cid in shapes]
    t0 = np.datetime64("2021-02-01T00:00:00", "ns")
    chunks = [make_xml0(t0, config_xml(channels)), make_xml0(t0, environment_xml())]
    for ch in channels:
        chunks.append(make_fil1(t0, ch["id"], 1, np.full(4, 0.25, dtype="c8"), 6))
        chunks.append(make_fil1(t0, ch["id"], 2, np.full(2, 0.5, dtype="c8"), 1))
    rng = np.random.default_rng(seed)
    for p in range(n_pings):
        ts = t0 + np.timedelta64(p + 1, "s")
        for ch in channels:
            cid = ch["id"]
            if p in (skip or {}).get(cid, ()):
                continue
            if ch["cal_freqs"] is not None and p not in (cw_pings or {}).get(cid, ()):
                xml = parameter_xml(cid, 1, freq_start=ch["fmin"] + 5000.0,
                                    freq_end=ch["fmax"], sample_interval=16e-6)
            else:
                xml = parameter_xml(cid, 0, frequency=ch["frequency"], sample_interval=32e-6)
            cs = (rng.normal(0, 1e-3, shapes[cid])
                  + 1j * rng.normal(0, 1e-3, shapes[cid])).astype("c8")
            chunks += [make_xml0(ts, xml), make_raw3(ts, cid, complex_samples=cs)]
    with open(path, "wb") as f:
        f.write(b"".join(chunks))


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
    for name, kw in MIXES.items():
        out[name] = str(d / f"{name}-D20210201-T000000.raw")
        _write_complex_mix(out[name], **kw)
    for bt in (17, 49, 65, 81):
        out[f"multisector_{bt}"] = str(d / f"MS{bt}-D20210201-T000000.raw")
        write_ek80_multisector(out[f"multisector_{bt}"], beam_type=bt)
    return out


CASES = [*VARIANTS, "two_epoch_cw", "two_epoch_bb", "multisector_17", "multisector_49",
         "multisector_65", "multisector_81", *MIXES]


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


@pytest.mark.parametrize("name", ["default", "complex_f16", "with_raw4", "ragged_channels",
                                  "fm_cw_interleaved", "multisector_17"])
def test_raw3_complex_planes_are_float32_and_widen_to_the_jax_decode(ek80_files, name):
    """decode_raw3_samples keeps the complex parts float32 (views of the
    gather); widened, they equal the JAX package's decode, NaN where NaN."""
    buf = open(ek80_files[name], "rb").read()
    t_index, j_index = tframing.scan_datagrams(buf), jframing.scan_datagrams(buf)
    for kind in ("RAW3", "RAW4"):
        rows = t_index.select(kind)
        if not len(rows):
            continue
        hdr, _, ch_ids = tdecode.decode_raw3_headers(t_index, rows)
        j_rows = j_index.select(kind)
        j_hdr, _, j_ch_ids = jdecode.decode_raw3_headers(j_index, j_rows)
        np.testing.assert_array_equal(rows, j_rows)
        for ch in sorted(set(ch_ids.tolist())):
            sel = np.nonzero(ch_ids == ch)[0]
            got = tdecode.decode_raw3_samples(t_index, rows[sel], hdr[sel])
            want = jdecode.decode_raw3_samples(j_index, j_rows[sel], j_hdr[sel])
            if want["complex_r"] is None:
                assert got["complex_r"] is None
                continue
            assert got["n_complex"] == want["n_complex"]
            for part in ("complex_r", "complex_i"):
                assert got[part].dtype == np.float32
                widened = got[part].astype("f8")
                assert widened.shape == want[part].shape
                np.testing.assert_array_equal(widened, want[part])
