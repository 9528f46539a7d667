"""Port parity: Nortek Signature (AD2CP) conversion.

``echopype_torch.open_raw(..., sonar_model="AD2CP")`` runs the port's copies
of ``parse_ad2cp`` and ``set_groups_ad2cp``.  On the files of
``tests/test_ad2cp.py``'s writers (average / burst / echosounder records,
bottom track, echosounder raw IQ with transmit pulses, version-2 records) it
must give what ``echopype_tpu.open_raw`` gives, bit for bit
(``assert_same_tree``).  AD2CP has no calibration in either package, and
the raw survey streamer refuses it.
"""

import numpy as np
import pytest

import echopype_torch as et
import echopype_tpu as ep
from echopype_torch.convert.parse_ad2cp import checksum as t_checksum
from echopype_tpu.convert.parse_ad2cp import checksum as j_checksum

from test_ad2cp import _packet, _raw_packet, _raw_record, _v2_record, write_ad2cp
from test_torch_convert import assert_same_tree

WRITER_CASES = {
    "default": dict(),
    "bottom_track_and_raw": dict(with_bottom_track=True, with_echosounder_raw=True),
    "burst": dict(average_id=0x15),
    "echosounder_first": dict(echosounder_first=True, n_pings=3),
    "no_echosounder": dict(with_echosounder=False, n_pings=5),
    "echosounder_only": dict(with_average=False),
    "three_beams": dict(record_kw={"num_beams": 3}),
}


def _v2_file(path):
    path.write_bytes(b"".join(_packet(0x16, _v2_record(second=s, seed=5 + s)[0])
                              for s in range(3)))


def _raw_transmit_file(path):
    """tests/test_ad2cp.py::TestAd2cpEchosounderRawTransmit's file."""
    rng = np.random.default_rng(9)
    chunks = []
    for p in range(3):
        chunks.append(_raw_packet(0x23, _raw_record(p, rng.integers(-(2**30), 2**30, (30, 2)))))
        if p < 2:
            chunks.append(_raw_packet(0x24, _raw_record(p, rng.integers(-(2**30), 2**30, (8, 2)))))
    path.write_bytes(b"".join(chunks))


@pytest.fixture(scope="module")
def ad2cp_files(tmp_path_factory):
    d = tmp_path_factory.mktemp("ad2cp")
    out = {}
    for name, kw in WRITER_CASES.items():
        out[name] = d / f"{name}.ad2cp"
        write_ad2cp(out[name], **kw)
    out["version2"] = d / "version2.ad2cp"
    _v2_file(out["version2"])
    out["raw_transmit"] = d / "raw_transmit.ad2cp"
    _raw_transmit_file(out["raw_transmit"])
    return {k: str(v) for k, v in out.items()}


@pytest.mark.parametrize("name", [*WRITER_CASES, "version2", "raw_transmit"])
def test_open_raw_matches_jax(ad2cp_files, name):
    got = et.open_raw(ad2cp_files[name], sonar_model="AD2CP")
    want = ep.open_raw(ad2cp_files[name], sonar_model="AD2CP")
    assert got.sonar_model == "AD2CP"
    assert_same_tree(got, want)


def test_checksum_matches_jax():
    rng = np.random.default_rng(3)
    for n in (0, 1, 2, 7, 64, 1001):
        buf = rng.integers(0, 256, n, dtype=np.uint8).tobytes()
        assert t_checksum(buf) == j_checksum(buf)


def test_corrupt_packet_is_skipped_as_in_jax(ad2cp_files, tmp_path):
    """A packet whose data checksum fails is skipped with a log, the same
    packet in both packages."""
    buf = bytearray(open(ad2cp_files["default"], "rb").read())
    buf[len(buf) // 2] ^= 0xFF
    bad = tmp_path / "corrupt.ad2cp"
    bad.write_bytes(bytes(buf))
    assert_same_tree(et.open_raw(bad, sonar_model="AD2CP"), ep.open_raw(bad, sonar_model="AD2CP"))


def test_survey_refuses_ad2cp(ad2cp_files):
    """tests/test_survey.py:240-243: AD2CP has no power-mode calibration."""
    with pytest.raises(ValueError, match="power"):
        et.run_survey_mvbs_from_raw([ad2cp_files["default"]], sonar_model="AD2CP", device="cpu")
    with pytest.raises(ValueError, match="power"):
        et.run_survey_mvbs_from_raw([], sonar_model="AD2CP", device="cpu")


def test_calibration_refuses_ad2cp(ad2cp_files):
    ed = et.open_raw(ad2cp_files["default"], sonar_model="AD2CP")
    with pytest.raises(ValueError, match="Unsupported sonar model"):
        et.calibrate.compute_Sv(ed, device="cpu")
