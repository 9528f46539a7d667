"""The port's NASC chain against the benchmark's plain reference.

``bench_port/reference/ek60_nasc.py`` computes, in float64 from what the
benchmark's EK60 writer drew, each file's NASC on the (distance, depth)
grid as ``open_raw`` -> ``compute_Sv`` -> ``add_depth`` -> ``add_location``
-> ``compute_NASC`` define it.  Here, at a tiny size on the CPU (240
samples a ping, 41 and 40 pings, 10 m x 0.02 nmi bins so that a file spans
several distance bins; ``closed="left"`` and ``skipna=True`` as the cell
runs them):

* the port within 1e-4 dB of the reference on every bin, on a file of one
  sound speed (the range-row grid) and on one with a CTD update mid-file
  (a grid that varies by ping), with NaN masks, distance and depth edges,
  each ping's distance bin, the mean ping times (exactly) and the mean
  positions (1e-9 degrees) equal.  Sv is float32 on the card: ~1e-5 dB
  read; a bfloat16 Sv reads ~0.4 dB;
* the reference's pieces: Vincenty's inverse formula on the published
  Flinders Peak - Buninyong line, the positions between and past the
  fixes, and how far the cell's full track keeps its pings from the
  0.5 nmi edges;
* the stages ``add_depth``, ``add_location``, ``nasc_prepare`` and
  ``nasc_assemble`` and the counters ``nasc_pings`` and
  ``nasc_sample_pings`` reach ``profiling.TRACED`` under a profiler, the
  NASC stages beside the binning's ``bin_membership`` and ``bin_device``
  and never around them; without a profiler they add nothing.
"""

import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import echopype_torch as et
from echopype_torch.commongrid.utils import get_distance_from_latlon
from echopype_torch.utils import profiling
from echopype_torch.utils.geodesy import pairwise_distance_nmi

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from bench_port.reference import compare  # noqa: E402
from bench_port.reference import ek60_nasc as ref  # noqa: E402
from bench_port.synth import ek60 as writer  # noqa: E402

torch.set_num_threads(1)

R, DIST_BIN, DEPTH_OFFSET = 240, 0.02, 9.15
SEEDS = [2147483677, 2**31 + 4099]
#: (pings, CTD update at this ping or None)
FILES = {"one_sound_speed": (41, None), "ctd_update": (40, 20)}


def _config():
    cfg = json.loads((ROOT / "bench_port" / "configs" / "ek60_5freq_nasc.json").read_text())
    cfg["samples_per_ping"] = R
    return cfg


def _file(tmp_path, kind, seed):
    pings, ctd = FILES[kind]
    spec = {"name": f"{kind}.raw", "pings": pings, "sound_speed": 1480.0}
    if ctd is not None:
        spec["ctd_update_ping"] = ctd
    (path, truth), = writer.write_files(_config(), {"files": [spec]}, seed, tmp_path, "cpu")
    return path, truth


def _chain(path):
    ed = et.open_raw(path, sonar_model="EK60")
    ds = et.calibrate.compute_Sv(ed, device="cpu")
    ds = et.consolidate.add_depth(ds, depth_offset=DEPTH_OFFSET)
    ds = et.consolidate.add_location(ds, ed, nmea_sentence="GGA")
    nasc = et.commongrid.compute_NASC(ds, range_bin="10m", dist_bin=f"{DIST_BIN}nmi",
                                      closed="left", skipna=True, device="cpu")
    return ds, nasc


@pytest.fixture(scope="module", params=[(k, s) for k in FILES for s in SEEDS],
                ids=lambda p: f"{p[0]}-{p[1]}")
def chained(request, tmp_path_factory):
    kind, seed = request.param
    path, truth = _file(tmp_path_factory.mktemp(kind), kind, seed)
    ds, nasc = _chain(path)
    want = ref.nasc_file(_config(), truth, 10.0, DIST_BIN, DEPTH_OFFSET)
    return kind, truth, ds, nasc, want


def _db(v):
    with np.errstate(invalid="ignore", divide="ignore"):
        return 10 * np.log10(np.asarray(v, dtype="f8"))


def test_nasc_within_1e4_db_of_the_reference(chained):
    _, _, _, nasc, want = chained
    got = np.asarray(nasc["NASC"].values)
    assert got.shape == want["NASC"].shape
    assert compare.nan_mismatch(got, want["NASC"]) == 0
    assert np.isfinite(got).sum() > got.size // 2
    assert compare.max_db_gap(_db(got), _db(want["NASC"])) < 1e-4


def test_grid_is_the_reference_grid(chained):
    _, _, ds, nasc, want = chained
    assert want["NASC"].shape[1] >= 5  # several distance bins a file
    np.testing.assert_array_equal(nasc.coords["distance"].values, want["distance"])
    np.testing.assert_array_equal(nasc.coords["depth"].values, want["depth"])
    dist = get_distance_from_latlon(ds)
    edges = np.append(want["distance"], want["distance"][-1] + DIST_BIN)
    np.testing.assert_array_equal(np.searchsorted(edges, dist, side="right") - 1, want["x"])


def test_depth_is_the_float32_grid_plus_the_offset(chained):
    kind, truth, ds, _, _ = chained
    er = np.asarray(ds["echo_range"].values)
    assert er.dtype == np.float32
    np.testing.assert_array_equal(np.asarray(ds["depth"].values), DEPTH_OFFSET + er.astype("f8"))
    varies = not np.array_equal(er[:, 0], er[:, -1])
    assert varies == (kind == "ctd_update")


def test_mean_ping_times_exact_and_positions(chained):
    _, _, ds, nasc, want = chained
    got = np.asarray(nasc["ping_time"].values, dtype="datetime64[ns]").astype("i8")
    np.testing.assert_array_equal(got, want["ping_time"])
    for key in ("latitude", "longitude"):
        np.testing.assert_allclose(nasc[key].values, want[key], rtol=0, atol=1e-9)


def test_ping_positions_are_the_fixes_interpolated(chained):
    _, truth, ds, _, _ = chained
    lat, lon = ref.ping_positions(truth["ping_time_ns"])
    np.testing.assert_allclose(ds["latitude"].values, lat, rtol=0, atol=1e-9)
    np.testing.assert_allclose(ds["longitude"].values, lon, rtol=0, atol=1e-9)


def test_positions_between_and_past_the_fixes():
    t = 500_000_000 + np.arange(6, dtype="i8") * 1_000_000_000
    lat, lon = ref.ping_positions(t)
    step = ref.TRACK_STEP_DEG
    np.testing.assert_allclose(lat, 45.0 + step * np.arange(6) / 2, rtol=0, atol=1e-12)
    np.testing.assert_allclose(lon, -(124.0 + step * np.arange(6) / 2), rtol=0, atol=1e-12)


def test_vincenty_on_the_published_flinders_peak_line():
    """Flinders Peak to Buninyong, Geoscience Australia's worked example of
    Vincenty's inverse formula on an ellipsoid of WGS-84's flattening:
    54,972.271 m."""
    lat1 = -(37 + 57 / 60 + 3.72030 / 3600)
    lon1 = 144 + 25 / 60 + 29.52440 / 3600
    lat2 = -(37 + 39 / 60 + 10.15610 / 3600)
    lon2 = 143 + 55 / 60 + 35.38390 / 3600
    d = ref.vincenty_m(np.array([lat1]), np.array([lon1]), np.array([lat2]), np.array([lon2]))
    assert d[0] == pytest.approx(54_972.271, abs=1e-3)
    assert ref.vincenty_m(np.array([45.0]), np.array([-124.0]), np.array([45.0]),
                          np.array([-124.0]))[0] == 0.0


def test_full_track_keeps_its_pings_off_the_half_mile_edges():
    """The cell's files: 1,955 pings at 1 Hz.  Every ping lies at least
    3e-4 nmi (0.56 m) from a 0.5 nmi edge, and the port's distance is
    within 1e-10 nmi of the reference's, so no ping can change bin between
    the two."""
    t = 500_000_000 + np.arange(1955, dtype="i8") * 1_000_000_000
    lat, lon = ref.ping_positions(t)
    dist = ref.along_track_nmi(lat, lon)
    assert 7.0 < dist[-1] < 7.5  # 15 distance bins
    assert ref.edge_margin_nmi(dist, 0.5) > 3e-4
    port = np.cumsum(pairwise_distance_nmi(lat, lon)[:-1])
    assert np.max(np.abs(port - dist[:-1])) < 1e-10


@pytest.fixture(scope="module")
def traced_call(tmp_path_factory):
    d = tmp_path_factory.mktemp("traced")
    path, truth = _file(d, "ctd_update", SEEDS[0])
    _chain(path)  # warm
    with profiling.trace(str(d / "trace")) as prof:
        _chain(path)
    return truth, profiling.TRACED.report(log=False), dict(profiling.TRACED.counters), prof


@pytest.mark.parametrize("name", ["add_depth", "add_location", "nasc_prepare",
                                  "nasc_assemble", "bin_membership", "bin_device"])
def test_stage_reaches_traced(traced_call, name):
    _, stages, _, _ = traced_call
    assert stages[name]["total_s"] >= 0 and stages[name]["count"] >= 1


def test_counters_count_the_pings(traced_call):
    truth, _, counters, _ = traced_call
    P = truth["power"].shape[1]
    assert counters["nasc_pings"] == P
    assert counters["nasc_sample_pings"] == P


def test_nasc_stages_are_siblings_of_the_binning(traced_call):
    *_, prof = traced_call
    spans = {}
    for e in prof.events():
        if e.name.startswith("stage:"):
            spans.setdefault(e.name[6:], []).append((e.time_range.start, e.time_range.end))
    assert len(spans["bin_membership"]) == 2 and len(spans["bin_device"]) == 2
    for outer in ("nasc_prepare", "nasc_assemble"):
        for s, t in spans[outer]:
            for inner in ("bin_membership", "bin_device"):
                assert all(b <= s or a >= t for a, b in spans[inner])
    (p0, p1), (a0, a1) = spans["nasc_prepare"][0], spans["nasc_assemble"][0]
    assert all(p1 <= a and b <= a0 for a, b in spans["bin_membership"] + spans["bin_device"])


def test_stages_add_nothing_without_a_profiler(tmp_path):
    path, _ = _file(tmp_path, "one_sound_speed", SEEDS[1])
    before = profiling.TRACED.report(log=False)
    counters = dict(profiling.TRACED.counters)
    _chain(path)
    assert profiling.TRACED.report(log=False) == before
    assert dict(profiling.TRACED.counters) == counters
