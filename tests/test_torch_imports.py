"""The port must run where neither jax, pandas nor the JAX package is installed.

A subprocess refuses ``jax``, ``jaxlib``, ``pandas`` and ``echopype_tpu``
from a ``sys.meta_path`` finder, imports echopype_torch and runs the
raw->MVBS survey, ``open_raw`` -> ``compute_Sv`` -> ``compute_MVBS`` /
``compute_MVBS_index_binning``, the fused survey step, and
``consolidate.add_location`` / ``add_depth`` -> ``run_survey_mvbs`` /
``run_survey_nasc``, EK80: ``open_raw`` -> BB ``compute_Sv`` (also under
``set_conv_precision("HIGH")``) and the fused BB survey
(``device_fused=True``), and the masks: ``clean.mask_*``,
``mask.frequency_differencing`` -> ``apply_mask``, and the survey
streamers with ``freq_diff`` and ``noise_masks``, and the other instruments:
AZFP ``open_raw`` -> ``compute_Sv`` and the AZFP raw survey (plain,
``freq_diff``), AD2CP ``open_raw`` and ``compute_Sv(ecs_file=)`` on EK60,
on the CPU (the AD2CP and ECS files come from test helpers that import the
JAX package, so this process writes them first), and the multi-file cruise:
three files -> ``combine_echodata`` -> a reversed ping -> ``to_zarr`` ->
``qc.orchestrate_reverse_time_check(zarr_store=)`` -> ``open_converted`` ->
``compute_Sv`` -> the five ``metrics``, and the raw survey with
``workers=2``; none of the four may be loaded afterwards.  The refusing
finder is installed by a ``sitecustomize`` on the subprocess's PYTHONPATH,
so the survey's spawned decode workers start with it too; each process that
loads it logs its pid, and the survey must have run in two more processes
than the script's own.
An AST scan holds the package's sources and ``chip_smoke.py`` to the same
rule, including imports inside functions.
"""

import ast
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import torch

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent

_FENCE = textwrap.dedent(
    """
    import importlib.abc
    import os
    import sys

    BLOCKED = ("jax", "jaxlib", "pandas", "echopype_tpu")

    class Refuse(importlib.abc.MetaPathFinder):
        def find_spec(self, name, path=None, target=None):
            if name.split(".")[0] in BLOCKED:
                raise ModuleNotFoundError(f"refused in this test: {name}")
            return None

    sys.meta_path.insert(0, Refuse())
    with open(os.environ["FENCE_PID_LOG"], "a") as log:
        log.write(f"{os.getpid()}\\n")
    """
)

_SCRIPT = textwrap.dedent(
    """
    import sys

    BLOCKED = ("jax", "jaxlib", "pandas", "echopype_tpu")
    sys.path[:0] = [sys.argv[1], sys.argv[1] + "/tests"]

    import numpy as np
    import torch

    torch.set_num_threads(1)
    import echopype_torch as et
    from synth_ek60 import write_ek60_raw

    path = sys.argv[2]
    write_ek60_raw(path, n_pings=30, n_samples=200, with_angle=False, jitter_raw0=True)
    mvbs = et.run_survey_mvbs_from_raw([path], range_bin="5m", ping_time_bin="10s",
                                       chunk_pings=16, device="cpu")
    ed = et.open_raw(path, sonar_model="EK60")
    sv = et.calibrate.compute_Sv(ed, device="cpu")
    assert np.isfinite(mvbs["Sv"].values).any() and sv["Sv"].values.shape == (2, 30, 200)
    grid = et.compute_MVBS(sv, range_bin="5m", ping_time_bin="10s", device="cpu")
    assert "ping_time: mean (interval: 10 second" in grid["Sv"].attrs["cell_methods"]
    assert np.isfinite(grid["Sv"].values).any()
    coarse = et.compute_MVBS_index_binning(sv, range_sample_num=20, ping_num=5, device="cpu")
    assert coarse["Sv"].values.shape == (2, 6, 10)
    rng = np.random.default_rng(0)
    power = rng.normal(-80, 10, (2, 16, 64)).astype("f4")
    cp = np.full((2, 16), 0.19, "f4")
    sv_t, mvbs_t = et.survey_pipeline_step(None, 4, 3, device="cpu")(
        power, cp, 2 * cp, cp * 0.05, cp - 30, np.arange(16) // 4, np.arange(0, 12.0, 3.0))
    assert sv_t.shape == (2, 16, 64) and torch.isfinite(mvbs_t).all()
    sv = et.consolidate.add_depth(et.consolidate.add_location(sv, ed), echodata=ed,
                                  use_platform_vertical_offsets=True)
    survey = et.run_survey_mvbs([sv], range_bin="5m", ping_time_bin="10s", device="cpu")
    nasc = et.run_survey_nasc([sv], range_bin="5m", dist_bin="1nmi", device="cpu")
    assert survey.attrs["routes"] == nasc.attrs["routes"] == ["per_ping"]
    assert np.isfinite(survey["Sv"].values).any() and np.isfinite(nasc["NASC"].values).any()
    from synth_ek80 import write_ek80_raw

    ek80 = path.replace(".raw", "-ek80.raw")
    write_ek80_raw(ek80, n_pings=6, n_samples=96, with_power_channel=False,
                   with_cw_complex=False)
    ed80 = et.open_raw(ek80, sonar_model="EK80")
    bb = et.calibrate.compute_Sv(ed80, waveform_mode="BB", encode_mode="complex", device="cpu")
    fused = et.run_survey_mvbs_from_raw([ek80], sonar_model="EK80", waveform_mode="BB",
                                        encode_mode="complex", device_fused=True,
                                        range_bin="0.2m", ping_time_bin="2s", device="cpu")
    assert np.isfinite(bb["Sv"].values).any() and np.isfinite(fused["Sv"].values).any()
    from echopype_torch.ops import matched_filter as mf

    mf.set_conv_precision("HIGH")
    try:
        bb_high = et.calibrate.compute_Sv(ed80, waveform_mode="BB", encode_mode="complex",
                                          device="cpu")
    finally:
        mf.set_conv_precision("HIGHEST")
    assert np.array_equal(np.isnan(bb_high["Sv"].values), np.isnan(bb["Sv"].values))
    assert not np.array_equal(bb_high["Sv"].values, bb["Sv"].values, equal_nan=True)
    imp = et.clean.mask_impulse_noise(sv, depth_bin="4m", num_side_pings=2, device="cpu")
    trn = et.clean.mask_transient_noise(sv, depth_bin="6m", num_side_pings=3,
                                        exclude_above="2m", device="cpu")
    fd = et.mask.frequency_differencing(sv, freqABEq="38kHz - 18kHz > 3.0dB")
    masked = et.mask.apply_mask(sv, fd)
    assert imp.values.shape == trn.values.shape == sv["Sv"].values.shape
    assert np.isnan(masked["Sv"].values).sum() > np.isnan(sv["Sv"].values).sum()
    fd_raw = et.run_survey_mvbs_from_raw([path], range_bin="5m", ping_time_bin="10s",
                                         chunk_pings=16, freq_diff="38kHz - 18kHz > 3.0dB",
                                         device="cpu")
    nm = et.run_survey_mvbs([sv], range_bin="5m", ping_time_bin="10s", device="cpu",
                            noise_masks={"impulse": dict(depth_bin="4m")})
    assert np.isfinite(fd_raw["Sv"].values).any() and np.isfinite(nm["Sv"].values).any()
    from synth_azfp import write_azfp_raw, write_azfp_xml

    azfp, xml = path.replace(".raw", ".01A"), path.replace(".raw", ".XML")
    write_azfp_xml(xml)
    write_azfp_raw(azfp, n_pings=8)
    env = {"salinity": 32.0, "pressure": 60.0}
    ed_az = et.open_raw(azfp, sonar_model="AZFP", xml_path=xml)
    sv_az = et.calibrate.compute_Sv(ed_az, env_params=env, device="cpu")
    kw_az = dict(sonar_model="AZFP", xml_path=xml, env_params=env, range_bin="2m",
                 ping_time_bin="4s", chunk_pings=3, device="cpu")
    az = et.run_survey_mvbs_from_raw([azfp], **kw_az)
    az_fd = et.run_survey_mvbs_from_raw([azfp], freq_diff="125kHz - 38kHz > 3.0dB", **kw_az)
    assert np.isfinite(sv_az["Sv"].values).all() and np.isfinite(az["Sv"].values).any()
    assert az_fd["Sv"].values.shape == az["Sv"].values.shape
    ad = et.open_raw(sys.argv[3], sonar_model="AD2CP")
    assert "Sonar/Beam_group1" in ad.group_paths
    sv_ecs = et.calibrate.compute_Sv(ed, ecs_file=sys.argv[4], device="cpu")
    np.testing.assert_allclose(np.asarray(sv_ecs["sound_speed"].values), 1473.0)
    cruise = [path]
    for i in (1, 2):
        cruise.append(path.replace("T000000", f"T0{i}0000"))
        write_ek60_raw(cruise[-1], n_pings=30, n_samples=200, with_angle=False, seed=i,
                       t0=np.datetime64("2020-01-01T00:00:00", "ns") + np.timedelta64(3600 * i, "s"))
    comb = et.combine_echodata([et.open_raw(p, sonar_model="EK60") for p in cruise])
    beam = comb["Sonar/Beam_group1"]
    pt = beam.coords["ping_time"].values.copy()
    pt[40] = pt[39] - np.timedelta64(3, "s")
    beam.coords["ping_time"] = et.xrlite.DataArray(pt, ("ping_time",), name="ping_time")
    store = path.replace(".raw", "-cruise.zarr")
    comb.to_zarr(store)
    et.qc.orchestrate_reverse_time_check(comb, zarr_store=store)
    back = et.open_converted(store)
    assert not et.qc.exist_reversed_time(back["Sonar/Beam_group1"], "ping_time")
    assert back["Provenance"].attrs["reversed_ping_times"] == 1
    sv_c = et.calibrate.compute_Sv(back, device="cpu")
    for m in ("abundance", "center_of_mass", "dispersion", "evenness", "aggregation"):
        assert np.isfinite(getattr(et.metrics, m)(sv_c).values).any(), m
    pooled = et.run_survey_mvbs_from_raw(cruise, workers=2, range_bin="5m", ping_time_bin="10s",
                                         chunk_pings=16, device="cpu")
    assert np.isfinite(pooled["Sv"].values).any()
    loaded = sorted(m for m in sys.modules if m.split(".")[0] in BLOCKED)
    print("LOADED", loaded)
    """
)


def test_port_runs_without_jax_or_pandas(tmp_path):
    from test_ad2cp import write_ad2cp
    from test_ecs import ECS_CONTENT

    ad2cp, ecs = tmp_path / "m.ad2cp", tmp_path / "cal.ecs"
    write_ad2cp(ad2cp, with_bottom_track=True, with_echosounder_raw=True)
    ecs.write_text(ECS_CONTENT)
    fence, pids = tmp_path / "fence", tmp_path / "fence_pids.txt"
    fence.mkdir()
    (fence / "sitecustomize.py").write_text(_FENCE)
    env = dict(os.environ, FENCE_PID_LOG=str(pids),
               PYTHONPATH=os.pathsep.join(filter(None, [str(fence),
                                                        os.environ.get("PYTHONPATH")])))
    res = subprocess.run(
        [sys.executable, "-c", _SCRIPT, str(REPO), str(tmp_path / "g-D20200101-T000000.raw"),
         str(ad2cp), str(ecs)],
        capture_output=True, text=True, timeout=300, cwd=tmp_path, env=env,
    )
    assert res.returncode == 0, res.stderr[-4000:]
    assert "LOADED []" in res.stdout
    assert len(set(pids.read_text().split())) >= 3  # the script and two decode workers


REFUSED_EVERYWHERE = ("jax", "jaxlib", "echopype_tpu")


def _imports(path):
    """(top-level package, line, at module level) of every absolute import."""
    tree = ast.parse(path.read_text(), filename=str(path))
    top = {id(node) for node in tree.body}
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0], node.lineno, id(node) in top
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0], node.lineno, id(node) in top


def test_sources_never_import_jax_or_pandas():
    """No module of the port, and not chip_smoke.py, imports jax, jaxlib or
    echopype_tpu anywhere, or pandas at module level (the card's machine has
    none of them; xrlite reaches pandas only inside its pandas-export helpers)."""
    offenders = [
        f"{p.relative_to(REPO)}:{line} {root}"
        for p in [*sorted((REPO / "echopype_torch").rglob("*.py")), REPO / "chip_smoke.py"]
        for root, line, at_top in _imports(p)
        if root in REFUSED_EVERYWHERE or (root == "pandas" and at_top)
    ]
    assert offenders == []


def test_import_scan_sees_nested_imports(tmp_path):
    src = tmp_path / "m.py"
    src.write_text("import pandas\n\ndef f():\n    from echopype_tpu.xrlite import Dataset\n"
                   "    import jax.numpy\n")
    assert sorted(_imports(src)) == [("echopype_tpu", 4, False), ("jax", 5, False),
                                     ("pandas", 1, True)]


def test_scan_covers_the_cruise_modules():
    """The scan's file list reaches the modules the cruise path added."""
    scanned = {p.relative_to(REPO / "echopype_torch").as_posix()
               for p in (REPO / "echopype_torch").rglob("*.py")}
    assert {"echodata/combine.py", "qc/api.py", "metrics/summary_statistics.py",
            "colormap/cm.py", "xrlite/datatree.py", "xrlite/xarray_compat.py",
            "utils/profiling.py"} <= scanned
