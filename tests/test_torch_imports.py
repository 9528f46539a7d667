"""The port must run where neither jax, pandas nor the JAX package is installed.

A subprocess refuses ``jax``, ``jaxlib``, ``pandas`` and ``echopype_tpu``
from a ``sys.meta_path`` finder, imports echopype_torch and runs the
raw->MVBS survey, ``open_raw`` -> ``compute_Sv`` -> ``compute_MVBS`` /
``compute_MVBS_index_binning``, the fused survey step, and
``consolidate.add_location`` / ``add_depth`` -> ``run_survey_mvbs`` /
``run_survey_nasc``, EK80: ``open_raw`` -> BB ``compute_Sv`` and the
fused BB survey (``device_fused=True``), and the masks: ``clean.mask_*``,
``mask.frequency_differencing`` -> ``apply_mask``, and the survey
streamers with ``freq_diff`` and ``noise_masks``, on the CPU; none of the
four may be loaded afterwards.
An AST scan holds the package's sources and ``chip_smoke.py`` to the same
rule, including imports inside functions.
"""

import ast
import subprocess
import sys
import textwrap
from pathlib import Path

import torch

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent

_SCRIPT = textwrap.dedent(
    """
    import importlib.abc
    import sys

    BLOCKED = ("jax", "jaxlib", "pandas", "echopype_tpu")

    class Refuse(importlib.abc.MetaPathFinder):
        def find_spec(self, name, path=None, target=None):
            if name.split(".")[0] in BLOCKED:
                raise ModuleNotFoundError(f"refused in this test: {name}")
            return None

    sys.meta_path.insert(0, Refuse())
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
    loaded = sorted(m for m in sys.modules if m.split(".")[0] in BLOCKED)
    print("LOADED", loaded)
    """
)


def test_port_runs_without_jax_or_pandas(tmp_path):
    res = subprocess.run(
        [sys.executable, "-c", _SCRIPT, str(REPO), str(tmp_path / "g-D20200101-T000000.raw")],
        capture_output=True, text=True, timeout=300, cwd=tmp_path,
    )
    assert res.returncode == 0, res.stderr[-4000:]
    assert "LOADED []" in res.stdout


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
