"""A run with the timed path broken underneath comes out not correct.

Each cell's run is driven on the CPU at a tiny size (the harness's look for
a card skipped), once for each fault the cell can have: a step that leaves
its state unchanged, half of the batch left out with the mean taken over
the rest, and an answer altered where it is produced.  (The cells run on
one chip: there is no exchange between chips to leave out.)
"""

import io

import numpy as np
import pytest
from tiny import tiny_bench

import echopype_torch.commongrid.api as cg_api
import echopype_torch.calibrate.api as cal_api
import echopype_torch.parallel.pipeline as pipeline
import echopype_torch.parallel.survey as survey
from bench_port.harness import main


def _survey_state_unchanged(mp):
    mp.setattr(survey._PartialAccumulator, "push", lambda self, *item, ch=None: None)


def _survey_half_batch(mp):
    orig = survey._PowerChunkStreamer.stream_file

    def half(self, power, *a, **kw):
        power = np.array(power, copy=True)
        power[:, 1::2] = np.nan  # every other ping: valid length 0, left out of the means
        return orig(self, power, *a, **kw)

    mp.setattr(survey._PowerChunkStreamer, "stream_file", half)


def _survey_answer_altered(mp):
    for name in ("window_partials_uniform", "window_partials"):
        orig = getattr(pipeline, name)

        def altered(*a, _orig=orig, **kw):
            out = _orig(*a, **kw)
            sums = out[0] if isinstance(out, tuple) else out
            sums[0, 0, 1] *= 1.1  # one bin's sum, 0.41 dB
            return out

        mp.setattr(pipeline, name, altered)


def _chain_state_unchanged(mp):
    orig = cg_api.binning.windowed_partials_np

    def unchanged(*a, **kw):
        sums, counts, nan = orig(*a, **kw)
        return np.zeros_like(sums), counts, nan

    mp.setattr(cg_api.binning, "windowed_partials_np", unchanged)


def _chain_half_batch(mp):
    orig = cg_api.binning.windowed_partials_np

    def half(sv, *a, **kw):
        sv = np.array(sv, copy=True)
        sv[:, 1::2] = np.nan  # every other ping skipped by the NaN-skipping mean
        return orig(sv, *a, **kw)

    mp.setattr(cg_api.binning, "windowed_partials_np", half)


def _chain_answer_altered(mp):
    orig = cal_api.compute_Sv

    def altered(*a, **kw):
        ds = orig(*a, **kw)
        ds["Sv"].values[0, 0, 100] += 1.0  # one sample, 1 dB
        return ds

    mp.setattr(cal_api, "compute_Sv", altered)
    import echopype_torch.calibrate as cal
    mp.setattr(cal, "compute_Sv", altered)


FAULTS = {
    "ek60_survey": [_survey_state_unchanged, _survey_half_batch, _survey_answer_altered],
    "azfp_ooi_survey": [_survey_state_unchanged, _survey_half_batch, _survey_answer_altered],
    "ek60_sv_chain": [_chain_state_unchanged, _chain_half_batch, _chain_answer_altered],
}


@pytest.mark.parametrize("cell,fault", [(c, f) for c, fs in FAULTS.items() for f in fs],
                         ids=lambda v: getattr(v, "__name__", v))
def test_broken_timed_path_is_not_correct(tmp_path, monkeypatch, cell, fault):
    bench = tiny_bench(tmp_path)
    fault(monkeypatch)
    res = main(["--workload", cell, "--seed", "2147483661", "--seconds", "0.2"],
               device="cpu", bench_dir=bench, out=io.StringIO())
    assert res["correct"] is False, res["checks"]
    assert "calls_failed" not in res["checks"]  # caught by the comparison, not a crash
    assert any(c["value"] > c["limit"] for c in res["checks"].values())


@pytest.mark.parametrize("cell", sorted(FAULTS))
def test_unbroken_run_is_correct(tmp_path, cell):
    res = main(["--workload", cell, "--seed", "2147483661", "--seconds", "0.2"],
               device="cpu", bench_dir=tiny_bench(tmp_path), out=io.StringIO())
    assert res["correct"] is True, res["checks"]
