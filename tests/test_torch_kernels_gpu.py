"""The CUDA window kernels (K1 / K2) against their plain PyTorch twins, on
the card.

Needs a CUDA device and nvcc; marked ``gpu`` and skipped elsewhere.  This
file imports neither jax nor the JAX package, so it also runs where JAX is
not installed:

    python -m pytest --noconftest -m gpu tests/test_torch_kernels_gpu.py -q

(``--noconftest`` skips tests/conftest.py, which sets up JAX.)  Small
shapes with the edge cases the survey produces: empty window bins, pings
parked past the window, short and zero valid lengths, a first valid sample
past bin edges.  Counts exact, sums within rtol 1e-5 (float32 sums in
another order), reruns bit-identical, one launch counted per call.
"""

import numpy as np
import pytest
import torch

from echopype_torch.ops import window_partials as wp
from echopype_torch.parallel.pipeline import kernel_inputs_from_numpy

pytestmark = pytest.mark.gpu

torch.set_num_threads(1)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _chunk(seed, C=3, P=300, R=700, W=9, vary_dr=False):
    rng = np.random.default_rng(seed)
    power = rng.integers(-12000, -2000, (C, P, R)).astype(np.int16)
    dr = np.tile(rng.uniform(0.15, 0.25, (C, 1)), (1, P)).astype("f4")
    if vary_dr:
        dr = (dr * rng.uniform(0.97, 1.03, (C, P))).astype("f4")
    shift = (dr * rng.integers(0, 12, (C, 1))).astype("f4")
    ab = rng.uniform(0.001, 0.05, (C, P)).astype("f4")
    off = rng.normal(-30, 2, (C, P)).astype("f4")
    vl = np.full((C, P), R, "i4")
    vl[:, ::11] = rng.integers(0, R, vl[:, ::11].shape)
    vl[:, ::29] = 0
    ids = np.sort(rng.integers(0, W - 2, P))  # the last window bins stay empty
    ids[-15:] = W  # parked padding
    edges = np.arange(0, 0.25 * R + 7.0, 7.0).astype("f4")
    return power, dr, shift, ab, off, vl, ids.astype("i4"), edges, W


def _compare(kernel, plain, counted, ops):
    wp.reset_launches()
    got = kernel(**ops)
    again = kernel(**ops)
    torch.cuda.synchronize()
    assert wp.LAUNCHES[counted] == 2
    want = plain(**ops)
    for g, a in zip(got, again):
        assert torch.equal(g, a), "rerun not bit-identical"
    s_g, c_g = (t.cpu().numpy() for t in got)
    s_w, c_w = (t.cpu().numpy() for t in want)
    np.testing.assert_array_equal(c_g, c_w)
    np.testing.assert_allclose(s_g, s_w, rtol=1e-5, atol=1e-30)
    assert (c_g > 0).any() and (c_g == 0).any()


@pytest.mark.parametrize("seed", [0, 1])
def test_k1_matches_plain(cuda, seed):
    args = _chunk(seed)
    ops = kernel_inputs_from_numpy(*args, uniform=True, device=cuda)
    _compare(wp.window_partials_uniform, wp.window_partials_uniform_plain,
             "window_partials_uniform", ops)
    sums_only = wp.window_partials_uniform(**ops, with_counts=False)
    assert torch.equal(sums_only, wp.window_partials_uniform(**ops)[0])


@pytest.mark.parametrize("seed", [0, 1])
def test_k2_matches_plain(cuda, seed):
    args = _chunk(seed, vary_dr=True)
    ops = kernel_inputs_from_numpy(*args, uniform=False, device=cuda)
    _compare(wp.window_partials, wp.window_partials_plain, "window_partials", ops)


def test_cuda_and_cpu_dispatch_agree(cuda):
    args = _chunk(5)
    on_card = wp.window_partials_uniform(**kernel_inputs_from_numpy(*args, uniform=True,
                                                                    device=cuda))
    on_cpu = wp.window_partials_uniform(**kernel_inputs_from_numpy(*args, uniform=True,
                                                                   device="cpu"))
    np.testing.assert_array_equal(on_card[1].cpu().numpy(), on_cpu[1].numpy())
    np.testing.assert_allclose(on_card[0].cpu().numpy(), on_cpu[0].numpy(), rtol=1e-5)


def test_wrapper_rejects_bad_operands(cuda):
    ops = kernel_inputs_from_numpy(*_chunk(2), uniform=True, device=cuda)
    wp.reset_launches()
    with pytest.raises(TypeError, match="int16"):
        wp.window_partials_uniform(**{**ops, "power": ops["power"].float()})
    with pytest.raises(ValueError, match="contiguous"):
        wp.window_partials_uniform(**{**ops, "power": ops["power"].transpose(1, 2)
                                      .contiguous().transpose(1, 2)})
    with pytest.raises(ValueError, match="is on cpu"):
        wp.window_partials_uniform(**{**ops, "xb": ops["xb"].cpu()})
    assert wp.LAUNCHES["window_partials_uniform"] == 0
