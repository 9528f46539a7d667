"""Port parity: the EK80 matched filter (``ops/matched_filter.py``).

The port's blocked-Toeplitz product (one ``torch.matmul``, here on the CPU)
in float32, as the fused survey step runs it, against the JAX package's
``_mxu_conv_real`` (its einsum at ``Precision.HIGHEST`` on the JAX CPU
backend) and against the exact float64 convolution (``_host_conv_f64`` /
``np.convolve``), on inputs made from a seed: replica lengths L in {1, 2,
64, 193, 260, 500}, the output window starting before, at and past L - 1,
and block sizes T set by hand.  Tolerance: max |error| / max |exact| < 2e-6
(the JAX package's own bound for its product,
tests/test_calibrate_ek80.py:308); ``pulse_compress_channel``'s device path
(float32 samples, float64 product) is held to the same bound against the
JAX package's float32 path and to 1e-12 against the float64 one.  The float64 host path
is bit-identical to the JAX package's.  The structural-zero tail (outputs
that touch only the replica's exact-zero leading taps) is exactly 0, and
NaN samples come back NaN.
"""

import numpy as np
import pytest
import torch

from echopype_torch.ops import matched_filter as tmf
from echopype_tpu.ops import matched_filter as jmf

torch.set_num_threads(1)

LENGTHS = [1, 2, 64, 193, 260, 500]


def _lanes(seed, lanes, R, L):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(lanes, R)) + 1j * rng.normal(size=(lanes, R))
    h = rng.normal(size=L) + 1j * rng.normal(size=L)
    return x, h


def _f4(a):
    return np.ascontiguousarray(a, dtype="f4")


def _port(x, h, out_start, out_len, block_t=0):
    t = [torch.from_numpy(_f4(a)) for a in (x.real, x.imag, h.real, h.imag)]
    re, im = tmf._toeplitz_conv(*t, out_start, out_len, block_t=block_t)
    return re.numpy().astype("f8") + 1j * im.numpy()


def _jax(x, h, out_start, out_len, block_t=0):
    re, im = jmf._mxu_conv_real(_f4(x.real), _f4(x.imag), _f4(h.real), _f4(h.imag),
                                out_start, out_len, block_t=block_t)
    return np.asarray(re).astype("f8") + 1j * np.asarray(im)


def _exact(x, h, out_start, out_len):
    full = np.stack([np.convolve(row, h) for row in x])
    full = np.pad(full, ((0, 0), (0, max(0, out_start + out_len - full.shape[1]))))
    return full[:, out_start : out_start + out_len]


@pytest.mark.parametrize("L", LENGTHS)
@pytest.mark.parametrize("where", ["before", "at", "past"])
def test_toeplitz_matches_jax_and_exact(L, where):
    R = 300
    x, h = _lanes(L, 5, R, L)
    out_start = {"before": max(0, L - 1 - 17), "at": L - 1, "past": L - 1 + 23}[where]
    got = _port(x, h, out_start, R)
    want = _exact(x, h, out_start, R)
    scale = np.abs(want).max()
    assert np.abs(got - want).max() / scale < 2e-6
    assert np.abs(got - _jax(x, h, out_start, R)).max() / scale < 2e-6


@pytest.mark.parametrize("L,block_t", [(64, 256), (260, 128), (260, 384), (500, 512)])
def test_block_size_override(L, block_t):
    R = 1000
    x, h = _lanes(7 * L, 3, R, L)
    want = _exact(x, h, L - 1, R)
    got = _port(x, h, L - 1, R, block_t=block_t)
    scale = np.abs(want).max()
    assert np.abs(got - want).max() / scale < 2e-6
    assert np.abs(got - _jax(x, h, L - 1, R, block_t=block_t)).max() / scale < 2e-6


@pytest.mark.parametrize("L", LENGTHS)
def test_host_f64_bit_identical_to_jax(L):
    x, h = _lanes(L + 1, 4, 120, L)
    rep = np.flipud(np.conj(h))
    np.testing.assert_array_equal(tmf._host_conv_f64(x, rep), jmf._host_conv_f64(x, rep))


def _bs(seed, P=4, R=150, B=3):
    rng = np.random.default_rng(seed)
    bs = (rng.normal(0, 1e-3, (P, R, B)) + 1j * rng.normal(0, 1e-3, (P, R, B)))
    bs[1, 120:, :] = np.nan  # a ragged ping
    bs[2, 40, 1] = np.nan + 0j  # an interior NaN
    return bs


@pytest.mark.parametrize("L", [25, 64, 193])
def test_pulse_compress_channel_matches_jax(L):
    bs = _bs(L)
    rng = np.random.default_rng(L)
    rep = rng.normal(size=L) + 1j * rng.normal(size=L)
    f64 = tmf.pulse_compress_channel(bs, rep, precision="float64")
    np.testing.assert_array_equal(f64, jmf.pulse_compress_channel(bs, rep, precision="float64"))
    f32 = tmf.pulse_compress_channel(bs, rep, precision="float32", device="cpu")
    want = jmf.pulse_compress_channel(bs, rep, precision="float32")
    np.testing.assert_array_equal(np.isnan(f32), np.isnan(want))
    ok = ~np.isnan(f64)
    scale = np.abs(f64[ok]).max()
    assert np.abs(f32[ok] - want[ok]).max() / scale < 2e-6
    # the samples ship as float32: exact on float32 data, as in EK80 files
    bs32 = bs.astype("c8").astype("c16")
    got = tmf.pulse_compress_channel(bs32, rep, precision="float32", device="cpu")
    exact = tmf.pulse_compress_channel(bs32, rep, precision="float64")
    assert np.abs(got[ok] - exact[ok]).max() / scale < 1e-12


def test_structural_zero_tail_and_nans():
    """A replica with z exact-zero leading taps: the last z outputs of every
    lane are exactly 0 in float32 too, and NaN samples are restored."""
    rng = np.random.default_rng(3)
    L, z = 40, 3
    rep = rng.normal(size=L) + 1j * rng.normal(size=L)
    rep[:z] = 0.0
    bs = _bs(5, R=90)
    out = tmf.pulse_compress_channel(bs, rep, precision="float32", device="cpu")
    nan_mask = np.isnan(bs.real) | np.isnan(bs.imag)
    np.testing.assert_array_equal(np.isnan(out), nan_mask)
    tail = out[:, -z:, :][~nan_mask[:, -z:, :]]
    assert tail.size and np.all(tail == 0)
    assert np.all(out[0, : -z][~nan_mask[0, : -z]] != 0)
    f64 = tmf.pulse_compress_channel(bs, rep, precision="float64")
    np.testing.assert_array_equal(out[:, -z:] == 0, f64[:, -z:] == 0)
    assert tmf._leading_zeros(rep) == z and tmf._leading_zeros(np.zeros(4)) == 4


def test_tf32_off_inside_the_call(monkeypatch):
    """The matmul runs with TF32 off, at the float32 matmul precision
    "highest" when the caller left it at its default; a caller's TF32
    setting comes back afterwards."""
    seen = []
    real = torch.matmul

    def spy(*a, **k):
        seen.append((torch.backends.cuda.matmul.allow_tf32,
                     torch.get_float32_matmul_precision()))
        return real(*a, **k)

    monkeypatch.setattr(torch, "matmul", spy)
    x, h = _lanes(1, 2, 64, 9)
    _port(x, h, 8, 64)
    assert seen == [(False, "highest")]
    saved = torch.backends.cuda.matmul.allow_tf32
    try:
        torch.backends.cuda.matmul.allow_tf32 = True
        _port(x, h, 8, 64)
        assert torch.backends.cuda.matmul.allow_tf32 is True
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved
    assert seen[1][0] is False


def test_conv_precision_knob(monkeypatch):
    """The JAX package's three precisions, in any case, are stored by name
    (``None`` is HIGHEST); any other value is refused and leaves the setting
    as it was."""
    monkeypatch.setattr(tmf, "_CONV_PRECISION", tmf._CONV_PRECISION)  # restored afterwards
    for given, stored in (("HIGHEST", "HIGHEST"), ("highest", "HIGHEST"), ("HIGH", "HIGH"),
                          ("default", "DEFAULT"), (None, "HIGHEST"), ("High", "HIGH")):
        tmf.set_conv_precision(given)
        assert tmf._CONV_PRECISION == stored
    with pytest.raises(ValueError):
        tmf.set_conv_precision("FASTEST")
    assert tmf._CONV_PRECISION == "HIGH"


def test_batched_matches_per_channel():
    bs = {"a": _bs(1), "b": _bs(2)}
    reps = {"a": np.arange(1, 6) + 0.5j, "b": np.arange(1, 9) - 0.25j}
    got = tmf.compress_pulse_batched(bs, reps)
    want = jmf.compress_pulse_batched(bs, reps)
    for ch in bs:
        np.testing.assert_array_equal(got[ch], want[ch])


def test_counts_only_device_launches():
    tmf.reset_launches()
    _port(*_lanes(2, 2, 50, 5), 4, 50)
    assert tmf.LAUNCHES == {"toeplitz_matmul": 0}
