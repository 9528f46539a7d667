"""Port parity: the matched filter's reduced precisions ("HIGH", "DEFAULT").

The JAX package's ``set_conv_precision`` and the ``precision`` of its fused
BB step take ``"HIGH"`` (the TPU's three-pass bf16 product) and
``"DEFAULT"`` (one bf16 pass).  The port computes them as bf16 split
products with float32 accumulation (``ops/matched_filter.py``); on the CPU
its plain version, the same bf16 parts upcast in one float32 matmul.  XLA's
CPU backend ignores the precision (HIGH, DEFAULT and HIGHEST give the same
bits there), so the port is held:

* to a float64 numpy oracle of the same bf16 terms (the bf16 rounding done
  here by bit arithmetic, independent of torch): max |error| / max |exact|
  < 2e-6 (float32 sums in another order; the JAX package's bound for its
  product, tests/test_calibrate_ek80.py:308), for L in {1, 12, 258},
  block sizes set by hand and the output window before, at and past L - 1;
* to the JAX package's documented budget for HIGH
  (echopype_tpu/ops/matched_filter.py:25-29): within 0.004 dB of its
  float64 matched filter for samples within 40 dB of the peak and 0.02 dB
  within 60 dB, and within the same of the JAX package run under its own
  ``set_conv_precision("HIGH")``; the fused step's Sv the same way and its
  bins (counts exact, bin means within 0.004 dB); compute_Sv BB end to end
  on a synthetic EK80 file the same way, on Sv within 40 / 60 dB of the
  channel's peak.

``"HIGHEST"`` keeps the parent's form bit for bit: one matmul of the
blocked operands in their dtype.  The precision names are parsed without
jax (``jax.lax.Precision`` objects by their names), ``bb_chunk_*`` never
touch compute_Sv's setting, and no TF32 runs on any route.
"""

import numpy as np
import pytest
import torch
from jax import lax

import echopype_torch as et
import echopype_tpu as ep
from echopype_torch.calibrate import ek80_complex as ekc
from echopype_torch.ops import bb_pipeline as tbb
from echopype_torch.ops import matched_filter as tmf
from echopype_tpu.ops import bb_pipeline as jbb
from echopype_tpu.ops import matched_filter as jmf
from synth_ek80 import write_ek80_raw

torch.set_num_threads(1)

REL = 2e-6  # of the output's largest magnitude
HIGH_DB = {40: 0.004, 60: 0.02}  # echopype_tpu/ops/matched_filter.py:25-29


@pytest.fixture
def conv_precision(monkeypatch):
    """Both packages' compute_Sv precision, restored after the test."""
    monkeypatch.setattr(tmf, "_CONV_PRECISION", tmf._CONV_PRECISION)
    monkeypatch.setattr(jmf, "_CONV_PRECISION", jmf._CONV_PRECISION)


def _bf16(a):
    """float32 -> the nearest bfloat16 (ties to even), as float64."""
    u = np.ascontiguousarray(a, dtype="f4").view("u4").astype("u8")
    u = (u + 0x7FFF + ((u >> 16) & 1)) & 0xFFFF0000
    return u.astype("u4").view("f4").astype("f8")


def _parts(z):
    """(hi, lo) complex bf16 parts of complex ``z`` taken as float32."""
    hi = _bf16(z.real) + 1j * _bf16(z.imag)
    lo = (_bf16(np.float32(z.real) - hi.real) + 1j * _bf16(np.float32(z.imag) - hi.imag))
    return hi, lo


def _conv(x, h, out_start, out_len):
    full = np.stack([np.convolve(row, h) for row in x])
    full = np.pad(full, ((0, 0), (0, max(0, out_start + out_len - full.shape[1]))))
    return full[:, out_start : out_start + out_len]


def _oracle(x, h, out_start, out_len, precision):
    """The split terms in float64: HIGH lo·Hhi + hi·Hlo + hi·Hhi, DEFAULT hi·Hhi."""
    (xh, xl), (hh, hl) = _parts(x), _parts(h)
    y = _conv(xh, hh, out_start, out_len)
    if precision == "HIGH":
        y = y + _conv(xh, hl, out_start, out_len) + _conv(xl, hh, out_start, out_len)
    return y


def _f4(a):
    return np.ascontiguousarray(a, dtype="f4")


def _port(x, h, out_start, out_len, precision, block_t=0):
    t = [torch.from_numpy(_f4(a)) for a in (x.real, x.imag, h.real, h.imag)]
    re, im = tmf._toeplitz_conv(*t, out_start, out_len, block_t=block_t, precision=precision)
    assert re.dtype == im.dtype == torch.float32
    return re.numpy().astype("f8") + 1j * im.numpy()


def _lanes(seed, lanes, R, L):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(lanes, R)) + 1j * rng.normal(size=(lanes, R))
    h = rng.normal(size=L) + 1j * rng.normal(size=L)
    return x, h


@pytest.mark.parametrize("precision", ["HIGH", "DEFAULT"])
@pytest.mark.parametrize("L,block_t,where", [
    (1, 0, "at"), (12, 0, "at"), (258, 0, "at"), (12, 256, "before"), (258, 0, "past"),
    (258, 128, "at"), (258, 384, "before"), (258, 512, "past"),
])
def test_split_terms_match_f64_oracle(precision, L, block_t, where):
    R = 700
    x, h = _lanes(10 * L + block_t, 4, R, L)
    out_start = {"before": max(0, L - 1 - 17), "at": L - 1, "past": L - 1 + 23}[where]
    got = _port(x, h, out_start, R, precision, block_t=block_t)
    want = _oracle(x, h, out_start, R, precision)
    assert np.abs(got - want).max() / np.abs(want).max() < REL


def test_reduced_precisions_are_not_highest():
    """HIGH lies between DEFAULT and the float32 product: each is its own
    arithmetic, not a renamed HIGHEST."""
    x, h = _lanes(5, 3, 500, 64)
    exact = _conv(x.astype("c8").astype("c16"), h.astype("c8").astype("c16"), 63, 500)
    err = {p: np.abs(_port(x, h, 63, 500, p) - exact).max() / np.abs(exact).max()
           for p in ("HIGHEST", "HIGH", "DEFAULT")}
    assert err["HIGHEST"] < err["HIGH"] < err["DEFAULT"]
    assert err["DEFAULT"] > 1e-3 and err["HIGH"] < 1e-4


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_highest_is_the_parents_form_bit_for_bit(dtype):
    """HIGHEST (given, or by default) is one matmul of the blocked operands,
    built here by explicit indexing, in the inputs' dtype."""
    L, R, T = 40, 300, 128
    x, h = _lanes(2, 3, R, L)
    t = [torch.from_numpy(np.ascontiguousarray(a)).to(dtype)
         for a in (x.real, x.imag, h.real, h.imag)]
    K, nblk = T + L - 1, -(-R // T)
    xp = np.pad(x, ((0, 0), (0, nblk * T + L - 1 - R)))
    X = np.stack([xp[:, b * T : b * T + K] for b in range(nblk)], axis=1)
    X = np.concatenate([X.real, X.imag], axis=-1)
    k, j = np.arange(K)[:, None], np.arange(T)[None, :]
    band = (k - j >= 0) & (k - j < L)
    hf = h[::-1]
    H = np.where(band, hf[np.clip(k - j, 0, L - 1)], 0)
    Hc = np.block([[H.real, H.imag], [-H.imag, H.real]])
    Y = torch.matmul(torch.from_numpy(X).to(dtype), torch.from_numpy(Hc).to(dtype))
    want = (Y[:, :, :T].reshape(3, -1)[:, :R], Y[:, :, T:].reshape(3, -1)[:, :R])
    for got in (tmf._toeplitz_conv(*t, L - 1, R),
                tmf._toeplitz_conv(*t, L - 1, R, precision="HIGHEST")):
        for g, w in zip(got, want):
            assert g.dtype == dtype and torch.equal(g, w)


def test_no_tf32_on_the_split_product(monkeypatch):
    """The plain version's float32 matmul runs with TF32 off, at the float32
    matmul precision "highest"; a caller's TF32 setting comes back."""
    seen = []
    real = torch.matmul

    def spy(a, b, *rest, **kw):
        seen.append((a.dtype, torch.backends.cuda.matmul.allow_tf32,
                     torch.get_float32_matmul_precision()))
        return real(a, b, *rest, **kw)

    monkeypatch.setattr(torch, "matmul", spy)
    x, h = _lanes(1, 2, 64, 9)
    saved = torch.backends.cuda.matmul.allow_tf32
    try:
        torch.backends.cuda.matmul.allow_tf32 = True
        for p in ("HIGH", "DEFAULT"):
            _port(x, h, 8, 64, p)
        assert torch.backends.cuda.matmul.allow_tf32 is True
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved
    assert seen == [(torch.float32, False, "highest")] * 2


# ------------------------------------------------------- parsing and setting
def test_jax_precision_objects_by_name(conv_precision):
    for obj, name in ((lax.Precision.HIGH, "HIGH"), (lax.Precision.DEFAULT, "DEFAULT"),
                      (lax.Precision.HIGHEST, "HIGHEST")):
        assert tmf._parse_precision(obj) == name
        tmf.set_conv_precision(obj)
        assert tmf._CONV_PRECISION == name
    for bad in ("FASTEST", "float32", "bfloat16", 3):
        with pytest.raises(ValueError):
            tmf._parse_precision(bad)


def _bb_replica():
    """The synthetic BB channel's transmit replica (tests/synth_ek80.py:
    50-90 kHz, 1.024 ms, fs 1.5 MHz; L = 258 with one zero leading tap)."""
    y, _ = ekc.tapered_chirp(1500000, 1.024e-3, 0.0078125, 50000.0, 90000.0)
    coeff = {"wbt_fil": np.full(4, 0.25, dtype="c8"), "pc_fil": np.full(2, 0.5, dtype="c8"),
             "wbt_decifac": 6, "pc_decifac": 1}
    return ekc.filter_decimate_chirp(coeff, y, 1500000.0)[0]


def _bs(seed, P=6, R=1200, B=4):
    """Noise as in the synthetic EK80 files, with a ragged ping, an interior
    NaN and one strong echo (the replica itself) for a deep dynamic range."""
    rng = np.random.default_rng(seed)
    bs = rng.normal(0, 1e-3, (P, R, B)) + 1j * rng.normal(0, 1e-3, (P, R, B))
    rep = _bb_replica()
    bs[2, R // 3 : R // 3 + len(rep), :] += 0.5 * rep[:, None]
    bs[1, R * 5 // 6 :, :] = np.nan
    bs[-1, 40, 1] = np.nan
    return bs.astype("c8").astype("c16")


def _within_db(got, want, level):
    """Max |dB| difference of ``got`` from ``want`` over the samples whose
    ``level`` (dB) lies within 40 and within 60 dB of its peak."""
    ok = np.isfinite(level)
    peak = level[ok].max()
    with np.errstate(invalid="ignore"):  # -inf - -inf at exact zeros, never selected
        err = np.abs(got - want)
    return {db: float(err[ok & (level >= peak - db)].max()) for db in (40, 60)}


def _db(z):
    with np.errstate(divide="ignore"):
        return 10 * np.log10(np.abs(z) ** 2)


def test_pulse_compress_channel_high_within_jax_budget(conv_precision):
    bs, rep = _bs(1), _bb_replica()
    exact = jmf.pulse_compress_channel(bs, rep, precision="float64")
    tmf.set_conv_precision("HIGH")
    got = tmf.pulse_compress_channel(bs, rep, precision="float32", device="cpu")
    jmf.set_conv_precision("HIGH")
    jax_high = jmf.pulse_compress_channel(bs, rep, precision="float32")
    np.testing.assert_array_equal(np.isnan(got), np.isnan(exact))
    z = tmf._leading_zeros(rep)
    assert z == 1 and np.all(got[:, -z:][~np.isnan(got[:, -z:])] == 0)
    level = _db(exact)
    assert level[np.isfinite(level)].max() - np.nanmedian(level) > 60  # the echo's range
    for want in (exact, jax_high):
        err = _within_db(_db(got), _db(want), level)
        assert err[40] <= HIGH_DB[40] and err[60] <= HIGH_DB[60], err
    # the default precision is untouched by the other package's setting
    tmf.set_conv_precision("HIGHEST")
    highest = tmf.pulse_compress_channel(bs, rep, precision="float32", device="cpu")
    assert not np.array_equal(highest, got)
    ok = ~np.isnan(exact)
    assert np.abs(highest[ok] - exact[ok]).max() / np.abs(exact[ok]).max() < 1e-12


def test_pulse_compress_channel_default_is_its_oracle(conv_precision):
    """DEFAULT through the entry point: float32 samples and replica, the one
    bf16 term, NaNs restored."""
    bs, rep = _bs(2, P=3, R=600), _bb_replica()
    tmf.set_conv_precision(lax.Precision.DEFAULT)
    got = tmf.pulse_compress_channel(bs, rep, precision="float32", device="cpu")
    nan = np.isnan(bs.real) | np.isnan(bs.imag)
    np.testing.assert_array_equal(np.isnan(got), nan)
    lanes = np.where(nan, 0, bs).transpose(0, 2, 1).reshape(-1, 600)
    h = np.flipud(np.conj(rep))
    want = _oracle(lanes, h, len(h) - 1, 600, "DEFAULT")
    want[:, -tmf._leading_zeros(rep):] = 0
    want = want.reshape(3, 4, 600).transpose(0, 2, 1)
    assert np.abs(got[~nan] - want[~nan]).max() / np.abs(want).max() < REL


# -------------------------------------------------------------- fused BB step
def _chunk(seed, P=8, R=1200, B=4):
    bs = _bs(seed, P, R, B).astype("c8")
    h = np.flipud(np.conj(_bb_replica()))
    rng = np.random.default_rng(seed)
    dr = np.full(P, 0.0118, "f4")
    shift = np.full(P, 0.379, "f4")
    k0 = np.maximum(np.floor(shift.astype("f8") / dr) + 1, 0).astype("i4")
    vl = (~np.isnan(bs.real[..., 0])).sum(axis=1).astype("i4")
    return (np.ascontiguousarray(bs.real), np.ascontiguousarray(bs.imag),
            np.ascontiguousarray(h.real, "f4"), np.ascontiguousarray(h.imag, "f4"),
            np.float32(1 / np.linalg.norm(h) ** 2), rng.uniform(0.1, 0.2, P).astype("f4"),
            dr, shift, np.full(P, 0.02, "f4"), rng.normal(-20, 1, P).astype("f4"), k0, vl)


@pytest.mark.parametrize("jax_precision", [None, lax.Precision.HIGH], ids=["HIGHEST", "HIGH"])
def test_bb_chunk_sv_high_within_jax_budget(conv_precision, jax_precision):
    """The fused step's Sv under HIGH against the JAX step (float32 on its
    CPU, at HIGHEST or HIGH alike) within the budget, on Sv within 40 / 60
    dB of the peak; compute_Sv's setting stays as it was."""
    ops = _chunk(3)
    tmf.set_conv_precision("DEFAULT")
    sv, er = tbb.bb_chunk_sv(*ops, True, "HIGH", device="cpu")
    assert tmf._CONV_PRECISION == "DEFAULT"
    sv_j, er_j = jbb.bb_chunk_sv(*ops, True, jax_precision)
    sv, sv_j = sv.numpy().astype("f8"), np.asarray(sv_j, dtype="f8")
    np.testing.assert_array_equal(np.isnan(sv), np.isnan(sv_j))
    np.testing.assert_array_equal(er.numpy(), np.asarray(er_j))
    err = _within_db(sv, sv_j, sv_j)
    assert err[40] <= HIGH_DB[40] and err[60] <= HIGH_DB[60], err
    same = tbb.bb_chunk_sv(*ops, True, lax.Precision.HIGH, device="cpu")[0]
    assert torch.equal(torch.from_numpy(sv.astype("f4")).isnan(), same.isnan())
    np.testing.assert_array_equal(same.numpy(), sv.astype("f4"))


@pytest.mark.parametrize("uniform_er", [True, False])
def test_bb_chunk_window_partials_high_within_jax_budget(conv_precision, uniform_er):
    """Bins of the fused step under HIGH: counts equal the JAX step's, bin
    means within 0.004 dB (a bin's mean is a weighted mean of its samples,
    dominated by those within 40 dB of the peak) of the port's HIGHEST bins
    and, on the uniform grid, of the JAX step's.  On a grid that varies by
    ping the JAX step's float32 prefix sums lose a quiet bin after the echo
    by dB (ROADMAP Queue 3), so there the port's HIGHEST bins, held to the
    JAX package in test_torch_survey_ek80.py, are the reference.
    compute_Sv's setting stays as it was, whatever the call's precision."""
    ops = _chunk(4)
    x_rel = (np.arange(8) // 3).astype("i4")
    r_edges = np.arange(0, 1200 * 0.0118 + 1.0, 1.0).astype("f4")
    tmf.set_conv_precision("HIGHEST")
    args = (*ops, x_rel, r_edges, 3, True)
    s, c = tbb.bb_chunk_window_partials(*args, "HIGH", uniform_er=uniform_er, device="cpu")
    assert tmf._CONV_PRECISION == "HIGHEST"
    s_0, c_0 = tbb.bb_chunk_window_partials(*args, uniform_er=uniform_er, device="cpu")
    s_j, c_j = jbb.bb_chunk_window_partials(*args, lax.Precision.HIGH, uniform_er=uniform_er)
    c = c.numpy()
    np.testing.assert_array_equal(c, np.asarray(c_j))
    np.testing.assert_array_equal(c, c_0.numpy())
    full = c > 0
    assert full.sum() > 20

    def mean_db(sums):
        return 10 * np.log10(np.asarray(sums, dtype="f8")[full] / c[full])

    refs = [s_0.numpy()] + ([s_j] if uniform_er else [])
    for ref in refs:
        assert np.abs(mean_db(s.numpy()) - mean_db(ref)).max() <= HIGH_DB[40]
    tmf.set_conv_precision("HIGH")
    tbb.bb_chunk_window_partials(*args, "DEFAULT", device="cpu")
    tbb.bb_chunk_sv(*ops, True, None, device="cpu")
    assert tmf._CONV_PRECISION == "HIGH"


# ------------------------------------------------------------ the whole slice
def test_compute_sv_bb_high_within_jax_budget(conv_precision, tmp_path):
    """open_raw -> compute_Sv BB under HIGH against the JAX package's
    float64 compute_Sv and its compute_Sv under its own HIGH, on Sv within
    40 / 60 dB of the channel's peak; identical NaN masks."""
    path = tmp_path / "bb-D20210101-T000000.raw"
    write_ek80_raw(path, n_pings=5, n_samples=1500, with_power_channel=False,
                   with_cw_complex=False, seed=9)
    kw = dict(waveform_mode="BB", encode_mode="complex")
    jed = ep.open_raw(str(path), sonar_model="EK80")
    exact = np.asarray(ep.calibrate.compute_Sv(jed, precision="float64", **kw)["Sv"].values)
    jmf.set_conv_precision("HIGH")
    jax_high = np.asarray(ep.calibrate.compute_Sv(jed, **kw)["Sv"].values)
    tmf.set_conv_precision("HIGH")
    got = np.asarray(et.calibrate.compute_Sv(et.open_raw(str(path), sonar_model="EK80"),
                                             device="cpu", **kw)["Sv"].values)
    assert np.isfinite(got).mean() > 0.5
    for want in (exact, jax_high):
        np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
        for ch in range(got.shape[0]):
            err = _within_db(got[ch], want[ch], exact[ch])
            assert err[40] <= HIGH_DB[40] and err[60] <= HIGH_DB[60], err
