"""The port's display analyzers against the JAX package on the CPU: the STFT
engine (windows, update, update_stereo, freq_at_bin, analyze_impulse), the
analyzer kernel's plain version (against the Pallas kernel in interpret
mode, all three modes at W = 8192), the phase wheel, the stereoscope and
the goniometer over chained calls, NaN / Inf samples and the interop round
trips of their states.

The same numpy inputs (fixed seeds) go through both packages; the JAX
meters run their default CPU paths (XLA ``rfft``).  Tolerances, and why:
  * power and level: rtol 2e-4, atol 1e-8 of the frame's peak power (two
    float32 FFTs differ by ~1e-7 of the frame's peak magnitude; the
    golden tests' bar, tests/test_fft_golden_parity.py:78-80);
  * phase (and the wheel's dphi), compared wrapped into [-pi, pi), on bins
    whose weaker channel's power P lies above 1e-6 of the frame's peak
    power: within 4 x 2^-23 of its magnitude (a few ulp: the wheel's dphi
    reaches 2 pi) plus 1e-6 sqrt(peak / P) rad.  A float32 FFT's absolute
    error is ~1e-7 of the frame's peak magnitude (measured:
    torch.fft.rfft 9.2e-8, jnp.fft.rfft 6.5e-8 against float64), and a
    phase error is that error over the bin's magnitude: 2e-6 rad at the
    peak, 1e-3 rad 60 dB down;
  * the ok masks: a bin may flip only where its weaker channel's power
    lies within 1e-3 relative of the threshold (that FFT error moves a
    power at the -60 dB threshold of a full-scale tone by ~3e-4 of it);
  * the goniometer: as tests/test_fft_golden_parity.py:213-240 (gain 1e-4,
    sum x^2 and sum y^2 1e-5, max |x| 1e-4, relative), and its state
    within 1e-5 relative plus 1e-6 of each leaf's scale;
  * windows, tails and carried histories: exact.
"""

import dataclasses
import math
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import meters_lv2_torch as mt
from meters_lv2_torch.models.goniometer import GonioState
from meters_lv2_torch.models.phasewheel import STEREOSCOPE_STATE, PhaseWheelState, octave_bands
from meters_lv2_torch.ops import fft as tfft
from meters_lv2_torch.ops import resample as tres
from meters_lv2_torch.ops import stft_fused
from meters_lv2_torch.utils.interop import state_from_numpy, state_to_numpy
from meters_lv2_tpu.models import create as jax_create
from meters_lv2_tpu.models.phasewheel import octave_bands as jax_octave_bands
from meters_lv2_tpu.ops import fft as jfft
from meters_lv2_tpu.ops import pallas_stft
from meters_lv2_tpu.ops import resample as jres

torch.set_num_threads(1)

POW_RTOL, POW_ATOL = 2e-4, 1e-8
PH_FFT, PH_REL = 1e-6, 1e-6  # rad at the peak magnitude; bins above 1e-6 of the peak
FLIP_REL = 1e-3
G_GAIN, G_SUM, G_MAX = 1e-4, 1e-5, 1e-4
ST_RTOL, ST_SCALE = 1e-5, 1e-6


def _wrap(p):
    return (np.asarray(p, np.float64) + np.pi) % (2 * np.pi) - np.pi


def _signal(B, T, fs=48000, seed=5):
    """[B, 2, T] float32: two tones, a delayed copy in the right channel,
    a little noise; stream b scaled by 1/(b+1)."""
    rng = np.random.default_rng(seed)
    t = np.arange(T) / fs
    base = np.sin(2 * np.pi * 440 * t) + 0.4 * np.sin(2 * np.pi * 2930 * t)
    x = np.stack([base + 0.01 * rng.standard_normal(T),
                  np.roll(base, 11) + 0.01 * rng.standard_normal(T)])
    return np.stack([x / (b + 1) for b in range(B)]).astype(np.float32)


def _close_power(a, b, what):
    """a, b [..., bins] power-like: rtol POW_RTOL plus POW_ATOL of each
    frame's peak."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    pk = np.abs(b).max(axis=-1, keepdims=True)
    err = np.abs(a - b)
    assert np.all(err <= POW_RTOL * np.abs(b) + POW_ATOL * pk), (what, float(err.max()))


def _close_phase(a, b, power, what, peak=None):
    """Wrapped phase error within 4 x 2^-23 |b| + PH_FFT sqrt(peak / power)
    on bins whose (weaker channel's) power lies above PH_REL of the frame's
    peak (``peak``, by default the max of ``power`` over the bins)."""
    power = np.asarray(power, np.float64)
    pk = power.max(axis=-1, keepdims=True) if peak is None else np.asarray(peak, np.float64)
    b = np.asarray(b, np.float64)
    d = np.abs(_wrap(np.asarray(a) - b))
    sig = power > PH_REL * pk
    assert sig.any(), what
    bar = 4 * 2.0 ** -23 * np.abs(b) + PH_FFT * np.sqrt(pk / np.maximum(power, 1e-300))
    assert np.all(d[sig] <= bar[sig]), (what, float((d / bar)[sig].max()))


def _frame_powers(ext, W, hop):
    """float64 powers [..., 2, F, W/2] of the Hann-windowed frames of ext
    [..., 2, L] (the bars' reference)."""
    win = jfft.make_window("hann", W).astype(np.float32).astype(np.float64)
    F = (ext.shape[-1] - W) // hop
    idx = (np.arange(F)[:, None] + 1) * hop + np.arange(W)[None]
    return np.abs(np.fft.rfft(ext[..., idx].astype(np.float64) * win, axis=-1)[..., : W // 2]) ** 2


def _masks_agree(ok_a, ok_b, pl, pr, thr, what):
    """The ok masks agree except on bins where the weaker channel's power
    lies within FLIP_REL of the threshold."""
    pmin = np.minimum(np.asarray(pl, np.float64), np.asarray(pr, np.float64))
    near = np.abs(pmin - thr) <= FLIP_REL * thr
    flips = np.asarray(ok_a) != np.asarray(ok_b)
    assert not (flips & ~near).any(), (what, int(flips.sum()), int((flips & ~near).sum()))


def _close(a, b, rtol, scale, what):
    """|a - b| <= rtol |b| + scale max|b|, the same non-finite values."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert a.shape == b.shape, (what, a.shape, b.shape)
    np.testing.assert_array_equal(np.isnan(a), np.isnan(b), err_msg=what)
    np.testing.assert_array_equal(np.isinf(a), np.isinf(b), err_msg=what)
    f = np.isfinite(b)
    np.testing.assert_array_equal(a[np.isinf(b)], b[np.isinf(b)], err_msg=what)
    a, b = np.where(f, a, 0.0), np.where(f, b, 0.0)
    err = np.abs(a - b)
    assert np.all(err <= rtol * np.abs(b) + scale * np.abs(b).max()), (what, float(err.max()))


def _jax_np(st):
    if isinstance(st, dict):
        return {k: _jax_np(v) for k, v in st.items()}
    if dataclasses.is_dataclass(st):
        return {f.name: _jax_np(getattr(st, f.name)) for f in dataclasses.fields(st)}
    return np.asarray(st)


# -- the STFT engine --------------------------------------------------------


@pytest.mark.parametrize("kind", jfft.WINDOW_TYPES)
def test_make_window_matches_jax(kind):
    for n in (256, 8192):
        w = tfft.make_window(kind, n)
        np.testing.assert_array_equal(w, jfft.make_window(kind, n))
        np.testing.assert_array_equal(
            tfft.STFT(48000, n, window=kind).win("cpu").numpy(),
            np.asarray(jfft.STFT(48000, n, window=kind).win))


@pytest.mark.parametrize("W,fs", [(512, 48000), (8192, 48000), (8192, 44100)])
def test_stft_update_matches_jax(W, fs):
    """Two chained updates of two frames each, B = 2; power, phase, the
    carried tail (exact) and phase_h."""
    ts, js = tfft.STFT(fs, W), jfft.STFT(fs, W)
    assert ts.hop == js.hop and ts.freq_per_bin == js.freq_per_bin
    T = 2 * ts.hop
    x = _signal(2, 2 * T, fs)[:, 0]
    st, sj = ts.init((2,), device="cpu"), js.init((2,))
    for i in range(2):
        xb = x[:, i * T:(i + 1) * T]
        pt, pht, st = ts.update(st, torch.from_numpy(xb))
        pj, phj, sj = js.update(sj, jnp.asarray(xb))
        pj, phj = np.asarray(pj), np.asarray(phj)
        assert pt.shape == pj.shape == (2, 2, W // 2)
        _close_power(pt.numpy(), pj, f"power {i}")
        _close_phase(pht.numpy(), phj, pj, f"phase {i}")
        assert (pht[..., 0] == 0).all() and (pht[..., -1] == 0).all() and (pt[..., -1] == 0).all()
        np.testing.assert_array_equal(st.tail.numpy(), np.asarray(sj.tail))
        _close_phase(st.phase_h.numpy(), np.asarray(sj.phase_h), pj[..., -1, :], "phase_h")
    p2, ph2, st2 = ts.update(st, torch.from_numpy(x[:, :T]), compute_phase=False)
    assert ph2 is None and st2.phase_h is st.phase_h


def test_stft_update_stereo_matches_jax():
    W = 8192
    ts, js = tfft.STFT(48000, W), jfft.STFT(48000, W)
    T = 2 * ts.hop
    x = _signal(2, 2 * T)
    st, sj = ts.init((2, 2), device="cpu"), js.init((2, 2))
    for i in range(2):
        xb = x[..., i * T:(i + 1) * T]
        pt, pht, st = ts.update_stereo(st, torch.from_numpy(xb))
        pj, phj, sj = js.update_stereo(sj, jnp.asarray(xb))
        pj = np.asarray(pj)
        assert pt.shape == pj.shape == (2, 2, 2, W // 2)
        _close_power(pt.numpy(), pj, f"power {i}")
        _close_phase(pht.numpy(), np.asarray(phj), pj, f"phase {i}")
        np.testing.assert_array_equal(st.tail.numpy(), np.asarray(sj.tail))
    # the packed transform against two real ones
    pu, phu, _ = ts.update(ts.init((2, 2), device="cpu"), torch.from_numpy(x[..., :T]))
    ps, phs, _ = ts.update_stereo(ts.init((2, 2), device="cpu"), torch.from_numpy(x[..., :T]))
    _close_power(ps.numpy(), pu.numpy(), "stereo vs two rffts")


def test_freq_at_bin_matches_jax():
    ts, js = tfft.STFT(48000, 512), jfft.STFT(48000, 512)
    rng = np.random.default_rng(3)
    ph = rng.uniform(-np.pi, np.pi, (3, 256)).astype(np.float32)
    ph_h = rng.uniform(-np.pi, np.pi, (3, 256)).astype(np.float32)
    ph[0, :4] = [np.pi, -np.pi, 0.0, 3.0]  # branch points of the wrap
    ft = ts.freq_at_bin(torch.from_numpy(ph), torch.from_numpy(ph_h), ts.hop).numpy()
    fj = np.asarray(js.freq_at_bin(jnp.asarray(ph), jnp.asarray(ph_h), js.hop))
    np.testing.assert_allclose(ft, fj, rtol=1e-6, atol=1e-3)


def test_analyze_impulse_matches_jax():
    """A one-pole lowpass with carried state, as numpy, behind both."""

    def make_run(to_np, back):
        s = [0.0]

        def run(blk):
            x = to_np(blk).astype(np.float64)
            y = np.empty_like(x)
            for i, v in enumerate(x):
                s[0] += 0.3 * (v - s[0])
                y[i] = s[0]
            return back(y.astype(np.float32))
        return run

    ts, js = tfft.STFT(48000, 1024), jfft.STFT(48000, 1024)
    pt, pht = ts.analyze_impulse(make_run(lambda b: b.numpy(), torch.from_numpy),
                                 prerun=3000, device="cpu")
    pj, phj = js.analyze_impulse(make_run(np.asarray, jnp.asarray), prerun=3000)
    _close_power(pt.numpy(), np.asarray(pj), "power")
    _close_phase(pht.numpy(), np.asarray(phj), np.asarray(pj), "phase")


# -- the analyzer kernel's plain version --------------------------------------


@pytest.mark.parametrize("mode", ["raw", "phasewheel", "stereoscope"])
def test_plain_frames_matches_pallas_interpret(mode):
    """B = 2, W = 8192, hop 1920, F = 2: the Pallas kernel in interpret mode,
    as its own tests run it (6-pass bf16 splits, the Cephes atan2)."""
    W, hop, F = 8192, 1920, 2
    ext = _signal(2, W + F * hop, seed=9)
    win = jfft.make_window("hann", W).astype(np.float32)
    thr = 1e-6 if mode == "phasewheel" else 1e-20
    at, bt = stft_fused.plain_frames(torch.from_numpy(ext), torch.from_numpy(win), hop, mode, thr)
    aj, bj = pallas_stft.analyzer_frames(jnp.asarray(ext), jnp.asarray(win), hop, mode, thr,
                                         interpret=True)
    at, bt, aj, bj = at.numpy(), bt.numpy(), np.asarray(aj), np.asarray(bj)
    assert at.shape == aj.shape and bt.shape == bj.shape
    pw = _frame_powers(ext, W, hop)  # [B, 2, F, D], the bars' reference
    if mode == "raw":
        assert at.shape == (2, 2, F, W // 2)
        _close_power(at ** 2 + bt ** 2, aj ** 2 + bj ** 2, "raw power")
        _close_phase(np.arctan2(bt, at), np.arctan2(bj, aj), pw, "raw phase")
        return
    pl, pr = pw[:, 0], pw[:, 1]
    if mode == "phasewheel":
        okt, okj = bt > -99, bj > -99
        _masks_agree(okt, okj, pl, pr, thr, "mask")
        both = okt & okj
        assert both.sum() > 20
        _close_power(np.where(both, bt, 0), np.where(both, bj, 0), "level")
        _close_phase(np.where(both, at, 0), np.where(both, aj, 0),
                     np.where(both, np.minimum(pl, pr), 0), "dphi",
                     peak=pw.max(axis=(-3, -1), keepdims=True)[:, 0])
        assert (at[~okt] == 0).all() and (bt[~okt] == -100).all()
    else:
        _close_power(bt, bj, "level")
        big = bj > 1e-6 * bj.max(axis=-1, keepdims=True)
        np.testing.assert_allclose(at[big], aj[big], atol=1e-4)


@pytest.mark.parametrize("mode", ["raw", "phasewheel", "stereoscope"])
def test_plain_frames_matches_stft_update(mode):
    """W = 256 at the 44.1 kHz hop 1764 (the golden geometry, which the JAX
    package runs through STFT.update): the plain version against the
    port's own STFT engine, both on torch.fft.rfft (identical frames and
    transform, so exact)."""
    W, hop, F = 256, 1764, 3
    ext = torch.from_numpy(_signal(2, W + F * hop, fs=44100, seed=2))
    st = tfft.STFT(44100, W)
    assert st.hop == hop
    win = st.win("cpu")
    a, b = stft_fused.plain_frames(ext, win, hop, mode, 1e-6)
    power, phase, _ = st.update(
        tfft.STFTState(tail=ext[..., :W], phase_h=torch.zeros(2, 2, W // 2)), ext[..., W:])
    if mode == "raw":
        X = torch.complex(a, b)
        p = (X.abs() ** 2)[..., :-1]
        torch.testing.assert_close(p, power[..., :-1], rtol=1e-6, atol=1e-12)
        return
    pl, pr = power[:, 0], power[:, 1]
    if mode == "phasewheel":
        ok = (pl >= 1e-6) & (pr >= 1e-6)
        assert torch.equal(b, torch.where(ok, torch.maximum(pl, pr), -100.0))
        assert torch.equal(a, torch.where(ok, phase[:, 1] - phase[:, 0], 0.0))
    else:
        assert torch.equal(b, torch.where((pl >= 1e-6) | (pr >= 1e-6), torch.maximum(pl, pr), 0.0))


# -- the meters ---------------------------------------------------------------


def _jax_meter(name, fs, **kw):
    os.environ.pop("METERS_TPU_STFT_FUSED", None)
    return jax_create(name, fs, **kw)


def _phasewheel_outputs_close(ot, oj, pw, what):
    """The wheel's outputs against JAX; pw [B, 2, F, D] the float64 powers
    of the call's frames (the bars' reference)."""
    lt, lj = ot["level"].numpy(), np.asarray(oj["level"])
    okt, okj = lt > -99, lj > -99
    pl, pr = pw[:, 0], pw[:, 1]
    _masks_agree(okt, okj, pl, pr, 1e-6, f"{what} mask")
    both = okt & okj
    _close_power(np.where(both, lt, 0), np.where(both, lj, 0), f"{what} level")
    _close_phase(np.where(both, ot["phase"].numpy(), 0), np.where(both, np.asarray(oj["phase"]), 0),
                 np.where(both, np.minimum(pl, pr), 0), f"{what} dphi",
                 peak=pw.max(axis=(-3, -1), keepdims=True)[:, 0])
    np.testing.assert_allclose(ot["peak"].numpy(), np.asarray(oj["peak"]), rtol=2e-4, err_msg=what)
    np.testing.assert_allclose(ot["correlation"].numpy(), np.asarray(oj["correlation"]),
                               atol=1e-5, err_msg=what)


@pytest.mark.parametrize("fs", [48000, 44100])
def test_phasewheel_matches_jax(fs):
    """Two calls of two frames each (the carried tail exercised), B = 2."""
    tm, jm = mt.create("phasewheel", fs), _jax_meter("phasewheel", fs)
    W, hop = 8192, tm.stft.hop
    T = 2 * hop
    x = _signal(2, 2 * T, fs, seed=7)
    xp = np.concatenate([np.zeros((2, 2, W), np.float32), x], axis=-1)  # [tail | x]
    st, sj = tm.init((2,), device="cpu"), jm.init((2,))
    for i in range(2):
        xb = x[..., i * T:(i + 1) * T]
        ot, st = tm.process(st, torch.from_numpy(xb))
        oj, sj = jm.process(sj, jnp.asarray(xb))
        assert ot["phase"].shape == (2, 2, 4096)
        pw = _frame_powers(xp[..., i * T:i * T + W + T], W, hop)
        _phasewheel_outputs_close(ot, oj, pw, f"call {i}")
        np.testing.assert_array_equal(st.stft.tail.numpy(), np.asarray(sj.stft.tail))
        # phase_h passes through, as on the JAX package's kernel path
        assert not st.stft.phase_h.any()
        _close(state_to_numpy(st.cor)["zp"], np.asarray(sj.cor.zp), ST_RTOL, ST_SCALE, "cor.zp")


def _stereoscope_outputs_close(ot, oj, what):
    lt, lj = ot["level"].numpy(), np.asarray(oj["level"])
    np.testing.assert_array_equal(np.isnan(lt), np.isnan(lj), err_msg=what)
    f = np.isfinite(lj)
    _close_power(np.where(f, lt, 0), np.where(f, lj, 0), f"{what} level")
    big = f & (lj > 1e-6 * np.where(f, lj, 0).max(axis=-1, keepdims=True))
    np.testing.assert_allclose(ot["lr"].numpy()[big], np.asarray(oj["lr"])[big], atol=1e-4,
                               err_msg=what)
    np.testing.assert_array_equal(np.isnan(ot["lr"].numpy()), np.isnan(np.asarray(oj["lr"])))


@pytest.mark.parametrize("fs", [48000, 44100])
def test_stereoscope_matches_jax(fs):
    tm, jm = mt.create("stereoscope", fs), _jax_meter("stereoscope", fs)
    T = 2 * tm.stft.hop
    x = _signal(2, 2 * T, fs, seed=8)
    st, sj = tm.init((2,), device="cpu"), jm.init((2,))
    for i in range(2):
        xb = x[..., i * T:(i + 1) * T]
        ot, st = tm.process(st, torch.from_numpy(xb))
        oj, sj = jm.process(sj, jnp.asarray(xb))
        assert ot["lr"].shape == ot["level"].shape == (2, 4096)
        _stereoscope_outputs_close(ot, oj, f"call {i}")
        np.testing.assert_array_equal(st["stft"].tail.numpy(), np.asarray(sj["stft"].tail))


@pytest.mark.parametrize("oversample", [1, 2, 4, 8])
def test_goniometer_matches_jax(oversample):
    """Three blocks of 1024 samples, B = 2, at the golden bars; the state
    (resampler history exact, smoother state and gain)."""
    tm = mt.create("goniometer", 48000, oversample=oversample)
    jm = jax_create("goniometer", 48000, oversample=oversample)
    x = _signal(2, 3 * 1024, seed=oversample)
    st, sj = tm.init((2,), device="cpu"), jm.init((2,))
    for i in range(3):
        xb = x[..., i * 1024:(i + 1) * 1024]
        ot, st = tm.process(st, torch.from_numpy(xb))
        oj, sj = jm.process(sj, jnp.asarray(xb))
        ax, ay = ot["x"].double().numpy(), ot["y"].double().numpy()
        jx, jy = np.asarray(oj["x"], np.float64), np.asarray(oj["y"], np.float64)
        assert ax.shape == (2, oversample * 1024)
        np.testing.assert_allclose(ot["gain"].numpy(), np.asarray(oj["gain"]), rtol=G_GAIN)
        np.testing.assert_allclose((ax ** 2).sum(-1), (jx ** 2).sum(-1), rtol=G_SUM)
        np.testing.assert_allclose((ay ** 2).sum(-1), (jy ** 2).sum(-1), rtol=G_SUM)
        np.testing.assert_allclose(np.abs(ax).max(-1), np.abs(jx).max(-1), rtol=G_MAX)
        np.testing.assert_array_equal(st.rhist.numpy(), np.asarray(sj.rhist))
        _close(st.lp.numpy(), np.asarray(sj.lp), ST_RTOL, ST_SCALE, "lp")


def test_resample_helpers_match_jax():
    for factor in (2, 4, 8):
        taps = tres.upsample_taps(factor, 12)
        np.testing.assert_array_equal(taps, np.asarray(jres.upsample_taps(factor, 12)))
        ct = tres.composed_smooth_taps(taps.astype(np.float64), 0.99)
        cj = jres.composed_smooth_taps(taps.astype(np.float64), 0.99)
        for a, b in zip(ct, cj):
            np.testing.assert_array_equal(a, b)
        rng = np.random.default_rng(factor)
        x = (0.3 * rng.standard_normal((2, 300))).astype(np.float32)
        h = tres.upsample_init((2,), 12, device="cpu")
        assert h.shape == (2, 23) and not h.any()
        yt, ht = tres.upsample(torch.from_numpy(x), h, taps)
        yj, hj = jres.upsample(jnp.asarray(x), jres.upsample_init((2,), 12), jnp.asarray(taps))
        np.testing.assert_allclose(yt.numpy(), np.asarray(yj), rtol=1e-5, atol=1e-6)
        np.testing.assert_array_equal(ht.numpy(), np.asarray(hj))


def test_octave_bands_matches_jax():
    rng = np.random.default_rng(4)
    ph = rng.uniform(-np.pi, np.pi, (2, 3, 512)).astype(np.float32)
    lv = np.where(rng.random((2, 3, 512)) < 0.3, -100.0, rng.random((2, 3, 512))).astype(np.float32)
    bt, lt = octave_bands(torch.from_numpy(ph), torch.from_numpy(lv), 48000 / 1024)
    bj, lj = jax_octave_bands(jnp.asarray(ph), jnp.asarray(lv), 48000 / 1024)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(_wrap(bt.numpy() - np.asarray(bj)), 0.0, atol=1e-4)


# -- NaN and Inf samples -------------------------------------------------------


def test_nan_in_one_channel_matches_jax():
    """A NaN in the left channel of stream 0, frame 1: the wheel marks every
    bin of that frame (-100, dphi 0) and the scope's level is NaN wherever
    the right channel reaches its threshold, as in the JAX package; stream 1
    and the other frame are untouched."""
    fs = 48000
    T = 2 * 1920
    x = _signal(2, T, fs, seed=11)
    x[0, 0, T - 100] = np.nan  # inside both frames' windows: frame 1 ends at T
    x[0, 0, 100] = np.nan  # in the tail region only of the next call
    for name in ("phasewheel", "stereoscope"):
        tm, jm = mt.create(name, fs), _jax_meter(name, fs)
        ot, _ = tm.process(tm.init((2,), device="cpu"), torch.from_numpy(x))
        oj, _ = jm.process(jm.init((2,)), jnp.asarray(x))
        if name == "phasewheel":
            lt = ot["level"].numpy()
            np.testing.assert_array_equal(lt[0], np.asarray(oj["level"])[0])
            np.testing.assert_array_equal(ot["phase"].numpy()[0], np.asarray(oj["phase"])[0])
            assert (lt[0] == -100).all()
            pw = _frame_powers(np.concatenate([np.zeros((2, 2, 8192), np.float32), x], -1)[1:],
                               8192, 1920)
            _phasewheel_outputs_close(
                {k: v[1:] for k, v in ot.items()}, {k: v[1:] for k, v in oj.items()}, pw,
                "stream 1")
        else:
            lt, lj = ot["level"].numpy(), np.asarray(oj["level"])
            np.testing.assert_array_equal(np.isnan(lt), np.isnan(lj))
            assert np.isnan(lt[0]).any() and not np.isnan(lt[1]).any()
            _stereoscope_outputs_close(
                {k: v[1:] for k, v in ot.items()}, {k: v[1:] for k, v in oj.items()}, "stream 1")


@pytest.mark.parametrize("value", [np.inf, -np.inf])
def test_inf_leaves_the_other_channel(value):
    """+-Inf in the left channel of stream 0: the right channel's raw bins
    equal those of the clean input exactly (the channels are transformed
    apart), and stream 1 of the wheel and the scope still matches JAX.
    Which of the left channel's bins turn Inf or NaN depends on the FFT, so
    they are not compared bin by bin."""
    fs, W, hop = 48000, 8192, 1920
    x = _signal(2, W + 2 * hop, fs, seed=12)
    xi = x.copy()
    xi[0, 0, W + 500] = value
    win = torch.from_numpy(jfft.make_window("hann", W).astype(np.float32))
    rc, ic = stft_fused.plain_frames(torch.from_numpy(x), win, hop, "raw", 0.0)
    ri, ii = stft_fused.plain_frames(torch.from_numpy(xi), win, hop, "raw", 0.0)
    assert torch.equal(ri[0, 1], rc[0, 1]) and torch.equal(ii[0, 1], ic[0, 1])
    assert torch.equal(ri[1], rc[1]) and torch.equal(ii[1], ic[1])
    assert not torch.isfinite(ri[0, 0, 1]).all()
    xb = xi[..., W:]
    for name in ("phasewheel", "stereoscope"):
        tm, jm = mt.create(name, fs), _jax_meter(name, fs)
        ot, _ = tm.process(tm.init((2,), device="cpu"), torch.from_numpy(xb))
        oj, _ = jm.process(jm.init((2,)), jnp.asarray(xb))
        o1, j1 = {k: v[1:] for k, v in ot.items()}, {k: v[1:] for k, v in oj.items()}
        if name == "phasewheel":
            pw = _frame_powers(np.concatenate([np.zeros((1, 2, W), np.float32), xb[1:]], -1),
                               W, hop)
            _phasewheel_outputs_close(o1, j1, pw, name)
        else:
            _stereoscope_outputs_close(o1, j1, name)


# -- state carrying and defaults -------------------------------------------------


@pytest.mark.parametrize("name", ["phasewheel", "stereoscope", "goniometer"])
def test_interop_round_trip(name):
    """A JAX state after one call seeds the port; both run one more call and
    agree; the numpy round trip is exact."""
    fs = 48000
    tm, jm = mt.create(name, fs), _jax_meter(name, fs)
    T = 2 * 1920 if name != "goniometer" else 1024
    x = _signal(2, 2 * T, fs, seed=13)
    sj = jm.init((2,))
    _, sj = jm.process(sj, jnp.asarray(x[..., :T]))
    arrays = _jax_np(sj)
    cls = {"phasewheel": PhaseWheelState, "stereoscope": STEREOSCOPE_STATE,
           "goniometer": GonioState}[name]
    st = state_from_numpy(arrays, device="cpu", cls=cls)
    back = state_to_numpy(st)

    def same(a, b, path):
        assert set(a) == set(b), path
        for k in b:
            if isinstance(b[k], dict):
                same(a[k], b[k], f"{path}.{k}")
            else:
                np.testing.assert_array_equal(a[k], b[k], err_msg=f"{path}.{k}")

    same(back, arrays, name)
    ot, st = tm.process(st, torch.from_numpy(x[..., T:]))
    oj, sj = jm.process(sj, jnp.asarray(x[..., T:]))
    if name == "phasewheel":
        ext = np.concatenate([np.zeros((2, 2, 8192), np.float32), x], -1)[..., T:]
        _phasewheel_outputs_close(ot, oj, _frame_powers(ext, 8192, 1920), name)
    elif name == "stereoscope":
        _stereoscope_outputs_close(ot, oj, name)
    else:
        np.testing.assert_allclose(ot["gain"].numpy(), np.asarray(oj["gain"]), rtol=G_GAIN)
        np.testing.assert_allclose(ot["x"].numpy(), np.asarray(oj["x"]), rtol=1e-4, atol=1e-6)


def test_defaults_and_wrapper_checks():
    """init() defaults to the card; the wrapper takes the plain version on
    CPU tensors (no launch counted) and refuses an unknown mode."""
    import inspect

    for name in ("phasewheel", "stereoscope", "goniometer"):
        m = mt.create(name, 48000)
        assert inspect.signature(m.init).parameters["device"].default == "cuda"
    assert inspect.signature(tfft.STFT.init).parameters["device"].default == "cuda"
    ext = torch.from_numpy(_signal(1, 256 + 2 * 100, seed=1))
    win = torch.from_numpy(tfft.make_window("hann", 256).astype(np.float32))
    n = stft_fused.launch_count
    a, b = stft_fused.analyzer_frames(ext, win, 100, "phasewheel", 1e-6)
    assert a.shape == (1, 2, 128) and stft_fused.launch_count == n
    a, b = stft_fused.analyzer_frames(ext, win, 100, "raw", 1e-6)
    assert a.shape == (1, 2, 2, 128)
    with pytest.raises(ValueError, match="mode"):
        stft_fused.analyzer_frames(ext, win, 100, "polar", 1e-6)
    with pytest.raises(ValueError):
        stft_fused.plain_frames(ext[..., :200], win, 100, "raw", 1e-6)
    m = mt.create("phasewheel", 48000)
    with pytest.raises(ValueError, match="hop"):
        m.process(m.init((), device="cpu"), torch.zeros(2, 1000))
    tw = stft_fused.twiddles(256, "cpu").numpy()
    k = np.arange(128)
    np.testing.assert_allclose(tw[:, 0], np.cos(np.pi * k / 128), atol=6e-8)
    np.testing.assert_allclose(tw[:, 1], -np.sin(np.pi * k / 128), atol=6e-8)
    assert math.isclose(float(tw[64, 0]), 0.0, abs_tol=1e-7)
