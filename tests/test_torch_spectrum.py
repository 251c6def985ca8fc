"""The port's 30-band spectrum analyzer against the JAX package on the CPU:
the banked LTI and runtime-omega one-pole ops, the plain version of the
fused core (against the Pallas kernel in interpret mode and the JAX
meter's unfused path), and SpectrumAnalyzer (mono and stereo, 128-aligned,
tail and short blocks, set_speed mid-stream, reset_peaks, NaN recovery).

The same numpy inputs (fixed seeds) go through both packages.  Filter
states are taken from a warm-up run over noise, at the scale a stream
really holds (random states would drive the high-Q bands far outside it).
Tolerances:
  * the banked block-operator leaves: bit-equal (the same float64 numpy);
  * band outputs y and filter states: 1e-5 of each band's scale (float32
    products summed in another order; the state chain carries it), plus
    1e-6 of the whole leaf's scale: under a pure tone a stopband band's
    state is what is left of cancelling terms (a 997 Hz tone leaves bands
    5-10 near -100 dB, where 7e-14 of the leaf's scale is 9% of theirs);
  * smoother values, block peaks, val / peak state: 1e-5 relative plus
    1e-5 of the leaf's scale (another summation order of the smoother's
    Toeplitz products);
  * against the Pallas kernel in interpret mode, 2e-4 relative: that
    kernel splits every product into bf16 hi/lo passes (3 of the 6 cross
    terms), a ~1e-5 error before the high-Q bands amplify it;
  * readouts: 1e-3 dB, and -100 dB floors equal;
  * non-finite values: the same NaN and Inf positions.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import meters_lv2_torch as mt
from meters_lv2_torch.ops import lti as t_lti
from meters_lv2_torch.ops import spectrum_fused
from meters_lv2_torch.models.spectrum import SpectrumState
from meters_lv2_torch.utils.interop import block_op_to_torch, state_from_numpy, state_to_numpy
from meters_lv2_tpu.models.spectrum import SpectrumAnalyzer as JSpectrum
from meters_lv2_tpu.ops import lti as j_lti
from meters_lv2_tpu.ops import pallas_spectrum
from signals import make_signal

torch.set_num_threads(1)

FS = 48000
LTI_SCALE = 1e-5
LTI_FLOOR = 1e-6
SM_RTOL, SM_SCALE = 1e-5, 1e-5
PALLAS_RTOL = 2e-4
DB_TOL = 1e-3


@pytest.fixture(scope="module")
def pair():
    return JSpectrum(FS), mt.create("spectr30stereo", FS)


def _warm_state(jm, B, seed):
    """Filter state [B, 30, 12] after 0.25 s of noise, and that noise's
    smoothed band power [B, 30]."""
    rng = np.random.default_rng(seed)
    x = (0.3 * rng.standard_normal((B, FS // 4))).astype(np.float32)
    y, z = jm.bank.apply(jnp.asarray(x), jm.bank.init((B,)))
    return np.asarray(z), np.mean(np.asarray(y) ** 2, axis=-1).astype(np.float32)


def _close_scaled(a, b, scale, what, axis=None, floor=0.0):
    """|a - b| <= scale * max|b| (the max over ``axis``, i.e. per band, when
    given) + floor * max|b| over the whole leaf."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert a.shape == b.shape, (what, a.shape, b.shape)
    np.testing.assert_array_equal(np.isnan(a), np.isnan(b), err_msg=what)
    np.testing.assert_array_equal(np.isinf(a), np.isinf(b), err_msg=what)
    f = np.isfinite(b)
    a, b = np.where(f, a, 0.0), np.where(f, b, 0.0)
    ref = np.abs(b).max(axis=axis, keepdims=True) if axis is not None else np.abs(b).max()
    err = np.abs(a - b)
    assert np.all(err <= scale * ref + floor * np.abs(b).max()), (
        what, float(err.max()), float(np.max(ref)))


def _close_rel(a, b, rtol, scale, what):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    np.testing.assert_array_equal(np.isnan(a), np.isnan(b), err_msg=what)
    np.testing.assert_array_equal(np.isinf(a), np.isinf(b), err_msg=what)
    f = np.isfinite(b)
    a, b = np.where(f, a, 0.0), np.where(f, b, 0.0)
    err = np.abs(a - b)
    assert np.all(err <= rtol * np.abs(b) + scale * np.abs(b).max()), (what, float(err.max()))


@pytest.mark.parametrize("fs", [48000, 96000])
def test_banked_op_leaves_equal_jax(fs):
    jo = JSpectrum(fs).bank.op(128)
    to = mt.create("spectr30mono", fs).bank.op(128)
    assert (to.block, to.d, to.m, to.p) == (jo.block, jo.d, jo.m, jo.p) == (128, 12, 1, 1)
    for k in ("kmat", "sy", "at", "g"):
        np.testing.assert_array_equal(getattr(to, k), np.asarray(getattr(jo, k)), err_msg=k)
    w = block_op_to_torch(jo, "cpu")
    assert tuple(w.kmat.shape) == (30, 128, 128) and tuple(w.at.shape) == (30, 12, 12)


@pytest.mark.parametrize("B", [1, 2, 30])
def test_banked_apply_matches_jax(pair, B):
    """T = 1000 (7 blocks of 128 and a 104-sample tail); B == 30 == NB is
    the case a plain matmul of the state [B, NB, d] by the banked [NB, d, d]
    would get silently wrong."""
    jm, tm = pair
    z0, _ = _warm_state(jm, B, B)
    x = (0.3 * np.random.default_rng(10 + B).standard_normal((B, 1000))).astype(np.float32)
    yj, zj = jm.bank.apply(jnp.asarray(x), jnp.asarray(z0))
    yt, zt = tm.bank.apply(torch.from_numpy(x), torch.from_numpy(z0))
    assert tuple(yt.shape) == (B, 30, 1000) and tuple(zt.shape) == (B, 30, 12)
    _close_scaled(yt.numpy(), np.asarray(yj), LTI_SCALE, "y", axis=(0, 2))
    _close_scaled(zt.numpy(), np.asarray(zj), LTI_SCALE, "z", axis=(0, 2))


@pytest.mark.parametrize("B,speed", [(1, 1.0), (2, 0.01), (30, 15.0)])
def test_one_pole_apply_traced_matches_jax(B, speed):
    rng = np.random.default_rng(B)
    u = np.abs(rng.standard_normal((B, 30, 1000))).astype(np.float32)
    s0 = np.abs(rng.standard_normal((B, 30, 1))).astype(np.float32)
    om = np.float32(1.0 - np.exp(-2.0 * np.pi * speed / FS))
    yj, sj = j_lti.one_pole_apply_traced(jnp.asarray(om), jnp.asarray(u), jnp.asarray(s0))
    yt, st = t_lti.one_pole_apply_traced(torch.tensor(om), torch.from_numpy(u), torch.from_numpy(s0))
    _close_rel(yt.numpy(), np.asarray(yj), SM_RTOL, SM_SCALE, "y")
    _close_rel(st.numpy(), np.asarray(sj), SM_RTOL, SM_SCALE, "s")
    opj = j_lti.one_pole_block_op_traced(jnp.asarray(om), 128)
    opt = t_lti.one_pole_block_op_traced(torch.tensor(om), 128)
    for k in ("kmat", "sy", "at", "g"):
        np.testing.assert_allclose(getattr(opt, k).numpy(), np.asarray(getattr(opj, k)),
                                   rtol=2e-6, atol=0, err_msg=k)


def _core_inputs(jm, B, T, seed, nonfinite=False):
    z0, v0 = _warm_state(jm, B, seed)
    x = (0.3 * np.random.default_rng(seed).standard_normal((B, T))).astype(np.float32)
    if nonfinite:
        x[0, 37] = np.nan
        x[1, T - 1] = np.inf
        x[2, 0] = -np.inf
        x[3, 130], x[3, 200] = np.inf, -np.inf
    om = np.float32(1.0 - np.exp(-2.0 * np.pi * 3.0 / FS))
    return x, z0, v0, om


def _plain(tm, x, z0, v0, om):
    return [t.numpy() for t in spectrum_fused.fused_core(
        torch.from_numpy(x), torch.from_numpy(z0), torch.from_numpy(v0),
        torch.tensor(om), tm.bank.op(128))]


@pytest.mark.parametrize("smooth", ["gemm", "scan"])
def test_plain_core_matches_pallas_interpret(pair, monkeypatch, smooth):
    """The Pallas kernel itself (interpret mode, both smoother forms)."""
    jm, tm = pair
    monkeypatch.setenv("METERS_TPU_SPECTRUM_SMOOTH", smooth)
    x, z0, v0, om = _core_inputs(jm, 3, 256, 5)
    vj, pj, zj = pallas_spectrum.fused_core(
        jnp.asarray(x), jnp.asarray(z0), jnp.asarray(v0), jnp.asarray(om),
        jm.bank.op(128), interpret=True)
    vt, pt, zt = _plain(tm, x, z0, v0, om)
    _close_rel(vt, np.asarray(vj), PALLAS_RTOL, 0.0, "val")
    _close_rel(pt, np.asarray(pj), PALLAS_RTOL, 0.0, "peak")
    _close_scaled(zt, np.asarray(zj), PALLAS_RTOL, "zf", axis=(0, 2))


@pytest.mark.parametrize("nonfinite", [False, True])
def test_plain_core_matches_xla_core(pair, nonfinite):
    """The JAX meter's unfused path, which the plain version follows; with
    NaN / +-Inf samples the non-finite outputs must sit in the same places."""
    jm, tm = pair
    x, z0, v0, om = _core_inputs(jm, 5, 1024, 7, nonfinite)
    vj, pj, zj = jm._xla_core(jnp.asarray(x), jnp.asarray(z0), jnp.asarray(v0), jnp.asarray(om))
    vt, pt, zt = _plain(tm, x, z0, v0, om)
    _close_rel(vt, np.asarray(vj), SM_RTOL, SM_SCALE, "val")
    _close_rel(pt, np.asarray(pj), SM_RTOL, SM_SCALE, "peak")
    _close_scaled(zt, np.asarray(zj), LTI_SCALE, "zf", axis=(0, 2))
    if nonfinite:
        assert not np.isfinite(vt[:4]).any() and np.isfinite(vt[4]).all()


@pytest.mark.parametrize("omega", [np.nan, 1.0])
def test_plain_core_degenerate_omega_matches_xla_core(pair, omega):
    """A NaN smoother coefficient (set_speed lets NaN through) or w = 1
    makes every val and peak NaN on both paths; the filter state is
    untouched."""
    jm, tm = pair
    x, z0, v0, _ = _core_inputs(jm, 3, 256, 8)
    om = np.float32(omega)
    vj, pj, zj = jm._xla_core(jnp.asarray(x), jnp.asarray(z0), jnp.asarray(v0), jnp.asarray(om))
    vt, pt, zt = _plain(tm, x, z0, v0, om)
    _close_rel(vt, np.asarray(vj), SM_RTOL, SM_SCALE, "val")
    _close_rel(pt, np.asarray(pj), SM_RTOL, SM_SCALE, "peak")
    _close_scaled(zt, np.asarray(zj), LTI_SCALE, "zf", axis=(0, 2))
    assert np.isnan(vt).all() and np.isnan(pt).all() and np.isfinite(zt).all()


def _jax_state_np(st):
    return {f.name: np.asarray(getattr(st, f.name)) for f in dataclasses.fields(st)}


def _compare_states(tst, jst, what):
    j = _jax_state_np(jst)
    t = state_to_numpy(tst)
    _close_scaled(t["zf"], j["zf"], LTI_SCALE, f"{what} zf",
                  axis=tuple(range(j["zf"].ndim - 2)) + (-1,), floor=LTI_FLOOR)
    _close_rel(t["val"], j["val"], SM_RTOL, SM_SCALE, f"{what} val")
    _close_rel(t["peak"], j["peak"], SM_RTOL, SM_SCALE, f"{what} peak")
    np.testing.assert_allclose(t["omega"], j["omega"], rtol=2e-7, err_msg=f"{what} omega")


def _compare_reads(tm, jm, tst, jst, what):
    ot, _ = tm.read(tst)
    oj, _ = jm.read(jst)
    for k in ("bands", "peaks"):
        a, b = ot[k].numpy(), np.asarray(oj[k])
        np.testing.assert_array_equal(a <= -100.0, b <= -100.0, err_msg=f"{what} {k} floor")
        np.testing.assert_allclose(a, b, atol=DB_TOL, rtol=0, err_msg=f"{what} {k}")


@pytest.mark.parametrize("stereo,block", [
    (False, 1024), (False, 1000), (True, 1024), (True, 1000), (True, 96),
])
def test_analyzer_matches_jax(pair, stereo, block):
    """128-aligned blocks (kernel bulk only), 1000-sample blocks (bulk plus
    a 104-sample tail through the plain ops) and 96-sample blocks (plain
    ops only), on a batch of two streams."""
    jm, tm = pair
    x = np.stack([make_signal("mix", 0.25), 0.3 * make_signal("bursts", 0.25)])
    if not stereo:
        x = x[:, 0]
    sj, st = jm.init((2,)), tm.init((2,), device="cpu")
    upd = jax.jit(lambda s, xb: jm.update(s, xb, stereo=stereo))
    n = 0
    for i in range(x.shape[-1] // block):
        xb = x[..., i * block:(i + 1) * block]
        sj = upd(sj, jnp.asarray(xb))
        st = tm.update(st, torch.from_numpy(xb), stereo=stereo)
        n += 1
    assert n >= 10
    _compare_states(st, sj, f"stereo={stereo} block={block}")
    _compare_reads(tm, jm, st, sj, f"stereo={stereo} block={block}")


def test_set_speed_and_reset_peaks_mid_stream(pair):
    jm, tm = pair
    x = make_signal("bursts", 0.5)
    sj, st = jm.init(()), tm.init((), device="cpu")
    upd = jax.jit(lambda s, xb: jm.update(s, xb, stereo=True))
    for i in range(12):
        if i == 4:
            sj, st = jm.set_speed(sj, 8.0), tm.set_speed(st, 8.0)
            _compare_states(st, sj, "after set_speed(8)")
        if i == 8:
            sj, st = jm.reset_peaks(sj), tm.reset_peaks(st)
            assert not st.peak.any()
            sj, st = jm.set_speed(sj, 0.2), tm.set_speed(st, torch.tensor(0.2))
        xb = x[:, i * 2000:(i + 1) * 2000]
        sj = upd(sj, jnp.asarray(xb))
        st = tm.update(st, torch.from_numpy(xb), stereo=True)
    _compare_states(st, sj, "set_speed / reset_peaks")
    _compare_reads(tm, jm, st, sj, "set_speed / reset_peaks")


def test_set_speed_clamps_and_passes_nan(pair):
    """speed clamps to [0.01, 15] as jnp.clip does, which lets NaN through."""
    jm, tm = pair
    for speed in (0.0, 100.0, 3.0, float("nan")):
        oj = np.asarray(jm.set_speed(jm.init(()), speed).omega)
        ot = tm.set_speed(tm.init((), device="cpu"), speed).omega
        assert ot.dtype == torch.float32 and ot.shape == ()
        np.testing.assert_allclose(ot.numpy(), oj, rtol=2e-7)
        assert np.isnan(oj) == np.isnan(ot.numpy())


def test_nan_speed_flushes_then_recovers(pair):
    """set_speed(NaN) and a clean block: val and peak-hold flush to their
    floors as in JAX (the old peak is not kept); a finite speed restores
    the readout."""
    jm, tm = pair
    x = make_signal("sine997", 0.5)
    sj, st = jm.init(()), tm.init((), device="cpu")
    upd = jax.jit(lambda s, xb: jm.update(s, xb, stereo=True))
    for i in range(12):
        if i == 4:
            sj, st = jm.set_speed(sj, float("nan")), tm.set_speed(st, float("nan"))
        if i == 5:
            assert not st.peak.any() and bool((st.val == 1e-20).all())
            _compare_states(st, sj, "after set_speed(NaN) and a clean block")
            sj, st = jm.set_speed(sj, 2.0), tm.set_speed(st, 2.0)
        xb = x[:, i * 2000:(i + 1) * 2000]
        sj = upd(sj, jnp.asarray(xb))
        st = tm.update(st, torch.from_numpy(xb), stereo=True)
    _compare_states(st, sj, "after recovery")
    _compare_reads(tm, jm, st, sj, "after recovery")
    assert int(np.argmax(tm.read(st)[0]["bands"].numpy())) == 16


def test_nan_block_then_clean_blocks_recover(pair):
    """A block with NaN and Inf samples flushes the state; clean 997 Hz
    blocks afterwards read finite levels with the tone in band 16."""
    jm, tm = pair
    x = make_signal("sine997", 1.0)
    bad = x[:, :1024].copy()
    bad[0, 100], bad[1, 700] = np.nan, np.inf
    sj, st = jm.init(()), tm.init((), device="cpu")
    upd = jax.jit(lambda s, xb: jm.update(s, xb, stereo=True))
    sj = upd(sj, jnp.asarray(bad))
    st = tm.update(st, torch.from_numpy(bad), stereo=True)
    for s in (st.zf, st.val, st.peak):
        assert bool(torch.isfinite(s).all())
    assert not st.zf.any() and not st.peak.any()
    for i in range(1, 40):
        xb = x[:, i * 1024:(i + 1) * 1024]
        sj = upd(sj, jnp.asarray(xb))
        st = tm.update(st, torch.from_numpy(xb), stereo=True)
    _compare_states(st, sj, "after NaN block")
    out, _ = tm.read(st)
    bands = out["bands"].numpy()
    assert np.isfinite(bands).all() and int(np.argmax(bands)) == 16
    assert bands[16] > -30.0


def test_interop_round_trip(pair):
    """A JAX SpectrumState (0-d omega included) seeds the port mid-stream;
    both then run on and agree."""
    jm, tm = pair
    x = make_signal("noise", 0.5)
    sj = jm.set_speed(jm.init(()), 4.0)
    upd = jax.jit(lambda s, xb: jm.update(s, xb, stereo=True))
    for i in range(6):
        sj = upd(sj, jnp.asarray(x[:, i * 2048:(i + 1) * 2048]))
    st = state_from_numpy(_jax_state_np(sj), device="cpu", cls=SpectrumState)
    assert st.omega.shape == () and st.omega.dtype == torch.float32
    back = state_to_numpy(st)
    for k, v in _jax_state_np(sj).items():
        np.testing.assert_array_equal(back[k], v, err_msg=k)
    for i in range(6, 10):
        xb = x[:, i * 2048:(i + 1) * 2048]
        sj = upd(sj, jnp.asarray(xb))
        st = tm.update(st, torch.from_numpy(xb), stereo=True)
    _compare_states(st, sj, "after interop")


def test_init_defaults_to_cuda(pair):
    import inspect

    _, tm = pair
    assert inspect.signature(tm.init).parameters["device"].default == "cuda"
    assert inspect.signature(tm.bank.init).parameters["device"].default == "cuda"
    if not torch.cuda.is_available():
        with pytest.raises((RuntimeError, AssertionError)):
            tm.init((2,))
