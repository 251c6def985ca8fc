"""Port ops (meters_lv2_torch.ops) against the JAX package's ops on CPU.

Inputs come from numpy with fixed seeds and go through both packages.
Tolerances: the vendored host design and the host-built operators are
bit-identical (same numpy code); the device-side ops are float32 on both
sides with different summation orders, so they agree to a few ulp of the
operands' scale.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from meters_lv2_torch.ops import design as t_design
from meters_lv2_torch.ops import lti as t_lti
from meters_lv2_torch.ops import resample as t_resample
from meters_lv2_torch.ops import segment as t_segment
from meters_lv2_tpu.ops import design as j_design
from meters_lv2_tpu.ops import lti as j_lti
from meters_lv2_tpu.ops import resample as j_resample
from meters_lv2_tpu.ops import segment as j_segment

torch.set_num_threads(1)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("fs", [44100, 48000, 96000])
def test_design_bit_identical(fs):
    for a, b in zip(t_design.k_weighting_state_space(fs),
                    j_design.k_weighting_state_space(fs)):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    assert np.array_equal(t_design.upsample4_kernel(24), j_design.upsample4_kernel(24))
    assert np.array_equal(t_design.R128_CHAN_GAIN, j_design.R128_CHAN_GAIN)
    assert dataclasses.astuple(t_design.k_weighting(fs)) == dataclasses.astuple(
        j_design.k_weighting(fs))


@pytest.mark.parametrize("block", [128, 96, 5])
def test_block_op_bit_identical(block):
    mats = j_design.k_weighting_state_space(48000)
    a = t_lti.build_lti_block_op(*mats, block)
    b = j_lti.build_lti_block_op(*mats, block)
    for k in ("kmat", "sy", "at", "g"):
        x, y = getattr(a, k), getattr(b, k)
        assert x.dtype == y.dtype == np.float32 and np.array_equal(x, y), k
    assert (a.block, a.d, a.m, a.p) == (b.block, b.d, b.m, b.p)


def _kw_systems():
    mats = t_design.k_weighting_state_space(48000)
    return t_lti.LTISystem(*mats), j_lti.LTISystem(*mats)


# y and the state are O(1..1e3) (the integrator state grows large); the
# JAX package composes >= 16 block states by associative scan, the port
# by a plain loop, so the chains round differently: 2e-5 of each
# quantity's scale (fp32 eps is 6e-8; measured worst 6.4e-7)
_SCALE_TOL = 1e-5


def _close_to_scale(got, want, axis=None):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = np.abs(want).max(axis=axis, keepdims=axis is not None)
    assert np.all(np.abs(got - want) <= _SCALE_TOL * scale), (
        np.abs(got - want).max(), scale)


@pytest.mark.parametrize("nblk", [4, 40])  # JAX: sequential scan / associative scan
def test_lti_scan_matches_jax(nblk):
    tsys, jsys = _kw_systems()
    rng = np.random.default_rng(nblk)
    u = (0.3 * rng.standard_normal((3, 2, 128 * nblk))).astype(np.float32)
    s0 = (0.5 * rng.standard_normal((3, 2, 4))).astype(np.float32)
    yt, st = t_lti.lti_scan(tsys.op(128), _t(u), _t(s0))
    yj, sj = j_lti.lti_scan(jsys.op(128), jnp.asarray(u), jnp.asarray(s0))
    assert yt.shape == yj.shape and st.shape == sj.shape
    _close_to_scale(yt, yj)
    _close_to_scale(st, sj, axis=(0, 1))


@pytest.mark.parametrize("T", [128 * 3 + 37, 50, 128 * 20])
def test_lti_system_apply_matches_jax(T):
    """main 128-blocks + one remainder block, as the JAX package splits."""
    tsys, jsys = _kw_systems()
    rng = np.random.default_rng(T)
    u = (0.3 * rng.standard_normal((2, T))).astype(np.float32)
    s0 = (0.1 * rng.standard_normal((2, 4))).astype(np.float32)
    yt, st = tsys.apply(_t(u), _t(s0))
    yj, sj = jsys.apply(jnp.asarray(u), jnp.asarray(s0))
    assert yt.shape == yj.shape == (2, T)
    _close_to_scale(yt, yj)
    _close_to_scale(st, sj, axis=0)


def _inject(x, rng):
    x = x.copy()
    flat = x.reshape(-1)
    idx = rng.choice(flat.size, 3, replace=False)
    flat[idx] = [np.nan, np.inf, -np.inf]
    return x


@pytest.mark.parametrize("T,nonfinite", [(768, False), (1000, False), (30, False),
                                         (768, True), (1000, True)])
def test_upsample4_absmax_matches_jax(T, nonfinite):
    """Block-matrix oversampling |max|: history exact, NaN oversamples
    skipped (a non-finite input poisons its frame in both packages)."""
    rng = np.random.default_rng(T + nonfinite)
    x = (0.5 * rng.standard_normal((4, 2, T))).astype(np.float32)
    h = (0.2 * rng.standard_normal((4, 2, 47))).astype(np.float32)
    if nonfinite:
        x = _inject(x, rng)
    mt, ht = t_resample.upsample4_absmax(_t(x), _t(h))
    mj, hj = j_resample.upsample4_absmax(jnp.asarray(x), jnp.asarray(h))
    np.testing.assert_array_equal(ht.numpy(), np.asarray(hj))
    assert not np.isnan(mt.numpy()).any()
    # the same oversamples through matmuls of two BLAS libraries
    np.testing.assert_allclose(mt.numpy(), np.asarray(mj), rtol=1e-6)


def test_upsample4_matches_jax():
    rng = np.random.default_rng(11)
    x = (0.5 * rng.standard_normal((3, 300))).astype(np.float32)
    h = (0.2 * rng.standard_normal((3, 47))).astype(np.float32)
    ut, ht = t_resample.upsample4(_t(x), _t(h))
    uj, hj = j_resample.upsample4(jnp.asarray(x), jnp.asarray(h))
    assert ut.shape == (3, 1200)
    np.testing.assert_allclose(ut.numpy(), np.asarray(uj), rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(ht.numpy(), np.asarray(hj))


@pytest.mark.parametrize("reduce", ["sum", "max"])
@pytest.mark.parametrize("T,seg_len", [(5000, 2400), (1000, 2400), (2400, 2400)])
def test_shifted_segments_matches_jax(reduce, T, seg_len):
    rng = np.random.default_rng(T)
    p = rng.random((3, T)).astype(np.float32)
    off = rng.integers(0, seg_len, 3).astype(np.int32)
    n_slots = T // seg_len + 2
    st = t_segment.shifted_segments(_t(p), _t(off), seg_len, n_slots, reduce)
    sj = j_segment.shifted_segments(jnp.asarray(p), jnp.asarray(off), seg_len, n_slots, reduce)
    assert st.shape == (3, n_slots)
    if reduce == "max":
        np.testing.assert_array_equal(st.numpy(), np.asarray(sj))
    else:  # sums of up to 2400 f32 values in two orders
        np.testing.assert_allclose(st.numpy(), np.asarray(sj), rtol=1e-5)


_SYSTEMS = {
    "one_pole": lambda fs: t_design.stcorr_coeffs(fs)[0],
    "grouped4_smoother": lambda fs: t_design.kmeter_coeffs(fs)[0],
    "vu_grouped4": lambda fs: t_design.vu_coeffs(fs)[0],
}


def _system_pair(name, fs=48000):
    w = _SYSTEMS[name](fs)
    return getattr(t_lti, name + "_system")(w), getattr(j_lti, name + "_system")(w)


@pytest.mark.parametrize("name", sorted(_SYSTEMS))
@pytest.mark.parametrize("fs", [44100, 96000])
def test_meter_systems_bit_identical(name, fs):
    """(A, B, C, D) and the block operators from the same float64 numpy code."""
    ts, js = _system_pair(name, fs)
    for k in "ABCD":
        a, b = getattr(ts, k), getattr(js, k)
        assert a.dtype == b.dtype == np.float64 and np.array_equal(a, b), k
    assert (ts.d, ts.m, ts.p) == (js.d, js.m, js.p)
    for block in (128, 37):
        for k in ("kmat", "sy", "at", "g"):
            assert np.array_equal(getattr(ts.op(block), k), getattr(js.op(block), k)), k


@pytest.mark.parametrize("name", sorted(_SYSTEMS))
@pytest.mark.parametrize("steps", [128 * 3 + 37, 128 * 20, 50])
def test_meter_system_apply_matches_jax(name, steps):
    """The grouped systems take m = 4 inputs per step ([..., steps, 4]), the
    one-pole a plain [..., T]; main 128-step blocks plus a remainder block
    (steps = 50: the remainder only; 128 * 20: the JAX side's associative
    scan).  float32 on both sides with different summation orders, so
    within 1e-5 of each quantity's scale."""
    ts, js = _system_pair(name)
    rng = np.random.default_rng(steps + len(name))
    shape = (3, 2, steps, 4) if ts.m == 4 else (3, 2, steps)
    u = np.abs(0.5 * rng.standard_normal(shape)).astype(np.float32)
    s0 = (0.1 * rng.standard_normal((3, 2, ts.d))).astype(np.float32)
    yt, st = ts.apply(_t(u), _t(s0))
    yj, sj = js.apply(jnp.asarray(u), jnp.asarray(s0))
    assert yt.shape == yj.shape and st.shape == sj.shape
    assert yt.dtype == st.dtype == torch.float32
    _close_to_scale(yt, yj)
    _close_to_scale(st, sj, axis=(0, 1))
