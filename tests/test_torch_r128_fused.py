"""Port fused R128 core (meters_lv2_torch.ops.r128_fused) against the JAX
package on CPU.

On a CPU tensor ``fused_core`` runs its plain PyTorch version, the same
lti_scan + upsample4_absmax pipeline as the JAX meter's unfused path.  It
is held against the Pallas kernel in interpret mode (3-pass bf16 GEMMs, so
the tolerances of tests/test_pallas_r128_fused.py) and, tighter, against the
JAX XLA ops (float32 on both sides).  The CUDA kernel itself is compared
with the plain version on the card by tests/test_torch_cuda.py and
chip_smoke.py.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from meters_lv2_torch.ops import design as t_design
from meters_lv2_torch.ops import lti as t_lti
from meters_lv2_torch.ops import r128_fused
from meters_lv2_torch.runtime import build
from meters_lv2_tpu.ops import lti as j_lti
from meters_lv2_tpu.ops import pallas_r128
from meters_lv2_tpu.ops import resample as j_resample

torch.set_num_threads(1)

R128_5 = r128_fused.gains_f32(t_design.R128_CHAN_GAIN[:5])


def _inputs(B, C, T, seed, state=True, nonfinite=False):
    rng = np.random.default_rng(seed)
    x = (0.3 * rng.standard_normal((B, C, T))).astype(np.float32)
    s = 1.0 if state else 0.0
    z0 = (s * 0.01 * rng.standard_normal((B, C, 4))).astype(np.float32)
    h = (s * 0.1 * rng.standard_normal((B, C, 47))).astype(np.float32)
    if nonfinite:
        x[0, 0, T // 3] = np.nan
        x[-1, -1, T // 2] = np.inf
        x[-1, 0, 7] = -np.inf
    return x, z0, h


def _port(x, z0, h, gains, flat):
    B, C, T = x.shape
    xt = torch.from_numpy(x.reshape(B, C * T) if flat else x)
    return [v.numpy() for v in r128_fused.fused_core(
        xt, torch.from_numpy(z0), torch.from_numpy(h), gains,
        t_lti.LTISystem(*t_design.k_weighting_state_space(48000)).op(128))]


@pytest.mark.parametrize("B,C,T,gains,seed,state,flat", [
    (5, 2, 768, (1.0, 1.41), 0, True, False),
    (2, 1, 256, (2.0,), 3, False, True),
    (2, 5, 384, R128_5, 6, True, False),
])
def test_fused_core_matches_pallas_interpret(B, C, T, gains, seed, state, flat):
    x, z0, h = _inputs(B, C, T, seed, state)
    jsys = j_lti.LTISystem(*t_design.k_weighting_state_space(48000))
    pj, zj, hj, tj = pallas_r128.fused_core(
        jnp.asarray(x), jnp.asarray(z0), jnp.asarray(h), gains, jsys.op(128),
        interpret=True,
    )
    p, z, hh, tp = _port(x, z0, h, gains, flat)
    # the interpret kernel's GEMMs are 3-pass bf16 (XLA Precision.HIGH,
    # ~1e-5 relative), so tests/test_pallas_r128_fused.py's tolerances
    np.testing.assert_allclose(p, pj, rtol=2e-4, atol=1e-5)
    np.testing.assert_allclose(z, zj, rtol=1e-4, atol=1e-4)
    np.testing.assert_array_equal(hh, hj)
    np.testing.assert_allclose(tp, tj, rtol=1e-4)


def _jax_ops(x, z0, h, gains):
    """The JAX meter's unfused path (models/ebur128.py xla_core)."""
    jsys = j_lti.LTISystem(*t_design.k_weighting_state_space(48000))
    y, z = jsys.apply(jnp.asarray(x), jnp.asarray(z0))
    g = jnp.asarray(np.asarray(gains, np.float32))
    p = jnp.sum(jnp.square(y) * g[:, None], axis=-2)
    tp, hh = j_resample.upsample4_absmax(jnp.asarray(x), jnp.asarray(h))
    return [np.asarray(v) for v in (p, z, hh, jnp.max(tp, axis=-1))]


def _same_nonfinite(a, b):
    np.testing.assert_array_equal(np.isnan(a), np.isnan(b))
    inf = np.isinf(b)
    np.testing.assert_array_equal(np.isinf(a), inf)
    np.testing.assert_array_equal(a[inf], b[inf])


@functools.lru_cache(maxsize=None)
def _case(C, gains, nonfinite):
    """Inputs and the JAX result, shared by the flat and 3-D layouts."""
    x, z0, h = _inputs(3, C, 128 * 20, 10 + C, nonfinite=nonfinite)
    return x, z0, h, _jax_ops(x, z0, h, gains)


@pytest.mark.parametrize("flat", [False, True])
@pytest.mark.parametrize("C,gains,nonfinite", [
    (1, (2.0,), False),
    (2, (1.0, 1.0), False),
    (5, R128_5, False),
    (2, (1.0, 1.41), True),
])
def test_fused_core_matches_jax_ops(C, gains, nonfinite, flat):
    x, z0, h, want = _case(C, gains, nonfinite)
    got = _port(x, z0, h, gains, flat)
    for a, b in zip(got, want):
        assert a.shape == b.shape and a.dtype == b.dtype == np.float32
        _same_nonfinite(a, b)
    p, z, hh, tp = got
    pj, zj, hj, tj = want
    fin = np.isfinite(pj)
    # float32 on both sides, summation orders of two BLAS libraries and of
    # the state chain (JAX: associative scan over >= 16 blocks); the state
    # error reaches p through s @ Sy, so it scales with the stream's power
    pmax = np.abs(pj[fin]).max()
    assert np.all(np.abs(p[fin] - pj[fin]) <= 1e-5 * np.abs(pj[fin]) + 1e-6 * pmax)
    zf = np.isfinite(zj)
    zscale = np.abs(np.where(zf, zj, 0)).max(axis=(0, 1))
    assert np.all(np.where(zf, np.abs(z - zj), 0) <= 1e-5 * zscale)
    np.testing.assert_array_equal(hh, hj)
    tf = np.isfinite(tj)
    np.testing.assert_allclose(tp[tf], tj[tf], rtol=1e-6)
    assert r128_fused.launch_count == 0  # the kernel never runs on CPU


def test_cuda_wrapper_validates_before_building():
    """The CUDA wrapper refuses bad shapes before it reaches the build."""
    op = t_lti.LTISystem(*t_design.k_weighting_state_space(48000)).op(128)
    x = torch.zeros(2, 2, 200)
    z0, h = torch.zeros(2, 2, 4), torch.zeros(2, 2, 47)
    with pytest.raises(ValueError, match="multiple of 128"):
        r128_fused._fused_core_cuda(x, z0, h, (1.0, 1.0), op)
    with pytest.raises(ValueError, match="channels"):
        r128_fused._fused_core_cuda(torch.zeros(2, 6, 128), z0, h, (1.0,) * 6, op)
    with pytest.raises(ValueError, match="shape"):
        r128_fused._fused_core_cuda(torch.zeros(2, 2, 256), z0[:1], h, (1.0, 1.0), op)
    with pytest.raises(ValueError, match="no fused_core for device"):
        r128_fused.fused_core(x.to("meta"), z0, h, (1.0, 1.0), op)


def test_build_without_nvcc_raises(monkeypatch):
    """No quiet fallback: a missing nvcc is an error, not the plain path."""
    import torch.utils.cpp_extension as ext

    monkeypatch.setattr(ext, "CUDA_HOME", None)
    monkeypatch.setenv("PATH", "")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build._nvcc()
