"""The port's surround meters against the JAX package on the CPU: the plain
version of the fused core (against the JAX meter's unfused ``_xla_core``
and the Pallas kernel in interpret mode), the runtime routing ``_sel``, and
SurroundMeter (surround3, surround5, surround8) over chained updates.

The same numpy inputs (fixed seeds) go through both packages.  The JAX
meter runs its unfused path (``METERS_TPU_SURROUND_FUSED=0``).
Tolerances:
  * the plain core against ``_xla_core``: the block peak exact (a max of
    the same squares); km_z, zl and the composed zp within 1e-5 relative
    plus 1e-6 of the leaf's scale (float32 products in another order and
    another blocking of the K-meter: the kernel's 128-sample blocks here,
    512 there);
  * against the Pallas kernel in interpret mode, that test's own bars
    (tests/test_pallas_surround_fused.py): km_z 2e-5 relative, zl and zp
    2e-4 (the Pallas lowpass is a 3-pass bf16 product);
  * meters: level and peak within 1e-4 dB (both below 1e-6 pass),
    correlation within 1e-5 absolute; the states' float leaves within 1e-5
    relative plus 1e-6 of the leaf's scale, the hold counters and read
    flags exact, non-finite values in the same places.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import meters_lv2_torch as mt
from meters_lv2_torch.models.surround import SurroundState
from meters_lv2_torch.ops import surround_fused
from meters_lv2_torch.utils.interop import state_from_numpy, state_to_numpy
from meters_lv2_tpu.models import create as jax_create
from meters_lv2_tpu.ops import pallas_surround

torch.set_num_threads(1)

FS = 48000
CORE_RTOL, CORE_SCALE = 1e-5, 1e-6
PALLAS_KM_RTOL, PALLAS_RTOL = 2e-5, 2e-4
DB_TOL = 1e-4
COR_TOL = 1e-5
ST_RTOL, ST_SCALE = 1e-5, 1e-6
RUNTIME_PAIRS = [[0, 0], [1, 1], [0, 1], [2, 3]]


@pytest.fixture
def unfused(monkeypatch):
    monkeypatch.setenv("METERS_TPU_SURROUND_FUSED", "0")


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


def _core_inputs(C, B=5, T=1280, seed=0, nonfinite=False):
    rng = np.random.default_rng(seed)
    x = (0.3 * rng.standard_normal((B, C, T))).astype(np.float32)
    if nonfinite:
        x[0, C - 1, 300] = np.nan
        x[1, 1, 700] = np.inf
        x[2, 0, 130] = -np.inf
    kmz = (0.01 * rng.random((B, C, 2))).astype(np.float32)
    zl = (0.05 * rng.standard_normal((B, C, 1))).astype(np.float32)
    zp = (0.01 * rng.random((B, 4 if C > 3 else 3, 3))).astype(np.float32)
    return x, kmz, zl, zp


def _sels(jm, tm, pairs):
    sj = jm._sel(None if pairs is None else jnp.asarray(pairs, jnp.float32), jnp.float32)
    st = tm._sel(None if pairs is None else torch.tensor(pairs, dtype=torch.float32), "cpu")
    for a, b in zip(st, sj):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    return sj, st


def _plain(tm, x, kmz, zl, zp, sel):
    T = x.shape[-1]
    wv, decay = tm.cor._ema_weights(T, "cpu")
    kz, zo, pk, pacc = surround_fused.fused_core(
        torch.from_numpy(x), torch.from_numpy(kmz), torch.from_numpy(zl), *sel,
        tm.km.sys, tm.cor.lp, tm.cor.w1, wv)
    return kz.numpy(), zo.numpy(), pk.numpy(), (torch.from_numpy(zp) * decay + pacc).numpy()


@pytest.mark.parametrize("T", [1280, 100])
@pytest.mark.parametrize("pairs", [None, RUNTIME_PAIRS])
def test_plain_core_matches_xla_core(pairs, T):
    """B=5, C=5, carried non-zero states; T=1280 (a kernel bulk) and T=100
    (the meter's short blocks and tails also run the plain version)."""
    jm, tm = jax_create("surround5", FS), mt.create("surround5", FS)
    x, kmz, zl, zp = _core_inputs(5, T=T)
    sj, st = _sels(jm, tm, pairs)
    kj, zlj, zpj, pkj = jm._xla_core(jnp.asarray(x), jnp.asarray(kmz), jnp.asarray(zl),
                                     jnp.asarray(zp), *sj)
    kt, zlt, pkt, zpt = _plain(tm, x, kmz, zl, zp, st)
    np.testing.assert_array_equal(pkt, np.asarray(pkj))
    _close(kt, kj, CORE_RTOL, CORE_SCALE, "km_z")
    _close(zlt, zlj, CORE_RTOL, CORE_SCALE, "zl")
    _close(zpt, zpj, CORE_RTOL, CORE_SCALE, "zp")


@pytest.mark.parametrize("C,nonfinite", [(5, False), (8, False), (5, True)])
def test_plain_core_matches_pallas_interpret(C, nonfinite):
    """The Pallas kernel itself, in interpret mode, with the same 128-sample
    K-meter blocking: with NaN / +-Inf samples the K-meter state and the
    peak are non-finite in the same places and zl / zp non-finite alike."""
    jm, tm = jax_create(f"surround{C}", FS), mt.create(f"surround{C}", FS)
    x, kmz, zl, zp = _core_inputs(C, seed=C, nonfinite=nonfinite)
    sj, st = _sels(jm, tm, None)
    T = x.shape[-1]
    kj, zlj, pkj, paccj = pallas_surround.fused_core(
        jnp.asarray(x), jnp.asarray(kmz), jnp.asarray(zl), *sj, jm.km.sys.op(32),
        jm.cor.lp.op(128), jm.cor.w1, jm.cor.w2, interpret=True)
    zpj = zp * np.float32((1.0 - jm.cor.w2) ** T) + np.asarray(paccj)
    kt, zlt, pkt, zpt = _plain(tm, x, kmz, zl, zp, st)
    np.testing.assert_array_equal(pkt, np.asarray(pkj))
    _close(kt, kj, PALLAS_KM_RTOL, 0.0, "km_z")
    for what, a, b in (("zl", zlt, np.asarray(zlj)), ("zp", zpt, zpj)):
        np.testing.assert_array_equal(np.isfinite(a), np.isfinite(b), err_msg=what)
        f = np.isfinite(b)
        np.testing.assert_allclose(a[f], b[f], rtol=PALLAS_RTOL, atol=1e-8, err_msg=what)
    if nonfinite:  # every pair of streams 0-2 poisoned, streams 3-4 clean
        assert not np.isfinite(zpt[:3]).any() and np.isfinite(zpt[3:]).all()


def _jax_state_np(st):
    return {f.name: (_jax_state_np(v) if dataclasses.is_dataclass(v) else np.asarray(v))
            for f in dataclasses.fields(st) for v in (getattr(st, f.name),)}


def _compare_states(tst, jst, what):
    def walk(a, b, path):
        for k in b:
            if isinstance(b[k], dict):
                walk(a[k], b[k], f"{path}.{k}")
            elif b[k].dtype.kind in "ib":
                np.testing.assert_array_equal(a[k], b[k], err_msg=f"{path}.{k}")
            else:
                _close(a[k], b[k], ST_RTOL, ST_SCALE, f"{path}.{k}")

    walk(state_to_numpy(tst), _jax_state_np(jst), what)


def _db(v):
    return 20 * np.log10(np.maximum(np.abs(np.asarray(v, np.float64)), 1e-30))


def _compare_reads(tm, jm, tst, jst, what):
    ot, tst = tm.read(tst)
    oj, jst = jm.read(jst)
    for k in ("level", "peak"):
        a, b = ot[k].numpy().astype(np.float64), np.asarray(oj[k], np.float64)
        np.testing.assert_array_equal(np.isfinite(a), np.isfinite(b), err_msg=f"{what} {k}")
        f = np.isfinite(b) & ~((np.abs(a) < 1e-6) & (np.abs(b) < 1e-6))
        np.testing.assert_allclose(_db(a[f]), _db(b[f]), atol=DB_TOL, rtol=0, err_msg=f"{what} {k}")
    a, b = ot["correlation"].numpy(), np.asarray(oj["correlation"])
    np.testing.assert_allclose(a, b, atol=COR_TOL, rtol=0, err_msg=f"{what} correlation")
    return ot, tst, jst


def _run_both(name, fs, blocks, batch, pairs=None):
    jm, tm = jax_create(name, fs), mt.create(name, fs)
    upd = jax.jit(lambda s, xb, p: jm.update(s, xb, pairs=p))
    sj, st = jm.init(batch), tm.init(batch, device="cpu")
    for xb in blocks:
        sj = upd(sj, jnp.asarray(xb), None if pairs is None else jnp.asarray(pairs, jnp.float32))
        st = tm.update(st, torch.from_numpy(xb),
                       None if pairs is None else torch.tensor(pairs, dtype=torch.float32))
    return jm, tm, sj, st, upd


# (fs, block length, state batch): 128-aligned blocks (kernel bulk only), 1 s
# at 44.1 kHz (a 68-sample tail through the plain ops), 100 samples (no
# bulk) and a scalar batch
SCENARIOS = {
    "aligned": (48000, 1280, (2,)),
    "44k_1s": (44100, 44100, (2,)),
    "short": (48000, 100, (2,)),
    "scalar": (48000, 640, ()),
}


@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
@pytest.mark.parametrize("name", ["surround3", "surround5", "surround8"])
def test_meter_matches_jax(unfused, name, scenario):
    """Two chained updates plus read(), then one more update and read (the
    read flags reset the rms hold)."""
    fs, T, batch = SCENARIOS[scenario]
    C = int(name[-1])
    rng = np.random.default_rng(C * 7 + T)
    blocks = [(0.2 * rng.standard_normal((*batch, C, T)) * (1.0 + 0.5 * i)).astype(np.float32)
              for i in range(3)]
    jm, tm, sj, st, upd = _run_both(name, fs, blocks[:2], batch)
    _compare_states(st, sj, f"{name} {scenario}")
    _, st, sj = _compare_reads(tm, jm, st, sj, f"{name} {scenario}")
    sj = upd(sj, jnp.asarray(blocks[2]), None)
    st = tm.update(st, torch.from_numpy(blocks[2]))
    _compare_states(st, sj, f"{name} {scenario} after read")
    _compare_reads(tm, jm, st, sj, f"{name} {scenario} after read")


def test_runtime_pairs_match_jax(unfused):
    """Runtime routing with a self-pair, on 1000-sample blocks (an
    896-sample bulk and a 104-sample tail), re-routed mid-stream."""
    rng = np.random.default_rng(11)
    blocks = [(0.2 * rng.standard_normal((3, 5, 1000))).astype(np.float32) for _ in range(4)]
    jm, tm, sj, st, upd = _run_both("surround5", FS, blocks[:2], (3,), RUNTIME_PAIRS)
    _compare_states(st, sj, "runtime pairs")
    pairs2 = [[4, 3], [2, 2], [1, 0], [3, 4]]
    for xb in blocks[2:]:
        sj = upd(sj, jnp.asarray(xb), jnp.asarray(pairs2, jnp.float32))
        st = tm.update(st, torch.from_numpy(xb), pairs=torch.tensor(pairs2))
    _compare_states(st, sj, "re-routed")
    out, _, _ = _compare_reads(tm, jm, st, sj, "re-routed")
    assert bool((out["correlation"][:, 1] > 0.99).all())  # the 2:2 self-pair


@pytest.mark.parametrize("name", ["surround3", "surround5", "surround8"])
def test_sel_matches_jax(name):
    """Half-way values round to even; NaN goes to channel 0, +inf to the
    last channel, -inf and negatives to 0, past-the-end values to the last,
    as the JAX package's round, int32 cast and clip give them."""
    jm, tm = jax_create(name, FS), mt.create(name, FS)
    vals = [0.5, 1.5, 2.5, np.nan, np.inf, -np.inf, -3.0, 99.0]
    P = tm.npairs
    for i in range(0, len(vals), P):
        col = (vals[i:] + vals)[:P]
        for pairs in (np.stack([col, col[::-1]], axis=1), np.stack([col[::-1], col], axis=1)):
            pairs = pairs.astype(np.float32)
            sj = jm._sel(jnp.asarray(pairs), jnp.float32)
            st = tm._sel(torch.from_numpy(pairs), "cpu")
            for a, b in zip(st, sj):
                np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=str(pairs))
    ip = np.array([[0, 1], [2, -1], [7, 1], [1, 1]][:P], np.int32)
    for a, b in zip(tm._sel(torch.from_numpy(ip), "cpu"), jm._sel(jnp.asarray(ip), jnp.float32)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_nan_and_inf_samples_match_jax(unfused):
    """One NaN sample in channel 4 of surround5 flushes every pair (the
    one-hot selection carries 0 * NaN into all of them): all four zp read
    1e-10 and all four correlations 1e-5.  One +Inf sample leaves the
    K-meter state [1e-20, inf] after finalize (the blocked form's zero
    entry of At multiplies it), so the level reads inf, and still reads inf
    after the next update."""
    rng = np.random.default_rng(3)
    blocks = [(0.2 * rng.standard_normal((2, 5, 640))).astype(np.float32) for _ in range(3)]
    blocks[0][0, 4, 100] = np.nan
    blocks[0][1, 4, 400] = np.inf
    jm, tm, sj, st, upd = _run_both("surround5", FS, blocks[:1], (2,))
    _compare_states(st, sj, "after the NaN / Inf block")
    np.testing.assert_array_equal(st.zp[0].numpy(), np.full((4, 3), 1e-10, np.float32))
    np.testing.assert_array_equal(st.km.z[0, 4].numpy(), np.float32([1e-20, 1e-20]))
    z = st.km.z[1, 4].numpy()
    assert z[0] == np.float32(1e-20) and z[1] == np.inf
    assert bool(torch.isfinite(st.zl).all())
    out, _ = tm.read(st)
    np.testing.assert_allclose(out["correlation"][0].numpy(), np.full(4, 1e-5), rtol=1e-6)
    assert out["peak"][0, 4] > 0  # the NaN did not erase channel 4's peak
    assert out["level"][1, 4] == np.inf
    for xb in blocks[1:]:
        sj = upd(sj, jnp.asarray(xb), None)
        st = tm.update(st, torch.from_numpy(xb))
    _compare_states(st, sj, "two blocks later")
    out, _, _ = _compare_reads(tm, jm, st, sj, "two blocks later")
    assert out["level"][1, 4] == np.inf
    assert bool(torch.isfinite(out["correlation"]).all())


def test_interop_round_trip(unfused):
    """A JAX SurroundState (km a nested state) seeds the port mid-stream;
    both then run on and agree."""
    rng = np.random.default_rng(5)
    blocks = [(0.2 * rng.standard_normal((2, 8, 1024))).astype(np.float32) for _ in range(5)]
    jm = jax_create("surround8", FS)
    sj = jm.init((2,))
    for xb in blocks[:3]:
        sj = jm.update(sj, jnp.asarray(xb))
    sj = jm.read(sj)[1]  # the read flags are part of the state
    arrays = _jax_state_np(sj)
    st = state_from_numpy(arrays, device="cpu", cls=SurroundState)
    assert st.km.cnt.dtype == torch.int32 and st.km.flag.dtype == torch.bool
    back = state_to_numpy(st)
    for k in ("zl", "zp"):
        np.testing.assert_array_equal(back[k], arrays[k], err_msg=k)
    for k, v in arrays["km"].items():
        np.testing.assert_array_equal(back["km"][k], v, err_msg=f"km.{k}")
    tm = mt.create("surround8", FS)
    for xb in blocks[3:]:
        sj = jm.update(sj, jnp.asarray(xb))
        st = tm.update(st, torch.from_numpy(xb))
    _compare_states(st, sj, "after interop")
    _compare_reads(tm, jm, st, sj, "after interop")


def test_init_defaults_to_cuda_and_wrapper_checks():
    import inspect

    tm = mt.create("surround5", FS)
    assert inspect.signature(tm.init).parameters["device"].default == "cuda"
    if not torch.cuda.is_available():
        with pytest.raises((RuntimeError, AssertionError)):
            tm.init((2,))
    with pytest.raises(ValueError):
        tm.update(tm.init((2,), device="cpu"), torch.zeros((2, 4, 128)))
    with pytest.raises(ValueError):
        surround_fused.fused_core_reference(
            torch.zeros((1, 5, 102)), None, None, None, None, None, None, 0.1, None)
