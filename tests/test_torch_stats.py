"""The port's statistics meters against the JAX package on the CPU: the
bit meter (and the plain version of its kernel), ops/hist, SigDistHist,
DR-14 and TP+RMS.

The same numpy inputs (fixed seeds) go through both packages.  Tolerances:
  * every integer and bool leaf, every histogram and counter: exact;
  * bitmeter |min| / |max|: exact (min and max of the same floats);
  * sigdist mean / M2 / running sum: 1e-5 of the leaf's scale in the
    default mode (float32 sums in another order), 1e-4 in the
    reference_oor_count mode (the log-depth prefix composition runs a
    different tree than jax.lax.associative_scan, each level rounding
    once more);
  * DR-14 / TP+RMS float leaves and readouts: 1e-5 of each leaf's scale
    (K-meter block-state chain and window sums of squares in another
    order; true-peak states as tests/test_torch_meters_ballistics.py).
DR-14 and TP+RMS run at fs = 2000 so that 3 s windows complete within a
few blocks: on the CPU the display true peak is the truepeak_fused
kernel's plain version, a Python loop per sample.
"""

import dataclasses
import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import meters_lv2_torch as mt
from meters_lv2_torch.models import base as t_base
from meters_lv2_torch.ops import bitmeter_stats as t_bs
from meters_lv2_torch.ops import hist as t_hist
from meters_lv2_torch.utils.interop import block_op_to_torch, state_from_numpy, state_to_numpy
from meters_lv2_tpu.models import bitmeter as j_bitmeter
from meters_lv2_tpu.models import dr14 as j_dr14
from meters_lv2_tpu.models import sigdist as j_sigdist
from meters_lv2_tpu.ops import hist as j_hist
from meters_lv2_tpu.ops import pallas_bitmeter
from signals import make_signal

torch.set_num_threads(1)

SD_SCALE = 1e-5
SD_OOR_SCALE = 1e-4
DR_SCALE = 1e-5


def _jax_np(st):
    return {f.name: (_jax_np(v) if dataclasses.is_dataclass(v) else np.asarray(v))
            for f in dataclasses.fields(st) for v in (getattr(st, f.name),)}


def _close(a, b, scale, what):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape, (what, a.shape, b.shape)
    if b.dtype.kind in "ib":
        np.testing.assert_array_equal(a, b, err_msg=what)
        return
    assert a.dtype == b.dtype, (what, a.dtype, b.dtype)
    fin = np.isfinite(b)
    np.testing.assert_array_equal(a[~fin], b[~fin], err_msg=what)
    a, b = a[fin].astype(np.float64), b[fin].astype(np.float64)
    bound = scale * np.abs(b).max(initial=0.0) + 1e-30
    assert np.all(np.abs(a - b) <= bound), (what, np.abs(a - b).max(), bound)


def assert_states_close(ts, js, scale, what="state"):
    t, j = state_to_numpy(ts), _jax_np(js)
    assert set(t) == set(j), what

    def walk(a, b, path):
        for k in b:
            if isinstance(b[k], dict):
                walk(a[k], b[k], f"{path}.{k}")
            else:
                _close(a[k], b[k], scale, f"{path}.{k}")

    walk(t, j, what)


def assert_reads_close(to, jo, scale):
    assert set(to) == set(jo)
    for k in jo:
        _close(to[k].numpy(), jo[k], scale, k)


# -- the bit meter ------------------------------------------------------------


def _weird_rows(T):
    x = make_signal("weird_floats", 0.2)[:, :T]
    rnd = (0.1 * np.random.default_rng(5).standard_normal((3, T))).astype(np.float32)
    rnd[2] *= np.float32(2.0) ** np.random.default_rng(6).integers(-60, 60, T).astype(np.float32)
    return np.concatenate([x, rnd])


@pytest.mark.parametrize("rows", ["weird_floats", "random"])
def test_bitmeter_stats_plain_matches_pallas(rows):
    """The plain version against the Pallas kernel in interpret mode, T=2048:
    every field exact."""
    x = _weird_rows(2048)
    x = x[:2] if rows == "weird_floats" else x[2:]
    got = t_bs.bitmeter_stats(torch.from_numpy(x))
    ref = pallas_bitmeter.fused_stats(jnp.asarray(x), interpret=True)
    assert set(got) == set(ref)
    for k in ref:
        assert got[k].dtype == (torch.float32 if k in ("vmin", "vmax") else torch.int32), k
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(ref[k]), err_msg=k)


def test_bitmeter_stats_strided_rows_and_no_normals():
    x = _weird_rows(600)
    wide = torch.from_numpy(np.concatenate([x, x], axis=1))[:, :600]  # strided rows
    a, b = t_bs.bitmeter_stats(wide), t_bs.bitmeter_stats(torch.from_numpy(x))
    for k in b:
        assert torch.equal(a[k], b[k]), k
    z = t_bs.bitmeter_stats(torch.tensor([[0.0, -0.0, float("nan"), 1e-42]]))
    assert z["vmin"].item() == float("inf") and z["vmax"].item() == 0.0
    assert [z[k].item() for k in t_bs.FLAGS] == [1, 0, 1, 2, 1]


@pytest.mark.parametrize("near_cap", [False, True])
def test_bitmeter_matches_jax(near_cap):
    """Chunked updates of 1000, 37 and 2048 samples (the JAX XLA path);
    near_cap seeds the integration time 3000 samples short of 2^31 - 1, so
    the gate stops the counters mid-stream; clear() and reset() last."""
    jm, tm = j_bitmeter.BitMeter(48000), mt.create("bitmeter", 48000)
    js, ts = jm.init((2,)), tm.init((2,), device="cpu")
    if near_cap:
        js = dataclasses.replace(js, time=jnp.full((2,), 2147483647 - 3000, jnp.int32))
        ts = state_from_numpy(_jax_np(js), device="cpu", cls=type(ts))
    x = _weird_rows(4096)[:4].reshape(2, 2, 4096).reshape(2, -1)
    t = 0
    for T in (1000, 37, 2048, 1000, 37, 2048):
        xb = x[:, t:t + T]
        t += T
        js = jm.update(js, jnp.asarray(xb))
        ts = tm.update(ts, torch.from_numpy(xb))
        assert_states_close(ts, js, 0.0, f"after {t} samples")
    if near_cap:
        assert int(ts.time[0]) == 2147483647 - 3000 + 2074  # the 2048s stopped
    assert_reads_close(tm.read(ts)[0], jm.read(js)[0], 0.0)
    assert_states_close(tm.clear(ts), jm.clear(js), 0.0, "clear")
    assert_states_close(tm.reset(ts), jm.reset(js), 0.0, "reset")


# -- ops/hist ------------------------------------------------------------------


def test_bincount_and_welford_match_jax():
    rng = np.random.default_rng(11)
    ids = rng.integers(-5, 370, (2, 3000)).astype(np.int32)
    valid = rng.random((2, 3000)) > 0.3
    w = rng.standard_normal((2, 3000)).astype(np.float32)
    got = t_hist.bincount(torch.from_numpy(ids), 361, valid=torch.from_numpy(valid),
                          dtype=torch.int32)
    ref = j_hist.bincount(jnp.asarray(ids), 361, valid=jnp.asarray(valid), dtype=jnp.int32)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    gw = t_hist.bincount(torch.from_numpy(ids), 361, weights=torch.from_numpy(w))
    rw = j_hist.bincount(jnp.asarray(ids), 361, weights=jnp.asarray(w))
    np.testing.assert_allclose(gw.numpy(), np.asarray(rw), rtol=1e-5, atol=1e-5)

    x = (0.3 + rng.standard_normal((2, 3000))).astype(np.float32)
    a_t = t_hist.welford_block(torch.from_numpy(x[:, :1000]), torch.from_numpy(valid[:, :1000]))
    b_t = t_hist.welford_block(torch.from_numpy(x[:, 1000:]))
    a_j = j_hist.welford_block(jnp.asarray(x[:, :1000]), jnp.asarray(valid[:, :1000]))
    b_j = j_hist.welford_block(jnp.asarray(x[:, 1000:]))
    for gt, rj in ((a_t, a_j), (b_t, b_j),
                   (t_hist.welford_merge(a_t, b_t), j_hist.welford_merge(a_j, b_j))):
        np.testing.assert_array_equal(gt[0].numpy(), np.asarray(rj[0]))
        assert gt[0].dtype == torch.int32
        for g, r in zip(gt[1:], rj[1:]):
            np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-5)


# -- SigDistHist ---------------------------------------------------------------


def _sigdist_blocks(seed):
    """Hot blocks (out-of-range samples past +-1.2), one with NaN, +-Inf and
    huge values, then quiet ones."""
    rng = np.random.default_rng(seed)
    for i, T in enumerate((1024, 1000, 512, 1024, 64)):
        x = ((0.9 if i < 2 else 0.2) * rng.standard_normal((3, T))).astype(np.float32)
        if i == 1:
            x[0, 10], x[1, 20], x[2, 30] = np.nan, np.inf, -np.inf
            x[0, 11], x[1, 21] = 3e9, -3e9
        yield x


@pytest.mark.parametrize("oor", [False, True])
def test_sigdist_matches_jax(oor):
    """Histogram and counters exact (a NaN lands in bin 0 on both sides,
    +-Inf and +-3e9 are dropped); mean, M2 and the sum within the stated
    scale; integrate(False) holds every leaf."""
    jm = j_sigdist.SigDistMeter(48000, reference_oor_count=oor)
    tm = mt.create("SigDistHist", 48000, reference_oor_count=oor)
    js, ts = jm.init((3,)), tm.init((3,), device="cpu")
    scale = SD_OOR_SCALE if oor else SD_SCALE
    upd = jax.jit(jm.update)
    for i, x in enumerate(_sigdist_blocks(3)):
        if i == 4:
            js, ts = jm.integrate(js, False), tm.integrate(ts, False)
        js = upd(js, jnp.asarray(x))
        ts = tm.update(ts, torch.from_numpy(x))
        if i == 1:  # the NaN poisons avg and var of stream 0 as in JAX
            assert int(ts.hist[0, 0]) == int(np.asarray(js.hist)[0, 0]) >= 1
            assert torch.isnan(ts.total[0]) and torch.isnan(ts.m2[0])
        assert_states_close(ts, js, scale, f"after block {i}")
    assert_reads_close(tm.read(ts)[0], jm.read(js)[0], scale)
    assert_states_close(tm.reset(ts), jm.reset(js), 0.0, "reset")


def test_sigdist_oor_prefix_past_2pow24():
    """The complement-form composition keeps the quirk mean moving past
    cnt ~ 2^24, as the JAX package's (within 1e-6 relative)."""
    jm = j_sigdist.SigDistMeter(48000, reference_oor_count=True)
    tm = mt.create("SigDistHist", 48000, reference_oor_count=True)
    js = dataclasses.replace(jm.init(()), time=jnp.asarray(1 << 25, jnp.int32),
                             mean=jnp.asarray(0.5, jnp.float32))
    ts = state_from_numpy(_jax_np(js), device="cpu", cls=type(tm.init((), device="cpu")))
    x = (0.2 + 0.05 * np.random.default_rng(7).standard_normal(4096)).astype(np.float32)
    js, ts = jax.jit(jm.update)(js, jnp.asarray(x)), tm.update(ts, torch.from_numpy(x))
    assert float(ts.mean) != 0.5
    np.testing.assert_allclose(float(ts.mean), float(js.mean), rtol=1e-6)


# -- DR-14 and TP+RMS ------------------------------------------------------------

DR_FS = 2000  # 3 s windows of 6001 samples


def _dr_blocks(C, seed):
    """26 blocks (~4 windows): loud, a silent stretch, NaN and +Inf in one
    channel each, quiet again."""
    rng = np.random.default_rng(seed)
    for i in range(26):
        T = 1000 if i % 3 == 1 else 1024
        lvl = 0.0 if 8 <= i < 15 else (0.5 if i % 5 == 0 else 0.1)
        x = (lvl * rng.standard_normal((2, C, T))).astype(np.float32)
        if i == 17:
            x[0, C - 1, 100] = np.nan
        if i == 20:
            x[1, 0, 7] = np.inf
        yield x


@pytest.mark.parametrize("name,C", [("dr14stereo", 2), ("dr14mono", 1),
                                    ("TPnRMSstereo", 2), ("TPnRMSmono", 1)])
def test_dr14_matches_jax(name, C):
    """Two streams; reads between blocks.  hist, num_windows, scnt exact;
    float leaves and readouts within DR_SCALE of their scale."""
    jcls = j_dr14.TPnRMSMeter if name.startswith("TPnRMS") else j_dr14.DR14Meter
    jm, tm = jcls(DR_FS, nchan=C), mt.create(name, DR_FS, nchan=C)
    js, ts = jm.init((2,)), tm.init((2,), device="cpu")
    upd = jax.jit(jm.update)
    for i, x in enumerate(_dr_blocks(C, seed=C)):
        js = upd(js, jnp.asarray(x))
        ts = tm.update(ts, torch.from_numpy(x))
        if i % 6 == 5:
            jo, js = jm.read(js)
            to, ts = tm.read(ts)
            assert_reads_close(to, jo, DR_SCALE)
    assert_states_close(ts, js, DR_SCALE, name)
    if name.startswith("dr14"):
        assert int(ts.num_windows.min()) >= 2
        # the NaN channel's window is counted by its loud twin, not binned
        assert int(ts.hist[..., 7999].sum()) == int(np.asarray(js.hist)[..., 7999].sum())
    jo, _ = jm.read(js)
    to, _ = tm.read(ts)
    assert_reads_close(to, jo, DR_SCALE)
    assert_states_close(tm.reset(ts), jm.reset(js), 0.0, "reset")


def test_dr14_state_round_trip():
    """A JAX DR-14 state (nested K-meter and true-peak states) seeds the
    port through utils/interop and back."""
    jm = j_dr14.DR14Meter(DR_FS, nchan=2)
    js = jax.jit(jm.update)(jm.init((2,)), jnp.asarray(next(_dr_blocks(2, seed=1))))
    ts = state_from_numpy(_jax_np(js), device="cpu", cls=mt.models.dr14.DR14State)
    assert_states_close(ts, js, 0.0, "seeded")
    np.testing.assert_equal(
        state_to_numpy(state_from_numpy(state_to_numpy(ts), device="cpu",
                                        cls=mt.models.dr14.DR14State)),
        state_to_numpy(ts))


# -- the card by default -----------------------------------------------------------

STATS = ("SigDistHist", "bitmeter", "dr14mono", "dr14stereo", "TPnRMSmono", "TPnRMSstereo")


def test_statistics_meters_registered():
    assert set(STATS) <= set(mt.available())
    assert not set(STATS) & t_base.NOT_YET_PORTED


@pytest.mark.parametrize("name", sorted(t_base._REGISTRY))
def test_init_defaults_to_the_card(name):
    """Every registered meter's init defaults to CUDA; with no card, init()
    with no device raises rather than returning CPU tensors."""
    m = mt.create(name, 48000)
    assert inspect.signature(m.init).parameters["device"].default == "cuda"
    if not torch.cuda.is_available():
        with pytest.raises((RuntimeError, AssertionError)):
            m.init((1,))


def test_state_from_numpy_defaults_to_the_card():
    for f in (state_from_numpy, block_op_to_torch):
        assert inspect.signature(f).parameters["device"].default == "cuda"
    if not torch.cuda.is_available():
        arrays = state_to_numpy(mt.create("bitmeter", 48000).init((), device="cpu"))
        with pytest.raises((RuntimeError, AssertionError)):
            state_from_numpy(arrays, cls=mt.models.bitmeter.BitMeterState)
        with pytest.raises((RuntimeError, AssertionError)):
            block_op_to_torch(mt.create("EBUr128", 48000).sys.op(128))
