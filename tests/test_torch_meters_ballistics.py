"""The port's ballistics-family meters against the JAX meters on CPU: dBTP,
DIN, BBC, BBC M-6, VU, K20 and COR.

The same numpy blocks (fixed seeds) go through both packages, with reads
in between; blocks of 1024, of 1000 (dBTP: a 104-sample tail after the
128-aligned bulk) and of 64 (shorter than one 128-sample frame).  Every
state leaf and every readout is compared; a JAX state seeds the port
mid-stream through utils/interop and both go on together.  Tolerances:
  * int and bool leaves: exact; the resampler history: exact (a copy of
    the input);
  * PPM and true-peak leaves and readouts: 1e-6 relative.  The port
    rounds every step of the recurrence on its own, XLA fuses the
    multiply-add (a few ulp, see tests/test_torch_ballistics.py); dBTP's
    oversamples also differ by BLAS summation order;
  * VU, K-meter and COR (blocked LTI state chains): 1e-5 of each leaf's
    scale, as tests/test_torch_ops.py, since the two packages compose the
    block states in different orders.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import meters_lv2_torch as mt
import meters_lv2_tpu.models as jm
from meters_lv2_torch.models import base as t_base
from meters_lv2_torch.utils.interop import state_from_numpy, state_to_numpy

torch.set_num_threads(1)

PPM_RTOL = 1e-6
LTI_SCALE = 1e-5


def _jax_np(st):
    return {f.name: (_jax_np(v) if dataclasses.is_dataclass(v) else np.asarray(v))
            for f in dataclasses.fields(st) for v in (getattr(st, f.name),)}


def _close(a, b, tol, scaled, what):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape, (what, a.dtype, b.dtype, a.shape, b.shape)
    if b.dtype.kind in "ib":
        np.testing.assert_array_equal(a, b, err_msg=what)
        return
    fin = np.isfinite(b)
    np.testing.assert_array_equal(a[~fin], b[~fin], err_msg=what)
    a, b = a[fin].astype(np.float64), b[fin].astype(np.float64)
    bound = tol * (np.abs(b).max(initial=0.0) if scaled else np.abs(b)) + 1e-30
    assert np.all(np.abs(a - b) <= bound), (what, np.abs(a - b).max())


def assert_states_close(ts, js, tol, scaled, what="state"):
    t, j = state_to_numpy(ts), _jax_np(js)
    assert set(t) == set(j), what

    def walk(a, b, path):
        for k in b:
            if isinstance(b[k], dict):
                walk(a[k], b[k], f"{path}.{k}")
            elif k == "hist":  # the resampler history: exact
                np.testing.assert_array_equal(a[k], b[k], err_msg=f"{path}.{k}")
            else:
                _close(a[k], b[k], tol, scaled, f"{path}.{k}")

    walk(t, j, what)


def assert_reads_close(to, jo, tol, scaled):
    if isinstance(jo, dict):
        assert set(to) == set(jo)
        for k in jo:
            _close(to[k].numpy(), jo[k], tol, scaled, k)
    else:
        _close(to.numpy(), jo, tol, scaled, "read")


def _blocks(sizes, shape, seed):
    """Blocks whose level changes block to block (hold, fall and release
    get exercised), with a loud burst in the second block."""
    rng = np.random.default_rng(seed)
    for i, T in enumerate(sizes):
        lvl = 0.9 if i == 1 else 0.02 * (1 + (5 * i) % 9)
        yield (lvl * rng.standard_normal((*shape, T))).astype(np.float32)


SIZES = [1024, 1000, 64, 1024, 64, 1000, 1024]
# (meter, batch of the state, extra block dims, tol, scaled)
METERS = [
    ("dBTPstereo", (3, 2), (), PPM_RTOL, False),
    ("DINstereo", (3, 2), (), PPM_RTOL, False),
    ("BBCstereo", (3, 2), (), PPM_RTOL, False),
    ("BBCM6", (3,), (2,), PPM_RTOL, False),
    ("VUstereo", (3, 2), (), LTI_SCALE, True),
    ("K20stereo", (3, 2), (), LTI_SCALE, True),
    ("COR", (3,), (2,), LTI_SCALE, True),
]


def _read(meter, st):
    if isinstance(meter, (jm.needle.VUMeter, jm.needle._PPMMeter,
                          jm.needle.BBCMidSideMeter,
                          mt.models.needle.VUMeter, mt.models.needle._PPMMeter,
                          mt.models.needle.BBCMidSideMeter)):
        return meter.read(st, ref_level_db=-20.0)
    return meter.read(st)


@pytest.mark.parametrize("name,batch,extra,tol,scaled", METERS, ids=[m[0] for m in METERS])
def test_port_meter_matches_jax(name, batch, extra, tol, scaled):
    jmeter, tmeter = jm.create(name, 48000), mt.create(name, 48000)
    js, ts = jmeter.init(batch), tmeter.init(batch, device="cpu")
    seeded = None
    for i, x in enumerate(_blocks(SIZES, (*batch, *extra), seed=len(name))):
        js = jmeter.update(js, jnp.asarray(x))
        ts = tmeter.update(ts, torch.from_numpy(x))
        if seeded is not None:
            seeded = tmeter.update(seeded, torch.from_numpy(x))
        if i in (1, 3, 5):  # reads between updates arm the restart flags
            jo, js = _read(jmeter, js)
            to, ts = _read(tmeter, ts)
            assert_reads_close(to, jo, tol, scaled)
            if seeded is not None:
                _, seeded = _read(tmeter, seeded)
        if i == 3:  # a JAX state seeds the port mid-stream
            seeded = state_from_numpy(_jax_np(js), device="cpu", cls=type(ts))
            assert_states_close(seeded, js, 0.0, False, "seeded")
        assert_states_close(ts, js, tol, scaled, f"{name} after block {i}")
    assert_states_close(seeded, js, tol, scaled, "seeded at the end")
    jo, _ = _read(jmeter, js)
    to, _ = _read(tmeter, ts)
    assert_reads_close(to, jo, tol, scaled)


@pytest.mark.parametrize("per_stream", [False, True])
def test_bbcm6_s20_matches_jax(per_stream):
    """S20 (side gain -6 -> +14 dB) as a Python bool or as a per-stream
    bool tensor broadcast over time."""
    jmeter, tmeter = jm.create("BBCM6", 48000), mt.create("BBCM6", 48000)
    js, ts = jmeter.init((3,)), tmeter.init((3,), device="cpu")
    for i, x in enumerate(_blocks([1024, 1000, 1024, 64], (3, 2), seed=9)):
        if per_stream:
            s20 = np.array([i % 2 == 0, True, False])
            js = jmeter.update(js, jnp.asarray(x), jnp.asarray(s20))
            ts = tmeter.update(ts, torch.from_numpy(x), torch.from_numpy(s20))
        else:
            js = jmeter.update(js, jnp.asarray(x), i >= 2)
            ts = tmeter.update(ts, torch.from_numpy(x), i >= 2)
        assert_states_close(ts, js, PPM_RTOL, False)
    jo, _ = jmeter.read(js)
    to, _ = tmeter.read(ts)
    assert_reads_close(to, jo, PPM_RTOL, False)


def test_kmeter_hold_fall_and_reset_peak_match_jax():
    """A peak, then 0.8 s of quiet 1024-sample blocks: the 0.5 s hold runs
    out and the peak falls at 15 dB/s; reset_peak clears the hold only."""
    jmeter, tmeter = jm.create("K20stereo", 48000), mt.create("K20stereo", 48000)
    js, ts = jmeter.init((2, 2)), tmeter.init((2, 2), device="cpu")
    upd = jax.jit(jmeter.update)
    rng = np.random.default_rng(4)
    held = []
    for i in range(40):
        lvl = 0.8 if i == 0 else (0.3 if i == 30 else 0.01)
        x = (lvl * rng.standard_normal((2, 2, 1024))).astype(np.float32)
        js = upd(js, jnp.asarray(x))
        ts = tmeter.update(ts, torch.from_numpy(x))
        held.append(ts.peak[0, 0].item())
        if i == 35:
            js, ts = jmeter.reset_peak(js), tmeter.reset_peak(ts)
        if i % 7 == 6:
            jo, js = jmeter.read(js)
            to, ts = tmeter.read(ts)
            assert_reads_close(to, jo, LTI_SCALE, True)
        assert_states_close(ts, js, LTI_SCALE, True, f"block {i}")
    assert held[1] == held[20] and held[27] < held[20]  # held, then falling
    assert ts.cnt.dtype == torch.int32
    ts = tmeter.reset(ts)
    assert float(ts.rms.abs().max()) == 0.0 and ts.z.shape == (2, 2, 2)


def test_truepeak_process_max_and_reset_match_jax():
    jmeter, tmeter = jm.create("dBTPmono", 48000), mt.create("dBTPmono", 48000)
    js, ts = jmeter.init((3,)), tmeter.init((3,), device="cpu")
    x = (0.5 * np.random.default_rng(2).standard_normal((3, 1000))).astype(np.float32)
    jmx, js = jmeter.process_max(js, jnp.asarray(x))
    tmx, ts = tmeter.process_max(ts, torch.from_numpy(x))
    np.testing.assert_allclose(tmx.numpy(), np.asarray(jmx), rtol=1e-6)
    np.testing.assert_array_equal(ts.hist.numpy(), np.asarray(js.hist))
    ts = tmeter.update(ts, torch.from_numpy(x))
    ts = tmeter.reset(ts)
    assert not bool(ts.bal.m.any()) and bool(ts.bal.res.all()) and bool(ts.hist.any())


def test_ref_level_gain_is_a_0dim_float32():
    """The needle gain multiplies readouts on any device only while it
    stays a 0-dim tensor."""
    g = t_base.ref_level_gain(-20.0)
    assert g.ndim == 0 and g.dtype == torch.float32
