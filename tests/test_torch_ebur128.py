"""Port EbuR128Meter (meters_lv2_torch) against the JAX EbuR128Meter on CPU
and against the committed C-reference goldens.

The JAX meter runs its XLA path here (exact for any T); the port runs the
plain versions of its kernels (CPU tensors).  Inputs are numpy arrays from
fixed seeds, fed to both.  Tolerances:
  * integer leaves (histograms, counts, phases, offsets, radar positions,
    sample counters): exact;
  * the true-peak history: exact (a copy of the input), dbtp: 1e-6
    relative (the same oversamples through two BLAS libraries);
  * loudness-valued leaves and readouts (LUFS/LU, radar rings): 1e-4 dB
    absolute, 100x the float32 noise measured between the two packages
    (~1e-6 dB) and 100x inside the 0.01 dB parity budget;
  * fragment powers: 1e-5 relative (two summation orders of float32);
  * the K-weighting state: 1e-5 of each component's scale (the state
    chain rounds differently: the JAX package composes >= 16 blocks by
    associative scan, the port by a loop).
The goldens use the bars of tests/test_golden_parity.py: 0.01 dB on every
readout and bin-exact histograms and counts.
"""

import glob
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from signals import make_signal, make_surround
from meters_lv2_torch.models.ebur128 import STATE_FIELDS
from meters_lv2_torch.models.ebur128 import EbuR128Meter as TorchMeter
from meters_lv2_torch.utils.interop import (
    block_op_to_torch, state_from_numpy, state_to_numpy,
)
from meters_lv2_tpu.models.ebur128 import EbuR128Meter as JaxMeter

torch.set_num_threads(1)

FIXDIR = os.path.join(os.path.dirname(__file__), "fixtures")
TOL_DB = 0.01
LOUD_ATOL = 1e-4

_LOUD = {"loud_m", "loud_s", "max_m", "max_s", "radar_m", "radar_s",
         "radar_cur_m", "radar_cur_s"}


def _jax_state_np(st):
    return {k: np.asarray(getattr(st, k)) for k in STATE_FIELDS}


def assert_states_match(ts, js):
    """Every EbuR128State leaf of the port against the JAX state."""
    t = state_to_numpy(ts)
    j = _jax_state_np(js)
    for k in STATE_FIELDS:
        a, b = t[k], j[k]
        assert a.dtype == b.dtype and a.shape == b.shape, (k, a.dtype, b.dtype, a.shape, b.shape)
        if b.dtype.kind in "ib" or k == "tp_hist":
            np.testing.assert_array_equal(a, b, err_msg=k)
        elif k in _LOUD:
            np.testing.assert_allclose(a, b, rtol=0, atol=LOUD_ATOL, err_msg=k)
        elif k == "z":
            scale = np.abs(b).max(axis=tuple(range(b.ndim - 1)))
            assert np.all(np.abs(a - b) <= 1e-5 * scale), (k, np.abs(a - b).max(), scale)
        elif k == "dbtp":
            np.testing.assert_allclose(a, b, rtol=1e-6, err_msg=k)
        else:  # frpwr, fhist
            np.testing.assert_allclose(a, b, rtol=1e-5, err_msg=k)


def assert_reads_match(to, jo):
    assert set(to) == set(jo)
    for k in jo:
        a, b = to[k].numpy(), np.asarray(jo[k])
        assert a.dtype == b.dtype and a.shape == b.shape, k
        if b.dtype.kind in "ib":
            np.testing.assert_array_equal(a, b, err_msg=k)
        elif k == "dbtp":
            np.testing.assert_allclose(a, b, rtol=1e-6, err_msg=k)
        elif k == "integ_time_s":
            np.testing.assert_array_equal(a, b, err_msg=k)
        else:
            np.testing.assert_allclose(a, b, rtol=0, atol=LOUD_ATOL, err_msg=k)


def _blocks(n, B, T, seed):
    """n blocks [B, 2, T] whose level changes block to block, so the
    gated integration and the loudness range see a spread."""
    rng = np.random.default_rng(seed)
    for i in range(n):
        lvl = 0.02 * (1 + (7 * i) % 11)
        yield (lvl * rng.standard_normal((B, 2, T))).astype(np.float32)


# (block T, flat layout, meter options, updates): 128-aligned bulk with a
# partial fragment, a non-128 tail (2400), and T < 128; both layouts; both
# radar modes; 500 ms cadence; runtime radar speed
CASES = [
    (128 * 41, True, dict(track_cadence=True), 56),
    (128 * 41, False, dict(reference_radar=True), 24),
    (2400, True, dict(runtime_radar_speed=True), 230),
    (2400, False, dict(reference_radar=True, track_cadence=True), 60),
    (64, False, dict(track_cadence=True), 50),
    (64, True, dict(reference_radar=True), 40),
]


@pytest.mark.parametrize("T,flat,opts,n", CASES)
def test_port_matches_jax_meter(T, flat, opts, n):
    B = 3
    jm, tm = JaxMeter(48000, nchan=2, **opts), TorchMeter(48000, nchan=2, **opts)
    js, ts = jm.init((B,)), tm.init((B,), device="cpu")
    upd = jax.jit(lambda s, x: jm.update(s, x, flat=flat))
    for i, x in enumerate(_blocks(n, B, T, seed=T + n)):
        if flat:
            x = x.reshape(B, -1)
        js = upd(js, jnp.asarray(x))
        ts = tm.update(ts, torch.from_numpy(x), flat=flat)
        if opts.get("runtime_radar_speed") and i == n // 2:
            js = jm.set_radar_speed(js, 45.0)
            ts = tm.set_radar_speed(ts, 45.0)
    assert_states_match(ts, js)
    jo, _ = jm.read(js)
    to, _ = tm.read(ts)
    assert_reads_match(to, jo)
    if opts.get("track_cadence"):
        jo, _ = jm.read(js, cadence_500ms=True)
        to, _ = tm.read(ts, cadence_500ms=True)
        assert_reads_match(to, jo)
    if T == 2400 and flat:  # long enough for gated I and LRA
        assert np.all(to["integrated"].numpy() > -100)
        assert np.all(to["lra"].numpy() > 0)


def test_integration_and_radar_controls_match_jax():
    """integr_pause/start/reset, radar_reset and set_radar_speed as state
    updates between blocks, against the JAX meter."""
    B, T = 2, 4800
    jm = JaxMeter(48000, nchan=2, runtime_radar_speed=True, track_cadence=True)
    tm = TorchMeter(48000, nchan=2, runtime_radar_speed=True, track_cadence=True)
    js, ts = jm.init((B,)), tm.init((B,), device="cpu")
    upd = jax.jit(jm.update)
    controls = {
        10: ("integr_pause",), 20: ("integr_start",), 30: ("radar_reset",),
        40: ("set_radar_speed", 30.0), 50: ("integr_reset",),
        55: ("set_radar_speed", 1e6),  # clamped to 4 h
    }
    for i, x in enumerate(_blocks(70, B, T, seed=5)):
        js = upd(js, jnp.asarray(x))
        ts = tm.update(ts, torch.from_numpy(x))
        if i in controls:
            name, *args = controls[i]
            js = getattr(jm, name)(js, *args)
            ts = getattr(tm, name)(ts, *args)
            assert_states_match(ts, js)
    assert_states_match(ts, js)
    for cad in (False, True):
        to, _ = tm.read(ts, cadence_500ms=cad)
        jo, _ = jm.read(js, cadence_500ms=cad)
        assert_reads_match(to, jo)
    np.testing.assert_array_equal(tm.total_samples(ts).numpy(), np.asarray(jm.total_samples(js)))


def test_mid_stream_seed_from_jax_state():
    """A JAX state (np.asarray of its leaves) seeds the port mid-stream;
    both continue and stay together.  Operators cross the same way."""
    B, T = 3, 3000
    jm, tm = JaxMeter(48000, nchan=2), TorchMeter(48000, nchan=2)
    js = jm.init((B,))
    upd = jax.jit(jm.update)
    blocks = list(_blocks(40, B, T, seed=17))
    for x in blocks[:25]:
        js = upd(js, jnp.asarray(x))
    ts = state_from_numpy(_jax_state_np(js), device="cpu")
    assert_states_match(ts, js)
    np.testing.assert_equal(state_to_numpy(state_from_numpy(state_to_numpy(ts), device="cpu")),
                            state_to_numpy(ts))
    for x in blocks[25:]:
        js = upd(js, jnp.asarray(x))
        ts = tm.update(ts, torch.from_numpy(x))
    assert_states_match(ts, js)
    assert_reads_match(tm.read(ts)[0], jm.read(js)[0])

    jop = jm.sys.op(128)
    for k, v in block_op_to_torch(jop, device="cpu")._asdict().items():
        np.testing.assert_array_equal(v.numpy(), getattr(jop, k))
        np.testing.assert_array_equal(v.numpy(), getattr(tm.sys.op(128), k))
    with pytest.raises(KeyError):
        state_from_numpy({k: v for k, v in _jax_state_np(js).items() if k != "z"}, device="cpu")


def _fixtures(prefix):
    out = []
    for p in sorted(glob.glob(os.path.join(FIXDIR, prefix + "_*.json"))):
        with open(p) as f:
            fx = json.load(f)
        if fx["meter"] == prefix:
            out.append(fx)
    return out


def _check(rec_val, got, what):
    if rec_val <= -199.0:
        assert got <= -199.0, (what, got, rec_val)
    else:
        assert abs(got - rec_val) < TOL_DB, (what, got, rec_val)


@pytest.mark.parametrize("prefix", ["ebur128", "ebur128mono", "ebur128_aligned", "ebur128_5ch"])
def test_golden_parity(prefix):
    """The asserts of tests/test_golden_parity.py (test_ebur128_parity,
    test_ebur128_5channel_parity, test_ebur128_cadence_500ms_parity)
    through the port: +-0.01 dB and bin-exact histograms and counts."""
    fxs = _fixtures(prefix)
    assert fxs, prefix
    for fx in fxs:
        m = TorchMeter(fx["fs"], nchan=fx["nchan"], track_cadence=True)
        if prefix == "ebur128_5ch":
            x = make_surround(fx["signal"], fx["seconds"], fs=fx["fs"])
        else:
            x = make_signal(fx["signal"], fx["seconds"], fs=fx["fs"])[: fx["nchan"]]
        xt = torch.from_numpy(x)
        st = m.init((), device="cpu")
        mid = iter([r for r in fx["reads"] if "final" not in r])
        final = [r for r in fx["reads"] if r.get("final")][0]
        keys = [("M", "loudness_M"), ("S", "loudness_S")]
        if prefix != "ebur128_5ch":
            keys += [("maxM", "max_M"), ("maxS", "max_S")]
        if prefix in ("ebur128_aligned", "ebur128_5ch"):
            keys += [("I", "integrated")]
        if prefix == "ebur128_aligned":
            keys += [("LRAmin", "range_min"), ("LRAmax", "range_max")]
        blk = fx["block"]
        for b in range(x.shape[1] // blk):
            st = m.update(st, xt[:, b * blk:(b + 1) * blk])
            if (b + 1) % fx["read_every"] == 0:
                out, _ = m.read(st)
                rec = next(mid)
                tag = f"{prefix}/{fx['signal']} blk {rec['block']}"
                for key, mine in keys:
                    _check(rec[key], float(out[mine]), f"{tag} {key}")
                if prefix == "ebur128":  # the reference's cached I/LRA
                    out, _ = m.read(st, cadence_500ms=True)
                    for key, mine in [("I", "integrated"), ("LRAmin", "range_min"),
                                      ("LRAmax", "range_max")]:
                        _check(rec[key], float(out[mine]), f"{tag} {key} (500 ms)")
        tag = f"{prefix}/{fx['signal']}"
        np.testing.assert_array_equal(st.hist_m.numpy(), final["histM"], err_msg=tag)
        np.testing.assert_array_equal(st.hist_s.numpy(), final["histS"], err_msg=tag)
        assert int(st.count_m) == final["countM"], tag
        assert int(st.count_s) == final["countS"], tag


@pytest.mark.parametrize("prefix", ["ebur128_44k", "ebur128_96k", "ebur128_blk4096"])
def test_golden_rates_and_block_size(prefix):
    """tests/test_golden_parity.py::test_parity_441khz, test_parity_96khz
    and test_block_size_invariance for R128 through the port: M and S
    within 0.01 dB at every read (44.1/96 kHz), histograms bin-exact."""
    fxs = _fixtures(prefix)
    assert fxs, prefix
    for fx in fxs:
        m = TorchMeter(fx["fs"], nchan=2)
        xt = torch.from_numpy(make_signal(fx["signal"], fx["seconds"], fs=fx["fs"]))
        st = m.init((), device="cpu")
        mid = iter([r for r in fx["reads"] if "final" not in r])
        final = [r for r in fx["reads"] if r.get("final")][0]
        blk = fx["block"]
        for b in range(xt.shape[1] // blk):
            st = m.update(st, xt[:, b * blk:(b + 1) * blk])
            if prefix != "ebur128_blk4096" and (b + 1) % fx["read_every"] == 0:
                out, _ = m.read(st)
                rec = next(mid)
                for key, mine in [("M", "loudness_M"), ("S", "loudness_S")]:
                    if rec[key] > -199.0:
                        _check(rec[key], float(out[mine]), f"{prefix} blk {rec['block']} {key}")
        np.testing.assert_array_equal(st.hist_m.numpy(), final["histM"], err_msg=prefix)
        if prefix != "ebur128_44k":
            np.testing.assert_array_equal(st.hist_s.numpy(), final["histS"], err_msg=prefix)


def test_reference_radar_ring_golden():
    """tests/test_golden_parity.py::test_ebur128_reference_radar_parity
    through the port: reference_radar=True reproduces the wrapper's
    block-rate radar ring; positions exact, values within 5e-4."""
    fxs = [fx for fx in _fixtures("ebur128") if fx["nchan"] == 2]
    assert len(fxs) == 7
    for fx in fxs:
        m = TorchMeter(fx["fs"], nchan=2, reference_radar=True)
        xt = torch.from_numpy(make_signal(fx["signal"], fx["seconds"], fs=fx["fs"]))
        st = m.init((), device="cpu")
        blk = fx["block"]
        for b in range(xt.shape[1] // blk):
            st = m.update(st, xt[:, b * blk:(b + 1) * blk])
        final = [r for r in fx["reads"] if r.get("final")][0]
        assert int(st.radar_pos) == final["radarPos"], fx["signal"]
        for got, want, tag in ((st.radar_m.numpy(), np.asarray(final["radarM"]), "M"),
                               (st.radar_s.numpy(), np.asarray(final["radarS"]), "S")):
            unset = want <= -998.0  # -999 encodes -inf
            assert np.all(np.isneginf(got[unset])), (fx["signal"], tag)
            np.testing.assert_allclose(got[~unset], want[~unset], atol=5e-4,
                                       err_msg=f"{fx['signal']} radar{tag}")


def _tone(level_dbfs, seconds, fs=48000, f0=997.0):
    t = np.arange(int(fs * seconds)) / fs
    s = (10 ** (level_dbfs / 20.0) * np.sin(2 * np.pi * f0 * t)).astype(np.float32)
    return np.stack([s, s])


def _whole(*parts):
    """The port meter over the parts, one update each; the readouts."""
    m = TorchMeter(48000, nchan=2)
    st = m.init((), device="cpu")
    for x in parts:
        st = m.update(st, torch.from_numpy(x))
    return {k: float(v) for k, v in m.read(st)[0].items() if v.ndim == 0}


def _compliance(case):
    if case == "bs1770_1khz_calibration":
        out = _whole(_tone(-23.0, 10.0))
        assert abs(out["integrated"] + 23.0) < 0.1  # Tech 3341; 0.1 LU bins
        assert abs(out["loudness_M"] + 23.0) < 0.05
        assert abs(out["loudness_S"] + 23.0) < 0.05
    elif case == "gain_linearity":
        d = _whole(_tone(-23.0, 10.0))["integrated"] - _whole(_tone(-33.0, 10.0))["integrated"]
        assert abs(d - 10.0) < 0.02
    elif case == "absolute_gate_ignores_silence":
        a = _whole(_tone(-23.0, 10.0))["integrated"]
        b = _whole(_tone(-23.0, 10.0), np.zeros((2, 48000 * 8), np.float32))["integrated"]
        assert abs(a - b) < 0.1
    elif case == "relative_gate_excludes_quiet_passage":
        i = _whole(np.concatenate([_tone(-36.0, 20.0), _tone(-23.0, 20.0)], axis=1))["integrated"]
        assert -23.6 < i < -22.9, i
    elif case == "lra_two_level_programme":
        lra = _whole(np.concatenate([_tone(-30.0, 20.0), _tone(-20.0, 20.0)], axis=1))["lra"]
        assert 8.0 < lra < 11.0, lra
    else:  # momentary_vs_short_windows
        out = _whole(_tone(-33.0, 6.0), _tone(-23.0, 1.0))
        assert abs(out["loudness_M"] + 23.0) < 0.1
        assert out["loudness_S"] < -24.0


@pytest.mark.parametrize("case", [
    "bs1770_1khz_calibration", "gain_linearity", "absolute_gate_ignores_silence",
    "relative_gate_excludes_quiet_passage", "lra_two_level_programme",
    "momentary_vs_short_windows",
])
def test_standards_compliance(case):
    """tests/test_standards_compliance.py through the port: BS.1770 1 kHz
    calibration, dB linearity, the absolute and relative gates, the LRA of
    a two-level programme and the M/S window lengths (EBU Tech 3341/3342
    constructions), each block fed to one update()."""
    _compliance(case)
