"""Plain versions of the port's ballistics kernels against the JAX package
on CPU.

``ops/ballistics_core.ballistics_reference`` (plain version of
csrc/ballistics.cu) is held against the Pallas kernel
``pallas_ballistics.ballistics_pallas`` in interpret mode and against the
JAX scan ``ops/ballistics._scan_ballistics``.  The port runs one float32
operation per step, each rounded on its own, so it equals a numpy oracle
of the same steps bit for bit, NaN and Inf samples included.  XLA's CPU
code contracts ``z + w*(t - z)`` into a fused multiply-add, so the JAX
side differs from the oracle by an ulp on some steps; the recurrence is
contractive, so the difference stays at 1 ulp in z1 and z2 and 2 in m
(measured over 256 rows x 8192 samples at four coefficient sets).  The
bound stated here is 4 ulp; NaN positions and p are exact.

``ops/truepeak_fused.truepeak_fused_reference`` (plain version of
csrc/truepeak_fused.cu) is held against ``pallas_truepeak.truepeak_pallas``
in interpret mode at rtol 2e-5, the bound of the JAX kernel's own test
(tests/test_pallas_truepeak_fused.py), because the interpret kernel runs
its frame GEMM as a 3-pass bf16 split; and, tighter, against the JAX
package's ``resample.upsample4`` + ``_scan_ballistics`` (float32 on both
sides: the oversamples differ by BLAS summation order only, rtol 1e-6).
The history is exact everywhere.  The CUDA kernels themselves are held
against these plain versions on the card (tests/test_torch_cuda.py,
chip_smoke.py).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from meters_lv2_torch.ops import ballistics_core, truepeak_fused
from meters_lv2_torch.ops import design as t_design
from meters_lv2_tpu.ops import ballistics as j_bal
from meters_lv2_tpu.ops import design as j_design
from meters_lv2_tpu.ops import pallas_ballistics, pallas_truepeak
from meters_lv2_tpu.ops import resample as j_resample

torch.set_num_threads(1)

IEC1 = t_design.iec1_ppm(48000)
IEC2 = t_design.iec2_ppm(44100)
TP = t_design.true_peak_ballistics(48000)


def _states(rng, N, scale=0.3):
    return [np.abs(scale * rng.standard_normal(N)).astype(np.float32) for _ in range(4)]


def _rect(rng, N, T, nonfinite):
    t = np.abs(0.4 * rng.standard_normal((N, T))).astype(np.float32)
    if nonfinite:
        t[0, 17], t[1 % N, T // 2], t[-1, 5] = np.nan, np.inf, np.nan
        t[-1, T - 3] = np.inf
    return t


def _port(t, st, c, track_peak):
    out = ballistics_core.ballistics(
        torch.from_numpy(t), *map(torch.from_numpy, st),
        w1=c.w1, w2=c.w2, w3=c.w3, track_peak=track_peak,
    )
    return [v.numpy() for v in out]


def _assert_same(got, want):
    for a, b in zip(got, want):
        b = np.asarray(b)
        assert a.dtype == b.dtype == np.float32 and a.shape == b.shape
        np.testing.assert_array_equal(a, b)  # NaN == NaN for this check


def _assert_ulps(got, want, bound=4):
    """Same shapes, NaN and Inf positions, p exact, z1/z2/m within
    ``bound`` ulp (the JAX side fuses the multiply-add, see above)."""
    for k, (a, b) in enumerate(zip(got, want)):
        b = np.asarray(b)
        assert a.dtype == b.dtype == np.float32 and a.shape == b.shape
        fin = np.isfinite(b)
        np.testing.assert_array_equal(a[~fin], b[~fin])
        d = np.abs(a[fin].view(np.int32).astype(np.int64) - b[fin].view(np.int32))
        assert d.max(initial=0) <= (0 if k == 3 else bound), (k, d.max())


def _oracle(t, st, c, track_peak):
    """numpy, one rounding per operation: the reference loop step by step."""
    w1, w2, w3 = (np.float32(w) for w in (c.w1, c.w2, c.w3))
    z1, z2, m, p = (v.copy() for v in st)
    with np.errstate(invalid="ignore"):
        for g in range(t.shape[1] // 4):
            z1, z2 = z1 * w3, z2 * w3
            for ti in t[:, 4 * g:4 * g + 4].T:
                z1 = np.where(ti > z1, z1 + w1 * (ti - z1), z1)
                z2 = np.where(ti > z2, z2 + w2 * (ti - z2), z2)
                if track_peak:
                    p = np.where(ti > p, ti, p)
            m = np.maximum(m, z1 + z2)
    return z1, z2, m, p


@pytest.mark.parametrize("N,T,track_peak,nonfinite,c", [
    (5, 1024, False, False, IEC1),
    (5, 1024, True, False, IEC2),
    (8, 2048, True, True, TP),
    (3, 1000, False, True, IEC2),  # T not a multiple of the TPU's chunk
])
def test_ballistics_reference_matches_pallas_interpret(N, T, track_peak, nonfinite, c):
    rng = np.random.default_rng(N * T + track_peak)
    t = _rect(rng, N, T, nonfinite)
    st = _states(rng, N)
    got = _port(t, st, c, track_peak)
    _assert_same(got, _oracle(t, st, c, track_peak))
    want = pallas_ballistics.ballistics_pallas(
        jnp.asarray(t), *map(jnp.asarray, st), w1=c.w1, w2=c.w2, w3=c.w3,
        track_peak=track_peak, interpret=True,
    )
    _assert_ulps(got, want)
    assert ballistics_core.launch_count == 0  # the kernel never runs on CPU


@pytest.mark.parametrize("track_peak", [False, True])
@pytest.mark.parametrize("nonfinite", [False, True])
def test_ballistics_reference_matches_jax_scan(track_peak, nonfinite):
    rng = np.random.default_rng(7 + 2 * track_peak + nonfinite)
    N, T = 6, 1536
    t = _rect(rng, N, T, nonfinite)
    st = _states(rng, N)
    if nonfinite:
        st[2][1] = np.nan  # a NaN carried max propagates like torch.maximum
    got = _port(t, st, IEC1, track_peak)
    z1, z2, m, p = map(jnp.asarray, st)
    want = j_bal._scan_ballistics(
        j_design.iec1_ppm(48000), jnp.asarray(t), z1, z2, m,
        p if track_peak else None, track_peak,
    )
    if not track_peak:
        want = (*want[:3], st[3])  # p passes through unchanged
    _assert_ulps(got, want)
    _assert_same(got, _oracle(t, st, IEC1, track_peak))


def _tp_inputs(N, T, seed, nonfinite=False):
    rng = np.random.default_rng(seed)
    x = (0.5 * rng.standard_normal((N, T))).astype(np.float32)
    h = (0.2 * rng.standard_normal((N, 47))).astype(np.float32)
    st = _states(rng, N, 0.2)
    if nonfinite:
        x[0, 300], x[1, 700], x[2, 130] = np.nan, np.inf, -np.inf
        h[2, 10] = -np.inf
    return x, h, st


def _tp_port(x, h, st, c=TP):
    out = truepeak_fused.truepeak_fused(
        torch.from_numpy(x), torch.from_numpy(h), *map(torch.from_numpy, st),
        w1=c.w1, w2=c.w2, w3=c.w3,
    )
    return [v.numpy() for v in out]


@pytest.mark.parametrize("N,T", [(3, 1280), (2, 2048)])
def test_truepeak_reference_matches_pallas_interpret(N, T):
    x, h, st = _tp_inputs(N, T, seed=N + T)
    got = _tp_port(x, h, st)
    want = [np.asarray(v) for v in pallas_truepeak.truepeak_pallas(
        jnp.asarray(x), jnp.asarray(h), *map(jnp.asarray, st),
        w1=TP.w1, w2=TP.w2, w3=TP.w3, interpret=True,
    )]
    for a, b in zip(got[:4], want[:4]):
        np.testing.assert_allclose(a, b, rtol=2e-5)
    np.testing.assert_array_equal(got[4], want[4])
    assert truepeak_fused.launch_count == 0


@pytest.mark.parametrize("nonfinite", [False, True])
def test_truepeak_reference_matches_jax_ops(nonfinite):
    """upsample4 + abs + the scan, float32 on both sides; a non-finite input
    poisons its 128-sample frame in both packages and the ballistics skip
    the NaN oversamples."""
    x, h, st = _tp_inputs(4, 1024, seed=3 + nonfinite, nonfinite=nonfinite)
    got = _tp_port(x, h, st)
    up, hj = j_resample.upsample4(jnp.asarray(x), jnp.asarray(h))
    want = j_bal._scan_ballistics(
        j_design.true_peak_ballistics(48000), jnp.abs(up),
        *map(jnp.asarray, st), True,
    )
    np.testing.assert_array_equal(got[4], np.asarray(hj))
    for a, b in zip(got[:4], want):
        b = np.asarray(b)
        fin = np.isfinite(b)
        np.testing.assert_array_equal(a[~fin], b[~fin])  # +Inf fed in stays
        np.testing.assert_allclose(a[fin], b[fin], rtol=1e-6)


def test_cuda_wrappers_validate_before_building():
    """The CUDA wrappers refuse bad shapes and types before the build."""
    z = torch.zeros(2)
    with pytest.raises(ValueError, match="multiple of 4"):
        ballistics_core._ballistics_cuda(torch.zeros(2, 6), z, z, z, z, 0.1, 0.1, 0.9, False)
    with pytest.raises(ValueError, match="shape"):
        ballistics_core._ballistics_cuda(torch.zeros(2, 8), z[:1], z, z, z, 0.1, 0.1, 0.9, True)
    with pytest.raises(TypeError, match="float32"):
        ballistics_core._ballistics_cuda(
            torch.zeros(2, 8, dtype=torch.float64), z, z, z, z, 0.1, 0.1, 0.9, True)
    h = torch.zeros(2, 47)
    with pytest.raises(ValueError, match="multiple of 128"):
        truepeak_fused._truepeak_fused_cuda(torch.zeros(2, 200), h, z, z, z, z, 0.1, 0.1, 0.9)
    with pytest.raises(ValueError, match="shape"):
        truepeak_fused._truepeak_fused_cuda(torch.zeros(2, 256), h[:1], z, z, z, z, 0.1, 0.1, 0.9)
    with pytest.raises(ValueError, match="unit stride"):
        truepeak_fused._truepeak_fused_cuda(torch.zeros(256, 2).T, h, z, z, z, z, 0.1, 0.1, 0.9)
    with pytest.raises(ValueError, match="no ballistics for device"):
        ballistics_core.ballistics(torch.zeros(2, 8, device="meta"), z, z, z, z,
                                   w1=0.1, w2=0.1, w3=0.9, track_peak=False)
    with pytest.raises(ValueError, match="multiple of 128"):
        truepeak_fused.truepeak_fused(torch.zeros(2, 200), h, z, z, z, z, w1=0.1, w2=0.1, w3=0.9)


def test_ppm_and_true_peak_ops_match_jax():
    """ops/ballistics: ppm_update/ppm_read and the unfused
    true_peak_update/true_peak_read on a rectified 4x stream, against the
    JAX ops (entry clamps, restart after a read, g scale, res merge,
    denormal offsets), three updates with a read in between."""
    from meters_lv2_torch.ops import ballistics as t_bal

    rng = np.random.default_rng(12)
    c_t, c_j = t_design.iec2_ppm(48000), j_design.iec2_ppm(48000)
    tp_t, tp_j = t_design.true_peak_ballistics(48000), j_design.true_peak_ballistics(48000)
    ts, js = t_bal.ppm_init((2, 3), device="cpu"), j_bal.ppm_init((2, 3))
    tt, jt = t_bal.true_peak_init((2, 3), device="cpu"), j_bal.true_peak_init((2, 3))
    for i in range(3):
        x = np.abs(rng.standard_normal((2, 3, 256)) * (3.0 if i == 0 else 0.2)).astype(np.float32)
        ts, js = t_bal.ppm_update(c_t, ts, torch.from_numpy(x)), j_bal.ppm_update(c_j, js, jnp.asarray(x))
        tt = t_bal.true_peak_update(tp_t, tt, torch.from_numpy(x))
        jt = j_bal.true_peak_update(tp_j, jt, jnp.asarray(x))
        if i == 1:
            tv, ts = t_bal.ppm_read(c_t, ts)
            jv, js = j_bal.ppm_read(c_j, js)
            np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=1e-6)
            tm, tpk, tt = t_bal.true_peak_read(tt)
            jm, jpk, jt = j_bal.true_peak_read(jt)
            np.testing.assert_allclose(tm.numpy(), np.asarray(jm), rtol=1e-6)
            np.testing.assert_array_equal(tpk.numpy(), np.asarray(jpk))
        for a, b in ((ts, js), (tt, jt)):
            for f in ("z1", "z2", "m", "p", "res"):
                if hasattr(b, f):
                    got, want = getattr(a, f).numpy(), np.asarray(getattr(b, f))
                    assert got.dtype == want.dtype and got.shape == want.shape, f
                    np.testing.assert_allclose(got, want, rtol=1e-6, err_msg=f)


def test_unfused_true_peak_below_4300_hz_with_the_envelope_switch(monkeypatch):
    """At fs = 2000, true peak's w2 = 4300 / fs passes 1, outside the
    envelope body's domain: the unfused true_peak_update, whose default is
    the envelope, runs the serial body there and reads as the JAX
    package's (within 0.01 dB)."""
    from meters_lv2_torch.ops import ballistics as t_bal

    bodies = []
    ballistics = ballistics_core.ballistics

    def spy(*a, envelope=False, **k):
        bodies.append(envelope)
        return ballistics(*a, envelope=envelope, **k)

    monkeypatch.setattr(ballistics_core, "ballistics", spy)
    tp_t, tp_j = t_design.true_peak_ballistics(2000), j_design.true_peak_ballistics(2000)
    assert tp_t.w2 > 1 and not ballistics_core.envelope_ok(tp_t.w1, tp_t.w2)
    rng = np.random.default_rng(21)
    tt, jt = t_bal.true_peak_init((3,), device="cpu"), j_bal.true_peak_init((3,))
    n0 = ballistics_core.envelope_launch_count
    for i in range(4):
        x = np.abs(rng.standard_normal((3, 512)) * (1.0 if i % 2 else 0.1)).astype(np.float32)
        tt = t_bal.true_peak_update(tp_t, tt, torch.from_numpy(x))
        jt = j_bal.true_peak_update(tp_j, jt, jnp.asarray(x))
    assert bodies == [False] * 4
    tm, tpk, _ = t_bal.true_peak_read(tt)
    jm, jpk, _ = j_bal.true_peak_read(jt)
    for got, want in ((tm.numpy(), np.asarray(jm)), (tpk.numpy(), np.asarray(jpk))):
        assert np.all(np.isfinite(got)) and np.all(want > 0)
        np.testing.assert_array_less(np.abs(20 * np.log10(got / want)), 0.01)
    assert ballistics_core.envelope_launch_count == n0  # no kernel on the CPU


def test_envelope_body_refuses_coefficients_outside_its_domain():
    """ballistics(envelope=True) raises for w2 > 1 (and w1 < 0); the serial
    body takes them."""
    t = torch.full((2, 16), 0.5)
    z = torch.zeros(2)
    tp = t_design.true_peak_ballistics(2000)
    for w1, w2 in ((tp.w1, tp.w2), (-0.1, 0.5)):
        with pytest.raises(ValueError, match="envelope body needs"):
            ballistics_core.ballistics(t, z, z, z, z, w1=w1, w2=w2, w3=tp.w3,
                                       track_peak=True, envelope=True)
    got = ballistics_core.ballistics(t, z, z, z, z, w1=tp.w1, w2=tp.w2, w3=tp.w3,
                                     track_peak=True)
    assert all(bool(torch.isfinite(v).all()) for v in got)
