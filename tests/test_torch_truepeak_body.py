"""truepeak_fused's two bodies, their plain versions, on the CPU.

``truepeak_fused_reference(body="envelope")`` (the default: upsample4, abs,
``ballistics_envelope_reference``) is held against ``body="serial"``
(upsample4, abs, ``ballistics_reference``) within TPK_RTOL = 1e-5 relative,
chip_smoke.py's bar for the kernel against the plain version, with the same
NaN and Inf values.  The envelope itself stays within 2e-6 of the serial
body (tests/test_torch_variants.py); the bar here is the one the card's
kernels are held to.  Both bodies are held against the JAX package at the
bars of tests/test_torch_ballistics.py: the Pallas kernel in interpret mode
at rtol 2e-5 (its frame GEMM is a 3-pass bf16 split), the JAX
``resample.upsample4`` + ``_scan_ballistics`` at rtol 1e-6.  The history is
exact everywhere.  The plain versions loop over groups in Python, so T
stays at or below 12,288 samples.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from meters_lv2_torch.ops import ballistics_core, resample, truepeak_fused
from meters_lv2_torch.ops import design as t_design
from meters_lv2_tpu.ops import ballistics as j_bal
from meters_lv2_tpu.ops import design as j_design
from meters_lv2_tpu.ops import pallas_truepeak
from meters_lv2_tpu.ops import resample as j_resample

torch.set_num_threads(1)

TPK_RTOL = 1e-5
TP48 = t_design.true_peak_ballistics(48000)
TP441 = t_design.true_peak_ballistics(44100)


def _run(x, h, st, c, body):
    out = truepeak_fused.truepeak_fused_reference(
        torch.from_numpy(x), torch.from_numpy(h), *map(torch.from_numpy, st),
        w1=c.w1, w2=c.w2, w3=c.w3, body=body)
    return [v.numpy() for v in out]


def _assert_bodies_agree(env, ser, what):
    np.testing.assert_array_equal(env[4], ser[4], err_msg=f"{what}: hist")
    for name, a, b in zip(("z1", "z2", "m", "p"), env[:4], ser[:4]):
        fin = np.isfinite(b)
        np.testing.assert_array_equal(a[~fin], b[~fin], err_msg=f"{what}: {name} non-finite")
        np.testing.assert_array_equal(np.isfinite(a), fin, err_msg=f"{what}: {name} finite")
        np.testing.assert_allclose(a[fin], b[fin], rtol=TPK_RTOL, err_msg=f"{what}: {name}")


def _signals(T, seed):
    """Rows: loud (0 dBFS-scale noise), quiet (-60 dB), a 1 kHz sine at
    -18 dBFS, and a burst followed by silence (the release)."""
    rng = np.random.default_rng(seed)
    t = np.arange(T) / 48000.0
    burst = np.zeros(T, np.float32)
    burst[: T // 8] = 0.9 * rng.standard_normal(T // 8)
    x = np.stack([
        0.7 * rng.standard_normal(T),
        1e-3 * rng.standard_normal(T),
        10 ** (-18 / 20) * np.sin(2 * np.pi * 1000.0 * t),
        burst,
    ]).astype(np.float32)
    h = (0.1 * rng.standard_normal((4, 47))).astype(np.float32)
    st = [np.abs(0.3 * rng.standard_normal(4)).astype(np.float32) for _ in range(4)]
    return x, h, st


@pytest.mark.parametrize("c", [TP48, TP441], ids=["48k", "44.1k"])
@pytest.mark.parametrize("T", [1280, 12288])
def test_envelope_matches_serial(c, T):
    x, h, st = _signals(T, seed=T)
    _assert_bodies_agree(_run(x, h, st, c, "envelope"), _run(x, h, st, c, "serial"),
                         f"T={T} w1={c.w1}")


def test_envelope_matches_serial_carried_over_blocks():
    """Twelve 1024-sample calls with the states and history carried, as the
    meter does (m and p restarted each call): the envelope's rounding does
    not grow away from the serial body's."""
    x, h, _ = _signals(12 * 1024, seed=5)
    z = np.zeros(4, np.float32)
    s_env = s_ser = [z, z.copy()]
    h_env = h_ser = h
    for k in range(12):
        xb = np.ascontiguousarray(x[:, k * 1024:(k + 1) * 1024])
        env = _run(xb, h_env, s_env + [z.copy(), z.copy()], TP48, "envelope")
        ser = _run(xb, h_ser, s_ser + [z.copy(), z.copy()], TP48, "serial")
        _assert_bodies_agree(env, ser, f"call {k}")
        s_env, s_ser, h_env, h_ser = env[:2], ser[:2], env[4], ser[4]


def _nonfinite_rows():
    """x [8, 1024] and hist [8, 47] with NaN, +Inf and -Inf in x at the
    first and the last sample of a 128-block and in the history, and rows
    where +Inf and -Inf inputs side by side make oversample groups that
    hold a NaN next to an Inf."""
    rng = np.random.default_rng(17)
    x = (0.3 * rng.standard_normal((8, 1024))).astype(np.float32)
    h = (0.1 * rng.standard_normal((8, 47))).astype(np.float32)
    x[0, 256] = np.nan  # first sample of block 2
    x[1, 383] = np.inf  # last sample of block 2
    x[2, 0] = -np.inf  # first sample of the call
    x[3, 1023] = np.nan  # last sample of the call
    h[4, 0], h[5, 46], h[6, 20] = np.nan, np.inf, -np.inf
    x[7, 600], x[7, 601] = np.inf, -np.inf
    st = [np.abs(0.2 * rng.standard_normal(8)).astype(np.float32) for _ in range(4)]
    return x, h, st


def test_nonfinite_rows_match_serial():
    x, h, st = _nonfinite_rows()
    up, _ = resample.upsample4(torch.from_numpy(x), torch.from_numpy(h))
    g = up.abs().reshape(8, -1, 4).numpy()
    mixed = np.isnan(g).any(-1) & np.isinf(g).any(-1)
    assert mixed[7].any(), "no group holds a NaN next to an Inf"
    for c in (TP48, TP441):
        env, ser = _run(x, h, st, c, "envelope"), _run(x, h, st, c, "serial")
        _assert_bodies_agree(env, ser, f"w1={c.w1}")
    assert np.isposinf(env[0][[1, 2, 5, 6, 7]]).all()  # an Inf input reaches z1


@pytest.mark.parametrize("body", truepeak_fused.BODIES)
@pytest.mark.parametrize("N,T", [(3, 1280), (2, 2048)])
def test_body_matches_pallas_interpret(N, T, body):
    rng = np.random.default_rng(N + T)
    x = (0.5 * rng.standard_normal((N, T))).astype(np.float32)
    h = (0.2 * rng.standard_normal((N, 47))).astype(np.float32)
    st = [np.abs(0.2 * rng.standard_normal(N)).astype(np.float32) for _ in range(4)]
    got = _run(x, h, st, TP48, body)
    want = [np.asarray(v) for v in pallas_truepeak.truepeak_pallas(
        jnp.asarray(x), jnp.asarray(h), *map(jnp.asarray, st),
        w1=TP48.w1, w2=TP48.w2, w3=TP48.w3, interpret=True)]
    for a, b in zip(got[:4], want[:4]):
        np.testing.assert_allclose(a, b, rtol=2e-5)
    np.testing.assert_array_equal(got[4], want[4])


@pytest.mark.parametrize("body", truepeak_fused.BODIES)
@pytest.mark.parametrize("nonfinite", [False, True])
def test_body_matches_jax_ops(nonfinite, body):
    rng = np.random.default_rng(3 + nonfinite)
    x = (0.5 * rng.standard_normal((4, 1024))).astype(np.float32)
    h = (0.2 * rng.standard_normal((4, 47))).astype(np.float32)
    st = [np.abs(0.2 * rng.standard_normal(4)).astype(np.float32) for _ in range(4)]
    if nonfinite:
        x[0, 300], x[1, 700], x[2, 130] = np.nan, np.inf, -np.inf
        h[2, 10] = -np.inf
    got = _run(x, h, st, TP48, body)
    up, hj = j_resample.upsample4(jnp.asarray(x), jnp.asarray(h))
    want = j_bal._scan_ballistics(j_design.true_peak_ballistics(48000), jnp.abs(up),
                                  *map(jnp.asarray, st), True)
    np.testing.assert_array_equal(got[4], np.asarray(hj))
    for a, b in zip(got[:4], want):
        b = np.asarray(b)
        fin = np.isfinite(b)
        np.testing.assert_array_equal(a[~fin], b[~fin])
        np.testing.assert_allclose(a[fin], b[fin], rtol=1e-6)


def test_cpu_wrapper_runs_the_default_body():
    """On CPU tensors truepeak_fused runs the plain version of the body the
    card runs by default (the envelope), bit for bit, and launches nothing;
    body="serial" runs the serial plain version."""
    x, h, st = _signals(2560, seed=2)
    args = [torch.from_numpy(a) for a in [x, h] + st]
    w = dict(w1=TP48.w1, w2=TP48.w2, w3=TP48.w3)
    n0 = (truepeak_fused.launch_count, truepeak_fused.serial_launch_count)
    default = truepeak_fused.truepeak_fused(*args, **w)
    env = truepeak_fused.truepeak_fused_reference(*args, **w, body="envelope")
    ser = truepeak_fused.truepeak_fused(*args, **w, body="serial")
    up, _ = resample.upsample4(args[0], args[1])
    direct = ballistics_core.ballistics_reference(up.abs(), *args[2:], **w, track_peak=True)
    assert all(torch.equal(a, b) for a, b in zip(default, env))
    assert all(torch.equal(a, b) for a, b in zip(ser[:4], direct))
    assert not all(torch.equal(a, b) for a, b in zip(default[:3], ser[:3]))
    assert (truepeak_fused.launch_count, truepeak_fused.serial_launch_count) == n0


def test_unknown_body_is_refused():
    z = torch.zeros(2)
    x, h = torch.zeros(2, 256), torch.zeros(2, 47)
    w = dict(w1=0.1, w2=0.1, w3=0.9)
    with pytest.raises(ValueError, match="body must be one of"):
        truepeak_fused.truepeak_fused(x, h, z, z, z, z, **w, body="fma")
    with pytest.raises(ValueError, match="body must be one of"):
        truepeak_fused.truepeak_fused_reference(x, h, z, z, z, z, **w, body="Envelope")
    with pytest.raises(ValueError, match="body must be one of"):  # before the build
        truepeak_fused._truepeak_fused_cuda(x, h, z, z, z, z, 0.1, 0.1, 0.9, "two-group")


def test_envelope_domain_and_the_meters_choice():
    """The envelope needs 0 <= w <= 1 (each attack step monotone in z);
    true peak's w2 = 4300 / fs passes 1 below 4,300 Hz.  There the envelope
    body refuses, and true_peak_update_fused runs the serial body (equal to
    the serial plain version), while at 8 kHz and up it runs the envelope."""
    from meters_lv2_torch.ops import ballistics as t_bal

    c8 = t_design.true_peak_ballistics(8000)
    assert truepeak_fused.envelope_ok(TP441.w1, TP441.w2) and truepeak_fused.envelope_ok(c8.w1, c8.w2)
    low = t_design.true_peak_ballistics(2000)
    assert low.w2 > 1 and not truepeak_fused.envelope_ok(low.w1, low.w2)
    x, h, st = _signals(1024, seed=8)
    with pytest.raises(ValueError, match="envelope body needs"):
        _run(x, h, st, low, "envelope")
    for c, body in ((low, "serial"), (TP48, "envelope")):
        s0 = t_bal.true_peak_init((4,), device="cpu")
        s1, h1 = t_bal.true_peak_update_fused(c, s0, torch.from_numpy(x), torch.from_numpy(h))
        z = torch.zeros(4)
        want = truepeak_fused.truepeak_fused_reference(
            torch.from_numpy(x), torch.from_numpy(h), z, z, z, z, w1=c.w1, w2=c.w2, w3=c.w3,
            body=body)
        assert torch.equal(s1.z1, want[0] + 1e-20) and torch.equal(h1, want[4]), body
