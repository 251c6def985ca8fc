"""The port's kernel variants against the JAX package on the CPU: the
ballistics envelope body, the R128 core's seg mode and the surround wide
layout (their plain versions; the CUDA kernels are held against these on
the card by tests/test_torch_cuda.py and chip_smoke.py).

Bars:
  * envelope (``ballistics_envelope_reference``) against the serial body
    (the port's plain version, bit-exact to a numpy oracle of the reference
    loop): rtol 2e-6, atol 1e-7, the bar of tests/test_ballistics_envelope.py.
    Against the JAX envelope in interpret mode: each is within that bar of
    the serial body, so 4e-6 / 2e-7 (the JAX body forms d a^k + b_k, the
    port d + (b_k - d c_k)).  The raw peak p is exact.  Every
    comparison with the JAX envelope leaves out the groups where it gives NaN
    and the serial body does not (``test_envelope_nan_and_inf``);
  * seg mode: the port's plain seg against its own full-rate p followed by
    ``segment.shifted_segments`` within rtol 2e-6, atol 1e-9, z / hist /
    tpmax bit-identical (the bars of tests/test_pallas_r128_fused.py:
    262-265); against the Pallas kernel's seg mode in interpret mode the
    bars of test_torch_r128_fused.py's interpret test (its GEMMs are 3-pass
    bf16): seg 2e-4 relative, z 1e-4, hist exact, tpmax 1e-4;
  * wide layout: the plain core (both layouts' plain version) against the
    Pallas wide kernel ``_fused_core_wide`` in interpret mode, at
    test_torch_surround.py's interpret bars: block peak exact, km_z 2e-5
    relative, zl and zp 2e-4 relative (atol 1e-8), non-finite alike.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import meters_lv2_torch as mt
from meters_lv2_torch.ops import ballistics_core, r128_fused, segment, surround_fused
from meters_lv2_torch.ops import design as t_design
from meters_lv2_torch.ops import lti as t_lti
from meters_lv2_tpu.models import create as jax_create
from meters_lv2_tpu.ops import lti as j_lti
from meters_lv2_tpu.ops import pallas_ballistics, pallas_r128, pallas_surround
from test_torch_ballistics import _oracle
from test_torch_surround import _core_inputs

torch.set_num_threads(1)

ENV_RTOL, ENV_ATOL = 2e-6, 1e-7


# -- B5: the ballistics envelope body ----------------------------------------


def _port(t, st, c, track_peak, envelope):
    out = ballistics_core.ballistics(
        torch.from_numpy(t), *map(torch.from_numpy, st),
        w1=c.w1, w2=c.w2, w3=c.w3, track_peak=track_peak, envelope=envelope)
    return [v.numpy() for v in out]


def _jax_env(t, st, c, track_peak, envelope=True):
    return [np.asarray(v) for v in pallas_ballistics.ballistics_pallas(
        jnp.asarray(t), *map(jnp.asarray, st), w1=c.w1, w2=c.w2, w3=c.w3,
        track_peak=track_peak, envelope=envelope, interpret=True)]


def _assert_env_close(got, want, rtol, atol, what):
    """Same non-finite values; p exact; z1, z2, m within the bar."""
    for k, (a, b) in enumerate(zip(got, want)):
        b = np.asarray(b)
        assert a.dtype == b.dtype == np.float32 and a.shape == b.shape
        fin = np.isfinite(b)
        np.testing.assert_array_equal(a[~fin], b[~fin], err_msg=f"{what} {k}")
        if k == 3:
            np.testing.assert_array_equal(a, b, err_msg=f"{what} p")
        else:
            np.testing.assert_allclose(a[fin], b[fin], rtol=rtol, atol=atol,
                                       err_msg=f"{what} {k}")


def _adversarial(B=8, T=256):
    """tests/test_ballistics_envelope.py's rows: silence runs (pure decay),
    a huge spike, NaN samples, a +Inf sample at the first position of its
    group (where the JAX envelope follows it)."""
    rng = np.random.default_rng(3)
    t = np.abs(rng.standard_normal((B, T))).astype(np.float32)
    t[0, 32:128] = 0.0
    t[1, 77] = 50.0
    t[2, 10] = np.nan
    t[3, ::7] = np.nan
    t[4, 100] = np.inf
    z1 = np.abs(rng.standard_normal(B)).astype(np.float32) * 0.5
    z2 = np.abs(rng.standard_normal(B)).astype(np.float32) * 0.5
    z = np.zeros(B, np.float32)
    return t, [z1, z2, z, z.copy()]


def _random_rows(seed, c_scale=0.7, B=16, T=512):
    rng = np.random.default_rng(seed)
    t = np.abs(c_scale * rng.standard_normal((B, T))).astype(np.float32)
    return t, [np.abs(0.3 * rng.standard_normal(B)).astype(np.float32) for _ in range(4)]


ENV_CASES = {
    "adversarial iec2 48k": (_adversarial, t_design.iec2_ppm(48000)),
    "random true peak 192k": (lambda: _random_rows(11), t_design.true_peak_ballistics(192000)),
    "random iec1 44.1k": (lambda: _random_rows(5, 0.4, 6, 1024), t_design.iec1_ppm(44100)),
}


@pytest.mark.parametrize("track_peak", [False, True])
@pytest.mark.parametrize("case", sorted(ENV_CASES))
def test_envelope_reference_matches_serial_and_pallas(case, track_peak):
    make, c = ENV_CASES[case]
    t, st = make()
    got = _port(t, st, c, track_peak, envelope=True)
    serial = _port(t, st, c, track_peak, envelope=False)
    for a, b in zip(serial, _oracle(t, st, c, track_peak)):
        np.testing.assert_array_equal(a, b)  # the serial plain version is the oracle
    _assert_env_close(got, serial, ENV_RTOL, ENV_ATOL, "envelope vs serial")
    jax_env = _jax_env(t, st, c, track_peak)
    _assert_env_close(got, jax_env, 2 * ENV_RTOL, 2 * ENV_ATOL, "envelope vs JAX envelope")
    assert ballistics_core.launch_count == ballistics_core.envelope_launch_count == 0


def _nan_inf_rows():
    """16 samples of 0.1 a row, zero state.  Rows 0 and 1: a NaN and a +Inf
    in one group, both orders; row 2: a NaN alone; row 3: a +Inf alone at
    the second position of its group; row 4: a +Inf, then a NaN in a later
    group; row 5: a +Inf alone at the first position of its group."""
    t = np.full((6, 16), 0.1, np.float32)
    t[0, 4], t[0, 5] = np.nan, np.inf
    t[1, 4], t[1, 5] = np.inf, np.nan
    t[2, 4] = np.nan
    t[3, 5] = np.inf
    t[4, 4], t[4, 9] = np.inf, np.nan
    t[5, 4] = np.inf
    z = np.zeros(6, np.float32)
    return t, [z, z.copy(), z.copy(), z.copy()]


def test_envelope_nan_and_inf():
    """Where the JAX envelope gives NaN, the port's gives the serial body's
    +Inf.  The JAX body's max-plus DP adds the -inf of a NaN sample, or the
    -inf of an intercept no attack subset reaches, to a +Inf (pallas_
    ballistics.py:84-92), and jnp.maximum keeps the NaN; the serial body
    (and the C reference, iec2ppmdsp.cc:47-80) skips the NaN sample and
    follows the +Inf.  The port's DP drops such candidates (fmax)."""
    c = t_design.iec2_ppm(48000)
    t, st = _nan_inf_rows()
    port = _port(t, st, c, True, envelope=True)
    jax_env = _jax_env(t, st, c, True, envelope=True)
    jax_serial = _jax_env(t, st, c, True, envelope=False)
    bad = [0, 1, 3, 4]  # the rows the JAX envelope turns to NaN
    for k in range(3):  # z1, z2, m
        assert np.isnan(jax_env[k][bad]).all(), k
        assert np.isposinf(jax_serial[k][bad]).all(), k
        assert np.isposinf(port[k][bad]).all(), k
        assert np.isposinf(port[k][5]) and np.isposinf(jax_env[k][5])
        np.testing.assert_allclose(port[k][2], jax_env[k][2], rtol=ENV_RTOL)
        np.testing.assert_allclose(port[k][2], jax_serial[k][2], rtol=ENV_RTOL)
    np.testing.assert_array_equal(port[3], jax_serial[3])  # p: inf on rows 0, 1, 3-5
    _assert_env_close(port, _port(t, st, c, True, envelope=False), ENV_RTOL, ENV_ATOL,
                      "envelope vs serial")


def test_envelope_keeps_a_nan_state():
    """A NaN carried z or m stays NaN through the envelope, as in the serial
    body; a +Inf carried into a group with a NaN sample stays +Inf."""
    c = t_design.iec1_ppm(48000)
    t = np.full((3, 8), 0.2, np.float32)
    t[2, 1] = np.nan
    z1 = np.array([np.nan, 0.1, np.inf], np.float32)
    z2 = np.array([0.1, 0.1, 0.1], np.float32)
    m = np.array([0.0, np.nan, 0.0], np.float32)
    st = [z1, z2, m, np.zeros(3, np.float32)]
    got = _port(t, st, c, True, envelope=True)
    want = _port(t, st, c, True, envelope=False)
    _assert_env_close(got, want, ENV_RTOL, ENV_ATOL, "NaN / Inf states")
    assert np.isnan(got[0][0]) and np.isnan(got[2][:2]).all() and np.isposinf(got[0][2])


def test_envelope_decrements_and_validation():
    """c_k = 1 - (1 - w)^k are float64 values of w = float32(w) rounded
    once, c_1 = w; the envelope wants T % 4 == 0 like the serial body."""
    w = t_design.true_peak_ballistics(192000).w1
    a = 1.0 - float(np.float32(w))
    c = ballistics_core.envelope_decrements(w)
    assert c == tuple(float(np.float32(1.0 - a**k)) for k in range(1, 5))
    assert c[0] == float(np.float32(w))
    z = torch.zeros(2)
    with pytest.raises(ValueError, match="multiple of 4"):
        ballistics_core.ballistics_envelope_reference(
            torch.zeros(2, 6), z, z, z, z, w1=0.1, w2=0.1, w3=0.9, track_peak=False)
    with pytest.raises(ValueError, match="multiple of 4"):
        ballistics_core._ballistics_cuda(torch.zeros(2, 6), z, z, z, z, 0.1, 0.1, 0.9, False,
                                         True)


def test_envelope_tracks_the_serial_body_over_a_second():
    """Over 12,000 groups (1 s at 48 kHz) the envelope stays within its bar
    of the serial body: the decay carries its rounding on c_k, not on a
    float32 a^k, whose bias the recurrence would multiply by about 1 / w."""
    rng = np.random.default_rng(9)
    t = np.abs(0.3 * rng.standard_normal((4, 48000))).astype(np.float32)
    st = [np.abs(0.3 * rng.standard_normal(4)).astype(np.float32) for _ in range(4)]
    for c in (t_design.iec2_ppm(48000), t_design.true_peak_ballistics(192000)):
        _assert_env_close(_port(t, st, c, True, True), _port(t, st, c, True, False),
                          ENV_RTOL, ENV_ATOL, f"w1={c.w1}")


@pytest.mark.parametrize("name", ["BBCstereo", "BBCM6", "DINmono"])
def test_envelope_switch_reaches_the_meters(monkeypatch, name):
    """The meter's ballistics run the envelope body by default: on the CPU
    its plain version, once per update, and never the serial one.  Forced
    outside the envelope's domain (``envelope_ok`` false) they run the
    serial body instead, and the readouts of the two runs stay within the
    envelope's bar of each other."""
    calls = {"envelope": 0, "serial": 0}
    refs = {"envelope": ballistics_core.ballistics_envelope_reference,
            "serial": ballistics_core.ballistics_reference}

    def counted(body):
        def run(*a, **k):
            calls[body] += 1
            return refs[body](*a, **k)
        return run

    monkeypatch.setattr(ballistics_core, "ballistics_envelope_reference", counted("envelope"))
    monkeypatch.setattr(ballistics_core, "ballistics_reference", counted("serial"))
    m = mt.create(name, 48000)
    shape = (3, 2, 1000) if name in ("BBCstereo", "BBCM6") else (3, 1000)
    x = torch.from_numpy(
        (0.3 * np.random.default_rng(9).standard_normal(shape)).astype(np.float32))
    batch = shape[:-1] if name == "BBCstereo" else shape[:1]
    outs = []
    for default in (True, False):
        if not default:
            monkeypatch.setattr(ballistics_core, "envelope_ok", lambda w1, w2: False)
        calls.update(envelope=0, serial=0)
        st = m.init(batch, device="cpu")
        for i in range(2):
            st = m.update(st, x[..., i * 500:(i + 1) * 500])
        out, _ = m.read(st)
        outs.append(out if isinstance(out, dict) else {"value": out})
        assert calls == ({"envelope": 2, "serial": 0} if default else {"envelope": 0, "serial": 2})
    for k in outs[0]:
        np.testing.assert_allclose(outs[0][k].numpy(), outs[1][k].numpy(), rtol=ENV_RTOL,
                                   atol=ENV_ATOL, err_msg=k)


# -- B4: the R128 core's seg mode ---------------------------------------------


def _r128_inputs(B, C, T, seed):
    rng = np.random.default_rng(seed)
    x = (0.3 * rng.standard_normal((B, C, T))).astype(np.float32)
    z0 = (0.01 * rng.standard_normal((B, C, 4))).astype(np.float32)
    h = (0.1 * rng.standard_normal((B, C, 47))).astype(np.float32)
    return x, z0, h, rng


SEG_CASES = [
    # fs, C, T (a multiple of 128), B
    (48000, 1, 2560, 3),
    (48000, 2, 2560, 5),   # the JAX test's shape
    (48000, 2, 1280, 3),   # T < fragm: shifted_segments' long-window path
    (44100, 5, 2304, 2),   # fragm 2205 (odd)
    (44100, 2, 4480, 3),   # two boundaries in the block
]


@pytest.mark.parametrize("fs,C,T,B", SEG_CASES)
def test_seg_mode_matches_full_rate_and_pallas(fs, C, T, B):
    fragm = fs // 20
    n_slots = T // fragm + 2
    gains = (2.0,) if C == 1 else r128_fused.gains_f32(t_design.R128_CHAN_GAIN[:C])
    x, z0, h, rng = _r128_inputs(B, C, T, fs + C + T)
    off = rng.integers(0, fragm, B).astype(np.int32)
    op = t_lti.LTISystem(*t_design.k_weighting_state_space(fs)).op(128)
    args = [torch.from_numpy(v) for v in (x, z0, h)]
    p, z, hh, tp = r128_fused.fused_core(*args, gains, op)
    seg, z2, h2, tp2 = r128_fused.fused_core(*args, gains, op, off=torch.from_numpy(off),
                                             fragm=fragm, n_slots=n_slots)
    assert seg.shape == (B, n_slots) and seg.dtype == torch.float32
    ref = segment.shifted_segments(p, torch.from_numpy(off), fragm, n_slots, "sum")
    np.testing.assert_allclose(seg.numpy(), ref.numpy(), rtol=2e-6, atol=1e-9)
    for a, b in ((z, z2), (hh, h2), (tp, tp2)):
        assert torch.equal(a, b)
    # every sample lands in a slot: the slots sum to the block's power
    np.testing.assert_allclose(seg.sum(-1).numpy(), p.double().sum(-1).numpy(), rtol=1e-5)

    jsys = j_lti.LTISystem(*t_design.k_weighting_state_space(fs))
    sj, zj, hj, tj = pallas_r128.fused_core(
        jnp.asarray(x), jnp.asarray(z0), jnp.asarray(h), gains, jsys.op(128), interpret=True,
        off=jnp.asarray(off), fragm=fragm, n_slots=n_slots)
    np.testing.assert_allclose(seg.numpy(), np.asarray(sj), rtol=2e-4, atol=1e-5 * fragm)
    np.testing.assert_allclose(z2.numpy(), np.asarray(zj), rtol=1e-4, atol=1e-4)
    np.testing.assert_array_equal(h2.numpy(), np.asarray(hj))
    np.testing.assert_allclose(tp2.numpy(), np.asarray(tj), rtol=1e-4)
    assert r128_fused.launch_count == r128_fused.seg_launch_count == 0


@pytest.mark.parametrize("kw,match", [
    (dict(fragm=128, n_slots=4), "fragm > 128"),
    (dict(fragm=2400), "needs fragm and n_slots"),
    (dict(n_slots=3), "needs fragm and n_slots"),
    (dict(fragm=2400, n_slots=1), "n_slots"),
    (dict(fragm=200, n_slots=2), "cannot hold"),
    (dict(fragm=2400, n_slots=3, off=np.zeros(2, np.int64)), "int32"),
    (dict(fragm=2400, n_slots=3, off=np.zeros(3, np.int32)), r"shape \(2,\)"),
    (dict(fragm=2400, n_slots=3, off=np.zeros((2, 1), np.int32)), r"shape \(2,\)"),
    (dict(fragm=2400, n_slots=3, off=None), "give off too"),
])
def test_seg_mode_validates_before_build(kw, match):
    """As the JAX kernel's asserts (pallas_r128.py:346), before any build:
    the CUDA wrapper raises on CPU tensors without reaching nvcc."""
    op = t_lti.LTISystem(*t_design.k_weighting_state_space(48000)).op(128)
    x, z0, h = torch.zeros(2, 2, 256), torch.zeros(2, 2, 4), torch.zeros(2, 2, 47)
    kw = dict(kw)
    off = kw.pop("off", np.zeros(2, np.int32))
    off = None if off is None else torch.from_numpy(off)
    with pytest.raises(ValueError, match=match):
        r128_fused._fused_core_cuda(x, z0, h, (1.0, 1.0), op, off, kw.get("fragm"),
                                    kw.get("n_slots"))
    with pytest.raises(ValueError, match=match):
        r128_fused.fused_core(x, z0, h, (1.0, 1.0), op, off=off, **kw)


# -- B2: the surround wide layout ----------------------------------------------


@pytest.mark.parametrize("C,nonfinite", [(5, False), (8, False), (5, True), (8, True)])
def test_wide_plain_matches_pallas_wide_interpret(C, nonfinite):
    """fused_core_wide on CPU tensors (the plain core) against the JAX
    package's wide kernel, _fused_core_wide, in interpret mode."""
    jm, tm = jax_create(f"surround{C}", 48000), mt.create(f"surround{C}", 48000)
    x, kmz, zl, zp = _core_inputs(C, seed=C + 10 * nonfinite, nonfinite=nonfinite)
    T = x.shape[-1]
    sj = jm._sel(None, jnp.float32)
    st = tm._sel(None, "cpu")
    kj, zlj, pkj, paccj = pallas_surround._fused_core_wide(
        jnp.asarray(x), jnp.asarray(kmz), jnp.asarray(zl), *sj, jm.km.sys.op(32),
        jm.cor.lp.op(128), jm.cor.w1, jm.cor.w2, interpret=True)
    wv, decay = tm.cor._ema_weights(T, "cpu")
    kt, zlt, pkt, pacct = surround_fused.fused_core_wide(
        torch.from_numpy(x), torch.from_numpy(kmz), torch.from_numpy(zl), *st, tm.km.sys,
        tm.cor.lp, tm.cor.w1, wv)
    zpt = (torch.from_numpy(zp) * decay + pacct).numpy()
    zpj = zp * np.float32((1.0 - jm.cor.w2) ** T) + np.asarray(paccj)
    np.testing.assert_array_equal(pkt.numpy(), np.asarray(pkj))
    kj = np.asarray(kj)
    np.testing.assert_array_equal(np.isnan(kt.numpy()), np.isnan(kj))
    f = np.isfinite(kj)
    np.testing.assert_array_equal(np.isfinite(kt.numpy()), f)
    np.testing.assert_allclose(kt.numpy()[f], kj[f], rtol=2e-5)
    for what, a, b in (("zl", zlt.numpy(), np.asarray(zlj)), ("zp", zpt, zpj)):
        np.testing.assert_array_equal(np.isfinite(a), np.isfinite(b), err_msg=what)
        f = np.isfinite(b)
        np.testing.assert_allclose(a[f], b[f], rtol=2e-4, atol=1e-8, err_msg=what)
    if nonfinite:  # every pair of streams 0-2 poisoned, streams 3-4 clean
        assert not np.isfinite(zpt[:3]).any() and np.isfinite(zpt[3:]).all()
    assert surround_fused.launch_count == surround_fused.wide_launch_count == 0


@pytest.mark.parametrize("name", ["surround5", "surround8"])
def test_wide_switch_reaches_the_meters(monkeypatch, name):
    """METERS_TORCH_SURROUND_WIDE=1, read on each call, sends the meter's
    128-aligned bulk through fused_core_wide; on the CPU that is the same
    plain version, so the readouts equal the default run's."""
    calls = []
    wide = surround_fused.fused_core_wide

    def counted(*a, **k):
        calls.append(1)
        return wide(*a, **k)

    monkeypatch.setattr(surround_fused, "fused_core_wide", counted)
    m = mt.create(name, 48000)
    C = m.nchan
    x = torch.from_numpy(
        (0.2 * np.random.default_rng(C).standard_normal((2, C, 1000))).astype(np.float32))
    outs = []
    for flag in ("0", "1"):
        monkeypatch.setenv("METERS_TORCH_SURROUND_WIDE", flag)
        st = m.init((2,), device="cpu")
        for i in range(2):
            st = m.update(st, x[..., i * 500:(i + 1) * 500])  # 384-sample bulk + tail
        outs.append(m.read(st)[0])
        assert len(calls) == (0 if flag == "0" else 2)
    for k in outs[0]:
        assert torch.equal(outs[0][k], outs[1][k]), k


def test_wide_wrapper_validates_before_building():
    """The wide launch takes the narrow wrapper's checks, before the build."""
    tm = mt.create("surround5", 48000)
    wv, _ = tm.cor._ema_weights(256, "cpu")
    sa, sb = tm._sel(None, "cpu")
    x = torch.zeros(2, 5, 200)
    z2, z1 = torch.zeros(2, 5, 2), torch.zeros(2, 5, 1)
    with pytest.raises(ValueError, match="multiple of 128"):
        surround_fused._fused_core_cuda(x, z2, z1, sa, sb, tm.km.sys, tm.cor.lp, tm.cor.w1,
                                        wv, wide=True)
    with pytest.raises(ValueError, match="no fused_core_wide for device"):
        surround_fused.fused_core_wide(x.to("meta"), z2, z1, sa, sb, tm.km.sys, tm.cor.lp,
                                       tm.cor.w1, wv)
