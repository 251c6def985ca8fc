"""The plain reference against the port's plain CPU path at small sizes,
and its blocked recurrences against sample-by-sample loops."""

import importlib

import numpy as np
import torch

import meters_lv2_torch as mt
from meters_lv2_torch.parallel.pipeline import MeterPipeline
from portbench import harness, signals
from portbench.reference import ballistics, design, lti

MIX = harness.load_json("mixes", "programme")
FS = 48000


def _audio(seed, P, B, T=4800):
    pool = torch.zeros(P, B, 2, T)
    signals.fill_pool(pool, seed, FS, MIX)
    return pool


def test_blocked_lti_is_the_recurrence():
    A, B, C, D = design.k_weighting_state_space(FS)
    x = np.random.default_rng(0).standard_normal((3, 3000))
    y = np.zeros_like(x)
    s = np.zeros((3, 4))
    for t in range(x.shape[1]):
        y[:, t] = s @ C[0] + D[0, 0] * x[:, t]
        s = s @ A.T + np.outer(x[:, t], B[:, 0])
    yb = lti.Blocked([(A, B, C, D)], lti.REFERENCE, "cpu", L=256)(torch.tensor(x)).numpy()
    assert np.abs(yb - y).max() < 1e-12 * np.abs(y).max()


def test_ballistics_is_the_recurrence():
    rng = np.random.default_rng(1)
    R, n, upd = 3, 4 * 600, 300
    t = np.abs(rng.standard_normal((R, n)) * np.repeat(rng.uniform(0.01, 1, (R, n // 200)), 200, 1))
    w1, w2, w3, off = 0.04, 0.18, 1 - 4e-3, 1e-3
    z1, z2, m = np.zeros(R), np.zeros(R), np.full(R, -np.inf)
    for g in range(n // 4):
        if g % upd == 0:
            if g:
                z1, z2 = z1 + off, z2 + off
            z1, z2 = np.clip(z1, 0, 20), np.clip(z2, 0, 20)
        z1, z2 = z1 * w3, z2 * w3
        for i in range(4):
            ti = t[:, 4 * g + i]
            z1 = np.where(ti > z1, z1 + w1 * (ti - z1), z1)
            z2 = np.where(ti > z2, z2 + w2 * (ti - z2), z2)
        m = np.maximum(m, z1 + z2)
    got = ballistics.peak_meter(torch.tensor(t), w1, w2, w3, upd, off).numpy()
    assert np.abs(got - m).max() < 1e-13 * m.max()


def test_r128_against_the_port_every_block():
    P, B, T = 120, 3, 4800  # 12 s: integrated and LRA both gated in
    pool = _audio(2**33 + 1, P, B, T)
    m = mt.create("EBUr128", FS)
    st = m.init((B,), device="cpu")
    got = {k: [] for k in ("loudness_M", "loudness_S", "max_M", "max_S", "integrated", "lra",
                           "dbtp")}
    for k in range(P):
        st = m.update(st, pool[k].reshape(B, 2 * T), flat=True)
        o, _ = m.read(st)
        for key in got:
            got[key].append(o[key].double())
    R = importlib.import_module("portbench.reference.EBUr128")
    x = signals.stream_audio(pool, range(B))
    ref = R.expected(x, FS, [T * (k + 1) for k in range(P)], lti.REFERENCE, T)
    for key, vals in got.items():
        a = torch.stack(vals, 1)
        b = ref[key]
        if key == "dbtp":
            a, b = 20 * torch.log10(a), 20 * torch.log10(b)
        assert float((a - b).abs().max()) < 2e-5, key
    assert float(ref["lra"][:, -1].max()) > 0 and float(ref["integrated"][:, -1].min()) > -200
    for key in ("hist_m", "hist_s"):
        assert torch.equal(getattr(st, key).long(), ref[key][:, -1])


KINDS = {"r128": "EBUr128", "dbtp": "dBTPstereo", "ppm": "EBUstereo", "cor": "COR",
         "spectrum": "spectr30stereo"}
BAR = {"lin": 2e-5, "lufs": 2e-5, "db": 5e-5, "db_peak": 5e-5, "cor": 1e-6, "gated": 2e-5}


def test_qc_meters_against_the_port():
    P, B, T = 10, 2, 4800
    pool = _audio(987654321987, P, B, T)
    pipe = MeterPipeline({k: mt.create(v, FS) for k, v in KINDS.items()})
    st = pipe.init((B,), device="cpu")
    for k in range(P):
        st = pipe.update(st, pool[k])
    outs, _ = pipe.read(st)
    x = signals.stream_audio(pool, range(B))
    for name, kind in KINDS.items():
        R = importlib.import_module(f"portbench.reference.{kind}")
        ref = R.expected(x, FS, [P * T], lti.REFERENCE, T)
        for key, ck in R.READOUTS.items():
            a = (outs[name] if key == "value" else outs[name][key]).double()
            b = ref[key][:, 0].double()
            if ck == "lin":
                a, b = 20 * torch.log10(a), 20 * torch.log10(b)
            assert float((a - b).abs().max()) <= BAR[ck], (name, key)
