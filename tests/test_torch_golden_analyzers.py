"""The port's STFT engine and display analyzers against the committed
C-reference goldens: stft_{mix,sine997,oddblock_mix},
phasewheel_{mix,sine997,44k_mix}, stereoscope_{mix,noise,44k_mix} and
goniometer_{mix,sine997,os1_mix,os2_mix,os8_mix}.

Each ``run_*`` streams one fixture whole with the cadence and the asserts
of tests/test_fft_golden_parity.py (the same bars):
  * STFT: power within 2e-4 relative plus 1e-8 of the frame's peak; phase
    (wrapped) within 1e-3 rad on bins above 1e-6 of the peak; the
    boundary bins; freq_at_bin within 5e-3 relative plus 2 Hz on bins
    above 1e-6; the oddblock fixture's power within 2e-4 on bins above
    1e-10;
  * phase wheel: level within 2e-4 relative plus 1e-8 of the read's
    maximum and dphi within 2e-3 rad where both sides pass the threshold,
    the peak within 1e-3 relative plus 1e-9, threshold flips on at most 1 %
    of the bins;
  * stereoscope: lr within 1e-4 absolute, level within 2e-3 relative plus
    1e-12;
  * goniometer: gain within 1e-4, sum x^2 and sum y^2 within 1e-5 and
    max |x| within 1e-4, relative.
The analyzers run frame by frame (one hop per call), so on a card every
call launches the STFT kernel at W = 256 with F = 1 (hop 1920 at 48 kHz,
1764 at 44.1 kHz).  ``chip_smoke.py`` streams the same fixtures on the card
with these functions.  This module imports no JAX.
"""

import glob
import json
import math
import os

import numpy as np
import pytest
import torch

import meters_lv2_torch as mt
from meters_lv2_torch.ops.fft import STFT

torch.set_num_threads(1)

FIXDIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures")
FIXTURES = (
    "stft_mix", "stft_sine997", "stft_oddblock_mix",
    "phasewheel_mix", "phasewheel_sine997", "phasewheel_44k_mix",
    "stereoscope_mix", "stereoscope_noise", "stereoscope_44k_mix",
    "goniometer_mix", "goniometer_sine997", "goniometer_os1_mix", "goniometer_os2_mix",
    "goniometer_os8_mix",
)


def _load(name):
    with open(os.path.join(FIXDIR, name + ".json")) as f:
        return json.load(f)


def _wrap(p):
    return ((p + np.pi) % (2 * np.pi)) - np.pi


def _np(t):
    return t.detach().cpu().numpy()


def run_stft(fx, device="cpu"):
    """One STFT update over the whole signal; every read's power, phase,
    boundary bins and instantaneous frequency.  Returns the number of
    frames checked."""
    from signals import make_signal

    ws, fps = int(fx["extra"][0]), float(fx["extra"][1])
    stft = STFT(fx["fs"], ws, fps)
    odd = fx["meter"] == "stft_oddblock"
    if odd:
        # the reference analyses every ceil(sps / block) * block samples
        sps = int(math.ceil(fx["fs"] / fps))
        stft.hop = int(math.ceil(sps / fx["block"])) * fx["block"]
        assert stft.hop == 2048
    else:
        assert fx["block"] * (stft.hop // fx["block"]) == stft.hop
    x = make_signal(fx["signal"], fx["seconds"], fs=fx["fs"])[0]
    T = len(x) - len(x) % stft.hop
    power, phase, _ = stft.update(stft.init((), device=device),
                                  torch.as_tensor(x[:T], device=device))
    n = 0
    for rec in fx["reads"]:
        assert rec["step"] == stft.hop  # frame-exact placement
        i = rec["frame"] - 1
        gp = np.asarray(rec["power"])
        p = _np(power[i])
        tag = f"{fx['meter']}/{fx['signal']} frame {rec['frame']}"
        if odd:
            sig = gp > 1e-10
            np.testing.assert_allclose(p[sig], gp[sig], rtol=2e-4, err_msg=f"{tag} power")
            n += 1
            continue
        gph = np.asarray(rec["phase"])
        np.testing.assert_allclose(p, gp, rtol=2e-4, atol=1e-8 * gp.max(), err_msg=f"{tag} power")
        sig = gp > 1e-6 * gp.max()
        pherr = np.abs(_wrap(_np(phase[i]) - gph))[sig]
        assert pherr.max() < 1e-3, (tag, pherr.max())
        assert float(phase[i][0]) == 0.0 and float(power[i][-1]) == 0.0
        assert gph[0] == 0.0 and gp[-1] == 0.0
        if i > 0:  # the golden phase_h of frame 1 predates the stream
            freq = _np(stft.freq_at_bin(phase[i], phase[i - 1], rec["step"]))
            sig = gp > 1e-6
            np.testing.assert_allclose(freq[sig], np.asarray(rec["freq"])[sig], rtol=5e-3,
                                       atol=2.0, err_msg=f"{tag} freq")
        n += 1
    return n


def run_phasewheel(fx, device="cpu"):
    """The fixture frame by frame; returns (worst level relative error,
    worst dphi error in rad, threshold flips, bins compared)."""
    from signals import make_signal

    m = mt.create("phasewheel", fx["fs"], bins=int(fx["extra"][0]))
    x = torch.as_tensor(make_signal(fx["signal"], fx["seconds"], fs=fx["fs"]), device=device)
    hop = m.stft.hop
    T = x.shape[1] - x.shape[1] % hop
    st = m.init((), device=device)
    reads = iter(fx["reads"])
    mism = tot = 0
    worst_lv = worst_ph = 0.0
    for f in range(1, T // hop + 1):
        out, st = m.process(st, x[:, (f - 1) * hop:f * hop])
        if f % fx["read_every"]:
            continue
        rec = next(reads)
        assert rec["frame"] == f
        tag = f"{fx['meter']}/{fx['signal']} frame {f}"
        gph, glv = np.asarray(rec["phase"]), np.asarray(rec["level"])  # bins 1..bins-2
        mph, mlv = _np(out["phase"])[0][1:-1], _np(out["level"])[0][1:-1]
        ok_g, ok_m = glv > -100.0, mlv > -100.0
        mism += int((ok_g != ok_m).sum())
        tot += len(ok_g)
        both = ok_g & ok_m
        np.testing.assert_allclose(mlv[both], glv[both], rtol=2e-4, atol=1e-8 * max(glv.max(), 0),
                                   err_msg=f"{tag} level")
        pherr = np.abs(_wrap(mph[both] - gph[both]))
        assert pherr.max() < 2e-3, (tag, pherr.max())
        np.testing.assert_allclose(float(out["peak"]), rec["peak"], rtol=1e-3, atol=1e-9,
                                   err_msg=f"{tag} peak")
        worst_lv = max(worst_lv, float((np.abs(mlv[both] - glv[both]) / np.abs(glv[both])).max()))
        worst_ph = max(worst_ph, float(pherr.max()))
    assert next(reads, None) is None, "reads left over"
    # threshold-boundary bins may flip with FFT precision; must be rare
    assert mism <= 0.01 * tot, (mism, tot)
    return worst_lv, worst_ph, mism, tot


def run_stereoscope(fx, device="cpu"):
    """The fixture frame by frame; returns (worst lr error, worst level
    relative error over levels above 1e-12, values compared)."""
    from signals import make_signal

    m = mt.create("stereoscope", fx["fs"], bins=int(fx["extra"][0]))
    x = torch.as_tensor(make_signal(fx["signal"], fx["seconds"], fs=fx["fs"]), device=device)
    hop = m.stft.hop
    T = x.shape[1] - x.shape[1] % hop
    st = m.init((), device=device)
    reads = iter(fx["reads"])
    worst_lr = worst_lv = 0.0
    n = 0
    for f in range(1, T // hop + 1):
        out, st = m.process(st, x[:, (f - 1) * hop:f * hop])
        if f % fx["read_every"]:
            continue
        rec = next(reads)
        assert rec["frame"] == f
        tag = f"{fx['meter']}/{fx['signal']} frame {f}"
        glr, glv = np.asarray(rec["lr"]), np.asarray(rec["level"])
        mlr, mlv = _np(out["lr"])[1:-1], _np(out["level"])[1:-1]
        np.testing.assert_allclose(mlr, glr, atol=1e-4, err_msg=f"{tag} lr")
        np.testing.assert_allclose(mlv, glv, rtol=2e-3, atol=1e-12, err_msg=f"{tag} level")
        worst_lr = max(worst_lr, float(np.abs(mlr - glr).max()))
        big = glv > 1e-12
        worst_lv = max(worst_lv, float((np.abs(mlv - glv)[big] / glv[big]).max()))
        n += 2 * len(glr)
    assert next(reads, None) is None, "reads left over"
    return worst_lr, worst_lv, n


def run_goniometer(fx, device="cpu"):
    """The fixture in its blocks; returns the worst relative deviation of
    (gain, sum x^2, sum y^2, max |x|) over the reads."""
    from signals import make_signal

    m = mt.create("goniometer", fx["fs"], oversample=int(fx["extra"][0]))
    x = torch.as_tensor(make_signal(fx["signal"], fx["seconds"], fs=fx["fs"]), device=device)
    st = m.init((), device=device)
    reads = iter(fx["reads"])
    blk = fx["block"]
    worst = [0.0] * 4
    for b in range(x.shape[1] // blk):
        out, st = m.process(st, x[:, b * blk:(b + 1) * blk])
        if (b + 1) % fx["read_every"]:
            continue
        rec = next(reads)
        ax, ay = _np(out["x"]).astype(np.float64), _np(out["y"]).astype(np.float64)
        tag = f"{fx['meter']}/{fx['signal']} blk {rec['block']}"
        got = (float(out["gain"]), (ax ** 2).sum(), (ay ** 2).sum(), np.abs(ax).max())
        want = (rec["gain"], rec["sx2"], rec["sy2"], rec["axmax"])
        for i, (g, w, rtol) in enumerate(zip(got, want, (1e-4, 1e-5, 1e-5, 1e-4))):
            np.testing.assert_allclose(g, w, rtol=rtol, err_msg=tag)
            worst[i] = max(worst[i], abs(g - w) / abs(w))
    assert next(reads, None) is None, "reads left over"
    return worst


def run_fixture(name, device="cpu"):
    """Stream fixture ``name`` (a FIXTURES entry) on ``device``; returns a
    one-line summary of its worst deviations."""
    fx = _load(name)
    if name.startswith("stft"):
        return f"{name} {run_stft(fx, device)} frames"
    if name.startswith("phasewheel"):
        lv, ph, mism, tot = run_phasewheel(fx, device)
        return f"{name} level {lv:.3g} rel, dphi {ph:.3g} rad, flips {mism}/{tot}"
    if name.startswith("stereoscope"):
        lr, lv, n = run_stereoscope(fx, device)
        return f"{name} lr {lr:.3g}, level {lv:.3g} rel ({n} values)"
    w = run_goniometer(fx, device)
    return f"{name} gain {w[0]:.3g}, sx2 {w[1]:.3g}, sy2 {w[2]:.3g}, axmax {w[3]:.3g} rel"


def test_fixture_list_is_complete():
    """Every analyzer fixture in tests/fixtures is streamed here."""
    names = set()
    for pre in ("stft", "phasewheel", "stereoscope", "goniometer"):
        names |= {os.path.basename(p)[:-5]
                  for p in glob.glob(os.path.join(FIXDIR, pre + "_*.json"))}
    assert names == set(FIXTURES)


@pytest.mark.parametrize("name", FIXTURES)
def test_analyzer_golden(name):
    assert run_fixture(name)
