"""The programme generator: deterministic in the seed, with its level
segments, silences below the gate, intersample peaks and clipping."""


import numpy as np
import torch

from portbench import harness, signals
from portbench.reference.lti import REFERENCE
from portbench.reference.truepeak import upsample4_abs

MIX = harness.load_json("mixes", "programme")
FS = 48000


def _pool(seed, B=24, P=30, T=4800):
    pool = torch.zeros(P, B, 2, T)
    return pool, signals.fill_pool(pool, seed, FS, MIX)


def test_same_seed_same_audio_other_seed_other_audio():
    a, _ = _pool(2**31 + 5)
    b, _ = _pool(2**31 + 5)
    c, _ = _pool(2**31 + 6)
    assert torch.equal(a, b)
    assert not torch.equal(a, c)
    assert float(a.abs().max()) <= 1.0


def test_level_segments_and_silences():
    pool, p = _pool(77, B=64)
    x = signals.stream_audio(pool, range(64)).numpy()
    n = x.shape[-1]
    seen_loud = seen_silent = 0
    for b in range(64):
        for k in range(p.seg_start.shape[1]):
            s0 = p.seg_start[b, k]
            s1 = p.seg_start[b, k + 1] if k + 1 < p.seg_start.shape[1] else n
            s1 = min(s1, n)
            if s1 - s0 < FS // 2 or p.isp[b] or p.clip[b]:
                continue
            seg = x[b, 0, s0:s1]
            rms_db = 10 * np.log10(np.mean(seg.astype(np.float64) ** 2))
            if p.silent[b, k]:
                assert rms_db < -70.0
                seen_silent += 1
            else:
                assert abs(rms_db - p.level_db[b, k]) < 2.5  # noise over a short segment
                seen_loud += 1
    assert seen_loud > 20 and seen_silent >= 1
    levels = p.level_db[~p.silent]
    assert levels.min() >= -40 and levels.max() <= -8


def test_intersample_peaks_and_clipping():
    pool, p = _pool(91, B=96)
    x = signals.stream_audio(pool, range(96))
    assert p.isp.any() and p.clip.any()
    for b in np.flatnonzero(p.isp & ~p.clip):
        # inside the burst the samples sit at 0.707 of its amplitude and
        # the true peak at the amplitude, between them
        s0 = int(p.isp_start[b]) + 100
        s1 = int(p.isp_start[b] + p.isp_len[b]) - 100
        seg = x[b, :, s0:s1].double()
        up = upsample4_abs(x[b].double(), REFERENCE)[:, s0:s1].amax()
        assert abs(float(seg.abs().max()) - np.sqrt(0.5) * p.isp_amp[b]) < 1e-6
        assert abs(float(up) - p.isp_amp[b]) < 0.02 * p.isp_amp[b]  # the FIR's ripple at fs/4
    for b in np.flatnonzero(p.clip):
        assert float(x[b].abs().max()) == 1.0


def test_correlation_modes():
    pool, p = _pool(5, B=64)
    x = signals.stream_audio(pool, range(64)).double()
    for b in range(64):
        if p.isp[b] or p.clip[b]:
            continue
        l, r = x[b, 0], x[b, 1]
        c = float((l * r).sum() / torch.sqrt((l * l).sum() * (r * r).sum()))
        mode = signals.CORR_MODES[p.corr[b]]
        if mode == "+1":
            assert c > 0.999
        elif mode == "-1":
            assert c < -0.999
        elif mode == "0":
            assert abs(c) < 0.5
