"""The statistics meters of the port against the committed C-reference
goldens: DR-14 (dr14, dr14mono, dr14_44k, dr14_96k), TP+RMS, SigDistHist
(and its out-of-range count quirk) and the bit meter -- 14 fixtures.

The asserts are those of tests/test_golden_parity.py: DR-14 and TP+RMS
readouts within 0.01 dB at every read, block_count exact; at the end the
window count exact, the DR histogram bin-exact (at 96 kHz one adjacent-bin
transfer allowed, as there) and the top-2 peaks to 1e-6; sigdist hist_max,
peak bin and time exact at every read, hist_avg to 1e-3 relative plus 0.1,
the final histogram exact, hist_var within 1e-3 (the quirk mode within
1e-5, the default mode more than 30x worse on sigdist_oor); the bit
meter's every counter exact and |min| / |max| to 1e-6.  Fixtures of one
prefix that share their cadence stream together as one batch of
independent rows.

On the CPU the display true peak of DR-14 and TP+RMS is the truepeak_fused
kernel's plain version, a Python loop per sample, so there the true-peak
readouts (v_peak, m_peak) are checked over the first ``tp_reads`` reads and
the true-peak meter then holds its state (``_HeldTruePeak``); every other
readout and the final structural checks cover the whole fixture.
``chip_smoke.py`` streams every fixture whole on the card, true peak
included, with the same functions.  This module imports no JAX.
"""

import glob
import json
import os

import numpy as np
import pytest
import torch

import meters_lv2_torch as mt

torch.set_num_threads(1)

FIXDIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures")
TOL_DB = 0.01
DR_PREFIXES = ("dr14", "dr14mono", "dr14_44k", "dr14_96k")
TP_KEYS = ("v_peak", "m_peak")


def fixtures(prefix):
    out = []
    for p in sorted(glob.glob(os.path.join(FIXDIR, prefix + "_*.json"))):
        with open(p) as f:
            fx = json.load(f)
        if fx["meter"] == prefix:
            out.append(fx)
    assert out, f"no {prefix} fixtures"
    return out


def _batch(fxs, make_signal, device):
    """The signals of fixtures sharing fs, cadence and channels as
    [S, C, T] on ``device``."""
    fx0 = fxs[0]
    for fx in fxs:
        for k in ("fs", "block", "read_every", "seconds", "nchan"):
            assert fx[k] == fx0[k], (fx["signal"], k)
    x = np.stack([make_signal(fx["signal"], fx["seconds"], fs=fx["fs"])[: fx0["nchan"]]
                  for fx in fxs])
    return torch.as_tensor(x, device=device)


class _HeldTruePeak:
    """Stands in for a meter's display true peak once its readouts are no
    longer checked: update keeps the state, read is the meter's own."""

    def __init__(self, tp):
        self.tp = tp

    def update(self, state, x):
        return state

    def read(self, state):
        return self.tp.read(state)


def _stream(meter, x, fx0, tp_reads, on_read):
    """Blocks of the fixture's length through ``meter``; on_read(out, k)
    after each read k; returns (state, reads, worst dB on the true-peak
    keys' reads)."""
    st = meter.init((x.shape[0],), device=x.device)
    blk, every = fx0["block"], fx0["read_every"]
    k = 0
    for b in range(x.shape[-1] // blk):
        st = meter.update(st, x[..., b * blk:(b + 1) * blk])
        if (b + 1) % every == 0:
            out, st = meter.read(st)
            on_read({key: v.cpu() for key, v in out.items()}, k)
            k += 1
            if tp_reads is not None and k == tp_reads:
                meter.tp = _HeldTruePeak(meter.tp)
    return st, k


def run_dr14(prefix, make_signal, device="cpu", tp_reads=None):
    """One DR-14 fixture family against its goldens; returns (worst dB
    deviation, values checked)."""
    fxs = fixtures(prefix)
    fx0 = fxs[0]
    x = _batch(fxs, make_signal, device)
    C = fx0["nchan"]
    meter = mt.create("dr14stereo" if C == 2 else "dr14mono", fx0["fs"], nchan=C)
    mids = [[r for r in fx["reads"] if "final" not in r] for fx in fxs]
    worst, n = [0.0], [0]

    def on_read(out, k):
        tp_on = tp_reads is None or k < tp_reads
        for i, fx in enumerate(fxs):
            rec = mids[i][k]
            tag = f"{prefix}/{fx['signal']} blk {rec['block']}"
            for c in range(C):
                for key in ("v_rms", "v_peak", "m_peak", "m_rms", "dr"):
                    if key in TP_KEYS and not tp_on:
                        continue
                    d = abs(float(out[key][i, c]) - rec["ch"][c][key])
                    assert d <= TOL_DB, (tag, key, c, float(out[key][i, c]), rec["ch"][c][key])
                    worst[0], n[0] = max(worst[0], d), n[0] + 1
            if C > 1:
                d = abs(float(out["dr_total"][i]) - rec["dr_total"])
                assert d <= TOL_DB, (tag, "dr_total", float(out["dr_total"][i]), rec)
                worst[0] = max(worst[0], d)
            assert float(out["block_count"][i]) == rec["block_count"], tag

    st, k = _stream(meter, x, fx0, tp_reads, on_read)
    assert k == len(mids[0]), (prefix, k)
    for i, fx in enumerate(fxs):
        final = [r for r in fx["reads"] if r.get("final")][0]
        assert int(st.num_windows[i]) == final["num_fragments"], fx["signal"]
        h = st.hist[i].cpu().numpy()
        g = np.asarray(final["hist"])
        if fx["fs"] >= 96000 and not np.array_equal(h, g):
            # tests/test_golden_parity.py: the reference's sequential f32
            # window sum may land one bin apart at 96 kHz; one adjacent-bin
            # transfer is allowed and nothing else
            d = (h.astype(np.int64) - g).reshape(-1, h.shape[-1])
            bad = [np.nonzero(r)[0] for r in d]
            assert sum(len(b) for b in bad) <= 2, fx["signal"]
            for r, b in zip(d, bad):
                if len(b):
                    assert len(b) == 2 and b[1] - b[0] == 1, (fx["signal"], b)
                    assert r[b[0]] + r[b[1]] == 0 and abs(r[b[0]]) == 1
        else:
            np.testing.assert_array_equal(h, g, err_msg=fx["signal"])
        np.testing.assert_allclose(
            st.peak_top2[i].cpu().numpy(), np.asarray(final["peak_top2"]),
            rtol=1e-6, atol=1e-9, err_msg=fx["signal"])
    return worst[0], n[0]


def run_tpnrms(make_signal, device="cpu", tp_reads=None):
    fxs = fixtures("tpnrms")
    fx0 = fxs[0]
    x = _batch(fxs, make_signal, device)
    C = fx0["nchan"]
    meter = mt.create("TPnRMSstereo" if C == 2 else "TPnRMSmono", fx0["fs"], nchan=C)
    mids = [[r for r in fx["reads"] if "final" not in r] for fx in fxs]
    worst, n = [0.0], [0]

    def on_read(out, k):
        for i, fx in enumerate(fxs):
            rec = mids[i][k]
            for c in range(C):
                for key in ("v_rms", "v_peak", "m_peak", "m_rms"):
                    if key in TP_KEYS and tp_reads is not None and k >= tp_reads:
                        continue
                    d = abs(float(out[key][i, c]) - rec["ch"][c][key])
                    assert d <= TOL_DB, (fx["signal"], rec["block"], key, c)
                    worst[0], n[0] = max(worst[0], d), n[0] + 1

    _, k = _stream(meter, x, fx0, tp_reads, on_read)
    assert k == len(mids[0])
    return worst[0], n[0]


def run_sigdist(prefix, make_signal, device="cpu", **meter_kw):
    """Streams every fixture of the prefix (channel 0, as the reference
    meters it); returns the worst hist_var relative error of each."""
    fxs = fixtures(prefix)
    fx0 = fxs[0]
    x = _batch(fxs, make_signal, device)[:, 0]
    meter = mt.create("SigDistHist", fx0["fs"], **meter_kw)
    mids = [[r for r in fx["reads"] if "final" not in r] for fx in fxs]
    worst = [0.0] * len(fxs)
    st = meter.init((len(fxs),), device=device)
    blk, k = fx0["block"], 0
    for b in range(x.shape[-1] // blk):
        st = meter.update(st, x[:, b * blk:(b + 1) * blk])
        if (b + 1) % fx0["read_every"]:
            continue
        out, st = meter.read(st)
        out = {key: v.cpu() for key, v in out.items()}
        for i, fx in enumerate(fxs):
            rec = mids[i][k]
            assert int(out["hist_max"][i]) == rec["hist_max"], (fx["signal"], rec["block"])
            assert int(out["hist"][i, int(out["hist_peak_bin"][i])]) == rec["hist_max"]
            assert int(out["integration_time"][i]) == rec["time"]
            np.testing.assert_allclose(float(out["hist_avg"][i]), rec["hist_avg"],
                                       rtol=1e-3, atol=0.1)
            worst[i] = max(worst[i], abs(float(out["hist_var"][i]) - rec["hist_var"])
                           / max(abs(rec["hist_var"]), 1e-3))
        k += 1
    assert k == len(mids[0])
    for i, fx in enumerate(fxs):
        final = [r for r in fx["reads"] if r.get("final")][0]
        np.testing.assert_array_equal(st.hist[i].cpu().numpy(), np.asarray(final["hist"]),
                                      err_msg=fx["signal"])
    return worst


def run_bitmeter(make_signal, device="cpu"):
    fxs = fixtures("bitmeter")
    fx0 = fxs[0]
    x = _batch(fxs, make_signal, device)[:, 0]
    meter = mt.create("bitmeter", fx0["fs"])
    st = meter.init((len(fxs),), device=device)
    blk = fx0["block"]
    for b in range(x.shape[-1] // blk):
        st = meter.update(st, x[:, b * blk:(b + 1) * blk])
    out, _ = meter.read(st)
    out = {key: v.cpu() for key, v in out.items()}
    for i, fx in enumerate(fxs):
        final = [r for r in fx["reads"] if r.get("final")][0]
        hs, sig = np.asarray(final["histS"]), fx["signal"]
        np.testing.assert_array_equal(out["hit"][i].numpy(), hs[0:280], err_msg=sig)
        np.testing.assert_array_equal(out["one"][i].numpy(), hs[280:560], err_msg=sig)
        np.testing.assert_array_equal(out["dset"][i].numpy(), hs[560:583], err_msg=sig)
        for key in ("zero", "pos", "nan", "inf", "den"):
            assert int(out[key][i]) == final[key], (sig, key)
        assert int(out["integration_time"][i]) == final["time"], sig
        np.testing.assert_allclose(float(out["max"][i]), final["max"], rtol=1e-6)
        np.testing.assert_allclose(float(out["min"][i]), final["min"], rtol=1e-6)
    return len(fxs)


@pytest.mark.parametrize("prefix", DR_PREFIXES)
def test_dr14_golden(prefix):
    """Every DR-14 fixture whole; the true-peak readouts over the first read."""
    from signals import make_signal

    worst, n = run_dr14(prefix, make_signal, tp_reads=1)
    assert n and worst <= TOL_DB


def test_tpnrms_golden():
    from signals import make_signal

    worst, n = run_tpnrms(make_signal, tp_reads=2)
    assert n and worst <= TOL_DB


def test_sigdist_golden():
    from signals import make_signal

    assert max(run_sigdist("sigdist", make_signal)) <= 1e-3


def test_sigdist_oor_quirk_golden():
    """The quirk mode tracks the float64 golden within 1e-5; the default
    (accepted-count) mode is more than 30x worse on this fixture."""
    from signals import make_signal

    quirk = run_sigdist("sigdist_oor", make_signal, reference_oor_count=True)
    plain = run_sigdist("sigdist_oor", make_signal)
    for q, p in zip(quirk, plain):
        assert q <= 1e-5 and p > 30 * q, (q, p)


def test_bitmeter_golden():
    from signals import make_signal

    assert run_bitmeter(make_signal) == 2
