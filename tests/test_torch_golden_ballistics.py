"""The ballistics families of the port against the committed C-reference
goldens: dBTP, DIN (iec1), BBC (iec2), BBC M-6 (msppm, msppm_s20), VU,
K-meter and stereo correlation.

``run_family`` streams every signal of one fixture family (one prefix, one
sample rate) as one batch through the port's meter, with the block and
read cadence of the fixture, and applies the asserts of
tests/test_golden_parity.py: every level readout within 0.01 dB
(``assert_level``: 20 log10 of the magnitudes, both below 1e-6 pass), the
correlation within 2e-3 absolute.  The signals of a batch are independent
rows, so batching them changes no readout.

On the CPU the PPM and true-peak meters run their kernels' plain versions,
a Python loop of torch ops per 4-sample group, so those families stream
their first two reads here; VU, K-meter and COR stream whole.
``chip_smoke.py`` streams every family whole on the card through the CUDA
kernels, with the same function.  This module imports no JAX.
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
COR_TOL = 2e-3

# fixture prefix -> (meter name, kind)
FAMILIES = {
    "truepeak": ("dBTPstereo", "tp"),
    "truepeak_44k": ("dBTPstereo", "tp"),
    "truepeak_96k": ("dBTPstereo", "tp"),
    "iec1": ("DINstereo", "needle"),
    "iec1_44k": ("DINstereo", "needle"),
    "iec2": ("BBCstereo", "needle"),
    "iec2_44k": ("BBCstereo", "needle"),
    "iec2_96k": ("BBCstereo", "needle"),
    "msppm": ("BBCM6", "ms"),
    "msppm_s20": ("BBCM6", "ms"),
    "vu": ("VUstereo", "needle"),
    "vu_44k": ("VUstereo", "needle"),
    "vu_96k": ("VUstereo", "needle"),
    "vu_blk4096": ("VUstereo", "needle"),
    "kmeter": ("K20stereo", "km"),
    "kmeter_44k": ("K20stereo", "km"),
    "kmeter_96k": ("K20stereo", "km"),
    "kmeter_blk512": ("K20stereo", "km"),
    "stcorr": ("COR", "cor"),
}
# families whose CPU run is a Python loop per 4-sample group
SLOW_ON_CPU = {p for p, (_, kind) in FAMILIES.items() if kind in ("tp", "ms")} | {
    p for p in FAMILIES if p.startswith(("iec1", "iec2"))}


def fixtures(prefix):
    out = []
    for p in sorted(glob.glob(os.path.join(FIXDIR, prefix + "_*.json"))):
        with open(p) as f:
            fx = json.load(f)
        if fx["meter"] == prefix:
            out.append(fx)
    return out


def _db(v):
    return 20 * np.log10(np.maximum(np.abs(np.asarray(v, np.float64)), 1e-12))


def assert_level(got, want, tol=TOL_DB, floor=1e-6, msg=""):
    """tests/test_golden_parity.py::assert_level; returns the deviation in
    dB (0 when both values are below the floor)."""
    got, want = float(got), float(want)
    if abs(want) < floor and abs(got) < floor:
        return 0.0
    d = abs(_db(got) - _db(want))
    assert d <= tol, f"{msg}: {got} vs {want}"
    return d


def run_family(prefix, make_signal, device="cpu", max_reads=None):
    """Stream every fixture of ``prefix`` through the port's meter on
    ``device`` as one batch; assert every read against the golden.

    Returns (worst deviation, number of values checked): the deviation is
    in dB for the level meters and absolute for COR."""
    fxs = fixtures(prefix)
    assert fxs, f"no {prefix} fixtures"
    name, kind = FAMILIES[prefix]
    fx0 = fxs[0]
    for fx in fxs:
        for k in ("fs", "block", "read_every", "seconds", "nchan"):
            assert fx[k] == fx0[k], (prefix, fx["signal"], k)
    fs, blk, every = fx0["fs"], fx0["block"], fx0["read_every"]
    S = len(fxs)
    x = np.stack([make_signal(fx["signal"], fx["seconds"], fs=fs) for fx in fxs])
    xd = torch.as_tensor(x, device=device)  # [S, 2, T]
    meter = mt.create(name, fs)
    st = meter.init((S, 2) if kind in ("tp", "needle", "km") else (S,), device=device)
    reads = [iter(fx["reads"]) for fx in fxs]
    nblocks = x.shape[-1] // blk
    if max_reads is not None:
        nblocks = min(nblocks, max_reads * every)
    worst, n = 0.0, 0
    for b in range(nblocks):
        xb = xd[..., b * blk:(b + 1) * blk]
        if prefix == "msppm_s20":  # S20 on from the halfway block, per stream
            on = b >= (x.shape[-1] // blk) // 2
            st = meter.update(st, xb, torch.full((S,), on, device=device))
        else:
            st = meter.update(st, xb)
        if (b + 1) % every:
            continue
        if kind in ("needle", "ms"):
            vals, st = meter.read(st, ref_level_db=-18.0)  # gain 1
        else:
            vals, st = meter.read(st)
        for i, fx in enumerate(fxs):
            rec = next(reads[i])
            tag = f"{prefix}/{fx['signal']} blk {rec['block']}"
            want = rec["values"]
            if kind == "tp":
                got = [vals["level"][i, 0], vals["peak"][i, 0], vals["level"][i, 1],
                       vals["peak"][i, 1]]
            elif kind == "km":
                got = [vals["rms"][i, 0], vals["peak"][i, 0], vals["rms"][i, 1],
                       vals["peak"][i, 1]]
            elif kind == "needle":
                got = [vals[i, 0], vals[i, 1]]
            elif kind == "ms":
                got = [vals["mid"][i], vals["side"][i]]
            else:
                d = abs(float(vals[i]) - want[0])
                assert d < COR_TOL, f"{tag}: {float(vals[i])} vs {want[0]}"
                worst, n = max(worst, d), n + 1
                continue
            for j, g in enumerate(got):
                worst = max(worst, assert_level(g, want[j], msg=f"{tag} value {j}"))
                n += 1
    assert n, prefix
    return worst, n


@pytest.mark.parametrize("prefix", sorted(FAMILIES))
def test_golden_family(prefix):
    """The port on the CPU against the goldens (PPM and true-peak families:
    the first two reads of every signal)."""
    from signals import make_signal

    worst, n = run_family(
        prefix, make_signal, max_reads=2 if prefix in SLOW_ON_CPU else None
    )
    assert worst <= (COR_TOL if prefix == "stcorr" else TOL_DB)
