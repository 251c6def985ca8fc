"""The port's 30-band spectrum analyzer against the committed C-reference
goldens: spectrum_mix, spectrum_noise, spectrum_sine997 (48 kHz),
spectrum_44k_mix and spectrum_96k_mix.

The asserts are those of tests/test_golden_parity.py: at 48 and 96 kHz
every band and peak readout within 0.01 dB of the golden, and a golden at
the -100 dB floor read at or below -99 dB; at 44.1 kHz every band readout
above the floor within 0.01 dB.  96 kHz is the precision worst case (the
25 Hz band's poles sit closest to the unit circle there).  Besides the
strict worst, ``run_spectrum`` reports the worst over readouts that carry
signal (golden above -60 dBFS, the reference display's floor): the
strict worst sits on deep stopband bins of bands 27-29 near -95 dBFS.
``chip_smoke.py`` streams the same fixtures on the card with the same
function.  This module imports no JAX.
"""

import json
import os

import pytest
import torch

import meters_lv2_torch as mt

torch.set_num_threads(1)

FIXDIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures")
TOL_DB = 0.01
IN_BAND_DB = -60.0  # readouts above this carry signal
FIXTURES = ("spectrum_mix", "spectrum_noise", "spectrum_sine997",
            "spectrum_44k_mix", "spectrum_96k_mix")


def run_spectrum(name, make_signal, device="cpu"):
    """Stream one fixture whole through spectr30stereo with its cadence;
    assert every readout; return (strict worst dB, in-band worst dB,
    number of readouts compared)."""
    with open(os.path.join(FIXDIR, name + ".json")) as f:
        fx = json.load(f)
    m = mt.create("spectr30stereo", fx["fs"])
    x = torch.as_tensor(make_signal(fx["signal"], fx["seconds"], fs=fx["fs"]), device=device)
    st = m.init((), device=device)
    keys = ("bands",) if fx["meter"] == "spectrum_44k" else ("bands", "peaks")
    reads = iter(fx["reads"])
    blk = fx["block"]
    strict = in_band = 0.0
    n = 0
    for b in range(x.shape[1] // blk):
        st = m.update(st, x[:, b * blk:(b + 1) * blk], stereo=True)
        if (b + 1) % fx["read_every"]:
            continue
        out, _ = m.read(st)
        rec = next(reads)
        for key in keys:
            got = out[key].cpu().double().tolist()
            for i, (g, want) in enumerate(zip(got, rec[key])):
                tag = f"{name} {key}[{i}] blk {rec['block']}: {g} vs {want}"
                if want <= -99.9:
                    if fx["meter"] != "spectrum_44k":
                        assert g <= -99.0, tag
                    continue
                d = abs(g - want)
                assert d < TOL_DB, tag
                strict = max(strict, d)
                if want > IN_BAND_DB:
                    in_band = max(in_band, d)
                n += 1
    assert next(reads, None) is None, f"{name}: reads left over"
    return strict, in_band, n


@pytest.mark.parametrize("name", FIXTURES)
def test_spectrum_golden(name):
    from signals import make_signal

    strict, in_band, n = run_spectrum(name, make_signal)
    assert n > 0 and in_band <= strict < TOL_DB
