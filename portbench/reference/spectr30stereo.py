"""Plain 30-band 1/3-octave spectrum analyzer (x42 ``spectr30stereo``).

src/spectrumlv2.c and src/spectr.c: the stereo input averaged,
(L + R) / 2 (:195-201); per band a 6-stage band-pass biquad cascade of the
IEC 61260 bilinear design (frozen design.bandpass_design, each stage in
its balanced modal form, design.cascade_modal_state_space); the squared
band output through the one-pole display smoother v += w (y^2 - v),
w = 1 - e^(-2 pi speed / fs) as a float32 value at speed 1
(:210-224); a peak-hold of v.  Readouts after the programme (:240-248):
20 log10(sqrt(2 v)) where sqrt(2 v) > 1e-5, else -100, for the final v
("bands") and its maximum ("peaks").  The meter's +1e-20 on v at each
update's exit is left out: against the smallest band power here (above
1e-14) it moves a readout by less than 1e-5 dB.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from . import design
from .lti import Blocked, Prec

KIND = "spectr30stereo"
READOUTS = {"bands": "db", "peaks": "db_peak"}
STATE = {}
N_BANDS = 30


def _db(p: torch.Tensor) -> torch.Tensor:
    vs = torch.sqrt(2.0 * p)
    return torch.where(vs > 1e-5, 20.0 * torch.log10(torch.clamp_min(vs, 1e-30)),
                       torch.full_like(vs, -100.0))


def expected(x: torch.Tensor, fs: int, reads: list[int], prec: Prec, block: int) -> dict:
    """x [S, 2, n], one read at the end -> {"bands", "peaks": [S, 1, 30]}."""
    S, C, n = x.shape
    if reads != [n]:
        raise ValueError("the spectrum reference reads once, at the programme's end")
    dev = x.device
    w = float(np.float32(1.0 - math.exp(-2.0 * math.pi * 1.0 / fs)))
    a = 1.0 - w
    with prec.active():
        bank = Blocked([design.cascade_modal_state_space(design.bandpass_design(fs, f, bw, order=6))
                        for f, bw in design.spectrum_band_frequencies(N_BANDS)], prec, dev)
        smooth = Blocked([(np.array([[a]]), np.array([[w]]), np.array([[a]]), np.array([[w]]))],
                         prec, dev)
        val, peak = [], []
        for s0 in range(0, S, 2):
            mono = 0.5 * (x[s0:s0 + 2, 0].to(prec.dtype) + x[s0:s0 + 2, 1].to(prec.dtype))
            y = bank(mono)  # [s, 30, n]
            v = smooth(y * y)
            del y
            val.append(v[..., -1])
            peak.append(v.amax(-1))
            del v
    return {"bands": _db(torch.cat(val))[:, None], "peaks": _db(torch.cat(peak))[:, None]}
