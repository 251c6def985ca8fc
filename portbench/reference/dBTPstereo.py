"""Plain digital true-peak meter (x42 ``dBTPstereo``, truepeakdsp.cc).

Per channel, from silence: the 4x oversampled stream of truepeak.py, its
|.|, and the Type-II-style ballistics of truepeakdsp.cc:58-107 on it, from
design.true_peak_ballistics (w1 = 4000 / fs / 4, w2 = 17200 / fs / 4, w3 =
1 - 7 / fs / 4 as float32 values, groups of 4 oversampled samples, +1e-20
on exit of each update), evaluated exactly by ballistics.py.  level = g
max(z1 + z2), g = 0.502, peak = max |up|, both since the programme's
start.
"""

from __future__ import annotations

import numpy as np
import torch

from . import design
from .ballistics import peak_meter
from .lti import Prec
from .truepeak import upsample4_abs

KIND = "dBTPstereo"
READOUTS = {"level": "lin", "peak": "lin"}
STATE = {}


def f32(v: float) -> float:
    return float(np.float32(v))


def expected(x: torch.Tensor, fs: int, reads: list[int], prec: Prec, block: int) -> dict:
    """x [S, C, n], one read at the end -> {"level", "peak": [S, 1, C]}."""
    if reads != [x.shape[-1]]:
        raise ValueError("the dBTP reference reads once, at the programme's end")
    S, C, n = x.shape
    with prec.active():
        up = upsample4_abs(x.reshape(S * C, n), prec).reshape(S * C, 4 * n)
        peak = up.amax(-1)
        c = design.true_peak_ballistics(fs)
        level = f32(c.g) * peak_meter(up, f32(c.w1), f32(c.w2), f32(c.w3), update=block,
                                      offset=1e-20)
    return {"level": level.reshape(S, 1, C), "peak": peak.reshape(S, 1, C)}
