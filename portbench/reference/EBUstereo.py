"""Plain EBU PPM (x42 ``EBUstereo``: IEC 60268-10 type IIb, iec2ppmdsp.cc).

Per channel, from silence: |x| through the dual attack / release
ballistics of design.iec2_ppm (w1 = 200 / fs, w2 = 860 / fs, w3 = 1 - 4 /
fs as float32 values, groups of 4 samples, entry clamp to [0, 20] and
+1e-10 on exit of each update), evaluated exactly by ballistics.py; the
readout is 10^(0.05 (-22 + 18)) g max(z1 + z2), g = 0.5141, since the
programme's start (src/meters.cc:303-306, the reference level port at its
default -22).
"""

from __future__ import annotations

import numpy as np
import torch

from . import design
from .ballistics import peak_meter
from .lti import Prec

KIND = "EBUstereo"
READOUTS = {"value": "lin"}
STATE = {}


def f32(v: float) -> float:
    return float(np.float32(v))


def expected(x: torch.Tensor, fs: int, reads: list[int], prec: Prec, block: int) -> dict:
    """x [S, C, n], one read at the end -> {"value": [S, 1, C]}."""
    if reads != [x.shape[-1]]:
        raise ValueError("the PPM reference reads once, at the programme's end")
    S, C, n = x.shape
    t = x.reshape(S * C, n).to(prec.dtype).abs()
    c = design.iec2_ppm(fs)
    m = peak_meter(t, f32(c.w1), f32(c.w2), f32(c.w3), update=block // 4, offset=1e-10)
    gain = f32(10.0 ** (0.05 * (-22.0 + 18.0))) * f32(c.g)
    return {"value": (gain * m).reshape(S, 1, C)}
