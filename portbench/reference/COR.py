"""Plain stereo phase-correlation meter (x42 ``COR``, stcorrdsp.cc).

Per sample (stcorrdsp.cc:53-76): zl += w1 (L - zl) + 1e-20 and the same
for zr, w1 = 6.28 * 2000 / fs; then one-pole averages w2 = 1 / (0.3 fs)
of zl zr, zl^2 and zr^2.  The lowpass runs as a blocked recurrence
(lti.py); each update's averages are the exact weighted sum
z_T = (1 - w2)^T z_0 + sum_t w2 (1 - w2)^(T-1-t) p_t, then +1e-10 on exit
(:65-76).  The readout is zlr / sqrt(zll zrr + 1e-10) after the
programme's last update.
"""

from __future__ import annotations

import numpy as np
import torch

from . import design
from .lti import Blocked, Prec

KIND = "COR"
READOUTS = {"value": "cor"}
STATE = {}


def expected(x: torch.Tensor, fs: int, reads: list[int], prec: Prec, block: int) -> dict:
    """x [S, 2, n], one read at the end -> {"value": [S, 1]}."""
    S, C, n = x.shape
    if reads != [n] or n % block:
        raise ValueError("the COR reference reads once, after whole updates")
    w1, w2 = design.stcorr_coeffs(fs)
    a = 1.0 - w1
    dev = x.device
    with prec.active():
        lp = Blocked([(np.array([[a]]), np.array([[w1]]), np.array([[a]]), np.array([[w1]]))],
                     prec, dev)
        y = lp(x.to(prec.dtype) + 1e-20 / w1)  # [S, 2, n]: zl, zr after each sample
        prods = torch.stack([y[:, 0] * y[:, 1], y[:, 0] * y[:, 0], y[:, 1] * y[:, 1]], 1)
        del y
        t = np.arange(block, dtype=np.float64)
        wv = prec.t(w2 * (1.0 - w2) ** (block - 1.0 - t), dev)
        decay = (1.0 - w2) ** block
        zp = torch.zeros((S, 3), dtype=prec.dtype, device=dev)
        for k in range(n // block):
            pk = prods[..., k * block:(k + 1) * block]
            zp = zp * decay + prec.mm(pk, wv[:, None])[..., 0] + 1e-10
        cor = zp[:, 0] / torch.sqrt(zp[:, 1] * zp[:, 2] + 1e-10)
    return {"value": cor[:, None]}
