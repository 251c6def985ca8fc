"""The 4x true-peak oversampler (truepeakdsp.cc:109-131, zita-resampler
setup(fs, 4 fs, 1, hl=24)): up[4t + ph] = sum_i taps[ph, i] x[t - 47 + i],
from zeros before the stream's first sample.  The taps come from the
frozen design, rounded to float32 as the C reference stores them."""

from __future__ import annotations

import numpy as np
import torch

from . import design
from .lti import Prec

_HL = 24
_CHUNK = 1 << 17


def taps(prec: Prec, device) -> torch.Tensor:
    """[48, 4]: taps[ph, i] transposed."""
    k = design.upsample4_kernel(_HL).astype(np.float32).astype(np.float64)
    return prec.t(k.T, device)


def upsample4_abs_chunks(x: torch.Tensor, prec: Prec):
    """x [..., n] -> yields (t0, |up| [..., m, 4]) over consecutive chunks."""
    tp = taps(prec, x.device)
    xp = torch.nn.functional.pad(x.to(prec.dtype), (2 * _HL - 1, 0))
    n = x.shape[-1]
    for t0 in range(0, n, _CHUNK):
        m = min(_CHUNK, n - t0)
        w = xp[..., t0:t0 + m + 2 * _HL - 1].unfold(-1, 2 * _HL, 1)  # [..., m, 48]
        yield t0, prec.mm(w, tp).abs()


def upsample4_abs(x: torch.Tensor, prec: Prec) -> torch.Tensor:
    """x [..., n] -> |up| [..., n, 4]."""
    return torch.cat([u for _, u in upsample4_abs_chunks(x, prec)], dim=-2)


def peak_per_sample(x: torch.Tensor, prec: Prec) -> torch.Tensor:
    """x [S, C, n] -> [S, n]: max of |up| over channels and phases."""
    return torch.cat([u.amax(dim=(1, 3)) for _, u in upsample4_abs_chunks(x, prec)], dim=-1)
