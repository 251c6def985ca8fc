"""Stereo phase-correlation meter (COR).

Counterpart of ``meters_lv2_tpu/models/cor.py``.  Reference:
jmeters/stcorrdsp.cc, wrapper src/meters.cc:511-536.  Per sample: one-pole
lowpass (w1 = 6.28*flp/fs) on L and R, then one-pole averages
(w2 = 1/(tcf*fs)) of zl*zr, zl^2, zr^2; readout zlr / sqrt(zll*zrr + 1e-10).

The lowpass is a blocked LTI recurrence (ops/lti.one_pole_system); the
running products need only their end-of-block value (read() is the only
consumer), so the w2 averages evaluate as one closed-form weighted sum
(ema_final) instead of a second scan.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..ops import design, lti
from ..ops.lti import canonical_device
from .base import register


@dataclasses.dataclass(frozen=True)
class CorState:
    zl: torch.Tensor  # [..., 1]
    zr: torch.Tensor  # [..., 1]
    zp: torch.Tensor  # [..., 3] (zlr, zll, zrr) — independent averaging poles


@register("COR")
class CorrelationMeter:
    def __init__(self, fs: float):
        self.fs = float(fs)
        w1, w2 = design.stcorr_coeffs(fs)  # flp 2 kHz, tcf 0.3 s
        self.w1 = w1
        self.w2 = w2
        self.lp = lti.one_pole_system(w1)
        self._weights: dict[tuple, tuple[torch.Tensor, float]] = {}

    def _ema_weights(self, T: int, device) -> tuple[torch.Tensor, float]:
        """(w2 (1-w2)^(T-1-t) for t < T as float32, (1-w2)^T), built in
        float64 on the host and cached per (T, device)."""
        key = (T, canonical_device(device))
        if key not in self._weights:
            t = np.arange(T, dtype=np.float64)
            wv = (self.w2 * (1.0 - self.w2) ** (T - 1.0 - t)).astype(np.float32)
            decay = float(np.float32((1.0 - self.w2) ** T))
            self._weights[key] = (torch.as_tensor(wv, device=key[1]), decay)
        return self._weights[key]

    def ema_final(self, prods: torch.Tensor, zp0: torch.Tensor) -> torch.Tensor:
        """Final value of the w2 running average over prods [..., T].

        Only the end-of-block value is ever read (stcorrdsp::read), so the
        one-pole is a closed-form weighted sum:
        z_T = (1-w)^T z_0 + sum_t w (1-w)^{T-1-t} p_t  (exact algebra of
        `z += w2*(p - z)`, stcorrdsp.cc:62-64).  The sum is an IEEE fp32
        matrix-vector product (never TF32).  It reorders the reference's
        sequential recurrence, so agreement degrades as T*w2 grows; blocks
        of up to a few seconds stay near 1e-6 (the JAX package's note)."""
        wv, decay = self._ema_weights(prods.shape[-1], prods.device)
        return zp0 * decay + torch.matmul(prods, wv)

    def init(self, batch_shape=(), device="cpu") -> CorState:
        batch_shape = tuple(batch_shape)
        z1 = torch.zeros((*batch_shape, 1), dtype=torch.float32, device=device)
        return CorState(
            zl=z1, zr=z1.clone(),
            zp=torch.zeros((*batch_shape, 3), dtype=torch.float32, device=device),
        )

    def update(self, state: CorState, lr: torch.Tensor) -> CorState:
        """lr: [..., 2, T]."""
        lr = lr.to(torch.float32)
        l, r = lr[..., 0, :], lr[..., 1, :]
        # zl += w1*(x - zl) + 1e-20  →  fold the +1e-20 into the input
        eps = float(np.float32(1e-20 / self.w1))
        yl, zl = self.lp.apply(l + eps, state.zl)
        yr, zr = self.lp.apply(r + eps, state.zr)
        prods = torch.stack([yl * yr, yl * yl, yr * yr], dim=-2)  # [..., 3, T]
        zp = self.ema_final(prods, state.zp)
        # non-finite flush + denormal offsets (stcorrdsp.cc:65-76)
        zl = torch.where(torch.isfinite(zl), zl, 0.0)
        zr = torch.where(torch.isfinite(zr), zr, 0.0)
        zp = torch.where(torch.isfinite(zp), zp, 0.0) + 1e-10
        return CorState(zl=zl, zr=zr, zp=zp)

    def read(self, state: CorState):
        zlr, zll, zrr = state.zp[..., 0], state.zp[..., 1], state.zp[..., 2]
        return zlr / torch.sqrt(zll * zrr + 1e-10), state
