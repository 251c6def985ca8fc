"""Goniometer (vectorscope) trace processing.

Counterpart of ``meters_lv2_tpu/models/goniometer.py``.  Reference:
gui/goniometer.c:299-538 (draw_rb) and src/goniometerlv2.c.  The plugin
ships raw stereo through a ring buffer; the GUI thread optionally
oversamples 2x/4x/8x (zita resampler, hlen=12), applies the one-pole
tracker lp += hpw (d - lp) with hpw = e^(-2 pi 20 / (rate os)) (the
reference comments it "high pass", gui/goniometer.c:400, but draws lp
itself), rotates to (x, y) = (L - R, L + R) and autoscales with an
asymmetric attack/decay gain.

process() is a function block -> trace points.  Oversampling and the
near-memoryless smoother are one composed FIR (ops/resample.
composed_smooth_taps), evaluated as overlapping-block float32 matrix
products (``torch.matmul``, IEEE fp32, as the JAX package leaves them to
XLA outside any kernel); the first three outputs of a block come from the
exact recurrence identity over the carried state.  Autogain is per-block
glue.  The JAX package's unfused diagnostic path (METERS_GONIO_COMPOSED=0)
is not ported.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from ..ops import resample
from ..ops.design import upsample_poly_kernel
from ..ops.lti import canonical_device, matmul
from .base import register

_F32 = torch.float32


@dataclasses.dataclass(frozen=True)
class GonioState:
    rhist: torch.Tensor  # [..., 2, 2*hl-1] resampler history
    lp: torch.Tensor  # [..., 2, 1] smoother state
    gain: torch.Tensor  # [...] autogain


@register("goniometer")
class Goniometer:
    def __init__(
        self,
        fs: float,
        oversample: int = 4,  # s_sfact default (goniometerlv2.c:95)
        autogain_attack: float = 54.0,
        autogain_decay: float = 58.0,
        autogain_rms: float = 50.0,
        autogain_target: float = 40.0,
    ):
        if oversample not in (1, 2, 4, 8):
            raise ValueError(f"oversample must be 1, 2, 4 or 8, got {oversample}")
        self.fs = float(fs)
        self.os = oversample
        self.hl = 12
        hpw = math.exp(-2.0 * math.pi * 20.0 / (fs * oversample))
        self.hpw = hpw
        base = (
            np.asarray(upsample_poly_kernel(oversample, self.hl), np.float64)
            if oversample > 1
            else np.ones((1, 1), np.float64)
        )
        self._comb = resample.composed_smooth_taps(base, hpw)
        eps_in = 1e-12 / hpw
        sm = hpw * (1.0 - hpw) ** np.arange(4, dtype=np.float64)
        self._eps_full = float(np.float32(eps_in * sm.sum()))
        self._eps_head = (eps_in * np.cumsum(sm)[:3]).astype(np.float32)
        self._head: dict[torch.device, tuple[torch.Tensor, ...]] = {}
        # dial mappings (gui/goniometer.c:895-912)
        self.attack_pow = max(0.01, 0.1 * math.exp(0.06 * autogain_attack) - 0.09)
        self.decay_pow = max(0.01, 0.1 * math.exp(0.06 * autogain_decay) - 0.09)
        self.g_rms = 0.01 * autogain_rms
        self.g_target = max(0.15, math.exp(1.8 * (-0.02 * autogain_target + 1.0)))

    def init(self, batch_shape=(), device="cuda") -> GonioState:
        batch_shape = tuple(batch_shape)
        return GonioState(
            rhist=resample.upsample_init((*batch_shape, 2), self.hl, device),
            lp=torch.zeros((*batch_shape, 2, 1), dtype=_F32, device=device),
            gain=torch.ones(batch_shape, dtype=_F32, device=device),
        )

    def _head_consts(self, device):
        """(C^T [K+1, 3], pow [3], eps_head [3]) on ``device``, cached."""
        device = canonical_device(device)
        if device not in self._head:
            _, C, powv = self._comb
            self._head[device] = tuple(
                torch.as_tensor(np.ascontiguousarray(a), device=device)
                for a in (C.T, powv, self._eps_head))
        return self._head[device]

    def _trace(self, state: GonioState, lr: torch.Tensor):
        """The trace through the composed oversample + smoother FIR: one
        overlapping-block matmul over [history | lr].

        Outputs 0..2 of the block are overwritten with the exact recurrence
        identity trace_t = sum_{k<=t} sm_k d_{t-k} + (1-hpw)^(t+1) s0: the
        carried smoother state covers all older history with an exact
        coefficient, so the zero-padded history corrupts nothing.  The
        truncation residual (1-hpw)^4 is <= ~7e-11 of the signal.
        """
        tapc = self._comb[0]
        nhp = tapc.shape[1] - 1
        hist = state.rhist
        nh = hist.shape[-1]
        if self.os > 1:
            histw = torch.nn.functional.pad(hist, (nhp - nh, 0))
        else:
            histw = hist[..., nh - nhp:]
        y, _ = resample._upsample_blocked(lr, histw, tapc)
        y = y + self._eps_full
        if self.os > 1:
            ct, powv, eps_head = self._head_consts(lr.device)
            win = torch.cat([hist, lr[..., :2]], dim=-1)
            y[..., :3] = matmul(win, ct) + state.lp * powv + eps_head
        lp = y[..., -1:].clone()
        rhist = torch.cat([hist, lr], dim=-1)[..., -nh:].contiguous()
        return y, lp, rhist

    def process(self, state: GonioState, lr: torch.Tensor, autogain: bool = True):
        """lr: [..., 2, T].  Returns ({'x', 'y', 'gain'}, new_state) with
        x/y [..., os*T] trace coordinates (before the display gain)."""
        if lr.ndim < 2 or lr.shape[-2] != 2:
            raise ValueError(f"lr must be [..., 2, T], got {tuple(lr.shape)}")
        lr = lr.to(_F32)
        T = lr.shape[-1]
        y, lp, rhist = self._trace(state, lr)
        l, r = y[..., 0, :], y[..., 1, :]
        ax = l - r
        ay = l + r

        # autogain (gui/goniometer.c:497-537), one step per block
        if autogain:
            xdif = torch.amax(ax, -1) - torch.amin(ax, -1)
            ydif = torch.amax(ay, -1) - torch.amin(ay, -1)
            mx = torch.sqrt(xdif * xdif + ydif * ydif) * 0.707
            rms0 = torch.sqrt(torch.mean(torch.square(l), -1))
            rms1 = torch.sqrt(torch.mean(torch.square(r), -1))
            rms = 5.436 * torch.maximum(rms0, rms1)
            if self.g_rms > 0:
                mx = mx * (1.0 - self.g_rms) + rms * self.g_rms
            mx = mx * self.g_target
            mx = torch.where(torch.isfinite(mx), mx, 0.0)
            tgt = torch.where(
                mx < 0.01, 100.0,
                torch.where(mx > 100.0, 0.02, 2.0 / torch.clamp_min(mx, 1e-6)))
            elapsed = T / self.fs
            att = torch.where(
                tgt < state.gain,
                self.attack_pow * (0.31 + 0.1 * math.log10(elapsed)),
                self.decay_pow * (0.03 + 0.007 * math.log(elapsed)),
            )
            gain = torch.clamp_min(state.gain + att * (tgt - state.gain), 0.001)
        else:
            gain = state.gain

        new_state = GonioState(rhist=rhist, lp=lp, gain=gain)
        return {"x": ax, "y": ay, "gain": gain}, new_state
