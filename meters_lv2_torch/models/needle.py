"""Needle meters: VU, DIN, Nordic (IEC Type I), BBC, EBU (IEC Type IIa/IIb)
and the BBC mid/side M-6 meter.

Counterpart of ``meters_lv2_tpu/models/needle.py``.  Reference semantics:
src/meters.cc:298-331 (run), jmeters/vumeterdsp.cc, iec1ppmdsp.cc,
iec2ppmdsp.cc, msppmdsp.cc.  Channels are independent DSP instances (a
batch dim here); the readout is ``rlgain * read()`` with
rlgain = 10^(0.05*(ref_level_db+18)).

The VU filter is linear at 4-sample cadence: a blocked LTI recurrence with
4 inputs per step (ops/lti.vu_grouped4_system).  The PPM family is the
nonlinear attack/release recurrence (ops/ballistics, the ballistics CUDA
kernel on a card).
"""

from __future__ import annotations

import dataclasses

import torch

from ..ops import ballistics as bal
from ..ops import design, lti
from ..ops.ballistics import PPMState
from ..ops.ballistics_core import f32
from .base import register, ref_level_gain


# ---------------------------------------------------------------------------
# VU (IEC 60268-17) — linear path
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class VUState:
    z: torch.Tensor  # [..., 2] filter state (z1, z2)
    m: torch.Tensor  # [...]
    res: torch.Tensor  # [...] bool


class VUMeter:
    """IEC 60268-17 VU ballistics (vumeterdsp.cc:45-98).

    Per channel: 2nd-order resonant lowpass on |x| with the reference's
    exact 4-sample update cadence; read() = 1.5*1.571 * max(z2) since last
    read.  update() takes blocks [..., T] with T % 4 == 0.
    """

    def __init__(self, fs: float):
        self.fs = float(fs)
        w, g = design.vu_coeffs(fs)
        self.g = g
        self.sys = lti.vu_grouped4_system(w)

    def init(self, batch_shape=(), device="cpu") -> VUState:
        batch_shape = tuple(batch_shape)
        return VUState(
            z=torch.zeros((*batch_shape, 2), dtype=torch.float32, device=device),
            m=torch.zeros(batch_shape, dtype=torch.float32, device=device),
            res=torch.ones(batch_shape, dtype=torch.bool, device=device),
        )

    def update(self, state: VUState, x: torch.Tensor) -> VUState:
        *batch, T = x.shape
        if T % 4:
            raise ValueError(f"block length {T} is not a multiple of 4")
        z = torch.clamp(state.z, -20.0, 20.0)
        m0 = torch.where(state.res, 0.0, state.m)
        u = torch.abs(x.to(torch.float32)).reshape(*batch, T // 4, 4)
        y, z = self.sys.apply(u, z)  # y: [..., T//4, 1] = z2 per group
        m = torch.maximum(m0, torch.amax(y[..., 0], dim=-1))
        # non-finite flush (vumeterdsp.cc:70-73)
        bad = ~torch.isfinite(z).all(dim=-1)
        z = torch.where(bad[..., None], 0.0, z)
        z = torch.stack([z[..., 0], z[..., 1] + 1e-10], dim=-1)
        m = torch.where(bad, float("inf"), m)
        return VUState(z=z, m=m, res=torch.zeros_like(state.res))

    def read(self, state: VUState, ref_level_db=-22.0):
        val = ref_level_gain(ref_level_db) * f32(self.g) * state.m
        return val, dataclasses.replace(state, res=torch.ones_like(state.res))


# ---------------------------------------------------------------------------
# PPM family — nonlinear ballistics path
# ---------------------------------------------------------------------------


class _PPMMeter:
    """Shared Type I/II PPM wrapper around ops.ballistics."""

    def __init__(self, fs: float, coeffs: design.BallisticsCoeffs):
        self.fs = float(fs)
        self.coeffs = coeffs

    def init(self, batch_shape=(), device="cpu") -> PPMState:
        return bal.ppm_init(batch_shape, device)

    def update(self, state: PPMState, x: torch.Tensor) -> PPMState:
        return bal.ppm_update(self.coeffs, state, torch.abs(x.to(torch.float32)))

    def read(self, state: PPMState, ref_level_db=-22.0):
        val, state = bal.ppm_read(self.coeffs, state)
        return ref_level_gain(ref_level_db) * val, state


class DINMeter(_PPMMeter):
    """DIN PPM (IEC 60268-10 Type I, iec1ppmdsp.cc)."""

    def __init__(self, fs: float):
        super().__init__(fs, design.iec1_ppm(fs))


class NordicMeter(DINMeter):
    """Nordic PPM — same Type I ballistics, different display scale."""


class BBCMeter(_PPMMeter):
    """BBC PPM (IEC 60268-10 Type IIa, iec2ppmdsp.cc)."""

    def __init__(self, fs: float):
        super().__init__(fs, design.iec2_ppm(fs))


class EBUMeter(BBCMeter):
    """EBU PPM (IEC 60268-10 Type IIb) — same DSP, different display scale."""


@dataclasses.dataclass(frozen=True)
class BBCMSState:
    mid: PPMState
    side: PPMState


_MV_6 = f32(10.0 ** (0.05 * -6.0))  # -6 dB: mid, and side with S20 off
_MV_14 = f32(10.0 ** (0.05 * 14.0))  # +14 dB: side with S20 on


@register("BBCM6")
class BBCMidSideMeter:
    """BBC M-6 mid/side meter (msppmdsp.cc, src/meters.cc:552-589).

    Type II ballistics on mv*|L+R| (mid) and mv*|L-R| (side); mid gain is
    -6 dB; side gain toggles -6/+14 dB ("S20" mode).  Mid and side run as
    one stacked [2N, T] batch through one ballistics call: the rows are
    independent, so the result is that of two calls.
    """

    def __init__(self, fs: float):
        self.fs = float(fs)
        self.coeffs = design.iec2_ppm(fs)

    def init(self, batch_shape=(), device="cpu") -> BBCMSState:
        return BBCMSState(
            mid=bal.ppm_init(batch_shape, device),
            side=bal.ppm_init(batch_shape, device),
        )

    def update(self, state: BBCMSState, lr: torch.Tensor, s20=False) -> BBCMSState:
        """lr: [..., 2, T] stereo block.

        ``s20`` selects the side-channel gain (-6 dB off, +14 dB on): a
        Python bool, or a bool tensor (scalar or one value per stream of
        the batch), read every update as the reference reads its port 7
        every run() (src/meters.cc:562-563,577-580).
        """
        lr = lr.to(torch.float32)
        l, r = lr[..., 0, :], lr[..., 1, :]
        if isinstance(s20, torch.Tensor):
            mv_s = torch.where(
                s20.to(device=lr.device, dtype=torch.bool),
                torch.tensor(_MV_14, dtype=torch.float32, device=lr.device),
                torch.tensor(_MV_6, dtype=torch.float32, device=lr.device),
            )
            if mv_s.ndim:  # per-stream s20: broadcast over the time axis
                mv_s = mv_s[..., None]
        else:
            mv_s = _MV_14 if s20 else _MV_6
        t = torch.stack([_MV_6 * torch.abs(l + r), mv_s * torch.abs(l - r)])
        both = bal.ppm_update(self.coeffs, _stack(state.mid, state.side), t)
        return BBCMSState(mid=_pick(both, 0), side=_pick(both, 1))

    def read(self, state: BBCMSState, ref_level_db=-22.0):
        g = ref_level_gain(ref_level_db)
        vm, mid = bal.ppm_read(self.coeffs, state.mid)
        vs, side = bal.ppm_read(self.coeffs, state.side)
        return {"mid": g * vm, "side": g * vs}, BBCMSState(mid=mid, side=side)


def _stack(a: PPMState, b: PPMState) -> PPMState:
    return PPMState(*(torch.stack([getattr(a, f.name), getattr(b, f.name)])
                      for f in dataclasses.fields(PPMState)))


def _pick(s: PPMState, i: int) -> PPMState:
    return PPMState(*(getattr(s, f.name)[i] for f in dataclasses.fields(PPMState)))


# register mono/stereo URI aliases; channel layout is just a batch dim here.
for _name, _cls in [
    ("VU", VUMeter),
    ("DIN", DINMeter),
    ("NOR", NordicMeter),
    ("BBC", BBCMeter),
    ("EBU", EBUMeter),
]:
    register(_name + "mono")(_cls)
    register(_name + "stereo")(_cls)
