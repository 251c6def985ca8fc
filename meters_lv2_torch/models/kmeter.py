"""K-meter (K-12/K-14/K-20): RMS ballistics + digital peak with hold/fall.

Counterpart of ``meters_lv2_tpu/models/kmeter.py``.  Reference:
jmeters/kmeterdsp.cc, wrapper src/meters.cc:333-418.

The squared-signal two-stage smoother is linear at 4-sample cadence: a
blocked LTI recurrence with 4 inputs per step
(ops/lti.grouped4_smoother_system).  The digital peak hold/fall logic runs
at block rate in the reference (one decision per process() call,
kmeterdsp.cc:124-139), so it stays per-block tensor logic here.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..ops import design, lti
from .base import register


@dataclasses.dataclass(frozen=True)
class KMeterState:
    z: torch.Tensor  # [..., 2] smoother state
    rms: torch.Tensor  # [...] max rms since last read
    peak: torch.Tensor  # [...] held digital peak
    cnt: torch.Tensor  # [...] int32 hold counter (samples)
    flag: torch.Tensor  # [...] bool: rms was read


class KMeter:
    """K-system meter; read() returns (rms, peak) like Kmeterdsp::read(rms&,peak&).

    update() takes blocks [..., T], T % 4 == 0.  The peak fall multiplier
    depends on the block length (kmeterdsp.cc:65-69): per block,
    fall = 10^(-0.05 * 15 * T/fs)  (15 dB/s).
    """

    def __init__(self, fs: float):
        self.fs = float(fs)
        omega, hold = design.kmeter_coeffs(fs)
        self.hold = hold
        self.sys = lti.grouped4_smoother_system(omega)

    def init(self, batch_shape=(), device="cpu") -> KMeterState:
        batch_shape = tuple(batch_shape)

        def z():
            return torch.zeros(batch_shape, dtype=torch.float32, device=device)

        return KMeterState(
            z=torch.zeros((*batch_shape, 2), dtype=torch.float32, device=device),
            rms=z(),
            peak=z(),
            cnt=torch.zeros(batch_shape, dtype=torch.int32, device=device),
            flag=torch.zeros(batch_shape, dtype=torch.bool, device=device),
        )

    def block_core(
        self, z: torch.Tensor, x: torch.Tensor
    ) -> tuple[torch.Tensor, torch.Tensor]:
        """Raw smoother advance + NaN-skipped block max of x^2; no entry
        clamp or finalize (the per-process() pieces live in update /
        finalize, so a fused kernel covering the bulk of a block can chain
        a plain tail through the same epilogue)."""
        *batch, T = x.shape
        if T % 4:
            raise ValueError(f"block length {T} is not a multiple of 4")
        sq = torch.square(x.to(torch.float32))
        # block digital peak (of x^2); NaN samples are skipped as the
        # reference's `if (t >= _peak)` comparison does (kmeterdsp.cc:124)
        t = torch.amax(torch.where(torch.isnan(sq), 0.0, sq), dim=-1)
        _, z = self.sys.apply(sq.reshape(*batch, T // 4, 4), z)
        return z, t

    def finalize(
        self, state: KMeterState, z: torch.Tensor, t: torch.Tensor, T: int
    ) -> KMeterState:
        """Per-process()-call epilogue on the advanced smoother state z
        and the block max t of x^2 (kmeterdsp.cc:101-139).  T is the block
        length, a Python int: the hold counter stays int32."""
        fall = float(np.float32(10.0 ** (-0.05 * 15.0 * (T / self.fs))))

        # NaN flush (kmeterdsp.cc:101-107)
        z = torch.where(torch.isnan(z), 0.0, z)
        t = torch.where(torch.isfinite(t), t, 0.0)
        z = z + 1e-20

        s = torch.sqrt(2.0 * z[..., 1])
        t = torch.sqrt(t)

        rms = torch.where(state.flag, s, torch.maximum(s, state.rms))

        # peak hold/fall, one decision per block (kmeterdsp.cc:124-139)
        new_hit = t >= state.peak
        holding = state.cnt > 0
        peak = torch.where(
            new_hit, t, torch.where(holding, state.peak, state.peak * fall + 1e-10)
        )
        cnt = torch.where(
            new_hit,
            torch.full_like(state.cnt, self.hold),
            torch.where(holding, state.cnt - int(T), state.cnt),
        )
        return KMeterState(z=z, rms=rms, peak=peak, cnt=cnt,
                           flag=torch.zeros_like(state.flag))

    def update(self, state: KMeterState, x: torch.Tensor) -> KMeterState:
        z = torch.clamp(state.z, 0.0, 50.0)  # entry clamp (kmeterdsp.cc:101)
        z, t = self.block_core(z, x)
        return self.finalize(state, z, t, x.shape[-1])

    def read(self, state: KMeterState):
        """Returns ({'rms', 'peak'}, state).  No rlgain argument: the
        K-meter wrapper re-uses the ref-level port for peak-hold reset
        instead of a gain (src/meters.cc:337-357)."""
        out = {"rms": state.rms, "peak": state.peak}
        return out, dataclasses.replace(state, flag=torch.ones_like(state.flag))

    def reset(self, state: KMeterState) -> KMeterState:
        return self.init(state.rms.shape, state.rms.device)

    def reset_peak(self, state: KMeterState) -> KMeterState:
        """Clear the held digital peak only — the K-meter wrapper re-uses
        its ref-level port edge as a peak-hold reset (src/meters.cc:
        337-357); the RMS needle and smoother state are untouched."""
        return dataclasses.replace(
            state,
            peak=torch.zeros_like(state.peak),
            cnt=torch.zeros_like(state.cnt),
        )


@register("K12mono")
@register("K12stereo")
class K12Meter(KMeter):
    k_offset = 12.0


@register("K14mono")
@register("K14stereo")
class K14Meter(KMeter):
    k_offset = 14.0


@register("K20mono")
@register("K20stereo")
class K20Meter(KMeter):
    k_offset = 20.0
