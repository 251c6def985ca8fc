"""Digital true-peak meter (dBTP): 4x polyphase oversampling + Type-II-style
ballistics and raw oversampled peak.

Counterpart of ``meters_lv2_tpu/models/truepeak.py``.  Reference:
jmeters/truepeakdsp.cc (DSP), src/meters.cc:438-508 (wrapper).

``update`` always takes the fused route (ops/ballistics.
true_peak_update_fused): on a card the 128-aligned bulk of each block runs
in the truepeak_fused CUDA kernel, where the 4x stream never leaves on-chip
memory, and a shorter tail runs the plain oversampling plus the
ballistics kernel.
"""

from __future__ import annotations

import dataclasses

import torch

from ..ops import ballistics as bal
from ..ops import design, resample
from ..ops.ballistics import TruePeakState
from .base import register


@dataclasses.dataclass(frozen=True)
class TruePeakMeterState:
    hist: torch.Tensor  # [..., 47] resampler history
    bal: TruePeakState


@register("dBTPmono")
@register("dBTPstereo")
class TruePeakMeter:
    """read() returns (level, peak) = ballistic max and raw oversampled max."""

    def __init__(self, fs: float):
        self.fs = float(fs)
        self.coeffs = design.true_peak_ballistics(fs)

    def init(self, batch_shape=(), device="cpu") -> TruePeakMeterState:
        batch_shape = tuple(batch_shape)
        return TruePeakMeterState(
            hist=torch.zeros((*batch_shape, 47), dtype=torch.float32, device=device),
            bal=bal.true_peak_init(batch_shape, device),
        )

    def update(self, state: TruePeakMeterState, x: torch.Tensor) -> TruePeakMeterState:
        """x: [..., T] with the state's batch shape, T % 4 == 0."""
        b, hist = bal.true_peak_update_fused(
            self.coeffs, state.bal, x.to(torch.float32), state.hist
        )
        return TruePeakMeterState(hist=hist, bal=b)

    def process_max(self, state: TruePeakMeterState, x: torch.Tensor):
        """Oversampled |max| only (truepeakdsp.cc:109-131).

        Returns (block_max, new_state) where new_state tracks only hist.
        """
        up, hist = resample.upsample4(x.to(torch.float32), state.hist)
        m = torch.amax(torch.abs(up), dim=-1)
        return m, dataclasses.replace(state, hist=hist)

    def read(self, state: TruePeakMeterState):
        m, p, b = bal.true_peak_read(state.bal)
        return {"level": m, "peak": p}, dataclasses.replace(state, bal=b)

    def reset(self, state: TruePeakMeterState) -> TruePeakMeterState:
        return dataclasses.replace(
            state, bal=bal.true_peak_init(state.bal.m.shape, state.bal.m.device)
        )
