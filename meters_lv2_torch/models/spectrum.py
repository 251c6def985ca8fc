"""30-band 1/3-octave spectrum analyzer (IEC 61260).

Counterpart of ``meters_lv2_tpu/models/spectrum.py``.  Reference:
src/spectrumlv2.c (plugin), src/spectr.c (filter design).  Per band: a
6-stage band-pass biquad cascade; per sample the squared band output feeds
a one-pole display smoother (omega = 1 - e^(-2*pi*speed/rate)) with a
running peak-hold; readout is 20*log10(sqrt(2*val)) floored at -100
(spectrumlv2.c:210-248).

The 30 cascades are one banked 12-state LTI (ops.lti.BankedLTISystem) of
modal-balanced 2x2 sections, designed in float64 on the host
(ops.design.bandpass_design, cascade_modal_state_space).  The 128-aligned
bulk of a block goes through ops.spectrum_fused.fused_core (the CUDA kernel
on a card); a non-aligned tail, or a block shorter than 128 samples, runs
the kernel's plain computation (ops.spectrum_fused.plain_core: the banked
LTI and runtime-omega one-pole) with chained state, as the JAX meter does.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from ..ops import design, lti, spectrum_fused
from .base import register

N_BANDS = spectrum_fused.N_BANDS
_BLOCK = spectrum_fused.BLOCK
_F32 = torch.float32


@dataclasses.dataclass(frozen=True)
class SpectrumState:
    zf: torch.Tensor  # [..., 30, 12] filter bank state
    val: torch.Tensor  # [..., 30] smoothed band power
    peak: torch.Tensor  # [..., 30] peak-hold of smoothed power
    omega: torch.Tensor  # [] display-smoother coefficient (runtime-mutable,
    # like the reference's UI speed port, spectrumlv2.c:161-177)


@register("spectr30mono")
@register("spectr30stereo")
class SpectrumAnalyzer:
    """update() takes mono blocks [..., T] or stereo [..., 2, T] (averaged,
    spectrumlv2.c:195-201)."""

    def __init__(self, fs: float, speed: float = 1.0):
        self.fs = float(fs)
        self.bank = lti.BankedLTISystem([
            design.cascade_modal_state_space(design.bandpass_design(fs, f_m, bw, order=6))
            for f_m, bw in design.spectrum_band_frequencies(N_BANDS)
        ])
        self.speed = min(max(float(speed), 0.01), 15.0)
        self.omega = 1.0 - math.exp(-2.0 * math.pi * self.speed / self.fs)

    def set_speed(self, state: SpectrumState, speed) -> SpectrumState:
        """Runtime speed change (UI speed port, spectrumlv2.c:161-177): a
        state update on the state's device, no rebuild and no host sync.
        The clamp lets NaN through, as the JAX package's jnp.clip does."""
        dev = state.omega.device
        if isinstance(speed, torch.Tensor):
            v = speed.to(device=dev, dtype=_F32)
        else:
            v = torch.full((), float(speed), dtype=_F32, device=dev)
        v = torch.clamp(v, 0.01, 15.0)
        omega = 1.0 - torch.exp(-2.0 * math.pi * v / self.fs)
        return dataclasses.replace(state, omega=omega)

    def init(self, batch_shape=(), device="cuda") -> SpectrumState:
        batch_shape = tuple(batch_shape)
        return SpectrumState(
            zf=self.bank.init(batch_shape, device),
            val=torch.zeros((*batch_shape, N_BANDS), dtype=_F32, device=device),
            peak=torch.zeros((*batch_shape, N_BANDS), dtype=_F32, device=device),
            omega=torch.tensor(self.omega, dtype=_F32, device=device),
        )

    def update(self, state: SpectrumState, x: torch.Tensor, stereo: bool = False) -> SpectrumState:
        if x.dtype != _F32:
            x = x.to(_F32)
        if stereo:
            x = 0.5 * (x[..., 0, :] + x[..., 1, :])
        *batch, T = x.shape
        d = self.bank.d
        if T >= _BLOCK:
            Tm = (T // _BLOCK) * _BLOCK
            val, bp, zf = spectrum_fused.fused_core(
                x[..., :Tm].reshape(-1, Tm).contiguous(),
                state.zf.reshape(-1, N_BANDS, d).contiguous(),
                state.val.reshape(-1, N_BANDS).contiguous(),
                state.omega,
                self.bank.op(_BLOCK),
            )
            val = val.reshape(*batch, N_BANDS)
            bp = bp.reshape(*batch, N_BANDS)
            zf = zf.reshape(*batch, N_BANDS, d)
            if Tm < T:  # non-128-aligned tail: plain ops, chained state
                val, bp2, zf = spectrum_fused.plain_core(
                    x[..., Tm:], zf, val, state.omega, self.bank.op)
                bp = torch.maximum(bp, bp2)
        else:
            val, bp, zf = spectrum_fused.plain_core(x, state.zf, state.val, state.omega, self.bank.op)
        # peak-hold tracks the smoothed value maximum (spectrumlv2.c:224)
        peak = torch.maximum(state.peak, bp)
        # non-finite flush + denormal guard (spectrumlv2.c:231-236)
        zf = torch.where(torch.isfinite(zf), zf, 0.0)
        val = torch.where(torch.isfinite(val), val, 0.0) + 1e-20
        peak = torch.where(torch.isfinite(peak), peak, 0.0)
        return SpectrumState(zf=zf, val=val, peak=peak, omega=state.omega)

    def read(self, state: SpectrumState):
        """({"bands": dB[..., 30], "peaks": dB[..., 30]}, state) per
        spectrumlv2.c:240-248."""

        def to_db(p):
            vs = torch.sqrt(2.0 * p)
            return torch.where(vs > 1e-5, 20.0 * torch.log10(torch.clamp_min(vs, 1e-30)), -100.0)

        return {"bands": to_db(state.val), "peaks": to_db(state.peak)}, state

    def reset_peaks(self, state: SpectrumState) -> SpectrumState:
        return dataclasses.replace(state, peak=torch.zeros_like(state.peak))
