"""Surround meters (surround3..8): per-channel K-meter RMS/peak plus
user-routable correlation pairs.

Counterpart of ``meters_lv2_tpu/models/surround.py``.  Reference:
src/surmeter.c, N Kmeterdsp instances and 4 Stcorrdsp instances (3 when
nchan <= 3), each correlating a configurable channel pair (:115-128).

The correlator lowpass runs once per channel and the pairs select the
filtered signals: filtering commutes with selection, so for any fixed
routing the result is the reference's per-correlator filters.  The
128-aligned bulk of a block goes through ops.surround_fused.fused_core (the
CUDA kernel on a card, its plain version on the CPU); a non-aligned tail,
or a block shorter than 128 samples, runs the plain ops with chained state,
as the JAX meter's fused path does.
"""

from __future__ import annotations

import dataclasses

import torch

from ..ops import surround_fused
from ..ops.hist import float_to_int32
from ..ops.lti import canonical_device
from .base import register
from .cor import CorrelationMeter
from .kmeter import KMeter, KMeterState

_BLOCK = surround_fused.BLOCK
_F32 = torch.float32


@dataclasses.dataclass(frozen=True)
class SurroundState:
    km: KMeterState  # [..., C]
    zl: torch.Tensor  # [..., C, 1] per-channel correlator lowpass state
    zp: torch.Tensor  # [..., P, 3] per-pair (zab, zaa, zbb) integrators


class SurroundMeter:
    """nchan-channel surround meter.

    ``pairs`` selects the correlator inputs (default: adjacent channels,
    wrapping around), mirroring the surc_a/surc_b control ports
    (src/surmeter.c:119-128).
    """

    nchan = 8

    def __init__(self, fs: float, pairs=None):
        self.fs = float(fs)
        self.km = KMeter(fs)
        self.cor = CorrelationMeter(fs)
        self.npairs = 4 if self.nchan > 3 else 3
        if pairs is None:
            pairs = tuple((i % self.nchan, (i + 1) % self.nchan) for i in range(self.npairs))
        if len(pairs) != self.npairs:
            raise ValueError(f"{self.npairs} pairs expected, got {len(pairs)}")
        # both ends clamped into [0, nchan-1] like the reference's port
        # handler (surmeter.c:122-125)
        self.pairs = tuple(
            (min(max(int(a), 0), self.nchan - 1), min(max(int(b), 0), self.nchan - 1))
            for a, b in pairs
        )
        self._static_sel: dict[torch.device, tuple[torch.Tensor, torch.Tensor]] = {}

    def init(self, batch_shape=(), device="cuda") -> SurroundState:
        batch_shape = tuple(batch_shape)
        return SurroundState(
            km=self.km.init((*batch_shape, self.nchan), device),
            zl=torch.zeros((*batch_shape, self.nchan, 1), dtype=_F32, device=device),
            zp=torch.zeros((*batch_shape, self.npairs, 3), dtype=_F32, device=device),
        )

    def _one_hot(self, idx: torch.Tensor) -> torch.Tensor:
        ch = torch.arange(self.nchan, device=idx.device)
        return (idx[:, None] == ch).to(_F32)

    def _sel(self, pairs, device):
        """[P, C] one-hot routing tensors on ``device`` from the construction
        pairs or a runtime [P, 2] tensor.  The reference re-reads
        surc_a/surc_b every run() (src/surmeter.c:119-128), so routing is a
        per-call input: no rebuild, no host sync.  A float pair rounds half
        to even (``jnp.round``), casts as the JAX package casts
        (``float_to_int32``: NaN -> 0, +inf -> INT32_MAX) and clamps to
        [0, nchan-1]."""
        if pairs is None:
            device = canonical_device(device)
            if device not in self._static_sel:
                idx = torch.tensor(self.pairs, dtype=torch.int64, device=device)
                self._static_sel[device] = (self._one_hot(idx[:, 0]), self._one_hot(idx[:, 1]))
            return self._static_sel[device]
        pr = torch.as_tensor(pairs, device=device)
        if tuple(pr.shape) != (self.npairs, 2):
            raise ValueError(f"pairs must be [{self.npairs}, 2], got {tuple(pr.shape)}")
        if pr.is_floating_point():
            pr = float_to_int32(torch.round(pr.to(_F32)))
        idx = torch.clamp(pr.to(torch.int64), 0, self.nchan - 1)
        return self._one_hot(idx[:, 0]), self._one_hot(idx[:, 1])

    def _core(self, core, x, kmz, zl, zp, sel_a, sel_b):
        """One (sub-)block through ``core`` (surround_fused.fused_core, or
        its plain version for a tail): K-meter smoother advance and block
        peak, correlator lowpass, and the w2 pair averages composed as
        zp (1 - w2)^T + pacc (cor.ema_final algebra)."""
        *batch, C, T = x.shape
        cor = self.cor
        wv, decay = cor._ema_weights(T, x.device)
        kmz_r, zl_r, pk, pacc = core(
            x.reshape(-1, C, T).contiguous(),
            kmz.reshape(-1, C, 2).contiguous(),
            zl.reshape(-1, C, 1).contiguous(),
            sel_a, sel_b, self.km.sys, cor.lp, cor.w1, wv,
        )
        zp = zp * decay + pacc.reshape(*batch, self.npairs, 3)
        return (kmz_r.reshape(*batch, C, 2), zl_r.reshape(*batch, C, 1), zp,
                pk.reshape(*batch, C))

    def update(self, state: SurroundState, x: torch.Tensor, pairs=None) -> SurroundState:
        """x: [..., C, T].  ``pairs`` optionally re-routes the correlators
        ([P, 2], a tensor on the card or host values); see _sel.  Across a
        re-route the pair integrators carry, as the reference's do."""
        if x.dtype != _F32:
            x = x.to(_F32)
        if x.ndim < 2 or x.shape[-2] != self.nchan or x.shape[-1] == 0:
            raise ValueError(f"x must be [..., {self.nchan}, T > 0], got {tuple(x.shape)}")
        T = x.shape[-1]
        sel = self._sel(pairs, x.device)
        kmz = torch.clamp(state.km.z, 0.0, 50.0)  # entry clamp (kmeterdsp.cc:101)
        zl, zp = state.zl, state.zp
        Tm = (T // _BLOCK) * _BLOCK
        if Tm:
            kmz, zl, zp, tmax = self._core(
                surround_fused.fused_core, x[..., :Tm], kmz, zl, zp, *sel)
        if T > Tm:  # non-128-aligned tail, or a short block: plain ops, chained state
            kmz, zl, zp, tmax_t = self._core(
                surround_fused.fused_core_reference, x[..., Tm:], kmz, zl, zp, *sel)
            tmax = torch.maximum(tmax, tmax_t) if Tm else tmax_t

        km = self.km.finalize(state.km, kmz, tmax, T)
        # non-finite flush + denormal offsets (stcorrdsp.cc:65-76)
        zl = torch.where(torch.isfinite(zl), zl, 0.0)
        zp = torch.where(torch.isfinite(zp), zp, 0.0) + 1e-10
        return SurroundState(km=km, zl=zl, zp=zp)

    def read(self, state: SurroundState):
        km_out, km_st = self.km.read(state.km)
        zab, zaa, zbb = state.zp[..., 0], state.zp[..., 1], state.zp[..., 2]
        c = zab / torch.sqrt(zaa * zbb + 1e-10)
        return {
            "level": km_out["rms"],
            "peak": km_out["peak"],
            "correlation": c,
        }, SurroundState(km=km_st, zl=state.zl, zp=state.zp)


def _make(n):
    @register(f"surround{n}")
    class _Sur(SurroundMeter):
        nchan = n

    _Sur.__name__ = _Sur.__qualname__ = f"Surround{n}Meter"
    return _Sur


Surround3Meter = _make(3)
Surround4Meter = _make(4)
Surround5Meter = _make(5)
Surround6Meter = _make(6)
Surround7Meter = _make(7)
Surround8Meter = _make(8)
