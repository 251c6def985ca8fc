"""Bit meter: IEEE-754 field statistics of the sample stream.

Counterpart of ``meters_lv2_tpu/models/bitmeter.py``.  Reference:
src/bitmeter.c (float_stats, :63-105): per sample, decode sign, exponent
and mantissa; count NaN/Inf/zero/denormal/positive; track |min| and |max|
of normals; and keep three histogram regions (layout src/uris.h:52-60):

  hit[j]  -- absolute bit position j = exponent + k (k = 0..22 mantissa
             bits, plus the implicit leading bit at k = 23 for normals)
  one[j]  -- the same positions, counted only where the bit is set
  dset[k] -- per-mantissa-bit set counts

Every update computes the block's counter deltas in one call of
ops/bitmeter_stats (the CUDA kernel for the whole block on a card, any
length; its plain version on the CPU) and adds them under the one
integration gate of the call.
"""

from __future__ import annotations

import dataclasses

import torch

from ..ops import bitmeter_stats as _stats
from ..ops.bitmeter_stats import NMAN, bitmeter_stats
from ..utils import profiler
from .base import register

NPOS = _stats.NPOS  # hit/one position range (matches reference region width)
_CAP = 2147483647


@dataclasses.dataclass(frozen=True)
class BitMeterState:
    hit: torch.Tensor  # [..., 280] int32 absolute-bit-position exposure counts
    one: torch.Tensor  # [..., 280] int32 set-bit counts at those positions
    dset: torch.Tensor  # [..., 23] int32 per-mantissa-bit set counts
    nan: torch.Tensor  # [...] int32 counters (reference: int, bitmeter.c:75-105)
    inf: torch.Tensor
    den: torch.Tensor
    zero: torch.Tensor
    pos: torch.Tensor
    vmin: torch.Tensor  # [...] f32
    vmax: torch.Tensor
    time: torch.Tensor  # [...] int32
    integrating: torch.Tensor  # [...] bool


@register("bitmeter")
class BitMeter:
    def __init__(self, fs: float, averaging: bool = True):
        self.fs = float(fs)
        self.averaging = averaging

    def init(self, batch_shape=(), device="cuda") -> BitMeterState:
        batch_shape = tuple(batch_shape)

        def zi(*s):
            return torch.zeros((*batch_shape, *s), dtype=torch.int32, device=device)

        return BitMeterState(
            hit=zi(NPOS), one=zi(NPOS), dset=zi(NMAN),
            nan=zi(), inf=zi(), den=zi(), zero=zi(), pos=zi(),
            vmin=torch.full(batch_shape, torch.inf, dtype=torch.float32, device=device),
            vmax=torch.zeros(batch_shape, dtype=torch.float32, device=device),
            time=zi(),
            integrating=torch.ones(batch_shape, dtype=torch.bool, device=device),
        )

    def update(self, state: BitMeterState, x: torch.Tensor) -> BitMeterState:
        """x: [..., T] float32 with the state's batch shape."""
        *batch, T = x.shape
        with profiler.span("bitmeter.update"):
            # one gate for the whole call (reference: per-process() acquisition
            # stop at INT_MAX)
            run = state.integrating & (state.time < _CAP - T)
            with profiler.span("bitmeter.kernel"):
                d = bitmeter_stats(x.to(torch.float32).reshape(-1, T))
            d = {k: v.reshape((*batch, *v.shape[1:])) for k, v in d.items()}
            gate = run.to(torch.int32)

            def gated(old, delta):  # old + delta * gate, one launch
                return torch.addcmul(old, delta,
                                     gate[..., None] if delta.ndim > run.ndim else gate)

            return BitMeterState(
                hit=gated(state.hit, d["hit"]),
                one=gated(state.one, d["one"]),
                dset=gated(state.dset, d["dset"]),
                nan=gated(state.nan, d["nan"]),
                inf=gated(state.inf, d["inf"]),
                den=gated(state.den, d["den"]),
                zero=gated(state.zero, d["zero"]),
                pos=gated(state.pos, d["pos"]),
                vmin=torch.where(run, torch.minimum(state.vmin, d["vmin"]), state.vmin),
                vmax=torch.where(run, torch.maximum(state.vmax, d["vmax"]), state.vmax),
                time=state.time + gate * T,
                integrating=state.integrating,
            )

    def read(self, state: BitMeterState):
        """bim_stats atom contents (bitmeter.c:268-296)."""
        return {
            "hit": state.hit,
            "one": state.one,
            "dset": state.dset,
            "nan": state.nan,
            "inf": state.inf,
            "den": state.den,
            "zero": state.zero,
            "pos": state.pos,
            "min": state.vmin,
            "max": state.vmax,
            "integration_time": state.time,
        }, state

    def clear(self, state: BitMeterState) -> BitMeterState:
        """5 fps window clear in non-averaging mode (bim_clear,
        bitmeter.c:47-55): keeps nan/inf/den."""
        fresh = self.init(state.time.shape, state.time.device)
        return dataclasses.replace(
            fresh, nan=state.nan, inf=state.inf, den=state.den,
            integrating=state.integrating,
        )

    def reset(self, state: BitMeterState) -> BitMeterState:
        return self.init(state.time.shape, state.time.device)
