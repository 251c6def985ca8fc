"""Nonlinear peak-meter ballistics (PPM attack/release recurrences).

Counterpart of ``meters_lv2_tpu/ops/ballistics.py``.  The PPM family
(iec1ppmdsp.cc:47-80, iec2ppmdsp.cc:47-80, msppmdsp.cc:45-121,
truepeakdsp.cc:58-107) shares one recurrence per state variable z::

    z *= w3                      # release, once per 4-sample group
    for each of 4 samples:
        if t > z: z += w * (t - z)   # conditional attack

Both z1 (fast) and z2 (slow) evolve independently; the meter reads
max(z1 + z2) over the block.  The recurrence itself is
ops/ballistics_core.ballistics (the CUDA kernel on a card); the true-peak
variant fuses the 4x oversampling into it (ops/truepeak_fused).  The
per-``process()``-call rules live here: entry clamps, the ``m``/``p``
restart after a read, the ``g`` scale and the denormal offsets.
"""

from __future__ import annotations

import dataclasses

import torch

from ..utils import profiler
from . import ballistics_core, resample, truepeak_fused
from .ballistics_core import f32
from .design import BallisticsCoeffs

_NH = 47  # resampler history
_CLAMP = (0.0, 20.0)  # entry clamp of z1, z2 (iec2ppmdsp.cc:49-50)
_DENORMAL = 1e-10  # PPM exit offset (iec2ppmdsp.cc:76-77)
# The meters run the envelope body on batches of up to this many rows, one
# wave of its 16-row CTAs on an H100 (132 SMs x 4 CTAs x 16 rows), and the
# serial body on larger ones.  chip_smoke.py's row sweep at T=48000 on an
# H100 80GB HBM3 at 700 W, envelope against serial: 0.458 / 0.829 ms at
# 4,224 rows, 0.828 / 0.903 at 8,448, 1.071 / 0.912 at 12,672, 2.654 /
# 2.423 at 33,792 (PERF.md).
ENVELOPE_MAX_ROWS = 8448


@dataclasses.dataclass(frozen=True)
class PPMState:
    """Carried per-stream ballistics state (tensors of shape [...])."""

    z1: torch.Tensor
    z2: torch.Tensor
    m: torch.Tensor  # max(z1+z2) since last read
    res: torch.Tensor  # bool: max was read, restart accumulation


def ppm_init(batch_shape=(), device="cuda") -> PPMState:
    z = torch.zeros(tuple(batch_shape), dtype=torch.float32, device=device)
    return PPMState(
        z1=z, z2=z.clone(), m=z.clone(),
        res=torch.ones(tuple(batch_shape), dtype=torch.bool, device=device),
    )


def _run_ballistics(coeffs: BallisticsCoeffs, t, z1, z2, m, p):
    """The core recurrence over t [..., T] with states [...]; p (raw peak
    tracking) may be None.  The batch is flattened to rows for
    ballistics_core.ballistics.

    The group-envelope body runs wherever it holds
    (``ballistics_core.envelope_ok``: DIN, NOR, BBC, EBU, M-6 at every
    rate, the unfused true-peak update from fs = 4,300 Hz on) on up to
    ``ENVELOPE_MAX_ROWS`` rows; the serial body elsewhere.  The choice is
    the same on the CPU as on the card."""
    *batch, T = t.shape
    track_peak = p is not None
    rows = t.reshape(-1, T).contiguous()
    envelope = (rows.shape[0] <= ENVELOPE_MAX_ROWS
                and ballistics_core.envelope_ok(coeffs.w1, coeffs.w2))

    def flat(v):
        return v.reshape(-1).contiguous()

    z1, z2, m, p = ballistics_core.ballistics(
        rows, flat(z1), flat(z2), flat(m),
        flat(p if track_peak else torch.zeros_like(m)),
        w1=coeffs.w1, w2=coeffs.w2, w3=coeffs.w3, track_peak=track_peak,
        envelope=envelope,
    )
    z1, z2, m, p = (v.reshape(batch) for v in (z1, z2, m, p))
    return z1, z2, m, (p if track_peak else None)


def ppm_update(coeffs: BallisticsCoeffs, state: PPMState, t: torch.Tensor) -> PPMState:
    """Process one block of rectified samples t, shape [..., T] (T % 4 == 0).

    Mirrors one process() call: state clamped on entry
    (iec2ppmdsp.cc:49-50), denormal offset added on exit (:76-77).
    """
    if t.shape[-1] % 4:
        raise ValueError(f"block length {t.shape[-1]} is not a multiple of 4")
    z1 = torch.clamp(state.z1, *_CLAMP)
    z2 = torch.clamp(state.z2, *_CLAMP)
    m0 = torch.where(state.res, 0.0, state.m)
    z1, z2, m, _ = _run_ballistics(coeffs, t, z1, z2, m0, None)
    return PPMState(
        z1=z1 + _DENORMAL, z2=z2 + _DENORMAL, m=m, res=torch.zeros_like(state.res)
    )


def ppm_read(coeffs: BallisticsCoeffs, state: PPMState) -> tuple[torch.Tensor, PPMState]:
    """read(): returns g * max and arms the reset flag (iec2ppmdsp.cc:83-87)."""
    return f32(coeffs.g) * state.m, dataclasses.replace(
        state, res=torch.ones_like(state.res)
    )


# ---------------------------------------------------------------------------
# True peak: the same ballistics on the 4x oversampled stream, plus the raw
# peak, with different max bookkeeping (truepeakdsp.cc:58-107: m is scaled
# by g inside process and maxed across calls; p is the raw oversampled peak).
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class TruePeakState:
    z1: torch.Tensor
    z2: torch.Tensor
    m: torch.Tensor  # g-scaled ballistic max since last read
    p: torch.Tensor  # raw oversampled |peak| since last read
    res: torch.Tensor


def true_peak_init(batch_shape=(), device="cuda") -> TruePeakState:
    z = torch.zeros(tuple(batch_shape), dtype=torch.float32, device=device)
    return TruePeakState(
        z1=z, z2=z.clone(), m=z.clone(), p=z.clone(),
        res=torch.ones(tuple(batch_shape), dtype=torch.bool, device=device),
    )


def _true_peak_epilogue(coeffs, state: TruePeakState, z1, z2, m, p) -> TruePeakState:
    """The per-process() tail: g scale, read-reset merge, denormal offsets."""
    m = m * f32(coeffs.g)
    m = torch.where(state.res, m, torch.maximum(m, state.m))
    p = torch.where(state.res, p, torch.maximum(p, state.p))
    return TruePeakState(
        z1=z1 + 1e-20, z2=z2 + 1e-20, m=m, p=p, res=torch.zeros_like(state.res)
    )


def true_peak_update(
    coeffs: BallisticsCoeffs, state: TruePeakState, up_abs: torch.Tensor
) -> TruePeakState:
    """Process a block of the rectified 4x-oversampled stream [..., 4*n]."""
    if up_abs.shape[-1] % 4:
        raise ValueError(f"block length {up_abs.shape[-1]} is not a multiple of 4")
    z1 = torch.clamp(state.z1, *_CLAMP)
    z2 = torch.clamp(state.z2, *_CLAMP)
    m0 = torch.zeros_like(state.m)
    p0 = torch.zeros_like(state.p)
    z1, z2, m, p = _run_ballistics(coeffs, up_abs, z1, z2, m0, p0)
    return _true_peak_epilogue(coeffs, state, z1, z2, m, p)


def true_peak_read(state: TruePeakState) -> tuple[torch.Tensor, torch.Tensor, TruePeakState]:
    """read(m, p): returns (ballistic max, raw peak), arms reset."""
    return state.m, state.p, dataclasses.replace(
        state, res=torch.ones_like(state.res)
    )


def true_peak_update_fused(
    coeffs: BallisticsCoeffs,
    state: TruePeakState,
    x: torch.Tensor,
    hist: torch.Tensor,
) -> tuple[TruePeakState, torch.Tensor]:
    """true_peak_update with the 4x oversampling fused into the ballistics
    (ops/truepeak_fused).  x is the raw block [..., T] (T % 4 == 0), hist
    the [..., 47] resampler history; returns (state', hist').

    One process() call (truepeakdsp.cc:58-107): the entry clamps apply
    once, the 128-aligned bulk runs in truepeak_fused, a remainder of
    T % 128 samples (or a whole block shorter than 128) is oversampled by
    resample.upsample4 and chained through ballistics_core.ballistics on
    the carried states, and the g-scale / res-merge / denormal epilogue
    applies once at the end.  The bulk runs truepeak_fused's envelope body
    at every row count (it beat the serial body at N=512 and N=8,192,
    PERF.md), and the serial body where the envelope does not hold (w2 > 1:
    fs below 4,300 Hz, ``ballistics_core.envelope_ok``)."""
    *batch, T = x.shape
    if T % 4:
        raise ValueError(f"block length {T} is not a multiple of 4")
    z1 = torch.clamp(state.z1, *_CLAMP).reshape(-1).contiguous()
    z2 = torch.clamp(state.z2, *_CLAMP).reshape(-1).contiguous()
    m = torch.zeros_like(z1)
    p = torch.zeros_like(z1)
    xf = x.reshape(-1, T)
    hf = hist.reshape(-1, _NH).contiguous()
    w = dict(w1=coeffs.w1, w2=coeffs.w2, w3=coeffs.w3)

    Tm = (T // truepeak_fused.BLOCK) * truepeak_fused.BLOCK
    if Tm:
        body = "envelope" if ballistics_core.envelope_ok(coeffs.w1, coeffs.w2) else "serial"
        if body == "serial":
            profiler.count("truepeak.serial")
        z1, z2, m, p, hf = truepeak_fused.truepeak_fused(xf[:, :Tm], hf, z1, z2, m, p, **w,
                                                         body=body)
    if Tm < T:  # the tail: plain oversampling, chained states, the serial
        # body (the JAX package's tail is its serial _scan_ballistics)
        up, hf = resample.upsample4(xf[:, Tm:], hf)
        z1, z2, m, p = ballistics_core.ballistics(
            up.abs(), z1, z2, m, p, **w, track_peak=True
        )
    z1, z2, m, p = (v.reshape(batch) for v in (z1, z2, m, p))
    return _true_peak_epilogue(coeffs, state, z1, z2, m, p), hf.reshape(hist.shape)
