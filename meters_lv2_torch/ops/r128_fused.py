"""Fused EBU R128 core: K-weighted channel power + 4x true-peak |max|.

Counterpart of ``meters_lv2_tpu/ops/pallas_r128.py::fused_core``.  One call
covers a 128-aligned block of every stream:

  * p[b, t] = sum_c gain_c * y_c[t]^2, the K-weighted combined power that
    the fragment machinery consumes (ebu_r128_proc.cc:302-337);
  * the max |4x-oversampled sample| over all channels
    (TruePeakdsp::process_max, truepeakdsp.cc:109-131, as used by
    src/ebulv2.cc:344-347);
  * the carried per-channel K-weighting state and 47-sample resampler
    history.

``fused_core`` launches the hand-written CUDA kernel (csrc/r128_fused.cu)
for CUDA tensors and uses the plain PyTorch version,
``fused_core_reference``, only for tensors on the CPU.  On a CUDA tensor it
launches the kernel or raises; it never falls back.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from . import lti, resample
from .lti import canonical_device, check_tensor

BLOCK = 128  # kernel block (samples); T must be a multiple
_NH = 47  # true-peak history
_MAX_C = 5  # channels the kernel supports (R128: 1..5)

# Kernel launches since import (or since a caller reset it): a run can
# show that its main path went through the kernel.  Only the CUDA branch
# of fused_core counts.
launch_count = 0

_GAINS_ON: dict[tuple, torch.Tensor] = {}


def _split_layout(x: torch.Tensor, C: int) -> tuple[int, int]:
    """(B, T) of a flat [B, C*T] or a [B, C, T] input."""
    if x.ndim == 2:
        if x.shape[1] % C:
            raise ValueError(f"flat input width {x.shape[1]} not a multiple of C={C}")
        return x.shape[0], x.shape[1] // C
    if x.ndim == 3 and x.shape[1] == C:
        return x.shape[0], x.shape[2]
    raise ValueError(f"x must be [B, C*T] or [B, C={C}, T], got {tuple(x.shape)}")


def fused_core_reference(
    x: torch.Tensor,
    z0: torch.Tensor,
    hist: torch.Tensor,
    gains: tuple[float, ...],
    op: lti.LTIBlockOp,
):
    """Plain PyTorch version: ``lti_scan`` + ``upsample4_absmax`` exactly
    as the JAX meter's unfused path (models/ebur128.py xla_core) runs them.

    Args:
      x:     [B, C*T] channel-major or [B, C, T], T % 128 == 0.
      z0:    [B, C, 4] K-weighting filter state.
      hist:  [B, C, 47] true-peak resampler history.
      gains: per-channel power gains (R128_CHAN_GAIN, or 2.0 for mono).
      op:    ops.lti.LTIBlockOp of the K-weighting system at block 128.

    Returns (p [B, T], z [B, C, 4], hist [B, C, 47], tpmax [B]).
    """
    C = z0.shape[1]
    B, T = _split_layout(x, C)
    x3 = x.reshape(B, C, T)
    y, z = lti.lti_scan(op, x3, z0)
    g = _gains_on(tuple(gains), x.device)
    p = torch.sum(torch.square(y) * g[:, None], dim=-2)
    tpm, hist1 = resample.upsample4_absmax(x3, hist)
    return p, z, hist1, torch.amax(tpm, dim=-1)


def _gains_on(gains: tuple, device) -> torch.Tensor:
    key = (gains, canonical_device(device))
    if key not in _GAINS_ON:
        _GAINS_ON[key] = torch.tensor(gains, dtype=torch.float32, device=key[1])
    return _GAINS_ON[key]


def _fused_core_cuda(x, z0, hist, gains, op):
    global launch_count
    from ..runtime import build

    device = canonical_device(x.device)
    C = len(gains)
    if not 1 <= C <= _MAX_C:
        raise ValueError(f"the kernel supports 1..{_MAX_C} channels, got {C}")
    B, T = _split_layout(x, C)
    if T < BLOCK or T % BLOCK:
        raise ValueError(f"T={T} must be a positive multiple of {BLOCK}")
    if B < 1:
        raise ValueError("empty batch")
    if not (op.block == BLOCK and op.d == 4 and op.m == 1 and op.p == 1):
        raise ValueError("op must be the 4-state K-weighting operator at block 128")
    check_tensor("x", x, x.shape, device)
    check_tensor("z0", z0, (B, C, 4), device)
    check_tensor("hist", hist, (B, C, _NH), device)

    w = op.tensors(device)
    taps = resample.upsample4_taps_on(device)
    p = torch.empty((B, T), dtype=torch.float32, device=device)
    z = torch.empty((B, C, 4), dtype=torch.float32, device=device)
    h = torch.empty((B, C, _NH), dtype=torch.float32, device=device)
    tpm = torch.empty((B,), dtype=torch.float32, device=device)
    g_host = (ctypes.c_float * C)(*gains)

    lib = build.kernels()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = lib.r128_fused_launch(
            x.data_ptr(), z0.data_ptr(), hist.data_ptr(),
            w.kmat.data_ptr(), w.sy.data_ptr(), w.at.data_ptr(),
            w.g.data_ptr(), taps.data_ptr(), g_host,
            B, C, T,
            p.data_ptr(), z.data_ptr(), h.data_ptr(), tpm.data_ptr(),
            stream,
        )
    build.check(lib, rc, "r128_fused_launch")
    launch_count += 1
    return p, z, h, tpm


def fused_core(
    x: torch.Tensor,
    z0: torch.Tensor,
    hist: torch.Tensor,
    gains: tuple[float, ...],
    op: lti.LTIBlockOp,
):
    """Fused K-weighting combined power + true-peak max over one block.

    Arguments and returns as ``fused_core_reference``.  A CUDA tensor goes
    to the CUDA kernel, which also needs contiguous float32 inputs; a CPU
    tensor goes to the plain version.
    """
    if x.device.type == "cuda":
        return _fused_core_cuda(x, z0, hist, tuple(float(g) for g in gains), op)
    if x.device.type == "cpu":
        return fused_core_reference(x, z0, hist, gains, op)
    raise ValueError(f"no fused_core for device {x.device}")


def gains_f32(gains) -> tuple[float, ...]:
    """Gains rounded to float32, as the kernel and the plain version use
    them."""
    return tuple(float(g) for g in np.asarray(gains, np.float32))
