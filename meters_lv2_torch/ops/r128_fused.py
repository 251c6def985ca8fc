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

Seg mode (``off``, ``fragm``, ``n_slots`` given; pallas_r128.py:298-326):
the first output is the per-fragment power sums seg [B, n_slots] of p placed
at the per-stream sample offset ``off`` on a ``fragm`` grid,
``segment.shifted_segments(p, off, fragm, n_slots, "sum")`` up to float32
summation order, and the full-rate p is never written.  z, hist and tpmax
are those of the full-rate mode.  The R128 meter runs seg mode on every
block that is a whole number of 128-sample blocks, and the full-rate mode
with ``shifted_segments`` on a block with a tail (models/ebur128.py).

``fused_core`` launches the hand-written CUDA kernel (csrc/r128_fused.cu)
for CUDA tensors and uses the plain PyTorch version,
``fused_core_reference``, only for tensors on the CPU.  On a CUDA tensor it
launches the kernel or raises; it never falls back.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..utils import profiler
from . import lti, resample, segment
from .lti import canonical_device, check_tensor

BLOCK = 128  # kernel block (samples); T must be a multiple
_NH = 47  # true-peak history
_MAX_C = 5  # channels the kernel supports (R128: 1..5)

# Kernel launches since import (or since a caller reset it): a run can
# show that its main path went through the kernel.  Only the CUDA branch
# of fused_core counts, the full-rate mode's and seg mode's apart.
launch_count = 0
seg_launch_count = 0

_GAINS_ON: dict[tuple, torch.Tensor] = {}
# id(op) -> (op, K's first row as the launcher's host array)
_TOEPLITZ_ROW: dict[int, tuple[object, ctypes.Array]] = {}


def _split_layout(x: torch.Tensor, C: int) -> tuple[int, int]:
    """(B, T) of a flat [B, C*T] or a [B, C, T] input."""
    if x.ndim == 2:
        if x.shape[1] % C:
            raise ValueError(f"flat input width {x.shape[1]} not a multiple of C={C}")
        return x.shape[0], x.shape[1] // C
    if x.ndim == 3 and x.shape[1] == C:
        return x.shape[0], x.shape[2]
    raise ValueError(f"x must be [B, C*T] or [B, C={C}, T], got {tuple(x.shape)}")


def check_seg(x: torch.Tensor, C: int, off, fragm, n_slots) -> bool:
    """Validate the seg-mode arguments against x (flat or 3-D, C channels);
    True in seg mode, False when ``off`` is None (full rate).

    As the JAX kernel's asserts (pallas_r128.py:346): fragm and n_slots
    given, fragm > 128 (a 128-sample block then spans at most two
    fragments); off an int32 [B] tensor on x's device.  Also n_slots >= 2
    and n_slots * fragm >= T + fragm - 1, so every sample of the block lands
    in a slot for any off in [0, fragm)."""
    if off is None:
        if fragm is not None or n_slots is not None:
            raise ValueError("fragm and n_slots are seg-mode arguments: give off too")
        return False
    B, T = _split_layout(x, C)
    if fragm is None or n_slots is None:
        raise ValueError("seg mode needs fragm and n_slots with off")
    fragm, n_slots = int(fragm), int(n_slots)
    if fragm <= BLOCK:
        raise ValueError(f"seg mode needs fragm > {BLOCK}, got {fragm}")
    if n_slots < 2 or n_slots * fragm < T + fragm - 1:
        raise ValueError(
            f"n_slots={n_slots} cannot hold {T} samples at any offset on a {fragm} grid "
            f"(need n_slots >= 2 and n_slots * fragm >= T + fragm - 1)")
    if not isinstance(off, torch.Tensor) or off.dtype != torch.int32 or off.shape != (B,):
        raise ValueError(
            f"off must be an int32 tensor of shape ({B},), got "
            f"{getattr(off, 'dtype', type(off))} {tuple(getattr(off, 'shape', ()))}")
    if canonical_device(off.device) != canonical_device(x.device):
        raise ValueError(f"off is on {off.device}, x on {x.device}")
    return True


def fused_core_reference(
    x: torch.Tensor,
    z0: torch.Tensor,
    hist: torch.Tensor,
    gains: tuple[float, ...],
    op: lti.LTIBlockOp,
    *,
    off: torch.Tensor | None = None,
    fragm: int | None = None,
    n_slots: int | None = None,
):
    """Plain PyTorch version: ``lti_scan`` + ``upsample4_absmax`` exactly
    as the JAX meter's unfused path (models/ebur128.py xla_core) runs them,
    then in seg mode ``segment.shifted_segments`` of the power.

    Args:
      x:     [B, C*T] channel-major or [B, C, T], T % 128 == 0.
      z0:    [B, C, 4] K-weighting filter state.
      hist:  [B, C, 47] true-peak resampler history.
      gains: per-channel power gains (R128_CHAN_GAIN, or 2.0 for mono).
      op:    ops.lti.LTIBlockOp of the K-weighting system at block 128.
      off, fragm, n_slots: seg mode (see ``check_seg``): off [B] int32, the
             samples already in each stream's open fragment.

    Returns (p [B, T] or seg [B, n_slots], z [B, C, 4], hist [B, C, 47],
    tpmax [B]).
    """
    C = z0.shape[1]
    seg_mode = check_seg(x, C, off, fragm, n_slots)
    B, T = _split_layout(x, C)
    x3 = x.reshape(B, C, T)
    y, z = lti.lti_scan(op, x3, z0)
    g = _gains_on(tuple(gains), x.device)
    p = torch.sum(torch.square(y) * g[:, None], dim=-2)
    tpm, hist1 = resample.upsample4_absmax(x3, hist)
    if seg_mode:
        p = segment.shifted_segments(p, off, int(fragm), int(n_slots), "sum")
    return p, z, hist1, torch.amax(tpm, dim=-1)


def _gains_on(gains: tuple, device) -> torch.Tensor:
    key = (gains, canonical_device(device))
    if key not in _GAINS_ON:
        with profiler.counted("cache.fill"):
            _GAINS_ON[key] = torch.tensor(gains, dtype=torch.float32, device=key[1])
    return _GAINS_ON[key]


def toeplitz_row(op) -> np.ndarray:
    """K's first row h, float32 [128], where the operator's kmat (stored
    as y = u @ kmat) is the lower-triangular Toeplitz matrix kmat[j, i] =
    h[i - j] for i >= j and 0 above, as ``lti.build_lti_block_op`` builds
    it; raises ValueError otherwise.  The kernel takes the taps h, not the
    matrix."""
    kmat = op.kmat
    if isinstance(kmat, torch.Tensor):
        kmat = kmat.detach().cpu().numpy()
    kmat = np.asarray(kmat, np.float32)
    h = kmat[0]
    lag = np.arange(BLOCK)[None, :] - np.arange(BLOCK)[:, None]  # i - j
    if kmat.shape != (BLOCK, BLOCK) or not np.array_equal(
            kmat, np.where(lag >= 0, h[np.clip(lag, 0, None)], np.float32(0))):
        raise ValueError("op.kmat must be the lower-triangular Toeplitz matrix of the "
                         "block's impulse response")
    return h


def _toeplitz_row_host(op) -> ctypes.Array:
    hit = _TOEPLITZ_ROW.get(id(op))
    if hit is None or hit[0] is not op:
        with profiler.counted("cache.fill"):
            hit = (op, (ctypes.c_float * BLOCK)(*toeplitz_row(op).tolist()))
            _TOEPLITZ_ROW[id(op)] = hit
    return hit[1]


def _fused_core_cuda(x, z0, hist, gains, op, off=None, fragm=None, n_slots=None):
    global launch_count, seg_launch_count
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
    seg_mode = check_seg(x, C, off, fragm, n_slots)
    if seg_mode and not off.is_contiguous():
        raise ValueError("off must be contiguous")

    h_row = _toeplitz_row_host(op)
    w = op.tensors(device)
    p = torch.empty((B, int(n_slots)) if seg_mode else (B, T), dtype=torch.float32,
                    device=device)
    z = torch.empty((B, C, 4), dtype=torch.float32, device=device)
    h = torch.empty((B, C, _NH), dtype=torch.float32, device=device)
    tpm = torch.empty((B,), dtype=torch.float32, device=device)
    g_host = (ctypes.c_float * C)(*gains)

    lib = build.kernels()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = lib.r128_fused_launch(
            x.data_ptr(), z0.data_ptr(), hist.data_ptr(),
            w.sy.data_ptr(), w.at.data_ptr(), w.g.data_ptr(),
            h_row, resample.upsample4_taps_host(), g_host,
            B, C, T,
            off.data_ptr() if seg_mode else None,
            int(fragm) if seg_mode else 0, int(n_slots) if seg_mode else 0,
            p.data_ptr(), z.data_ptr(), h.data_ptr(), tpm.data_ptr(),
            stream,
        )
    build.check(lib, rc, "r128_fused_launch")
    if seg_mode:
        seg_launch_count += 1
    else:
        launch_count += 1
    return p, z, h, tpm


def fused_core(
    x: torch.Tensor,
    z0: torch.Tensor,
    hist: torch.Tensor,
    gains: tuple[float, ...],
    op: lti.LTIBlockOp,
    *,
    off: torch.Tensor | None = None,
    fragm: int | None = None,
    n_slots: int | None = None,
):
    """Fused K-weighting combined power + true-peak max over one block;
    with ``off``, ``fragm`` and ``n_slots`` the per-fragment power sums
    instead of the power (seg mode).

    Arguments and returns as ``fused_core_reference``; the seg-mode
    arguments are checked before anything is built.  A CUDA tensor goes to
    the CUDA kernel, which also needs contiguous float32 inputs; a CPU
    tensor goes to the plain version.
    """
    if x.device.type == "cuda":
        return _fused_core_cuda(x, z0, hist, tuple(float(g) for g in gains), op,
                                off, fragm, n_slots)
    if x.device.type == "cpu":
        return fused_core_reference(x, z0, hist, gains, op, off=off, fragm=fragm,
                                    n_slots=n_slots)
    raise ValueError(f"no fused_core for device {x.device}")


def gains_f32(gains) -> tuple[float, ...]:
    """Gains rounded to float32, as the kernel and the plain version use
    them."""
    return tuple(float(g) for g in np.asarray(gains, np.float32))
