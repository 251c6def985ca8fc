"""4x polyphase oversampling for true-peak detection, as batched block
matmuls.  Counterpart of the ``upsample4`` / ``upsample4_absmax`` part of
``meters_lv2_tpu/ops/resample.py``.

The oversampled stream is

    up[4*t + ph] = sum_{i=0}^{47} taps[ph, i] * x[t - 47 + i]

(see ops/design.upsample4_kernel).  Phase 0 is a pure hl-sample delay, so
the reference's alignment, including its zero prefeed at init
(truepeakdsp.cc:159-168), is reproduced by zero history at stream start.
The 47-sample input history is carried across blocks for streaming use.

Each 128-sample block is one overlapping frame of 47 + 128 inputs times a
dense [175, 512] block matrix, exactly as the JAX package evaluates it.
One consequence is kept on purpose: a non-finite input sample meets the
matrix's zeros (x * 0 = NaN), so it turns every oversample of its frame
that it does not feed into NaN, and NaN oversamples are skipped.  The CUDA
kernel (csrc/r128_fused.cu) reproduces that rule.
"""

from __future__ import annotations

import numpy as np
import torch

from .design import upsample4_kernel
from .lti import canonical_device

_HL = 24  # zita half-length: 48 taps, 47 samples of history

_BLOCK_MATS: dict[tuple, np.ndarray] = {}
_BLOCK_MATS_ON: dict[tuple, torch.Tensor] = {}


def upsample4_taps() -> np.ndarray:
    """[4, 48] float32 phase filters (float64 design)."""
    return upsample4_kernel(_HL).astype(np.float32)


def _block_matrix(taps: np.ndarray, tb: int) -> np.ndarray:
    """Dense block operator M [tb + K - 1, factor*tb] with
    M[j+i, factor*j + ph] = taps[ph, i]: one matmul produces factor*tb
    outputs from tb inputs + (K-1)-sample halo."""
    factor, K = taps.shape
    key = (taps.tobytes(), tb)
    if key not in _BLOCK_MATS:
        M = np.zeros((tb + K - 1, factor * tb), np.float32)
        for j in range(tb):
            for ph in range(factor):
                M[j : j + K, factor * j + ph] = taps[ph]
        _BLOCK_MATS[key] = M
    return _BLOCK_MATS[key]


def _block_matrix_on(taps: np.ndarray, tb: int, device) -> torch.Tensor:
    device = canonical_device(device)
    key = (taps.tobytes(), tb, device)
    if key not in _BLOCK_MATS_ON:
        _BLOCK_MATS_ON[key] = torch.as_tensor(
            _block_matrix(taps, tb), device=device
        )
    return _BLOCK_MATS_ON[key]


def _frames(xp: torch.Tensor, T: int, nh: int, tb: int = 128):
    """Yield (frames [..., nblk, step + nh], step) for the main run of
    tb-sample blocks and one remainder block over xp = [hist ++ x]."""
    *batch, _ = xp.shape
    main = (T // tb) * tb
    segments = []
    if main:
        segments.append((0, main, tb))
    if T - main:
        segments.append((main, T, T - main))
    for start, end, step in segments:
        seg = xp[..., start : end + nh]  # [..., L + nh]
        L = end - start
        nblk = L // step
        blocks = seg[..., :L].reshape(*batch, nblk, step)
        tail = seg[..., L:][..., None, :]  # [..., 1, nh]
        if step >= nh:
            heads = torch.cat([blocks[..., 1:, :nh], tail], dim=-2)
        else:
            # step < nh: heads overlap several blocks
            heads = torch.stack(
                [seg[..., (n + 1) * step : (n + 1) * step + nh]
                 for n in range(nblk)],
                dim=-2,
            )
        yield torch.cat([blocks, heads], dim=-1), step


def _upsample_blocked(
    x: torch.Tensor, hist: torch.Tensor, taps_np: np.ndarray, tb: int = 128
) -> tuple[torch.Tensor, torch.Tensor]:
    """x [..., T], hist [..., K-1] -> (up [..., factor*T], new_hist)."""
    factor, K = taps_np.shape
    nh = K - 1
    *batch, T = x.shape
    xp = torch.cat([hist, x], dim=-1)  # [..., nh + T]
    outs = []
    for frames, step in _frames(xp, T, nh, tb):
        M = _block_matrix_on(taps_np, step, x.device)
        y = torch.matmul(frames, M)
        outs.append(y.reshape(*batch, -1))
    up = outs[0] if len(outs) == 1 else torch.cat(outs, dim=-1)
    return up, xp[..., -nh:]


def upsample4_absmax(
    x: torch.Tensor, hist: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """max |4x-oversampled stream| over the block, reduced per frame matmul
    (the full 4T stream is never assembled).  TruePeakdsp::process_max
    (truepeakdsp.cc:109-131) over one block.  Returns (absmax [...],
    new_hist)."""
    taps_np = upsample4_taps()
    nh = taps_np.shape[1] - 1
    *batch, T = x.shape
    xp = torch.cat([hist, x], dim=-1)
    best = torch.zeros(batch, dtype=x.dtype, device=x.device)
    for frames, step in _frames(xp, T, nh):
        M = _block_matrix_on(taps_np, step, x.device)
        av = torch.matmul(frames, M).abs()
        # reference `if (v > m) m = v` (truepeakdsp.cc:111-122): NaN
        # comparisons are false, so NaN oversamples are skipped, not
        # propagated (0 is the max identity here; +/-Inf still registers)
        av = torch.where(torch.isnan(av), 0.0, av)
        best = torch.maximum(best, av.amax(dim=(-2, -1)))
    return best, xp[..., -nh:]


def upsample4(
    x: torch.Tensor, hist: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """Upsample a block 4x.

    Args:
      x: [..., T] input block.
      hist: [..., 47] carried history (zeros at stream start).

    Returns:
      (up, new_hist): up [..., 4*T] oversampled stream aligned like the
      reference (up[4t+ph] uses inputs ... x[t]); new_hist [..., 47].
    """
    return _upsample_blocked(x, hist, upsample4_taps())
