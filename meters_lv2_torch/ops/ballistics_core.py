"""PPM / true-peak attack-release recurrence over a [N, T] batch of rows.

Counterpart of ``meters_lv2_tpu/ops/pallas_ballistics.py``
(``ballistics_pallas``, ``envelope=False``).  Per row, per 4-sample group
(iec2ppmdsp.cc:47-80, truepeakdsp.cc:58-107)::

    z1 *= w3; z2 *= w3                    # release, once per group
    for each of the 4 samples t:
        if t > z1: z1 += w1 * (t - z1)    # conditional attack
        if t > z2: z2 += w2 * (t - z2)
        if t > p:  p = t                  # raw peak (track_peak only)
    m = max(m, z1 + z2)

A NaN sample compares false and is skipped; ``max`` propagates a NaN as
``torch.maximum`` does.  Entry clamps, ``m``/``p`` zeroing and the read
reset stay with the caller (ops/ballistics.py): they happen once per
``update()``, not per sample.

``ballistics`` launches the hand-written CUDA kernel (csrc/ballistics.cu)
for CUDA tensors and runs the plain PyTorch version,
``ballistics_reference``, only for tensors on the CPU.  The kernel does the
same float32 operations in the same order, so on the card it is bit-exact
to the plain version.
"""

from __future__ import annotations

import numpy as np
import torch

from .lti import check_tensor

# Kernel launches since import (or since a caller reset it).  Only the CUDA
# branch of ballistics() counts.
launch_count = 0


def f32(v: float) -> float:
    """v rounded to float32 (the JAX package's jnp.float32(v))."""
    return float(np.float32(v))


def coeffs_f32(w1: float, w2: float, w3: float) -> tuple[float, float, float]:
    """The coefficients rounded to float32 once, as the kernel and the plain
    version both use them."""
    return f32(w1), f32(w2), f32(w3)


def ballistics_reference(
    t_abs: torch.Tensor,
    z1: torch.Tensor,
    z2: torch.Tensor,
    m: torch.Tensor,
    p: torch.Tensor,
    *,
    w1: float,
    w2: float,
    w3: float,
    track_peak: bool,
):
    """Plain PyTorch version: the grouped loop of the JAX package's
    ``ops/ballistics._scan_ballistics``, one torch op per float32 step.

    Args:
      t_abs: [N, T] rectified samples, T % 4 == 0.
      z1, z2, m, p: [N] carried states (p is returned unchanged unless
        ``track_peak``).

    Returns (z1, z2, m, p), each [N].
    """
    N, T = t_abs.shape
    if T % 4:
        raise ValueError(f"T={T} must be a multiple of 4")
    w1, w2, w3 = coeffs_f32(w1, w2, w3)
    # [G, 4, N]: each step reads one contiguous row of samples
    tg = t_abs.reshape(N, T // 4, 4).permute(1, 2, 0).contiguous()
    for tb in tg:
        z1 = z1 * w3
        z2 = z2 * w3
        for ti in tb:
            z1 = torch.where(ti > z1, z1 + w1 * (ti - z1), z1)
            z2 = torch.where(ti > z2, z2 + w2 * (ti - z2), z2)
            if track_peak:
                p = torch.where(ti > p, ti, p)
        m = torch.maximum(m, z1 + z2)
    return z1, z2, m, p


def _ballistics_cuda(t_abs, z1, z2, m, p, w1, w2, w3, track_peak):
    global launch_count
    from ..runtime import build

    device = t_abs.device
    if t_abs.ndim != 2:
        raise ValueError(f"t_abs must be [N, T], got {tuple(t_abs.shape)}")
    N, T = t_abs.shape
    if N < 1 or T < 4 or T % 4:
        raise ValueError(f"need N >= 1 and T a positive multiple of 4, got N={N} T={T}")
    check_tensor("t_abs", t_abs, (N, T), device)
    if t_abs.data_ptr() % 16:
        raise ValueError("t_abs must be 16-byte aligned (the kernel stages it with bulk copies)")
    for name, v in (("z1", z1), ("z2", z2), ("m", m), ("p", p)):
        check_tensor(name, v, (N,), device)
    w1, w2, w3 = coeffs_f32(w1, w2, w3)
    out = torch.empty((4, N), dtype=torch.float32, device=device)
    lib = build.kernels()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = lib.ballistics_launch(
            t_abs.data_ptr(), z1.data_ptr(), z2.data_ptr(), m.data_ptr(),
            p.data_ptr(), N, T, w1, w2, w3, int(bool(track_peak)),
            out[0].data_ptr(), out[1].data_ptr(), out[2].data_ptr(),
            out[3].data_ptr(), stream,
        )
    build.check(lib, rc, "ballistics_launch")
    launch_count += 1
    return out[0], out[1], out[2], out[3]


def ballistics(
    t_abs: torch.Tensor,
    z1: torch.Tensor,
    z2: torch.Tensor,
    m: torch.Tensor,
    p: torch.Tensor,
    *,
    w1: float,
    w2: float,
    w3: float,
    track_peak: bool,
):
    """The recurrence over t_abs [N, T]; arguments and returns as
    ``ballistics_reference``.  A CUDA tensor goes to the CUDA kernel
    (contiguous float32 inputs); a CPU tensor to the plain version."""
    if t_abs.device.type == "cuda":
        return _ballistics_cuda(t_abs, z1, z2, m, p, w1, w2, w3, track_peak)
    if t_abs.device.type == "cpu":
        return ballistics_reference(
            t_abs, z1, z2, m, p, w1=w1, w2=w2, w3=w3, track_peak=track_peak
        )
    raise ValueError(f"no ballistics for device {t_abs.device}")
