"""Fused true peak: 4x oversampling + ballistics + raw peak in one pass.

Counterpart of ``meters_lv2_tpu/ops/pallas_truepeak.py::truepeak_pallas``.
One call covers a 128-aligned block x [N, T] of every row: the 4x
oversampled stream of [hist ++ x] (ops/resample.upsample4), rectified, runs
through the PPM-style recurrence of ops/ballistics_core with the raw peak
``p`` tracked (truepeakdsp.cc:58-107).  Entry clamps, the ``g`` scale and
the read-reset merge stay with the caller (ops/ballistics.py).

Two bodies compute the recurrence, as in ``ballistics_core.ballistics``:
``body="envelope"`` (the default) evaluates each group of four oversamples
as the group envelope (``ballistics_envelope_reference``), whose max-plus
DP never reads the carried state; ``body="serial"`` runs the serial step
(``ballistics_reference``).  The two agree within 2e-6 relative (the
envelope's bar, tests/test_torch_variants.py), with the same non-finite
values, where the envelope holds: its max-of-affine form needs every
attack step z' = max(z, (1 - w) z + w t) monotone in z, 0 <= w <= 1 for
w1 and w2 (``ballistics_core.envelope_ok``).  True peak's w2 = 4300 / fs
passes 1 below fs = 4,300 Hz; there the envelope body refuses and the
meter runs the serial one (ops/ballistics.py).

``truepeak_fused`` launches the hand-written CUDA kernel
(csrc/truepeak_fused.cu) for CUDA tensors, in which the oversampled stream
never leaves on-chip memory: the envelope body overlaps the FIR and the DP
of one block, on four producer warps, with the chains of the block before,
on a consumer warp.  It runs the plain PyTorch version,
``truepeak_fused_reference``, of the same body only for tensors on the
CPU.
"""

from __future__ import annotations

import ctypes

import torch

from . import ballistics_core, resample
from .ballistics_core import coeffs_f32, envelope_decrements, envelope_ok
from .lti import check_tensor

BLOCK = 128  # kernel block (samples); T must be a multiple
BODIES = ("envelope", "serial")
_NH = 47  # resampler history

# Kernel launches since import (or since a caller reset it), the envelope
# body's and the serial body's apart.  Only the CUDA branch of
# truepeak_fused() counts.
launch_count = 0
serial_launch_count = 0


def _check_body(body: str, w1: float, w2: float) -> None:
    if body not in BODIES:
        raise ValueError(f"body must be one of {BODIES}, got {body!r}")
    if body == "envelope" and not envelope_ok(w1, w2):
        raise ValueError(f"the envelope body needs 0 <= w1, w2 <= 1, got w1={w1} w2={w2}: "
                         "use body='serial'")


def truepeak_fused_reference(
    x: torch.Tensor,
    hist: torch.Tensor,
    z1: torch.Tensor,
    z2: torch.Tensor,
    m: torch.Tensor,
    p: torch.Tensor,
    *,
    w1: float,
    w2: float,
    w3: float,
    body: str = "envelope",
):
    """Plain PyTorch version: ``resample.upsample4``, ``abs``, then
    ``ballistics_envelope_reference`` (``body="envelope"``) or
    ``ballistics_reference`` (``body="serial"``), with ``track_peak``.

    Args:
      x:    [N, T] raw samples, T % 128 == 0.
      hist: [N, 47] resampler history.
      z1, z2, m, p: [N] states (entry clamps and m/p zeroing applied).

    Returns (z1, z2, m, p, hist'), hist' the last 47 samples of
    [hist ++ x].
    """
    _check_body(body, w1, w2)
    ref = (ballistics_core.ballistics_envelope_reference if body == "envelope"
           else ballistics_core.ballistics_reference)
    up, hist1 = resample.upsample4(x, hist)
    z1, z2, m, p = ref(up.abs(), z1, z2, m, p, w1=w1, w2=w2, w3=w3, track_peak=True)
    return z1, z2, m, p, hist1


def _truepeak_fused_cuda(x, hist, z1, z2, m, p, w1, w2, w3, body="envelope"):
    global launch_count, serial_launch_count
    from ..runtime import build

    _check_body(body, w1, w2)
    device = x.device
    if x.ndim != 2:
        raise ValueError(f"x must be [N, T], got {tuple(x.shape)}")
    N, T = x.shape
    if N < 1 or T < BLOCK or T % BLOCK:
        raise ValueError(f"need N >= 1 and T a positive multiple of {BLOCK}, got N={N} T={T}")
    if x.dtype != torch.float32:
        raise TypeError(f"x must be float32, got {x.dtype}")
    if x.stride(1) != 1 or x.stride(0) < T:
        raise ValueError("x must have unit stride along time (rows may be strided)")
    check_tensor("hist", hist, (N, _NH), device)
    for name, v in (("z1", z1), ("z2", z2), ("m", m), ("p", p)):
        check_tensor(name, v, (N,), device)
    w1, w2, w3 = coeffs_f32(w1, w2, w3)
    env_dec = (ctypes.c_float * 8)(*envelope_decrements(w1), *envelope_decrements(w2))
    envelope = body == "envelope"
    out = torch.empty((4, N), dtype=torch.float32, device=device)
    h = torch.empty((N, _NH), dtype=torch.float32, device=device)
    lib = build.kernels()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = lib.truepeak_fused_launch(
            x.data_ptr(), x.stride(0), hist.data_ptr(), z1.data_ptr(),
            z2.data_ptr(), m.data_ptr(), p.data_ptr(), resample.upsample4_taps_host(),
            N, T, w1, w2, w3, int(envelope), env_dec,
            out[0].data_ptr(), out[1].data_ptr(), out[2].data_ptr(),
            out[3].data_ptr(), h.data_ptr(), stream,
        )
    build.check(lib, rc, "truepeak_fused_launch")
    if envelope:
        launch_count += 1
    else:
        serial_launch_count += 1
    return out[0], out[1], out[2], out[3], h


def truepeak_fused(
    x: torch.Tensor,
    hist: torch.Tensor,
    z1: torch.Tensor,
    z2: torch.Tensor,
    m: torch.Tensor,
    p: torch.Tensor,
    *,
    w1: float,
    w2: float,
    w3: float,
    body: str = "envelope",
):
    """Fused oversample + ballistics over x [N, T] (T % 128 == 0);
    arguments and returns as ``truepeak_fused_reference``.  A CUDA tensor
    goes to the CUDA kernel of ``body`` (float32; x may have strided rows,
    the rest contiguous); a CPU tensor to the plain version of ``body``."""
    _check_body(body, w1, w2)
    if x.device.type == "cuda":
        return _truepeak_fused_cuda(x, hist, z1, z2, m, p, w1, w2, w3, body)
    if x.device.type == "cpu":
        if x.shape[-1] % BLOCK:
            raise ValueError(f"T={x.shape[-1]} must be a multiple of {BLOCK}")
        return truepeak_fused_reference(x, hist, z1, z2, m, p, w1=w1, w2=w2, w3=w3,
                                        body=body)
    raise ValueError(f"no truepeak_fused for device {x.device}")
