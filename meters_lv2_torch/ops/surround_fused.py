"""Fused surround core: K-meter smoothers, block peaks, the correlator
lowpass and the routed pair sums in one pass over the input.

Counterpart of ``meters_lv2_tpu/ops/pallas_surround.py::fused_core``.  One
call covers a 128-aligned block x [B, C, T] of every stream and returns, per
stream:

  * km_z' [B, C, 2]: the K-meter's grouped-4 two-stage smoother state on x^2
    after the block (kmeterdsp.cc:77-107), advanced in blocks of 128 samples
    (s' = s @ At + x^2 @ G) as the Pallas kernel does;
  * zl' [B, C, 1]: the correlator one-pole lowpass state after the block, run
    on x + eps (stcorrdsp.cc:56-60), eps = float32(1e-20 / w1);
  * pk [B, C]: the block max of x^2, NaN samples skipped (kmeterdsp.cc:124);
  * pacc [B, P, 3]: for each routed pair p the weighted sums
    sum_t wv_t (ya yb, ya ya, yb yb)(t) of the filtered channels the pair
    selects, ya = sel_a[p] . y, yb = sel_b[p] . y; the caller composes the
    pair integrators as zp * (1 - w2)^T + pacc (models/cor.ema_final).

``wv`` holds the closed-form weights w2 (1 - w2)^(T-1-t) of the w2 averages
(``CorrelationMeter._ema_weights``, built in float64 on the host and cached
per length and device).  Routing is a runtime input: sel_a / sel_b are
float32 [P, C] one-hot tensors on the input's device.

``fused_core`` launches the hand-written CUDA kernel (csrc/surround_fused.cu)
for CUDA tensors and uses the plain PyTorch version, ``fused_core_reference``,
only for tensors on the CPU.  On a CUDA tensor it launches the kernel or
raises; it never falls back.  The two agree to a stated tolerance (float32
sums in other orders); the block peak agrees bit for bit.

``fused_core_wide`` computes the same function with the wide layout of the
JAX package's ``_fused_core_wide`` (pallas_surround.py:252), one unit of
parallel work per (stream, channel) row (csrc/surround_wide.cu), and the
same plain version.  ``fused_core`` goes to it when the environment variable
``METERS_TORCH_SURROUND_WIDE`` is ``1``, read on each call (the JAX
package's METERS_TPU_SURROUND_WIDE); the default ``0`` keeps the narrow
layout.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from .lti import canonical_device, check_tensor, matmul

BLOCK = 128  # kernel block (samples); T must be a multiple
# channel counts the kernel is built for, each with its pair count
# (surmeter.c: 4 correlators, 3 when nchan <= 3)
PAIRS_OF = {c: (4 if c > 3 else 3) for c in range(3, 9)}

# Kernel launches since import (or since a caller reset it): a run can
# show that its main path went through the kernel.  Only the CUDA branches
# count, the narrow layout's and the wide layout's apart.
launch_count = 0
wide_launch_count = 0


def lowpass_eps(w1: float) -> float:
    """The correlator's denormal offset folded into its input,
    float32(1e-20 / w1) (stcorrdsp.cc:56-60)."""
    return float(np.float32(1e-20 / w1))


def select_channels(sel: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """sel [P, C] applied to y [..., C, T]: [..., P, T].

    A broadcast multiply and sum over every channel, not a matmul: a
    caller's ``torch.set_float32_matmul_precision("high")`` would run a
    matmul (or an einsum, which becomes one) in TF32 on the card.  Every
    channel enters the sum, so a non-finite y in any channel reaches every
    pair through 0 * NaN, as the JAX package's one-hot product does."""
    return (sel[:, :, None] * y.unsqueeze(-3)).sum(-2)


def pair_products(sel_a: torch.Tensor, sel_b: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """The routed pair products (ya yb, ya ya, yb yb): [..., P, 3, T]."""
    ya = select_channels(sel_a, y)
    yb = select_channels(sel_b, y)
    return torch.stack([ya * yb, ya * ya, yb * yb], dim=-2)


def fused_core_reference(x, km_z, zl, sel_a, sel_b, km_sys, lp_sys, w1, wv):
    """Plain PyTorch version of the kernel.

    The meter also runs it on a non-128-aligned tail, or on a whole block
    shorter than 128 samples, so it takes any T % 4 == 0.

    Args:
      x:     [B, C, T] input, T % 4 == 0 (the kernel: T % 128 == 0).
      km_z:  [B, C, 2] K-meter smoother state (clamped by the caller,
             kmeterdsp.cc:101).
      zl:    [B, C, 1] correlator lowpass state.
      sel_a, sel_b: [P, C] float32 one-hot routing.
      km_sys: the K-meter's grouped-4 smoother (``KMeter.sys``), advanced
             over blocks of 32 groups = 128 samples, as the kernel does.
      lp_sys: the correlator one-pole (``CorrelationMeter.lp``).
      w1:    its coefficient (for eps).
      wv:    [T] float32 weights of the w2 averages.

    Returns (km_z' [B, C, 2], zl' [B, C, 1], pk [B, C], pacc [B, P, 3]).
    """
    *batch, C, T = x.shape
    if T % 4:
        raise ValueError(f"block length {T} is not a multiple of 4")
    sq = torch.square(x)
    pk = torch.amax(torch.where(torch.isnan(sq), 0.0, sq), dim=-1)
    _, kmz = km_sys.apply(sq.reshape(*batch, C, T // 4, 4), km_z, prefer_block=BLOCK // 4)
    y, zl = lp_sys.apply(x + lowpass_eps(w1), zl)
    pacc = matmul(pair_products(sel_a, sel_b, y), wv)
    return kmz, zl, pk, pacc


def _fused_core_cuda(x, km_z, zl, sel_a, sel_b, km_sys, lp_sys, w1, wv, wide=False):
    global launch_count, wide_launch_count
    from ..runtime import build

    device = canonical_device(x.device)
    if x.ndim != 3:
        raise ValueError(f"x must be [B, C, T], got {tuple(x.shape)}")
    B, C, T = x.shape
    if B < 1:
        raise ValueError("empty batch")
    if T < BLOCK or T % BLOCK:
        raise ValueError(f"T={T} must be a positive multiple of {BLOCK}")
    if C not in PAIRS_OF or sel_a.shape[:1] != (PAIRS_OF[C],):
        raise ValueError(
            f"the kernel takes C in 3..8 with P = 4 (3 when C == 3) pairs, got x "
            f"{tuple(x.shape)} and sel {tuple(sel_a.shape)}")
    P = PAIRS_OF[C]
    km_op, lp_op = km_sys.op(BLOCK // 4), lp_sys.op(BLOCK)
    if not (km_op.d == 2 and km_op.m == 4 and lp_op.d == 1 and lp_op.m == 1):
        raise ValueError("km_sys must be the grouped-4 smoother, lp_sys a one-pole")
    check_tensor("x", x, (B, C, T), device)
    check_tensor("km_z", km_z, (B, C, 2), device)
    check_tensor("zl", zl, (B, C, 1), device)
    check_tensor("sel_a", sel_a, (P, C), device)
    check_tensor("sel_b", sel_b, (P, C), device)
    check_tensor("wv", wv, (T,), device)
    if x.data_ptr() % 16 or wv.data_ptr() % 16:
        raise ValueError("x and wv must be 16-byte aligned (the kernel reads float4)")

    km_w, lp_w = km_op.tensors(device), lp_op.tensors(device)
    # one allocation for the four outputs, which the kernel writes in full
    buf = torch.empty(B * (4 * C + 3 * P), dtype=torch.float32, device=device)
    kmz, zlo, pk, pacc = (t.view(s) for t, s in zip(
        torch.split(buf, (2 * B * C, B * C, B * C, 3 * B * P)),
        ((B, C, 2), (B, C, 1), (B, C), (B, P, 3))))
    lib = build.kernels()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        name = "surround_wide_launch" if wide else "surround_fused_launch"
        rc = getattr(lib, name)(
            x.data_ptr(), km_z.data_ptr(), zl.data_ptr(), sel_a.data_ptr(),
            sel_b.data_ptr(), wv.data_ptr(), km_w.at.data_ptr(), km_w.g.data_ptr(),
            lp_w.at.data_ptr(), lp_w.sy.data_ptr(),
            float(np.float32(w1)), float(np.float32(1.0 - w1)), lowpass_eps(w1),
            B, C, T, kmz.data_ptr(), zlo.data_ptr(), pk.data_ptr(), pacc.data_ptr(), stream,
        )
    build.check(lib, rc, name)
    if wide:
        wide_launch_count += 1
    else:
        launch_count += 1
    return kmz, zlo, pk, pacc


def fused_core_wide(x, km_z, zl, sel_a, sel_b, km_sys, lp_sys, w1, wv):
    """``fused_core`` in the wide layout: the same arguments, returns and
    contract; a CUDA tensor goes to csrc/surround_wide.cu, a CPU tensor to
    the same plain version."""
    if x.device.type == "cuda":
        return _fused_core_cuda(x, km_z, zl, sel_a, sel_b, km_sys, lp_sys, w1, wv, wide=True)
    if x.device.type == "cpu":
        return fused_core_reference(x, km_z, zl, sel_a, sel_b, km_sys, lp_sys, w1, wv)
    raise ValueError(f"no fused_core_wide for device {x.device}")


def fused_core(x, km_z, zl, sel_a, sel_b, km_sys, lp_sys, w1, wv):
    """K-meter smoothers + block peaks + correlator lowpass + routed pair
    sums over one block, the input read once.

    Arguments and returns as ``fused_core_reference``.  A CUDA tensor goes
    to the CUDA kernel, which also needs contiguous float32 inputs on one
    card, C in 3..8 and P = 4 pairs (3 when C == 3); the routing and the
    weights are read there, never synchronised to the host.  A CPU tensor
    goes to the plain version.  ``METERS_TORCH_SURROUND_WIDE=1`` sends the
    call to ``fused_core_wide``.
    """
    if os.environ.get("METERS_TORCH_SURROUND_WIDE", "0") == "1":
        return fused_core_wide(x, km_z, zl, sel_a, sel_b, km_sys, lp_sys, w1, wv)
    if x.device.type == "cuda":
        return _fused_core_cuda(x, km_z, zl, sel_a, sel_b, km_sys, lp_sys, w1, wv)
    if x.device.type == "cpu":
        return fused_core_reference(x, km_z, zl, sel_a, sel_b, km_sys, lp_sys, w1, wv)
    raise ValueError(f"no fused_core for device {x.device}")
