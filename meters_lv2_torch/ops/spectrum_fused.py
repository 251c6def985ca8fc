"""Fused 30-band spectrum core: band filters, square, smoother, peak.

Counterpart of ``meters_lv2_tpu/ops/pallas_spectrum.py::fused_core``.  One
call covers a 128-aligned block of every (downmixed) stream and returns,
per stream and band:

  * val:        the display one-pole smoother's value after the block
                (v_i = (1-w) v_{i-1} + w y_i^2, spectrumlv2.c:210-224),
  * block_peak: the maximum of the smoothed series over the block (the
                meter folds it into its peak-hold),
  * zf:         the band filter's 12-dim state after the block (the banked
                modal-balanced IEC 61260 band-pass, src/spectr.c:68-87).

``fused_core`` launches the hand-written CUDA kernel
(csrc/spectrum_fused.cu) for CUDA tensors and uses the plain PyTorch
version, ``fused_core_reference``, only for tensors on the CPU.  On a CUDA
tensor it launches the kernel or raises; it never falls back.  The plain
version follows the JAX meter's unfused path (models/spectrum.py
``_xla_core``: blocked filter, then the smoother as a blocked Toeplitz
product); the kernel runs the smoother sample by sample, so the two agree
to a stated tolerance, not bit for bit.
"""

from __future__ import annotations

import torch

from . import lti
from .lti import canonical_device, check_tensor

BLOCK = 128  # kernel block (samples); T must be a multiple
N_BANDS = 30
D_STATE = 12  # six 2x2 modal sections per band

# Kernel launches since import (or since a caller reset it): a run can
# show that its main path went through the kernel.  Only the CUDA branch
# of fused_core counts.
launch_count = 0


def plain_core(x: torch.Tensor, z0: torch.Tensor, v0: torch.Tensor,
               omega: torch.Tensor, op_of):
    """The plain computation for any T, as the JAX meter's ``_xla_core``
    runs it: the banked filter over 128-sample blocks plus one remainder
    block (``op_of(n)``, e.g. ``BankedLTISystem.op``, gives the banked
    operator at n samples), square, the runtime-omega one-pole, block max.

    x [..., T], z0 [..., NB, d], v0 [..., NB].  Returns (val [..., NB],
    block_peak [..., NB], zf [..., NB, d]).
    """
    nb = z0.shape[-2]
    ub = x.unsqueeze(-2).expand(*x.shape[:-1], nb, x.shape[-1]).unsqueeze(-1)
    y, zf = lti._scan_split(op_of, ub, z0, BLOCK)  # y [..., NB, T, 1]
    vs, val = lti.one_pole_apply_traced(omega, torch.square(y[..., 0]), v0[..., None])
    return val[..., 0], torch.amax(vs, dim=-1), zf


def fused_core_reference(
    x: torch.Tensor,
    z0: torch.Tensor,
    v0: torch.Tensor,
    omega: torch.Tensor,
    op: lti.LTIBlockOp,
):
    """Plain PyTorch version of the kernel: ``plain_core`` on one banked
    operator.

    Args:
      x:     [B, T] downmixed input, T % 128 == 0.
      z0:    [B, NB, d] banked filter state.
      v0:    [B, NB] smoother value state (the meter's ``val``).
      omega: 0-d tensor, the smoother coefficient.
      op:    the banked LTIBlockOp at block 128 (``BankedLTISystem.op``).

    Returns (val [B, NB], block_peak [B, NB], zf [B, NB, d]).
    """
    if op.block != BLOCK or x.shape[-1] % BLOCK:
        raise ValueError(f"needs op.block == {BLOCK} and T % {BLOCK} == 0, "
                         f"got {op.block} and {x.shape[-1]}")
    return plain_core(x, z0, v0, omega, lambda n: op)


def _fused_core_cuda(x, z0, v0, omega, op):
    global launch_count
    from ..runtime import build

    device = canonical_device(x.device)
    if x.ndim != 2:
        raise ValueError(f"x must be [B, T], got {tuple(x.shape)}")
    B, T = x.shape
    if B < 1:
        raise ValueError("empty batch")
    if T < BLOCK or T % BLOCK:
        raise ValueError(f"T={T} must be a positive multiple of {BLOCK}")
    if not (op.block == BLOCK and op.d == D_STATE and op.m == 1 and op.p == 1
            and op.kmat.shape == (N_BANDS, BLOCK, BLOCK)):
        raise ValueError(
            f"op must be the banked {N_BANDS}-band {D_STATE}-state operator at block {BLOCK}")
    check_tensor("x", x, (B, T), device)
    check_tensor("z0", z0, (B, N_BANDS, D_STATE), device)
    check_tensor("v0", v0, (B, N_BANDS), device)
    check_tensor("omega", omega, (), device)

    w = op.tensors(device)
    val = torch.empty((B, N_BANDS), dtype=torch.float32, device=device)
    peak = torch.empty((B, N_BANDS), dtype=torch.float32, device=device)
    zf = torch.empty((B, N_BANDS, D_STATE), dtype=torch.float32, device=device)
    lib = build.kernels()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = lib.spectrum_fused_launch(
            x.data_ptr(), z0.data_ptr(), v0.data_ptr(), omega.data_ptr(),
            w.kmat.data_ptr(), w.sy.data_ptr(), w.at.data_ptr(), w.g.data_ptr(),
            B, T, val.data_ptr(), peak.data_ptr(), zf.data_ptr(), stream,
        )
    build.check(lib, rc, "spectrum_fused_launch")
    launch_count += 1
    return val, peak, zf


def fused_core(
    x: torch.Tensor,
    z0: torch.Tensor,
    v0: torch.Tensor,
    omega: torch.Tensor,
    op: lti.LTIBlockOp,
):
    """Fused band filters + square + smoother + block peak over one block.

    Arguments and returns as ``fused_core_reference``.  A CUDA tensor goes
    to the CUDA kernel, which also needs contiguous float32 inputs and
    omega as a 0-d float32 tensor on the same card (read there, never
    synchronised to the host); a CPU tensor goes to the plain version.
    """
    if x.device.type == "cuda":
        return _fused_core_cuda(x, z0, v0, omega, op)
    if x.device.type == "cpu":
        return fused_core_reference(x, z0, v0, omega, op)
    raise ValueError(f"no fused_core for device {x.device}")
