"""Bit-meter IEEE-754 field statistics of a block, one pass.

Counterpart of ``meters_lv2_tpu/ops/pallas_bitmeter.py::fused_stats``.  For
x [N, T] float32 it returns the unconditional per-row block deltas of
every bit-meter counter (src/bitmeter.c:63-105)::

    hit, one [N, 280] int32   absolute-bit-position exposure / set counts
    dset     [N, 23]  int32   per-mantissa-bit set counts
    nan, inf, den, zero, pos [N] int32
    vmin, vmax [N] float32    |min| / |max| of the normals (+inf / 0 if none)

Denormals use the effective exponent 1; normals add the implicit bit at
position exponent + 23; NaN, Inf and zeros enter no bit field.  The
integration gate is the caller's (models/bitmeter.py).

``bitmeter_stats`` launches the hand-written CUDA kernel
(csrc/bitmeter_stats.cu) for CUDA tensors, any T, rows possibly strided;
the plain PyTorch version, ``bitmeter_stats_reference``, runs only for
tensors on the CPU.  Both are exact, so they agree in every field.
"""

from __future__ import annotations

import torch

NPOS = 280
NMAN = 23
FLAGS = ("nan", "inf", "den", "zero", "pos")

# Kernel launches since import (or since a caller reset it).  Only the CUDA
# branch of bitmeter_stats() counts.
launch_count = 0


def bitmeter_stats_reference(x: torch.Tensor) -> dict:
    """Plain PyTorch version on the int32 bit view of x [N, T].

    Fields are taken with ``>>`` then ``& mask`` (the arithmetic shift's
    sign fill is masked off).  Positions are counted with one
    ``scatter_add_`` per bit index k = 0..23 into column e_eff + k, so no
    variable shift by 32 - e_eff is ever needed."""
    N, T = x.shape
    x = x.to(torch.float32)
    bits = x.contiguous().view(torch.int32)
    exp = (bits >> 23) & 0xFF
    man = bits & 0x7FFFFF
    is_inf = (exp == 255) & (man == 0)
    is_nan = (exp == 255) & (man != 0)
    is_zero = (exp == 0) & (man == 0)
    is_den = (exp == 0) & (man != 0)
    is_num = (exp != 255) & ~is_zero
    is_norm = is_num & (exp > 0)

    def cnt(mask):
        return mask.sum(-1, dtype=torch.int32)

    out = {
        "nan": cnt(is_nan), "inf": cnt(is_inf), "den": cnt(is_den),
        "zero": cnt(is_zero), "pos": cnt(is_num & (bits >= 0)),
    }
    av = x.abs()
    out["vmin"] = torch.where(is_norm, av, torch.inf).amin(-1)
    out["vmax"] = torch.where(is_norm, av, 0.0).amax(-1)

    e_eff = torch.where(exp > 0, exp, 1).to(torch.int64)
    one24 = torch.where(is_num, torch.where(is_norm, man | (1 << 23), man), 0)
    hit24 = torch.where(is_num, torch.where(is_norm, 0xFFFFFF, 0x7FFFFF), 0).to(torch.int32)
    hit = torch.zeros((N, NPOS), dtype=torch.int32, device=x.device)
    one = torch.zeros((N, NPOS), dtype=torch.int32, device=x.device)
    dset = torch.zeros((N, NMAN), dtype=torch.int32, device=x.device)
    for k in range(24):
        idx = e_eff + k
        hit.scatter_add_(1, idx, (hit24 >> k) & 1)
        one.scatter_add_(1, idx, (one24 >> k) & 1)
        if k < NMAN:
            dset[:, k] = ((one24 >> k) & 1).sum(-1, dtype=torch.int32)
    out.update(hit=hit, one=one, dset=dset)
    return out


def _bitmeter_stats_cuda(x: torch.Tensor) -> dict:
    """The kernel launch."""
    global launch_count
    from ..runtime import build

    if x.ndim != 2:
        raise ValueError(f"x must be [N, T], got {tuple(x.shape)}")
    N, T = x.shape
    if N < 1 or T < 1:
        raise ValueError(f"need N >= 1 and T >= 1, got N={N} T={T}")
    if x.dtype != torch.float32:
        raise TypeError(f"x must be float32, got {x.dtype}")
    if x.stride(1) != 1 or (N > 1 and x.stride(0) < T):
        raise ValueError("x must have unit stride along time (rows may be strided)")
    device = x.device
    # one allocation, no fill: the kernel writes every element
    buf = torch.empty(N * (2 * NPOS + NMAN + len(FLAGS) + 2), dtype=torch.int32, device=device)
    hit, one, dset, flags, vmin, vmax = torch.split(
        buf, [N * NPOS, N * NPOS, N * NMAN, len(FLAGS) * N, N, N])
    hit, one, dset = hit.view(N, NPOS), one.view(N, NPOS), dset.view(N, NMAN)
    flags = flags.view(len(FLAGS), N)
    vmin, vmax = vmin.view(torch.float32), vmax.view(torch.float32)
    lib = build.kernels()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = lib.bitmeter_stats_launch(
            x.data_ptr(), max(x.stride(0), T), N, T, hit.data_ptr(),
            one.data_ptr(), dset.data_ptr(), flags.data_ptr(),
            vmin.data_ptr(), vmax.data_ptr(), stream,
        )
    build.check(lib, rc, "bitmeter_stats_launch")
    launch_count += 1
    out = dict(zip(FLAGS, flags))
    out.update(hit=hit, one=one, dset=dset, vmin=vmin, vmax=vmax)
    return out


def bitmeter_stats(x: torch.Tensor) -> dict:
    """Every bit-meter counter delta of x [N, T]; see the module docstring.
    A CUDA tensor goes to the CUDA kernel (float32, unit stride in time);
    a CPU tensor to the plain version."""
    if x.device.type == "cuda":
        return _bitmeter_stats_cuda(x)
    if x.device.type == "cpu":
        return bitmeter_stats_reference(x)
    raise ValueError(f"no bitmeter_stats for device {x.device}")
