"""SigDistHist's update in one pass: bin cast, 361-bin histogram and block
moments, read from the block once.

No Pallas kernel has this role: the JAX package leaves
``SigDistMeter.update`` to XLA.  For x [N, T] float32 and the leaves of a
``SigDistState`` flattened to N rows, ``sigdist_fused`` launches the
hand-written CUDA kernel (csrc/sigdist_fused.cu) and returns the next
state's ``(hist, n, mean, m2, total, time)``, as
``models/sigdist.py::SigDistMeter._plain_update`` computes them with
``reference_oor_count`` off: the histogram, ``n`` and ``time`` exactly,
``mean``, ``m2`` and ``total`` within float32 sums in another order.  The
plain version is that method, over ``ops/hist.py``; it runs for tensors on
the CPU and is the kernel's test oracle.  The meter takes the kernel for a
CUDA tensor in its default mode (``SigDistMeter.takes_kernel``).
"""

from __future__ import annotations

import torch

BINS = 361

# Kernel launches since import (or since a caller reset it).
launch_count = 0


def sigdist_fused(hist, n, mean, m2, total, time, integrating, x: torch.Tensor):
    """The next (hist [N, 361], n, mean, m2, total, time [N]) of a state's
    leaves after the block x [N, T] (CUDA, float32; rows may be strided,
    any other layout is copied first).  The outputs are new tensors; the
    state's ``integrating`` is unchanged."""
    global launch_count
    from ..runtime import build

    if x.ndim != 2:
        raise ValueError(f"x must be [N, T], got {tuple(x.shape)}")
    N, T = x.shape
    if N < 1 or T < 1:
        raise ValueError(f"need N >= 1 and T >= 1, got N={N} T={T}")
    if x.dtype != torch.float32:
        raise TypeError(f"x must be float32, got {x.dtype}")
    device = x.device
    if device.type != "cuda":
        raise ValueError(f"sigdist_fused runs on a CUDA device, got {device}")
    if x.stride(1) != 1 or (N > 1 and x.stride(0) < T):
        x = x.contiguous()
    leaves = {"hist": (hist, torch.int32, (N, BINS)), "n": (n, torch.int32, (N,)),
              "mean": (mean, torch.float32, (N,)), "m2": (m2, torch.float32, (N,)),
              "total": (total, torch.float32, (N,)), "time": (time, torch.int32, (N,)),
              "integrating": (integrating, torch.bool, (N,))}
    args = []
    for name, (t, dtype, shape) in leaves.items():
        if t.dtype != dtype or t.device != device or tuple(t.shape) != shape:
            raise ValueError(f"{name} must be {dtype} {shape} on {device}, got "
                             f"{t.dtype} {tuple(t.shape)} on {t.device}")
        args.append(t.contiguous())
    # one allocation, no fill: the kernel writes every element
    buf = torch.empty(N * (BINS + 5), dtype=torch.int32, device=device)
    h_out, n_out, mean_out, m2_out, total_out, time_out = torch.split(
        buf, [N * BINS, N, N, N, N, N])
    h_out = h_out.view(N, BINS)
    mean_out, m2_out, total_out = (v.view(torch.float32) for v in (mean_out, m2_out, total_out))
    outs = (h_out, n_out, mean_out, m2_out, total_out, time_out)
    lib = build.kernels()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = lib.sigdist_fused_launch(
            x.data_ptr(), max(x.stride(0), T), N, T, *(t.data_ptr() for t in args),
            *(t.data_ptr() for t in outs), stream,
        )
    build.check(lib, rc, "sigdist_fused_launch")
    launch_count += 1
    return outs
