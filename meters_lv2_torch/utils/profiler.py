"""Profiling / tracing utilities (counterpart of
``meters_lv2_tpu/utils/profiler.py``; the reference has none, only
disabled printf counters, src/ebulv2.cc:232-237).

Two layers:

- time_op: completion-synchronized wall timing.  CUDA launches return at
  enqueue, so every timed loop ends with ``torch.cuda.synchronize()`` and a
  one-element host copy of the output (the fetch barrier), before the
  clock is read.
- trace: context manager around ``torch.profiler.profile`` (CPU and CUDA
  activities) that exports a Chrome trace into a directory.  A profiler
  that fails to start raises.
"""

from __future__ import annotations

import contextlib
import os
import time

import numpy as np
import torch

from .interop import tree_flatten


def _fetch_barrier(tree) -> None:
    """Force completion: synchronize the card (when a leaf lies on one),
    then host-copy ONE ELEMENT of the first tensor leaf with an element.

    The copy is a single element, not the whole leaf: its arrival proves
    the work that produced it has completed without billing the timed
    region for a state transfer."""
    tensors = [x for x in tree_flatten(tree)[0] if isinstance(x, torch.Tensor)]
    if any(x.is_cuda for x in tensors):
        torch.cuda.synchronize()
    for leaf in tensors:
        if leaf.numel():
            leaf[(0,) * leaf.ndim].item()
            return


def time_op(fn, *args, iters: int = 10, warmup: int = 2, best_of: int = 3,
            **kwargs):
    """Completion-synchronized timing of fn(*args, **kwargs).

    Returns a dict {ms_per_call, calls_per_s, iters}.  fn is called in a
    loop of `iters` enqueues ended by one fetch barrier (matching
    production dispatch patterns); best of `best_of` loops.
    """
    for _ in range(warmup):
        out = fn(*args, **kwargs)
    _fetch_barrier(out)
    best = float("inf")
    for _ in range(best_of):
        t0 = time.perf_counter()
        for _ in range(iters):
            out = fn(*args, **kwargs)
        _fetch_barrier(out)
        best = min(best, time.perf_counter() - t0)
    return {
        "ms_per_call": best / iters * 1e3,
        "calls_per_s": iters / best,
        "iters": iters,
    }


def meter_throughput(meter, batch_shape, chunk_samples: int, fs: float,
                     nchan: int | None = None, iters: int = 10, device="cuda"):
    """x-realtime throughput of meter.update (process() for the display
    meters) at a given operating point on `device`, timed by time_op.  The
    input is 0.1 N(0, 1) drawn from a torch.Generator on the device, seeded
    with 0."""
    batch_shape = tuple(batch_shape)
    shape = (*batch_shape, *((nchan,) if nchan else ()), chunk_samples)
    gen = torch.Generator(device=device).manual_seed(0)
    x = 0.1 * torch.randn(shape, generator=gen, device=device, dtype=torch.float32)
    st = meter.init(batch_shape, device=device)
    if hasattr(meter, "update"):
        r = time_op(lambda s: meter.update(s, x), st, iters=iters)
    else:  # display processors (goniometer/phasewheel/stereoscope)
        r = time_op(lambda s: meter.process(s, x)[1], st, iters=iters)
    streams = int(np.prod(batch_shape)) if batch_shape else 1
    stream_seconds = streams * chunk_samples / fs
    r["x_realtime"] = stream_seconds / (r["ms_per_call"] / 1e3)
    return r


@contextlib.contextmanager
def trace(logdir: str):
    """torch.profiler trace around a block, with CPU activity and, where a
    card is present, CUDA activity; on exit the trace is written into
    `logdir` as a Chrome trace (chrome://tracing, Perfetto), named
    ``trace_<pid>_<ns>.json``.  Yields the profiler (key_averages() and
    the rest of its API).  Raises if the profiler cannot start."""
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(logdir, exist_ok=True)
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(
        os.path.join(logdir, f"trace_{os.getpid()}_{time.time_ns()}.json"))
