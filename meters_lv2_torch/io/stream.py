"""Streaming ingest: feed long files or live captures through a meter with
bounded memory and host/device overlap (counterpart of
``meters_lv2_tpu/io/stream.py``).

CUDA launches are asynchronous: update(n+1) is enqueued while the card
still runs update(n), so a plain loop already overlaps the host's work with
the card's.  ``stream_pipelined`` also overlaps the host-to-device copies
of the next blocks with that work.
"""

from __future__ import annotations

import dataclasses
from collections import deque
from typing import Callable, Iterable, Iterator

import numpy as np
import torch


def chunk_array(x: np.ndarray, chunk: int, pad: bool = True) -> Iterator[np.ndarray]:
    """Split [..., T] into chunk-sized pieces.

    `chunk` is rounded DOWN to a multiple of 4 (the meters' minimum
    block granularity) so that no zeros are ever injected mid-stream —
    e.g. a naive 0.5 s chunk at 44.1 kHz (22050) would otherwise need 2
    pad samples after EVERY piece.  With pad=True only the final piece
    is zero-padded up to the 4-grain; pad=False yields exact lengths for
    callers that enforce the padding-never-measured invariant themselves."""
    chunk = max(4, chunk // 4 * 4)
    T = x.shape[-1]
    for i in range(0, T, chunk):
        piece = x[..., i : i + chunk]
        rem = (-piece.shape[-1]) % 4
        if pad and rem:
            piece = np.pad(piece, [(0, 0)] * (piece.ndim - 1) + [(0, rem)])
        yield piece


def state_device(state) -> torch.device:
    """The device of a meter state (a dataclass or dict of tensors)."""
    if dataclasses.is_dataclass(state):
        return state_device(getattr(state, dataclasses.fields(state)[0].name))
    if isinstance(state, dict):
        return state_device(next(iter(state.values())))
    return state.device


def to_host(out):
    """A readout (a tensor or a dict of them) as numpy arrays."""
    if isinstance(out, dict):
        return {k: to_host(v) for k, v in out.items()}
    if isinstance(out, torch.Tensor):
        return out.detach().cpu().numpy()
    return out


def _read(meter, state, i, read_every, on_read):
    if read_every and (i + 1) % read_every == 0:
        out, state = meter.read(state)
        if on_read is not None:
            on_read(i, to_host(out))
    return state


def stream(
    meter,
    state,
    blocks: Iterable,
    read_every: int = 0,
    on_read: Callable | None = None,
):
    """Run a block iterator (numpy arrays or tensors) through meter.update
    on the state's device, with optional periodic readouts (read_every
    blocks; 0 = never; on_read(i, readout as numpy)).  Returns the final
    state."""
    dev = state_device(state)
    for i, blk in enumerate(blocks):
        state = meter.update(state, torch.as_tensor(blk, device=dev))
        state = _read(meter, state, i, read_every, on_read)
    return state


def stream_pipelined(
    meter,
    state,
    blocks: Iterable,
    depth: int = 2,
    read_every: int = 0,
    on_read: Callable | None = None,
):
    """stream() with `depth` blocks in flight to the card.

    Each block is staged in pinned host memory and copied with
    ``copy_(non_blocking=True)`` on a side CUDA stream; the compute stream
    waits on the copy's event, and the block is marked with
    ``record_stream`` so that the caching allocator does not hand its
    memory out again before the compute stream is done with it.  The copy
    of block n+1 then overlaps update(n).  The same updates run in the same
    order as in stream(), so the final state is bit-identical.  On a CPU
    state the blocks are used as they come.  No host thread is used."""
    if depth < 1:
        raise ValueError(f"depth must be >= 1, got {depth}")
    dev = state_device(state)
    cuda = dev.type == "cuda"
    if cuda:
        copy_stream = torch.cuda.Stream(dev)
        compute = torch.cuda.current_stream(dev)
    it = iter(blocks)
    q: deque = deque()

    def prefetch():
        blk = next(it, None)
        if blk is None:
            return
        host = torch.as_tensor(blk)
        if not cuda or host.device == dev:
            q.append((host.to(dev), None))
            return
        pinned = torch.empty(host.shape, dtype=host.dtype, pin_memory=True)
        pinned.copy_(host)
        with torch.cuda.stream(copy_stream):
            xd = torch.empty(host.shape, dtype=host.dtype, device=dev)
            xd.copy_(pinned, non_blocking=True)
            done = torch.cuda.Event()
            done.record(copy_stream)
        q.append((xd, done))

    for _ in range(depth):
        prefetch()
    i = 0
    while q:
        xb, done = q.popleft()
        if done is not None:
            compute.wait_event(done)
            xb.record_stream(compute)
        state = meter.update(state, xb)
        del xb
        prefetch()
        state = _read(meter, state, i, read_every, on_read)
        i += 1
    return state


def stream_wav(meter, path: str, chunk_seconds: float = 2.0, device="cuda", **kw):
    """Decode a WAV (native codec) and stream it through a fresh meter
    state on `device`; returns (final readout as numpy, final state)."""
    from .wav import read_wav

    x, rate = read_wav(path)
    if abs(rate - meter.fs) >= 1:
        raise ValueError(f"{path} is at {rate} Hz, the meter at {meter.fs}")
    state = meter.init((), device=device)
    state = stream(meter, state, chunk_array(x, int(rate * chunk_seconds)), **kw)
    out, state = meter.read(state)
    return to_host(out), state
