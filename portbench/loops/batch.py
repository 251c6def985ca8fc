"""Closed loop, dispatch ahead: a catalogue job.

The host submits the pool's blocks to ``update()`` one after another
without waiting for the device.  After every ``programme_blocks`` blocks
the programme is done: ``read()``, the readouts of every stream copied
without blocking into pinned host buffers behind an event (the sample's
histograms with them), and a fresh state for the next programme.  A
programme's copy is waited for only at the end of the next one, so the
device never waits for the host's copy.  The window closes at the first
block boundary after ``--seconds`` once a programme has finished, with a
read of the open programme, its copy and a synchronise: every block
submitted is done.

End to end: ``xrt``, the stream-seconds submitted over the window's wall
seconds.  With ``--trace 1`` the second programme runs traced, and the
first ``HOST_PROBE`` updates after it each start on an idle device, after
a synchronise outside their span, so that the span holds the host's own
time in ``update()`` and no wait for room in the launch queue; the
garbage the trace's reading left is collected before them.
"""

from __future__ import annotations

import gc
import time

import numpy as np
import torch

from portbench.harness import LoopOut
from portbench.trace import Profile

HOST_PROBE = 20  # updates timed alone after the traced programme


def _take(ctx, state):
    outs, _ = ctx.system.read(state)
    return ctx.system.readouts(outs, state, ctx.names)


def _state_keys(ctx) -> set:
    return {f"{m}.{k}" for m, (_, ks) in ctx.names.items() for k in ks}


def _copy(ctx, vals, bufs, sample_dev):
    """Readouts (every stream) and state leaves (the sample's rows) into
    pinned host buffers; returns the event that marks the copies."""
    states = _state_keys(ctx)
    for key, v in vals.items():
        src = v.index_select(0, sample_dev) if key in states else v
        if key not in bufs:
            bufs[key] = ctx.dev.host_like(src)
        bufs[key].copy_(src, non_blocking=True)
    return ctx.dev.mark()


def _sampled(ctx, bufs):
    states = _state_keys(ctx)
    return {k: (b.numpy().copy() if k in states else b.numpy()[ctx.sample].copy())
            for k, b in bufs.items()}


def warm(ctx):
    """The cell's shapes once each: update, read, the copies, a fresh state."""
    sample_dev = torch.as_tensor(ctx.sample, device=ctx.pool.device)
    ctx.bufs = [{}, {}]  # the window's pinned buffers, made here
    state = ctx.system.init(ctx.batch)
    for k in range(2):
        state = ctx.system.update(state, ctx.pool[k])
    for bufs in ctx.bufs:
        ctx.dev.wait(_copy(ctx, _take(ctx, state), bufs, sample_dev))
    ctx.system.init(ctx.batch)


def window(ctx) -> LoopOut:
    tr = ctx.cell.traffic
    prog = tr["programme_blocks"]
    P = ctx.pool.shape[0]
    span = ctx.spans
    sample_dev = torch.as_tensor(ctx.sample, device=ctx.pool.device)
    bufs = ctx.bufs
    done = []  # the sample's readouts of each finished programme
    pending = None  # (event, buffers) of the last programme's copy
    traced = None
    probe_left = HOST_PROBE if ctx.trace else 0
    blocks = k = programmes = 0
    state = ctx.system.init(ctx.batch)
    t0 = time.perf_counter()
    while True:
        if ctx.trace and programmes == 1 and k == 0 and traced is None:
            traced = Profile(ctx).__enter__()
        alone = probe_left > 0 and traced is not None and traced.data is not None
        if alone:  # an idle device and an empty launch queue
            if probe_left == HOST_PROBE:  # the trace's objects go before, not inside
                gc.collect()
            ctx.dev.sync()
            probe_left -= 1
        with span("update.alone" if alone else "update"):
            state = ctx.system.update(state, ctx.pool[k % P])
        blocks += 1
        k += 1
        if k == prog:
            with span("read"):
                vals = _take(ctx, state)
            with span("copy"):
                ev = _copy(ctx, vals, bufs[programmes % 2], sample_dev)
            if pending is not None:
                with span("wait"):
                    ctx.dev.wait(pending[0])
                done.append(_sampled(ctx, pending[1]))
            pending = (ev, bufs[programmes % 2])
            with span("init"):
                state = ctx.system.init(ctx.batch)
            k = 0
            programmes += 1
            if traced is not None and traced.data is None:
                traced.__exit__(None, None, None)
        # a window holds at least one whole programme, and a traced run's
        # its whole traced programme and the updates timed alone
        traced_done = not ctx.trace or (traced is not None and traced.data is not None
                                        and not probe_left)
        if time.perf_counter() - t0 >= ctx.seconds and programmes and traced_done:
            break
    if k:  # the open programme's readouts reach the host too
        ctx.dev.wait(_copy(ctx, _take(ctx, state), bufs[programmes % 2], sample_dev))
    ctx.dev.sync()
    t1 = time.perf_counter()
    if traced is not None and traced.data is None:
        traced.__exit__(None, None, None)
    if pending is not None:
        ctx.dev.wait(pending[0])
        done.append(_sampled(ctx, pending[1]))
    T = ctx.block
    xrt = blocks * ctx.batch * T / ctx.cell.config["fs"] / (t1 - t0)
    answers = {key: np.stack([d[key] for d in done], axis=1) for key in (done[0] if done else {})}
    at = {key: np.zeros(len(done), np.int64) for key in answers}  # each programme: read 0
    at.update({f"{m}.state_pos": np.arange(len(done)) for m in ctx.names})
    return LoopOut(
        t_first=t0,
        e2e={"xrt": (xrt, "x-realtime")},
        answers=answers,
        at=at,
        reads=[prog * T],
        samples=prog * T,
        attempted=blocks * ctx.batch,
        prof=traced.data if traced is not None else None,
        host=dict(span.times),
    )
