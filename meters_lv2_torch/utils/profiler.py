"""Spans, counters and Chrome traces of the port's own work.

- ``span(name)``: a context manager around one step of the program.  Spans
  are off by default; off, ``span()`` tests one module-level bool and
  returns a shared no-op context (no clock read, no allocation).  On
  (``enable()``), each span keeps ``Span(name, parent, id, t0, t1)`` in
  memory: ``parent`` is the index of the enclosing span of the same thread
  (-1 at the top), ``id`` the call number of the top span it lies under
  (the n-th ``r128.update`` and every span inside it carry n), and
  ``t0``/``t1`` are ``time.perf_counter_ns()``.  Under a running
  ``torch.profiler`` a span is also a ``record_function`` range, so it
  lands in the Chrome trace as a ``user_annotation`` beside the device
  operations it launched.
- ``count(name, seconds=0.0)`` adds one (and ``seconds``) to a counter;
  ``counted(name)`` counts one with the seconds its block took.  Off, both
  do nothing.  Spans and counters may be recorded from several threads.
- ``collect()`` returns ``(spans, counters)`` and clears them;
  ``counters`` maps a name to ``(count, seconds)``.
- ``trace(logdir)``: ``torch.profiler`` around a block (CPU and, with a
  card, CUDA activity), written into ``logdir`` as a Chrome trace, with the
  spans on while it runs.

The spans and counters the port records:

  ``r128.update`` (``models/ebur128.py``) with the children
  ``r128.kernel`` (the r128_fused call: checks, launch, reshapes),
  ``r128.tail`` (the plain ops on a tail or a short block),
  ``r128.fragments``, ``r128.windows``, ``r128.hist`` and ``r128.radar``;
  ``r128.read``; ``r128.design`` (the meter's float64 design);
  ``build.load`` (``runtime/build.py``: the kernel library's load) with
  ``build.compile`` when nvcc runs; the counter ``cache.fill``, one for
  each fill of a cache of device tensors, operators or host arrays on the
  R128 path (only a miss counts); the counter ``r128.seg``, one for each
  update whose fragment sums come from r128_fused's seg mode.

  On the mastering meters and the pipeline that runs them:
  ``pipe.update`` (``parallel/pipeline.py``) with one child a meter,
  ``pipe.<meter name>``; ``dr14.update`` (``models/dr14.py``, TP+RMS too)
  with the children ``dr14.km`` (the K-meter), ``dr14.tp`` (the true peak),
  ``dr14.windows`` (the shifted window sums and peaks) and ``dr14.hist``
  (the epilogue: gate, histogram and the slot loop of the top two peaks);
  ``dr14.read``; ``sigdist.update`` (``models/sigdist.py``) with
  ``sigdist.kernel`` (the sigdist_fused call) on a card, else
  ``sigdist.hist`` and ``sigdist.moments`` (the plain ops); the counter
  ``sigdist.kernel``, one for each sigdist update that launched
  sigdist_fused; ``bitmeter.update``
  (``models/bitmeter.py``) with ``bitmeter.kernel`` (the bitmeter_stats
  call); the counter ``truepeak.serial`` (``ops/ballistics.py``), one for
  each true-peak update whose bulk falls back to truepeak_fused's serial
  body because the envelope does not hold.
"""

from __future__ import annotations

import contextlib
import os
import threading
import time
from typing import NamedTuple

import torch

_on = False
_spans: list = []  # [name, parent, id, t0, t1], t1 0 while open
_base = 0  # spans collected so far: _spans[i] is span number _base + i
_counters: dict[str, list] = {}  # name -> [count, seconds]
_calls: dict[str, int] = {}  # top span name -> calls so far
_lock = threading.Lock()  # guards the four above
_local = threading.local()  # .stack: (number, id) of this thread's open spans
_NULL = contextlib.nullcontext()


class Span(NamedTuple):
    name: str
    parent: int  # index of the enclosing span in the same list, -1 at the top
    id: int  # call number of the top span this one lies under
    t0: int  # time.perf_counter_ns()
    t1: int


class _Span:
    __slots__ = ("name", "rec", "rf")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        stack = getattr(_local, "stack", None)
        if stack is None:
            stack = _local.stack = []
        self.rf = None
        if torch.autograd._profiler_enabled():
            self.rf = torch.profiler.record_function(self.name)
            self.rf.__enter__()
        with _lock:
            if stack:
                up, sid = stack[-1]
                # a parent collected while this span was opening: -1
                parent = up - _base if up >= _base else -1
            else:
                parent = -1
                sid = _calls.get(self.name, 0)
                _calls[self.name] = sid + 1
            self.rec = [self.name, parent, sid, time.perf_counter_ns(), 0]
            stack.append((_base + len(_spans), sid))
            _spans.append(self.rec)
        return self

    def __exit__(self, *exc):
        self.rec[4] = time.perf_counter_ns()
        if self.rf is not None:
            self.rf.__exit__(*exc)
        _local.stack.pop()
        return False


class _Counted:
    __slots__ = ("name", "t0")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        count(self.name, (time.perf_counter_ns() - self.t0) * 1e-9)
        return False


def span(name: str):
    """A context manager that records one span while spans are on."""
    if not _on:
        return _NULL
    return _Span(name)


def count(name: str, seconds: float = 0.0) -> None:
    """Add one (and ``seconds``) to the counter ``name`` while spans are
    on."""
    if _on:
        with _lock:
            c = _counters.setdefault(name, [0, 0.0])
            c[0] += 1
            c[1] += seconds


def counted(name: str):
    """A context manager that counts one for ``name`` with the seconds its
    block took, while spans are on."""
    if not _on:
        return _NULL
    return _Counted(name)


def enable() -> None:
    global _on
    _on = True


def disable() -> None:
    global _on
    _on = False


def collect() -> tuple[list[Span], dict[str, tuple[int, float]]]:
    """The spans and counters recorded so far, cleared, and the call
    numbers started again.  Call it between top spans: a span still open
    is dropped when it closes, and a span opened inside it after the call
    is kept with parent -1."""
    global _base
    with _lock:
        spans = [Span(*s) for s in _spans]
        counters = {k: (c[0], c[1]) for k, c in _counters.items()}
        _base += len(_spans)
        _spans.clear()
        _counters.clear()
        _calls.clear()
    return spans, counters


@contextlib.contextmanager
def trace(logdir: str):
    """torch.profiler trace around a block, with CPU activity and, where a
    card is present, CUDA activity; on exit the trace is written into
    `logdir` as a Chrome trace (chrome://tracing, Perfetto), named
    ``trace_<pid>_<ns>.json``.  The port's spans are on inside the block,
    so the trace holds them as ``user_annotation`` ranges; if they were
    off before, they are turned off again after and what they recorded in
    memory is dropped.  Yields the profiler (key_averages() and the rest of
    its API).  Raises if the profiler cannot start."""
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(logdir, exist_ok=True)
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    was_on = _on
    enable()
    try:
        with profile(activities=acts) as prof:
            yield prof
    finally:
        if not was_on:
            disable()
            collect()
    prof.export_chrome_trace(
        os.path.join(logdir, f"trace_{os.getpid()}_{time.time_ns()}.json"))
