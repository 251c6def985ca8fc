"""The program's own spans in a traced run: which step of the port launched
each device operation, where the host's time in ``update()`` goes, and what
set-up is made of.

The program records spans and counters when they are turned on
(``meters_lv2_torch/utils/profiler.py``): ``r128.update`` with its parts
``r128.kernel``, ``r128.tail``, ``r128.fragments``, ``r128.windows``,
``r128.hist`` and ``r128.radar``; ``r128.read``; ``r128.design``;
``build.load`` (``build.compile`` inside); the counter ``cache.fill``.
Under ``torch.profiler`` they are also annotations in the Chrome trace,
nested inside the harness's own (``update``, ``read``, ``copy``, ``wait``,
``init``).  Nothing here imports the program: the readers take the
trace's events and the spans and counters as plain tuples.

``nest(events)`` reduces the trace with nesting: each device operation
goes to the innermost annotation that encloses its launch (the
``cuda_runtime`` or ``cuda_driver`` event with the same ``correlation``
id), and each idle gap to the innermost annotation enclosing its start.
Every reader returns None where the program's spans are absent.

Temporary in part: ``nest()`` repeats ``trace.reduce()``'s walk over the
idle gaps, and only ``tools/r128_spans.py`` calls it.  Once ``reduce()``
calls ``nest()`` for its gaps and device ops, the repeated walk goes, and
the readers here become the benchmark's metric files.  None of these
readings is a metric of BENCHMARK.json yet.
"""

from __future__ import annotations

import dataclasses
import statistics

from .trace import DEVICE_CATS, is_port_kernel

LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
# the glue's parts: device ops launched inside each span, an update
GLUE_PARTS = {
    "r128.fragments": "glue_ms.fragments",
    "r128.windows": "glue_ms.windows",
    "r128.hist": "glue_ms.hist",
    "r128.radar": "glue_ms.radar",
    "r128.read": "glue_ms.read",
}
GLUE_OTHER = "glue_ms.other"  # r128.update's self time, r128.tail, the harness's spans


@dataclasses.dataclass
class Nested:
    device_ops: list  # (name, start_us, dur_us, span that launched it or None)
    gaps: list  # (innermost span at the gap's start or "host", seconds)
    annotations: list  # (name, start_us, dur_us)

    def count(self, name: str) -> int:
        return sum(1 for a in self.annotations if a[0] == name)

    def idle_gaps(self) -> list:
        """[label, seconds] summed by label, the largest first."""
        by: dict[str, float] = {}
        for label, s in self.gaps:
            by[label] = by.get(label, 0.0) + s
        return [[k, v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:10]]


def innermost(annotations: list, times: list) -> list:
    """For each time in ``times``, the name of the innermost annotation
    (name, start, dur) with start <= t < start + dur, or None: the one
    opened last among those still open, as spans of one thread nest."""
    events = []
    for i, (_, s, d) in enumerate(annotations):
        events.append((s, 1, i))
        events.append((s + d, 0, i))
    for j, t in enumerate(times):
        events.append((t, 2, j))
    events.sort()
    stack, closed = [], set()
    out = [None] * len(times)
    for _, kind, i in events:
        if kind == 1:
            stack.append(i)
        elif kind == 0:
            closed.add(i)
        else:
            while stack and stack[-1] in closed:
                stack.pop()
            out[i] = annotations[stack[-1]][0] if stack else None
    return out


def nest(events: list) -> Nested:
    """Chrome-trace events of a traced stretch -> Nested."""
    ann = sorted(((e["name"], float(e["ts"]), float(e.get("dur", 0.0))) for e in events
                  if e.get("ph") == "X" and e.get("cat") == "user_annotation"),
                 key=lambda a: a[1])
    launch_at = {e["args"]["correlation"]: float(e["ts"]) for e in events
                 if e.get("ph") == "X" and e.get("cat") in LAUNCH_CATS
                 and "correlation" in e.get("args", {})}
    dev = sorted((e for e in events if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS),
                 key=lambda e: float(e["ts"]))
    launches = [launch_at.get(e.get("args", {}).get("correlation")) for e in dev]
    known = [t for t in launches if t is not None]
    names = iter(innermost(ann, known))
    ops = [(e["name"], float(e["ts"]), float(e.get("dur", 0.0)),
            next(names) if t is not None else None) for e, t in zip(dev, launches)]
    # idle gaps between the device's busy stretches, as trace.reduce finds them
    gaps = []
    starts = [o[1] for o in ops] + [a[1] for a in ann]
    if starts:
        cur, t1 = min(starts), max([o[1] + o[2] for o in ops] + [a[1] + a[2] for a in ann])
        for _, s, d, _ in ops:
            if s > cur:
                gaps.append((cur, s))
            cur = max(cur, s + d)
        if t1 > cur:
            gaps.append((cur, t1))
    labels = innermost(ann, [a for a, _ in gaps])
    return Nested(ops, [(lb or "host", (b - a) * 1e-6) for lb, (a, b) in zip(labels, gaps)],
                  ann)


def glue_split(nested: Nested | None) -> dict | None:
    """Device ms an update of the glue (every device operation but the
    port's named kernels) by the span that launched it: ``GLUE_PARTS``,
    and ``glue_ms.other`` for the rest; ``r128.read``'s spread over the
    programme's updates as the whole glue's is.  The parts sum to the
    benchmark's ``glue_ms`` over the same trace."""
    if nested is None or not nested.device_ops:
        return None
    units = nested.count("update")
    if not units or not any(a[0].startswith("r128.") for a in nested.annotations):
        return None
    us = dict.fromkeys([*GLUE_PARTS.values(), GLUE_OTHER], 0.0)
    for name, _, dur, span in nested.device_ops:
        if not is_port_kernel(name):
            us[GLUE_PARTS.get(span, GLUE_OTHER)] += dur
    return {k: v * 1e-3 / units for k, v in us.items()}


def enqueue_split(spans: list, probes: list) -> dict | None:
    """Host ms of the updates timed alone (the harness's ``update.alone``
    spans, ``probes``: (t0_ns, t1_ns)): the median over them of the time
    in ``r128.kernel`` (``enqueue_ms.kernel``) and of ``r128.update`` less
    it (``enqueue_ms.glue``).  ``spans``: the program's (name, parent, id,
    t0_ns, t1_ns), where ``id`` is the call number of the ``r128.update``
    a ``r128.kernel`` lies under."""
    kernel: dict[int, int] = {}
    for s in spans:
        if s[0] == "r128.kernel":
            kernel[s[2]] = kernel.get(s[2], 0) + s[4] - s[3]
    tops = [s for s in spans if s[0] == "r128.update"
            and any(p0 <= s[3] and s[4] <= p1 for p0, p1 in probes)]
    if not tops:
        return None
    k = [kernel.get(s[2], 0) * 1e-6 for s in tops]
    g = [(s[4] - s[3]) * 1e-6 - kk for s, kk in zip(tops, k)]
    return {"enqueue_ms.kernel": statistics.median(k), "enqueue_ms.glue": statistics.median(g)}


def setup_split(spans: list, counters: dict, pool_s: float | None) -> dict:
    """Seconds of set-up by phase, from the program's spans and counters of
    set-up (to the first timed block): ``setup_s.library`` the kernel
    library's load (``build.load``, nvcc inside on a first run),
    ``setup_s.design`` the meter's design (``r128.design``) and the
    caches filled on its first calls (``cache.fill``'s seconds), and
    ``setup_s.pool`` the benchmark's own audio, where given."""
    secs = lambda name: sum(s[4] - s[3] for s in spans if s[0] == name) * 1e-9
    out = {}
    if any(s[0] == "build.load" for s in spans):
        out["setup_s.library"] = secs("build.load")
    if any(s[0] == "r128.design" for s in spans):
        out["setup_s.design"] = secs("r128.design") + counters.get("cache.fill", (0, 0.0))[1]
    if pool_s is not None:
        out["setup_s.pool"] = pool_s
    return out


def cache_fills(spans: list, counters: dict) -> int | None:
    """``cache.fill`` over the window (0 where nothing is rebuilt); None
    where the program recorded nothing, its spans being off."""
    if not spans and not counters:
        return None
    return counters.get("cache.fill", (0, 0.0))[0]
