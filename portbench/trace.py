"""The traced stretch of a ``--trace 1`` run and the per-layer metrics.

``Profile`` wraps a steady stretch of the window in ``torch.profiler``
(CPU and CUDA activity): the harness's spans become annotations on the
host timeline, and the device's kernels, copies and fills come back with
their times.  The stretch starts and ends with a synchronise, so every
device operation it launched lies inside it.  ``TraceData`` holds what the
chrome trace export says, reduced: the device operations, the host
annotations, the busy time (the union of device intervals) and the idle
gaps, each labelled by the harness span the host was in when it began.

Every file ``metrics/<name>.py`` is one per-layer metric: ``UNIT`` and
``read(m) -> float | None``, where ``m`` is a ``MetricInput``.  A reader
that finds nothing to read returns None and the metric is left out.
"""

from __future__ import annotations

import bisect
import dataclasses
import json
import os
import tempfile

import torch

from .harness import ROOT, load_module

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
# the port's hand-written CUDA kernels (meters_lv2_torch/csrc), by function
# name; any other device operation is glue
PORT_KERNELS = (
    "r128_fused_kernel", "ballistics_kernel", "ballistics_env_kernel",
    "truepeak_fused_kernel", "spectrum_fused_kernel", "bitmeter_stats_kernel",
    "surround_fused_kernel", "surround_wide_kernel", "stft_generic_kernel",
    "stft_hopper_kernel",
)


def is_port_kernel(name: str) -> bool:
    return any(k in name for k in PORT_KERNELS)


@dataclasses.dataclass
class TraceData:
    device_ops: list  # (name, start_us, dur_us)
    annotations: list  # (name, start_us, dur_us)
    window_s: float
    busy_s: float
    gaps: list  # (label, seconds)

    def count(self, name: str) -> int:
        return sum(1 for a in self.annotations if a[0] == name)

    def breakdown(self) -> dict:
        by_op: dict[str, float] = {}
        for name, _, dur in self.device_ops:
            by_op[name] = by_op.get(name, 0.0) + dur * 1e-6
        by_gap: dict[str, float] = {}
        for label, s in self.gaps:
            by_gap[label] = by_gap.get(label, 0.0) + s
        top = lambda d: [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:10]]
        return {"device_ops": top(by_op), "idle_gaps": top(by_gap)}


def reduce(events: list) -> TraceData:
    """Chrome-trace events -> TraceData."""
    ops = sorted(((e["name"], float(e["ts"]), float(e.get("dur", 0.0))) for e in events
                  if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS), key=lambda o: o[1])
    ann = sorted(((e["name"], float(e["ts"]), float(e.get("dur", 0.0))) for e in events
                  if e.get("ph") == "X" and e.get("cat") == "user_annotation"),
                 key=lambda a: a[1])
    starts = [o[1] for o in ops] + [a[1] for a in ann]
    ends = [o[1] + o[2] for o in ops] + [a[1] + a[2] for a in ann]
    if not starts:
        return TraceData(ops, ann, 0.0, 0.0, [])
    t0, t1 = min(starts), max(ends)
    busy = 0.0
    gaps = []
    cur = t0
    for name, s, d in ops:
        if s > cur:
            gaps.append((cur, s))
        busy += max(0.0, s + d - max(s, cur))
        cur = max(cur, s + d)
    if t1 > cur:
        gaps.append((cur, t1))

    ann_starts = [a[1] for a in ann]

    def label(t):  # the harness's spans do not nest
        i = bisect.bisect_right(ann_starts, t) - 1
        if i >= 0 and t < ann[i][1] + ann[i][2]:
            return ann[i][0]
        return "host"

    return TraceData(ops, ann, (t1 - t0) * 1e-6, busy * 1e-6,
                     [(label(a), (b - a) * 1e-6) for a, b in gaps])


class Profile:
    """``with Profile(ctx): ...`` traces the body; ``.data`` after."""

    def __init__(self, ctx):
        self.ctx = ctx
        self.data: TraceData | None = None

    def __enter__(self):
        acts = [torch.profiler.ProfilerActivity.CPU]
        if self.ctx.dev.cuda:
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        self.ctx.dev.sync()
        self.prof = torch.profiler.profile(activities=acts)
        self.prof.__enter__()
        self.ctx.spans.profiling = True
        return self

    def __exit__(self, *exc):
        self.ctx.dev.sync()
        self.ctx.spans.profiling = False
        self.prof.__exit__(*exc)
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            self.prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f).get("traceEvents", [])
        finally:
            os.unlink(path)
        self.data = reduce(events)
        return False


@dataclasses.dataclass
class MetricInput:
    """What a per-layer metric reader may read."""

    loop: str  # the traffic's loop kind
    config: dict
    traffic: dict
    trace: TraceData | None
    host: dict  # span name -> [seconds], outside the traced stretch
    peaks: dict | None  # the card's peak rates (peaks.json), None if unknown

    def cost(self, kernel: str):
        return load_module("costs", kernel)

    def device_time(self, kernel: str) -> tuple[int, float]:
        """(launches, seconds) of device operations whose name holds
        ``kernel``."""
        if self.trace is None:
            return 0, 0.0
        hits = [d for n, _, d in self.trace.device_ops if kernel in n]
        return len(hits), sum(hits) * 1e-6

    def roofline(self, kernel: str, flops: float, nbytes: float, unit: str) -> float | None:
        """100 x the least time of the work over the measured device time,
        per ``unit`` (a harness span counted in the trace)."""
        n, secs = self.device_time(kernel)
        units = self.trace.count(unit) if self.trace else 0
        if not n or not units or not self.peaks or secs <= 0:
            return None
        least = max(flops / self.peaks["fp32_flops_per_s"], nbytes / self.peaks["hbm_bytes_per_s"])
        return 100.0 * least * units / secs


def peaks_for(kind: str) -> dict | None:
    table = json.loads((ROOT / "peaks.json").read_text())
    for key, p in table.items():
        if key in kind:
            return p
    return None


def per_layer(cell, out, kind: str) -> dict:
    m = MetricInput(cell.traffic["loop"], cell.config, cell.traffic, out.prof,
                    out.host, peaks_for(kind))
    metrics = {}
    for path in sorted((ROOT / "metrics").glob("*.py")):
        mod = load_module("metrics", path.stem)
        v = mod.read(m)
        if v is not None:
            metrics[path.stem] = {"value": float(v), "unit": mod.UNIT}
    return metrics

