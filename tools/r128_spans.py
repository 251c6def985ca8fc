#!/usr/bin/env python3
"""A traced run of a benchmark cell with the port's spans on: the glue,
the device's and the host's time in update() and set-up, split by the
port's own spans.  Any cell: ``r128_batch`` (the R128 spans) or
``mastering_qc`` (``pipe.update``, ``dr14.*``, ``sigdist.*``,
``bitmeter.*`` and the counters ``truepeak.serial`` and ``sigdist.kernel``).

Run from the root of a checkout, on a machine with a CUDA card:

    python3 tools/r128_spans.py --workload r128_batch --seed <n> --seconds 10 \\
        [--port-spans 0|1] [--out FILE]

It runs the cell as ``python3 -m portbench.run --trace 1`` does (set-up,
the warm pass, the window with its traced programme and the updates timed
alone after it), with ``meters_lv2_torch.utils.profiler.enable()`` before
the system is built, and prints one JSON line: ``metrics``, the cell's
per-layer metrics as the benchmark reads them and the readings of
``portbench/spans.py`` (``glue_ms.*``, ``enqueue_ms.kernel`` and
``.glue``, ``cache_fills``, ``setup_s.*``) and ``seg_share``, the
window's updates that took r128_fused's seg mode (the counter ``r128.seg``
over the ``r128.update`` spans) and ``truepeak_serial``, the window's
true-peak updates that fell back to truepeak_fused's serial body (the
counter ``truepeak.serial``, 0 where the envelope held, wherever
``dr14.tp`` ran) and ``sigdist_kernel_share``, the window's sigdist updates
that launched sigdist_fused (the counter ``sigdist.kernel`` over the
``sigdist.update`` spans); ``window_counts``, each of the port's
counters over the window; ``idle_gaps`` labelled by the
innermost span at each gap's start; ``probe_ms``, the median host ms of
each part of the top span of update() over the updates timed alone (its
spans at every depth by name; ``self`` is the top span, ``r128.update`` or
``pipe.update``, less its direct children); ``device_ms_by_kernel`` and
``device_ms_by_span``, the traced programme's device ms an update by the
port's kernels (``glue`` for the rest) and by the innermost span, the
port's or the harness's, that launched each operation; ``setup_s`` and ``setup_parts`` (seconds to
the run's start, that is the imports, the pool, and the port's set-up
spans by name); ``spans_s``, the host seconds in each of the port's spans
over the window, waits for room in the launch queue included; the card's
name and power limit.  ``--port-spans 0`` leaves the port's spans off, for
their cost on the same run.  The answers are not checked here: the
benchmark checks them.  With ``--out`` the line is also written to FILE.

Temporary: this runner stands in for the benchmark until
``portbench/run.py`` turns the port's spans on itself (``System.spans``
and ``System.collect()``, a harness span around the pool, ``reduce()``
calling ``spans.nest()``, the readings as metric files with their
BENCHMARK.json entries).  It reaches into the harness's internals
(``trace.reduce``, ``signals.fill_pool``, ``harness.Spans``), so a change
there can break it without a warning; delete the runner then, keeping
``--on-cost`` if the spans' cost is still wanted.

    python3 tools/r128_spans.py --on-cost 10 [--out FILE]

times the spans' cost instead: one span entered and left 100,000 times
off, on, and on under torch.profiler (ns a span), and the cell's update()
at its batch and block on an idle card, 20 calls with the spans off and 20
with them on in turn for each of the rounds (median host ms of each).
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import os  # noqa: E402

for _v in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
    os.environ[_v] = "1"

import argparse  # noqa: E402
import contextlib  # noqa: E402
import json  # noqa: E402
import statistics  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

from meters_lv2_torch.utils import profiler  # noqa: E402
from portbench import harness, signals, spans, trace  # noqa: E402
from portbench.system import System  # noqa: E402


class StampedSpans(harness.Spans):
    """The harness's spans, each also kept with its host-clock bounds."""

    def __init__(self):
        super().__init__(True)
        self.stamps: list[tuple[str, int, int]] = []

    @contextlib.contextmanager
    def __call__(self, name: str):
        t0 = time.perf_counter_ns()
        with super().__call__(name):
            yield
        self.stamps.append((name, t0, time.perf_counter_ns()))


def card() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "unknown"


def _median_ms(xs: list) -> float:
    return 1e3 * statistics.median(xs) if xs else 0.0


def probe_parts(win_spans: list, probes: list) -> dict:
    """Median host ms of each part of the updates timed alone: for each of
    the port's top spans inside a probe (``r128.update``, ``pipe.update``),
    the time in each span below it, summed by name at any depth, and
    ``self``, the top span less its direct children."""
    parts: dict[str, list] = {}
    for i, s in enumerate(win_spans):
        if s.parent != -1 or not any(p0 <= s.t0 and s.t1 <= p1 for p0, p1 in probes):
            continue
        own: dict[str, float] = {}
        below = {i}
        direct = 0.0
        for j in range(i + 1, len(win_spans)):
            c = win_spans[j]
            if c.parent not in below:
                continue
            below.add(j)
            t = (c.t1 - c.t0) * 1e-9
            own[c.name] = own.get(c.name, 0.0) + t
            if c.parent == i:
                direct += t
        own["self"] = (s.t1 - s.t0) * 1e-9 - direct
        for k, v in own.items():
            parts.setdefault(k, []).append(v)
    return {k: _median_ms(v) for k, v in parts.items()}


def device_split(nested) -> dict:
    """Device ms an update of the traced programme, (a) by the port's
    kernels by name and ``glue`` for every other operation, (b) by the
    innermost span, the port's or the harness's, that launched each
    operation (``none`` where none was open)."""
    if nested is None or not nested.device_ops:
        return {}
    units = nested.count("update")
    if not units:
        return {}
    by_kernel: dict[str, float] = {}
    by_span: dict[str, float] = {}
    for name, _, dur, span in nested.device_ops:
        kernel = next((k for k in trace.PORT_KERNELS if k in name), "glue")
        by_kernel[kernel] = by_kernel.get(kernel, 0.0) + dur * 1e-3 / units
        by_span[span or "none"] = by_span.get(span or "none", 0.0) + dur * 1e-3 / units
    order = lambda d: dict(sorted(d.items(), key=lambda kv: -kv[1]))  # noqa: E731
    return {"device_ms_by_kernel": order(by_kernel), "device_ms_by_span": order(by_span)}


def run(workload: str, seed: int, seconds: float, port_spans: bool, device: str = "cuda",
        overrides: dict | None = None) -> dict:
    t_run = time.perf_counter()
    events = []  # each traced stretch's chrome-trace events
    reduce = trace.reduce
    trace.reduce = lambda ev: (events.append(ev), reduce(ev))[1]
    pool_s = []
    fill_pool = signals.fill_pool

    def timed_fill_pool(*a, **k):
        t0 = time.perf_counter()
        fill_pool(*a, **k)
        if device != "cpu":
            torch.cuda.synchronize()
        pool_s.append(time.perf_counter() - t0)

    signals.fill_pool = timed_fill_pool
    try:
        if port_spans:
            profiler.enable()
        cell = harness.load_cell(workload, overrides)
        loop = harness.load_module("loops", cell.traffic["loop"])
        ctx = harness.set_up(cell, seed, seconds, True, device)
        ctx.spans = StampedSpans()
        loop.warm(ctx)
        ctx.dev.sync()
        set_spans, set_counts = profiler.collect()
        out = loop.window(ctx)
        win_spans, win_counts = profiler.collect()
    finally:
        profiler.disable()
        trace.reduce = reduce
        signals.fill_pool = fill_pool
    setup_s = out.t_first - T_START
    kind = torch.cuda.get_device_name(0) if device != "cpu" else "cpu"
    metrics = {k: v["value"] for k, v in trace.per_layer(cell, out, kind).items()}
    nested = spans.nest(events[-1]) if out.prof is not None else None
    probes = [(t0, t1) for name, t0, t1 in ctx.spans.stamps if name == "update.alone"]
    for part in (spans.glue_split(nested), spans.enqueue_split(win_spans, probes),
                 spans.setup_split(set_spans, set_counts, pool_s[0] if pool_s else None)):
        metrics.update(part or {})
    fills = spans.cache_fills(win_spans, win_counts)
    if fills is not None:
        metrics["cache_fills"] = fills
    if any(s.name == "dr14.tp" for s in win_spans):  # 0 where the envelope held
        metrics["truepeak_serial"] = win_counts.get("truepeak.serial", (0, 0.0))[0]
    n_updates = sum(s.name == "r128.update" for s in win_spans)
    if n_updates:
        metrics["seg_share"] = win_counts.get("r128.seg", (0, 0.0))[0] / n_updates
    n_updates = sum(s.name == "sigdist.update" for s in win_spans)
    if n_updates:
        metrics["sigdist_kernel_share"] = (win_counts.get("sigdist.kernel", (0, 0.0))[0]
                                           / n_updates)
    by_span: dict[str, float] = {}
    for s in win_spans:
        by_span[s.name] = by_span.get(s.name, 0.0) + (s.t1 - s.t0) * 1e-9
    alone = ctx.spans.times.get("update.alone", [])
    setup_parts = {"imports": t_run - T_START, "pool": pool_s[0] if pool_s else None}
    for s in set_spans:
        setup_parts[s.name] = setup_parts.get(s.name, 0.0) + (s.t1 - s.t0) * 1e-9
    return {
        "workload": workload, "seed": seed, "port_spans": port_spans,
        "metrics": metrics,
        "enqueue_ms_each": [1e3 * t for t in alone],
        "idle_gaps": nested.idle_gaps() if nested is not None else [],
        "probe_ms": probe_parts(win_spans, probes),
        **device_split(nested),
        "setup_s": setup_s,
        "setup_parts": setup_parts,
        "setup_counts": {k: list(v) for k, v in set_counts.items()},
        "window_counts": {k: v[0] for k, v in win_counts.items()},
        "spans_s": by_span,
        "device": kind if device == "cpu" else f"{kind}; {card()}",
    }


def on_cost(workload: str, rounds: int, device: str = "cuda",
            overrides: dict | None = None) -> dict:
    """ns a span off, on and on under torch.profiler; host ms of update()
    on an idle card with the spans off and on, in turn."""
    def per_span(n=100_000):
        t0 = time.perf_counter_ns()
        for _ in range(n):
            with profiler.span("r128.kernel"):
                pass
        return (time.perf_counter_ns() - t0) / n

    off_ns = per_span()
    profiler.enable()
    on_ns = per_span()
    acts = [torch.profiler.ProfilerActivity.CPU]
    if device != "cpu":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts):
        prof_ns = per_span(10_000)
    profiler.disable()
    profiler.collect()

    cell = harness.load_cell(workload, overrides)
    dev = harness.Device(device)
    system = System(cell.config, device)
    B, C, T = cell.traffic["batch"], cell.config["nchan"], cell.traffic["block"]
    x = 0.1 * torch.randn((B, C, T), device=device)
    state = system.init(B)
    for _ in range(3):
        state = system.update(state, x)
    times = {False: [], True: []}
    for r in range(rounds):
        for on in ((False, True) if r % 2 == 0 else (True, False)):
            if on:
                profiler.enable()
            for _ in range(20):
                dev.sync()
                t0 = time.perf_counter()
                state = system.update(state, x)
                times[on].append(time.perf_counter() - t0)
            profiler.disable()
            profiler.collect()
    dev.sync()
    return {"span_ns": {"off": off_ns, "on": on_ns, "on_profiled": prof_ns},
            "update_ms": {"off": _median_ms(times[False]), "on": _median_ms(times[True])},
            "update_ms_quartiles": {str(k): [1e3 * q for q in statistics.quantiles(v, n=4)]
                                    for k, v in times.items()},
            "calls": {str(k): len(v) for k, v in times.items()}}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="r128_spans")
    ap.add_argument("--workload", default="r128_batch")
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--port-spans", type=int, choices=(0, 1), default=1)
    ap.add_argument("--seed", type=int)
    ap.add_argument("--on-cost", type=int, metavar="ROUNDS")
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("r128_spans: needs a CUDA card", file=sys.stderr)
        return 3
    torch.set_num_threads(1)
    torch.cuda.set_device(0)
    if args.on_cost:
        result = on_cost(args.workload, args.on_cost)
        result["device"] = f"{torch.cuda.get_device_name(0)}; {card()}"
    elif args.seed is None:
        ap.error("--seed is required")
    else:
        result = run(args.workload, args.seed, args.seconds, bool(args.port_spans))
    line = json.dumps(result)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        with open(args.out, "a") as f:
            f.write(line + "\n")
    print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
