"""One run of one cell: set-up, the loop's window, the check, the result.

``run_cell`` is what ``run.py`` calls on a card and what the CPU tests call
at a tiny size with ``device="cpu"``.  Set-up makes the cell's system and
its pool of audio from the seed and warms the cell's own shapes; the loop
kind named by the traffic file times its window; after the window the
program's answers for a sample of streams drawn from the seed are judged
against the plain reference, which runs once the program's pool and state
are freed.
"""

from __future__ import annotations

import contextlib
import dataclasses
import importlib
import importlib.util
import json
import sys
import time
from pathlib import Path

import numpy as np
import torch

from . import signals
from .reference import compare
from .reference.lti import REFERENCE, Prec

ROOT = Path(__file__).resolve().parent

# top-level module names that must never be loaded by a run
FORBIDDEN = ("jax", "jaxlib", "flax", "meters_lv2_tpu")


def load_json(kind: str, name: str) -> dict:
    path = ROOT / kind / f"{name}.json"
    if not path.is_file():
        raise SystemExit(f"portbench: no {kind[:-1] if kind.endswith('s') else kind} "
                         f"named {name!r} ({path.relative_to(ROOT.parent)})")
    return json.loads(path.read_text())


def load_module(kind: str, name: str):
    """portbench/<kind>/<name>.py as a module (names may hold dots)."""
    path = ROOT / kind / f"{name}.py"
    if not path.is_file():
        raise SystemExit(f"portbench: no {path.relative_to(ROOT.parent)}")
    spec = importlib.util.spec_from_file_location(f"portbench_{kind}_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def forbidden_loaded() -> list[str]:
    """Top-level names of FORBIDDEN modules in sys.modules, compared whole."""
    return sorted({m.split(".", 1)[0] for m in list(sys.modules)} & set(FORBIDDEN))


@dataclasses.dataclass
class Cell:
    name: str
    workload: dict
    config: dict
    traffic: dict
    mix: dict
    chips: int

    @property
    def limits(self) -> dict:
        return self.workload.get("limits", {})


def load_cell(name: str, overrides: dict | None = None) -> Cell:
    """The cell's files; ``overrides`` replaces traffic keys (the tests'
    tiny sizes)."""
    w = load_json("workloads", name)
    traffic = dict(load_json("traffic", w["traffic"]), **(overrides or {}))
    return Cell(name, w, load_json("configs", w["config"]), traffic,
                load_json("mixes", traffic["signal"]), int(w["chips"]))


def sample_streams(seed: int, batch: int, count: int) -> np.ndarray:
    """``count`` streams drawn from the seed, one from each of ``count``
    equal strata of the batch, so every part of the batch is judged."""
    count = min(count, batch)
    rng = np.random.default_rng([seed % (1 << 64), 0xC4EC])
    edges = np.linspace(0, batch, count + 1).astype(np.int64)
    return np.array([rng.integers(lo, hi) for lo, hi in zip(edges[:-1], edges[1:])])


class Spans:
    """Host-clock spans around calls into the port, kept in memory; while
    ``profiling`` they are also profiler annotations."""

    def __init__(self, enabled: bool):
        self.enabled = enabled
        self.profiling = False
        self.times: dict[str, list[float]] = {}

    @contextlib.contextmanager
    def __call__(self, name: str):
        if not self.enabled:
            yield
            return
        rf = torch.profiler.record_function(name) if self.profiling else contextlib.nullcontext()
        t0 = time.perf_counter()
        with rf:
            yield
        if not self.profiling:
            self.times.setdefault(name, []).append(time.perf_counter() - t0)


class Device:
    """Synchronisation, events and host buffers for a card or the CPU."""

    def __init__(self, device):
        self.device = torch.device(device)
        self.cuda = self.device.type == "cuda"

    def sync(self):
        if self.cuda:
            torch.cuda.synchronize(self.device)

    def mark(self):
        """An event recorded on the current stream (None on the CPU, where
        every operation has finished when it returns)."""
        if not self.cuda:
            return None
        ev = torch.cuda.Event()
        ev.record()
        return ev

    @staticmethod
    def wait(ev):
        if ev is not None:
            ev.synchronize()

    def host_like(self, t: torch.Tensor) -> torch.Tensor:
        return torch.empty(t.shape, dtype=t.dtype, pin_memory=self.cuda)


@dataclasses.dataclass
class Context:
    """What a loop kind gets from set-up."""

    cell: Cell
    system: object
    pool: torch.Tensor  # [P, B, C, T]
    sample: np.ndarray  # [S] stream indices the check judges
    names: dict  # meter -> (readout keys, state keys) the reference judges
    seconds: float
    trace: bool
    dev: Device
    spans: Spans

    @property
    def batch(self) -> int:
        return self.pool.shape[1]

    @property
    def block(self) -> int:
        return self.pool.shape[3]


@dataclasses.dataclass
class LoopOut:
    """What a loop kind hands back once its window has closed."""

    t_first: float  # host clock at the first timed block
    e2e: dict  # name -> (value, unit)
    answers: dict  # "<meter>.<key>" -> [S, R', ...] numpy
    at: dict  # "<meter>.<key>" -> [R'] index into reads each answer answers;
    # "<meter>.state_pos" -> where in the readouts' R' the state leaves were taken
    reads: list  # sample counts of each stream at each read, ascending
    samples: int  # each judged stream's samples the reference replays
    attempted: int  # stream-blocks submitted in the window
    prof: object = None  # trace.TraceData of the traced stretch
    host: dict = dataclasses.field(default_factory=dict)  # span -> [s], untraced


def reference_modules(config: dict) -> dict:
    """The plain reference of each meter: portbench/reference/<kind>.py."""
    return {name: importlib.import_module(f"portbench.reference.{m['kind']}")
            for name, m in config["meters"].items()}


def judged_names(refs: dict) -> dict:
    return {name: (list(r.READOUTS), list(r.STATE)) for name, r in refs.items()}


def expected(refs: dict, x: torch.Tensor, fs: int, reads: list, block: int,
             prec: Prec = REFERENCE) -> tuple[dict, dict]:
    """({"<meter>.<key>": [S, R, ...] numpy}, {key: kind}) of the reference
    over x [S, C, n] read after ``reads`` samples: every output of each
    meter's module, and the kinds of those the program answers."""
    vals, kinds = {}, {}
    for name, r in refs.items():
        for k, v in r.expected(x, fs, reads, prec, block).items():
            vals[f"{name}.{k}"] = v.detach().cpu().numpy()
        for k, kind in {**r.READOUTS, **r.STATE}.items():
            kinds[f"{name}.{k}"] = kind
    return vals, kinds


def set_up(cell: Cell, seed: int, seconds: float, trace: bool, device) -> Context:
    from .system import System

    tr = cell.traffic
    system = System(cell.config, device)
    P, B, T = tr["pool_blocks"], tr["batch"], tr["block"]
    pool = torch.empty((P, B, cell.config["nchan"], T), dtype=torch.float32, device=device)
    signals.fill_pool(pool, seed, cell.config["fs"], cell.mix)
    refs = reference_modules(cell.config)
    ctx = Context(cell, system, pool, sample_streams(seed, B, cell.workload["sample_streams"]),
                  judged_names(refs), seconds, trace, Device(device), Spans(trace))
    if trace:  # the profiler's own start-up (CUPTI) belongs to set-up
        from .trace import Profile

        with Profile(ctx):
            torch.zeros(1, device=device).add_(1)
    return ctx


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, device="cuda",
             t_start: float | None = None, control: Prec | None = None,
             fault=None) -> dict:
    """One run; returns the result object (with ``checks`` last).  With
    ``control`` the result also holds ``control``: the numbers the check
    gives when the reference in that precision stands in the program's
    place, and ``control_correct``: the verdict the cell's limits give on
    them.  ``fault(ctx)`` may break the timed path underneath (the tests)."""
    t_start = time.perf_counter() if t_start is None else t_start
    loop = load_module("loops", cell.traffic["loop"])
    ctx = set_up(cell, seed, seconds, trace, device)
    if fault is not None:
        fault(ctx)
    loop.warm(ctx)
    ctx.dev.sync()
    out: LoopOut = loop.window(ctx)
    setup_s = out.t_first - t_start
    dev = ctx.dev
    peak = torch.cuda.max_memory_allocated(dev.device) if dev.cuda else 0
    kind = torch.cuda.get_device_name(dev.device) if dev.cuda else "cpu"

    # the check: the sample's audio, then the program's memory freed
    P = ctx.pool.shape[0]
    cycles = -(-out.samples // (P * ctx.block))
    x = signals.stream_audio(ctx.pool, ctx.sample, cycles)[..., :out.samples]
    fs, block = cell.config["fs"], ctx.block
    del ctx.pool, ctx.system
    ctx = None
    if dev.cuda:
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    refs = reference_modules(cell.config)
    ref, kinds = expected(refs, x, fs, out.reads, block)
    per_stream = compare.numbers(out.answers, out.at, ref, kinds, refs)
    detail = {k: float(v.max()) for k, v in
              compare.gaps(out.answers, out.at, ref, kinds).items()}
    correct, checks, failed = compare.judge(per_stream, cell.limits)
    if control is not None:  # the control answers the same reads
        ctl, _ = expected(refs, x, fs, out.reads, block, control)
        ctl = {k: ctl[k][:, out.at[k]] for k in out.answers}
        control_gaps = {k: float(v.max()) for k, v in
                        compare.gaps(ctl, out.at, ref, kinds).items()}
        ctl = compare.numbers(ctl, out.at, ref, kinds, refs)
        control_numbers = {k: float(v.max()) for k, v in ctl.items()}
        control_correct, _, _ = compare.judge(ctl, cell.limits)

    check_s = time.perf_counter() - t_check
    result = {"correct": correct, "attempted": out.attempted, "failed": failed,
              "check_s": check_s}
    if trace:
        from .trace import per_layer

        metrics = per_layer(cell, out, kind)
    else:
        metrics = {name: {"value": v, "unit": u} for name, (v, u) in out.e2e.items()}
        metrics["setup_s"] = {"value": setup_s, "unit": "s"}
    result["metrics"] = metrics
    device_info = {"platform": "gpu" if dev.cuda else "cpu", "kind": kind, "count": 1,
                   "memory_peak_bytes": int(peak)}
    result["device"] = device_info
    if trace and out.prof is not None:
        device_info["busy_s"] = out.prof.busy_s
        device_info["window_s"] = out.prof.window_s
        result["breakdown"] = out.prof.breakdown()
    if control is not None:
        result["control_correct"] = control_correct
        result["control"] = control_numbers
        result["control_gaps"] = control_gaps
    result["gaps"] = detail  # each readout's widest gap, ahead of the numbers
    result["checks"] = checks
    return result
