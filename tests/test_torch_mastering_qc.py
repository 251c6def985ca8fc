"""The mastering QC deployment (``portbench/configs/mastering_stereo_48k.json``)
on CPU tensors: the port's dr14stereo, SigDistHist and bitmeter through
MeterPipeline against the benchmark's float64 plain reference
(``portbench/reference/``), the ``mastering_qc`` cell run whole through
the harness at a tiny size, the spans of the mastering path and the
``truepeak.serial`` counter.

The tolerances are the cell's own limits (``portbench/workloads/
mastering_qc.json``; their two readings are in PERF.md):
  * ``level_db``: the display and accumulated true peak and the DR read of
    the program's own histogram, in dB, and ``rms_db``: the display RMS
    (the K-meter), in dB: float32 evaluations of recurrences the
    reference evaluates in float64;
  * ``dr_moves``, ``sigdist_moves``: histogram points moved beyond the
    float32 rounding of their bin's edge, 0: the histograms are bin-exact
    but for that ambiguity;
  * ``sigdist_rel``: the running sum, mean and var_s against the scale of
    what was summed, float32 accumulation;
  * ``bit_moves``: 0, the bit meter's counts, min and max are exact.
"""

import ast
from pathlib import Path

import numpy as np
import pytest
import torch

import meters_lv2_torch as mt
from meters_lv2_torch.utils import profiler
from portbench import harness, signals
from portbench.reference import compare
from portbench.reference.lti import CONTROL
from portbench.system import System

torch.set_num_threads(1)

FS = 48000
BLOCK = 48000
ROOT = Path(__file__).resolve().parents[1]
CELL = harness.load_cell("mastering_qc")
REFS = harness.reference_modules(CELL.config)
NAMES = harness.judged_names(REFS)
SEED = 2**31 + 2701
# a tiny run of the cell: four 0.1 s updates a programme, three streams
TINY = {"batch": 3, "block": 4800, "pool_blocks": 4, "programme_blocks": 4}


def _meter(x: torch.Tensor) -> dict:
    """The cell's system over x [B, 2, n] in 1 s updates, read once ->
    {"<meter>.<key>": [B, 1, ...]} numpy."""
    system = System(CELL.config, "cpu")
    state = system.init(x.shape[0])
    for i in range(0, x.shape[-1], BLOCK):
        state = system.update(state, x[..., i:i + BLOCK].contiguous())
    outs, _ = system.read(state)
    return {k: v.numpy()[:, None] for k, v in system.readouts(outs, state, NAMES).items()}


def _numbers(port: dict, expected: tuple) -> dict:
    """Each meter's check numbers, as the cell judges them, given the
    reference's (values, kinds) over the same audio: {meter: {number: [B]}}."""
    ref, kinds = expected
    at = {k: np.zeros(1, np.int64) for k in port}
    at.update({f"{m}.state_pos": np.arange(1) for m in REFS})
    out = {}
    for meter, mod in REFS.items():
        mine = {k: v for k, v in kinds.items() if k.startswith(meter + ".")}
        out[meter] = compare.numbers(port, at, ref, mine, {meter: mod})
    return out


def _programmes(batch: int, blocks: int) -> torch.Tensor:
    pool = torch.empty((blocks, batch, 2, BLOCK))
    signals.fill_pool(pool, SEED, FS, CELL.mix)
    return signals.stream_audio(pool, np.arange(batch))


def _full_scale(n: int) -> torch.Tensor:
    """[2, n]: a 997 Hz sine at twice full scale clipped to [-1, 1], then a
    tone at fs/4 and 45 degrees whose samples sit at 0.92 and whose true peak
    is +2.3 dBTP; the right channel the left inverted."""
    t = torch.arange(n, dtype=torch.float64)
    clip = torch.clamp(2.0 * torch.sin(2 * np.pi * 997.0 * t / FS), -1.0, 1.0)
    isp = 1.3 * torch.sin(0.5 * np.pi * (t % 4) + 0.25 * np.pi)
    left = torch.where(t < n // 2, clip, isp).to(torch.float32)
    return torch.stack([left, -left])


@pytest.fixture(scope="module")
def readings():
    """Three 10 s programmes of the cell's mix (up to three DR windows
    each), and three 4 s rows (one DR window each): silence, full scale
    with intersample peaks, and a programme quantised to 16 bits."""
    prog = _programmes(3, 10)
    n = 4 * BLOCK
    pcm16 = torch.clamp(torch.round(prog[1, :, :n] * 32768.0), -32768.0, 32767.0) / 32768.0
    rows = torch.stack([torch.zeros((2, n)), _full_scale(n), pcm16])
    out = {}
    for name, x in (("programme", prog), ("rows", rows)):
        port = _meter(x)
        expected = harness.expected(REFS, x, FS, [x.shape[-1]], BLOCK)
        out[name] = (port, expected, _numbers(port, expected))
    return out


@pytest.mark.parametrize("meter", ["dr14", "sigdist", "bits"])
@pytest.mark.parametrize("case", ["programme", "rows"])
def test_port_against_the_plain_reference(readings, case, meter):
    numbers = readings[case][2][meter]
    assert numbers
    for name, g in numbers.items():
        assert float(g.max()) <= CELL.limits[name], (name, g)


def test_the_readings_are_what_the_rows_hold(readings):
    port, _, _ = readings["rows"]
    prog, _, _ = readings["programme"]
    assert (port["dr14.v_rms"][0] == -80.0).all()  # silence
    assert (port["dr14.dr_total"][0] == 21.0).all() and port["dr14.num_windows"][0, 0] == 0
    assert port["bits.zero"][0, 0] == 4 * BLOCK and port["sigdist.hist_peak_bin"][0, 0] == 180
    assert (port["dr14.m_peak"][1] > 2.0).all()  # past full scale between samples
    assert (port["dr14.hist"][1, 0, :, -1] == 1).all()  # sqrt(2) RMS: the top bin
    assert port["sigdist.hist"][1, 0, 30] > 0 and port["sigdist.hist"][1, 0, 330] > 0
    assert (port["bits.dset"][2, 0, :8] == 0).all()  # 16 bits leave the low mantissa bits clear
    full = prog["dr14.num_windows"][:, 0] == 3
    assert full.any() and (prog["dr14.dr"][full] < 21.0).all()


def _corrupt(port: dict, key: str, fn) -> dict:
    port = dict(port)
    port[key] = fn(port[key].copy())
    return port


def _move_top_point(h):
    s, r, c = 0, 0, 0
    b = int(np.flatnonzero(h[s, r, c])[-1])
    h[s, r, c, b] -= 1
    h[s, r, c, b - 2] += 1
    return h


@pytest.mark.parametrize("key, fn, number", [
    ("dr14.hist", _move_top_point, "dr_moves"),
    ("dr14.m_rms", lambda v: v + 0.01, "level_db"),
    ("dr14.v_rms", lambda v: v + 0.01, "rms_db"),
    ("dr14.v_peak", lambda v: v + 0.01, "level_db"),
    ("dr14.peak_top2", lambda v: v * np.float32(0.999), "dr_moves"),
    ("sigdist.hist", lambda h: np.roll(h, 1, axis=-1), "sigdist_moves"),
    ("sigdist.mean", lambda v: v + 1e-3 * np.abs(v).max() + 1e-4, "sigdist_rel"),
    ("sigdist.hist_var", lambda v: v * 1.001, "sigdist_rel"),
    ("bits.hit", lambda h: h + (np.arange(h.shape[-1]) == 120), "bit_moves"),
    ("bits.max", lambda v: np.nextafter(v, np.float32(2.0)), "bit_moves"),
], ids=lambda v: v if isinstance(v, str) else "")
def test_the_check_sees_a_fault(readings, key, fn, number):
    port, expected, _ = readings["programme"]
    numbers = _numbers(_corrupt(port, key, fn), expected)[key.split(".")[0]]
    assert float(numbers[number].max()) > CELL.limits[number]


def _run(**kw):
    cell = harness.load_cell("mastering_qc", TINY)
    return harness.run_cell(cell, SEED, 0.2, kw.pop("trace", False), device="cpu", **kw)


@pytest.mark.parametrize("trace", [False, True], ids=["untraced", "traced"])
def test_a_tiny_run_of_the_cell_is_correct(trace):
    r = _run(trace=trace)
    assert r["correct"] is True, r["checks"]
    assert set(r["checks"]) == set(CELL.limits)
    if trace:
        assert "enqueue_ms" in r["metrics"]


def test_the_control_is_not_correct():
    r = _run(control=CONTROL)
    assert r["correct"] is True and r["control_correct"] is False, r["control"]


def _unchanged(ctx):
    ctx.system.update = lambda state, x: state


def _off_by_a_hundredth(ctx):
    read = ctx.system.read

    def altered(state):
        outs, st = read(state)
        return dict(outs, dr14=dict(outs["dr14"], m_peak=outs["dr14"]["m_peak"] + 0.01)), st

    ctx.system.read = altered


@pytest.mark.parametrize("fault", [_unchanged, _off_by_a_hundredth],
                         ids=["state_unchanged", "readout_off"])
def test_a_fault_is_not_correct(fault):
    r = _run(fault=fault)
    assert r["correct"] is False and r["failed"] > 0


@pytest.fixture
def spans_on():
    profiler.disable()
    profiler.collect()
    profiler.enable()
    yield
    profiler.disable()
    profiler.collect()


def test_the_mastering_spans_nest(spans_on):
    system = System(CELL.config, "cpu")
    x = 0.1 * torch.randn((2, 2, 4800), generator=torch.Generator().manual_seed(3))
    state = system.update(system.init(2), x)
    system.read(state)
    spans, counters = profiler.collect()
    name = {i: s.name for i, s in enumerate(spans)}
    tree = {(s.name, name.get(s.parent)) for s in spans}
    assert tree == {
        ("pipe.update", None),
        ("pipe.dr14", "pipe.update"), ("pipe.sigdist", "pipe.update"),
        ("pipe.bits", "pipe.update"),
        ("dr14.update", "pipe.dr14"), ("sigdist.update", "pipe.sigdist"),
        ("bitmeter.update", "pipe.bits"),
        ("dr14.km", "dr14.update"), ("dr14.tp", "dr14.update"),
        ("dr14.windows", "dr14.update"), ("dr14.hist", "dr14.update"),
        ("sigdist.hist", "sigdist.update"), ("sigdist.moments", "sigdist.update"),
        ("bitmeter.kernel", "bitmeter.update"),
        ("dr14.read", None),
    }
    assert "truepeak.serial" not in counters  # the envelope holds at 48 kHz


def test_the_spans_are_off_by_default():
    profiler.disable()
    profiler.collect()
    system = System(CELL.config, "cpu")
    state = system.update(system.init(1), torch.zeros((1, 2, 256)))
    system.read(state)
    assert profiler.collect() == ([], {})


def test_truepeak_serial_counts_each_fallback(spans_on):
    # below 4,300 Hz the envelope does not hold: every update's bulk runs the
    # serial body
    m = mt.create("dBTPmono", 4000)
    st = m.init((2,), device="cpu")
    for _ in range(3):
        st = m.update(st, 0.5 * torch.ones((2, 256)))
    assert profiler.collect()[1]["truepeak.serial"][0] == 3


@pytest.mark.parametrize("module", ["dr14stereo", "SigDistHist", "bitmeter"])
def test_the_reference_imports_neither_jax_nor_either_package(module):
    tree = ast.parse((ROOT / "portbench" / "reference" / f"{module}.py").read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
    assert not names & {"jax", "jaxlib", "flax", "meters_lv2_tpu", "meters_lv2_torch"}
    assert names <= {"__future__", "numpy", "torch"}


def test_sigdist_on_the_cpu_takes_the_plain_ops(spans_on):
    from meters_lv2_torch.ops import sigdist_fused

    n0 = sigdist_fused.launch_count
    for oor in (False, True):
        m = mt.create("SigDistHist", FS, reference_oor_count=oor)
        st = m.init((2,), device="cpu")
        x = 0.1 * torch.randn((2, 4800), generator=torch.Generator().manual_seed(5))
        got = m.update(st, x)
        want = m._plain_update(st, x)
        for k in ("hist", "n", "mean", "m2", "total", "time"):
            assert torch.equal(getattr(got, k), getattr(want, k)), k
    spans, counters = profiler.collect()
    assert "sigdist.kernel" not in counters and sigdist_fused.launch_count == n0
    assert {s.name for s in spans} == {"sigdist.update", "sigdist.hist", "sigdist.moments"}


@pytest.mark.parametrize("oor", [False, True], ids=["default", "reference_oor_count"])
def test_sigdist_takes_the_kernel_only_for_a_card_tensor_in_the_default_mode(oor):
    from types import SimpleNamespace

    m = mt.create("SigDistHist", FS, reference_oor_count=oor)
    on_card = SimpleNamespace(device=torch.device("cuda", 0))
    assert m.takes_kernel(on_card) is not oor
    assert m.takes_kernel(torch.zeros(4)) is False


def test_the_span_split_reports_the_sigdist_kernel_share():
    import importlib.util

    spec = importlib.util.spec_from_file_location("r128_spans", ROOT / "tools" / "r128_spans.py")
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    tiny = {"batch": 2, "block": 4800, "pool_blocks": 2, "programme_blocks": 2}
    on = tool.run("mastering_qc", SEED, 0.2, True, device="cpu", overrides=tiny)
    assert on["metrics"]["sigdist_kernel_share"] == 0.0  # the CPU runs the plain ops
    assert {"sigdist.hist", "sigdist.moments"} <= set(on["probe_ms"])
