"""The port's spans and counters (utils/profiler.py) on the R128 path, on
CPU tensors: off by default and recording nothing, the same answers on and
off, the span tree of one update() and one read(), the cache.fill and
r128.seg counters, and the Chrome trace of profiler.trace().

The module state is shared by every test of a worker process, so a fixture
turns the spans off and clears them around each test.
"""

import json
import os
import threading

import numpy as np
import pytest
import torch

from meters_lv2_torch.models.ebur128 import EbuR128Meter
from meters_lv2_torch.utils import profiler

torch.set_num_threads(1)

FS = 48000
UPDATE_PARTS = ["r128.kernel", "r128.fragments", "r128.windows", "r128.hist", "r128.radar"]


@pytest.fixture(autouse=True)
def spans_off():
    profiler.disable()
    profiler.collect()
    yield
    profiler.disable()
    profiler.collect()


def _block(T, B=3, seed=0):
    rng = np.random.default_rng(seed)
    return torch.from_numpy((0.1 * rng.standard_normal((B, 2 * T))).astype(np.float32))


def _run(m, blocks):
    st = m.init((blocks[0].shape[0],), device="cpu")
    for x in blocks:
        st = m.update(st, x, flat=True)
    return st, m.read(st)[0]


def _tree(spans):
    return [(s.name, s.parent, s.id) for s in spans]


def test_off_records_nothing():
    m = EbuR128Meter(FS)
    _run(m, [_block(48000)])
    with profiler.span("r128.update"):
        profiler.count("cache.fill")
    with profiler.counted("cache.fill"):
        pass
    assert profiler.collect() == ([], {})


def test_on_and_off_give_the_same_state_and_readouts():
    blocks = [_block(48000, seed=1), _block(4800, seed=2), _block(100, seed=3)]
    st_off, out_off = _run(EbuR128Meter(FS), blocks)
    profiler.enable()
    st_on, out_on = _run(EbuR128Meter(FS), blocks)
    for f in st_off.__dataclass_fields__:
        assert torch.equal(getattr(st_off, f), getattr(st_on, f)), f
    for k in out_off:
        assert torch.equal(out_off[k], out_on[k]), k


@pytest.mark.parametrize("T, tail", [(48000, False), (4800, True)])
def test_one_update_gives_the_span_tree(T, tail):
    """The meter is built and warmed with spans off, so only the update's
    spans are recorded: r128.update at the top, each part once under it,
    with the update's call number; r128.tail after the kernel only on a
    block that is not a multiple of 128."""
    m = EbuR128Meter(FS)
    st = m.update(m.init((3,), device="cpu"), _block(T), flat=True)
    profiler.enable()
    m.update(st, _block(T, seed=1), flat=True)
    spans, _ = profiler.collect()
    parts = UPDATE_PARTS[:1] + ["r128.tail"] * tail + UPDATE_PARTS[1:]
    assert _tree(spans) == [("r128.update", -1, 0)] + [(p, 0, 0) for p in parts]
    top = spans[0]
    assert all(top.t0 <= s.t0 <= s.t1 <= top.t1 for s in spans)
    assert all(a.t1 <= b.t0 for a, b in zip(spans[1:], spans[2:]))  # in turn


def test_a_short_block_runs_the_tail_alone():
    m = EbuR128Meter(FS)
    profiler.enable()
    m.update(m.init((3,), device="cpu"), _block(100), flat=True)
    spans, _ = profiler.collect()
    assert [s.name for s in spans] == ["r128.update", "r128.tail"] + UPDATE_PARTS[1:]


def test_spans_of_a_call_share_its_number():
    m = EbuR128Meter(FS)
    st = m.init((3,), device="cpu")
    profiler.enable()
    for k in range(3):
        st = m.update(st, _block(48000, seed=k), flat=True)
    m.read(st)
    m.read(st)
    spans, _ = profiler.collect()
    tops = [(s.name, s.id) for s in spans if s.parent < 0]
    assert tops == [("r128.update", 0), ("r128.update", 1), ("r128.update", 2),
                    ("r128.read", 0), ("r128.read", 1)]
    for s in spans:
        if s.parent >= 0:
            assert spans[s.parent].parent == -1 and s.id == spans[s.parent].id
            assert spans[s.parent].t0 <= s.t0 <= s.t1 <= spans[s.parent].t1


def test_read_gives_one_span_and_design_one_at_construction():
    profiler.enable()
    m = EbuR128Meter(FS)
    st = m.init((3,), device="cpu")
    m.read(st)
    spans, counters = profiler.collect()
    assert _tree(spans) == [("r128.design", -1, 0), ("r128.read", -1, 0)]
    assert all(s.t1 >= s.t0 > 0 for s in spans)
    assert counters["cache.fill"][0] == 1  # read()'s bin powers


def test_cache_fill_counts_a_cold_meter_and_not_a_warm_one():
    profiler.enable()
    m = EbuR128Meter(FS)
    st = m.update(m.init((3,), device="cpu"), _block(4800), flat=True)
    m.read(st)
    _, cold = profiler.collect()
    n, secs = cold["cache.fill"]
    # the block operators and their tensors, the gains, the bin powers
    assert n >= 4 and secs > 0
    st = m.update(st, _block(4800, seed=1), flat=True)
    m.read(st)
    _, warm = profiler.collect()
    assert "cache.fill" not in warm


@pytest.mark.parametrize("T, seg", [(48000, True), (2560, True), (4800, False), (100, False)])
def test_r128_seg_counts_the_updates_that_take_seg_mode(T, seg):
    """One r128.seg an update whose block is a whole number of 128-sample
    blocks, none for a block with a tail or one shorter than 128."""
    m = EbuR128Meter(FS)
    st = m.update(m.init((3,), device="cpu"), _block(T), flat=True)
    profiler.enable()
    for k in range(3):
        st = m.update(st, _block(T, seed=k + 1), flat=True)
    _, counters = profiler.collect()
    assert counters.get("r128.seg") == ((3, 0.0) if seg else None)


def test_collect_clears():
    profiler.enable()
    with profiler.span("a"):
        with profiler.span("b"):
            profiler.count("c", 0.25)
            profiler.count("c", 0.25)
    spans, counters = profiler.collect()
    assert _tree(spans) == [("a", -1, 0), ("b", 0, 0)] and counters == {"c": (2, 0.5)}
    assert profiler.collect() == ([], {})
    with profiler.span("a"):  # numbering starts again
        pass
    assert _tree(profiler.collect()[0]) == [("a", -1, 0)]


def test_threads_do_not_nest_into_each_other():
    profiler.enable()
    inside, done = threading.Event(), threading.Event()

    def other():
        inside.wait(5)
        with profiler.span("other"):
            pass
        done.set()

    t = threading.Thread(target=other)
    t.start()
    with profiler.span("main"):
        inside.set()
        assert done.wait(5)
    t.join(5)
    assert not t.is_alive()
    spans, _ = profiler.collect()
    assert sorted((s.name, s.parent) for s in spans) == [("main", -1), ("other", -1)]


def test_threads_nesting_at_once_keep_their_parents_and_numbers():
    profiler.enable()
    n_threads, calls = 4, 200
    start = threading.Barrier(n_threads)

    def work():
        start.wait(5)
        for _ in range(calls):
            with profiler.span("top"):
                with profiler.span("mid"):
                    with profiler.span("leaf"):
                        pass

    ts = [threading.Thread(target=work) for _ in range(n_threads)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(30)
    assert not any(t.is_alive() for t in ts)
    spans, _ = profiler.collect()
    assert len(spans) == 3 * n_threads * calls
    tops = sorted(s.id for s in spans if s.name == "top")
    assert tops == list(range(n_threads * calls))
    up = {"top": None, "mid": "top", "leaf": "mid"}
    for s in spans:
        if up[s.name] is None:
            assert s.parent == -1
        else:
            p = spans[s.parent]
            assert p.name == up[s.name] and p.id == s.id
            assert p.t0 <= s.t0 <= s.t1 <= p.t1


def test_a_span_opened_after_a_mid_call_collect_has_no_parent():
    profiler.enable()
    with profiler.span("a"):
        with profiler.span("b"):
            pass
        profiler.collect()
        with profiler.span("c"):
            with profiler.span("d"):
                pass
    # "a" closed after the collect and is dropped; "c" lost its parent
    assert _tree(profiler.collect()[0]) == [("c", -1, 0), ("d", 0, 0)]


def test_trace_writes_the_spans_as_annotations(tmp_path):
    m = EbuR128Meter(FS)
    st = m.update(m.init((3,), device="cpu"), _block(48000), flat=True)
    d = str(tmp_path / "trace")
    with profiler.trace(d):
        m.read(m.update(st, _block(48000, seed=1), flat=True))
    (name,) = os.listdir(d)
    with open(os.path.join(d, name)) as f:
        events = json.load(f)["traceEvents"]
    ann = [e for e in events if e.get("cat") == "user_annotation"]
    names = [e["name"] for e in ann]
    assert names.count("r128.update") == 1 and names.count("r128.read") == 1
    for p in UPDATE_PARTS:
        assert names.count(p) == 1, p
    (up,) = [e for e in ann if e["name"] == "r128.update"]
    for e in ann:
        if e["name"] in UPDATE_PARTS:
            assert up["ts"] <= e["ts"] and e["ts"] + e["dur"] <= up["ts"] + up["dur"]
    # off again after, with nothing left in memory
    assert profiler.collect() == ([], {})
    m.update(st, _block(48000), flat=True)
    assert profiler.collect() == ([], {})
