"""The readers of the program's spans (portbench/spans.py) on synthetic
traces, and one tiny run of tools/r128_spans.py on CPU tensors."""

import importlib.util

import pytest
import torch

from portbench import spans
from portbench.harness import ROOT

torch.set_num_threads(1)

KERNEL = "void (anonymous namespace)::r128_fused_kernel<2, false, 4>(...)"


def _x(cat, name, ts, dur, corr=None):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def _trace(port=True):
    """One harness update holding the port's update, its fragments part,
    and three launches: glue in the fragments, the kernel, glue after the
    fragments ended; then a read with one launch."""
    ev = [
        _x("user_annotation", "update", 0, 100),
        _x("cuda_runtime", "cudaLaunchKernel", 15, 1, 1),
        _x("cuda_driver", "cuLaunchKernel", 35, 1, 3),
        _x("cuda_runtime", "cudaLaunchKernel", 40, 1, 2),
        _x("kernel", "elementwise_kernel", 50, 10, 1),
        _x("kernel", KERNEL, 60, 5, 3),
        _x("kernel", "reduce_kernel", 70, 5, 2),
        _x("user_annotation", "read", 100, 20),
        _x("cuda_runtime", "cudaLaunchKernel", 110, 1, 4),
        _x("kernel", "where", 130, 4, 4),
    ]
    if port:
        ev += [_x("user_annotation", "r128.update", 1, 90),
               _x("user_annotation", "r128.fragments", 10, 20),
               _x("user_annotation", "r128.read", 105, 10)]
    return ev


def test_innermost_picks_the_last_opened_of_the_enclosing():
    ann = [("a", 0, 100), ("b", 10, 20), ("c", 12, 3), ("d", 200, 5)]
    assert spans.innermost(ann, [5, 10, 13, 15, 29.9, 30, 100, 150, 202]) == [
        "a", "b", "c", "b", "b", "a", None, None, "d"]


def test_a_gap_after_a_child_goes_to_its_parent():
    n = spans.nest(_trace())
    # 0-50 in update's own span, 65-70 inside r128.update after its
    # fragments part ended, 75-130 in read and its r128.read, 134-... none
    assert [g[0] for g in n.gaps] == ["update", "r128.update", "r128.update"]
    assert n.gaps[0][1] == pytest.approx(50e-6)
    assert n.gaps[1][1] == pytest.approx(5e-6)


def test_device_ops_go_to_the_span_of_their_launch():
    n = spans.nest(_trace())
    assert [(o[0], o[3]) for o in n.device_ops] == [
        ("elementwise_kernel", "r128.fragments"), (KERNEL, "r128.update"),
        ("reduce_kernel", "r128.update"), ("where", "r128.read")]


def test_an_op_without_its_launch_has_no_span():
    ev = [e for e in _trace() if e.get("args", {}).get("correlation") != 2
          or e["cat"] != "cuda_runtime"]
    n = spans.nest(ev)
    assert [o[3] for o in n.device_ops] == ["r128.fragments", "r128.update", None, "r128.read"]


def test_glue_split_by_part_sums_to_the_glue():
    g = spans.glue_split(spans.nest(_trace()))
    assert g == pytest.approx({"glue_ms.fragments": 0.010, "glue_ms.windows": 0.0,
                               "glue_ms.hist": 0.0, "glue_ms.radar": 0.0,
                               "glue_ms.read": 0.004, "glue_ms.other": 0.005})
    # the benchmark's glue_ms over the same trace: all but the kernel
    assert sum(g.values()) == pytest.approx((10 + 5 + 4) * 1e-3)


def test_enqueue_split_over_the_updates_timed_alone():
    sp = [("r128.update", -1, 0, 0, 1_000_000), ("r128.kernel", 0, 0, 100, 600_100),
          ("r128.update", -1, 1, 2_000_000, 4_000_000), ("r128.kernel", 2, 1, 2_000_100, 2_500_100),
          ("r128.fragments", 2, 1, 2_600_000, 2_700_000),
          ("r128.update", -1, 2, 5_000_000, 8_000_000), ("r128.kernel", 5, 2, 5_000_100, 5_700_100)]
    # the first update ran in the traced programme, not alone
    e = spans.enqueue_split(sp, [(1_900_000, 4_100_000), (4_900_000, 8_100_000)])
    assert e == pytest.approx({"enqueue_ms.kernel": 0.6, "enqueue_ms.glue": 1.9})


def test_setup_split():
    sp = [("r128.design", -1, 0, 0, 2_000_000), ("build.load", -1, 0, 5_000_000, 9_000_000),
          ("build.compile", 1, 0, 5_000_001, 8_000_000)]
    s = spans.setup_split(sp, {"cache.fill": (6, 0.25)}, 1.5)
    assert s == pytest.approx({"setup_s.library": 0.004, "setup_s.design": 0.252,
                               "setup_s.pool": 1.5})


def test_readers_find_nothing_without_the_programs_spans():
    assert spans.glue_split(spans.nest(_trace(port=False))) is None
    assert spans.glue_split(None) is None
    assert spans.enqueue_split([], [(0, 10)]) is None
    assert spans.setup_split([], {}, None) == {}
    assert spans.cache_fills([], {}) is None
    assert spans.cache_fills([("r128.update", -1, 0, 0, 1)], {}) == 0


def test_tiny_cpu_run_of_the_span_split():
    spec = importlib.util.spec_from_file_location("r128_spans", ROOT.parent / "tools" /
                                                  "r128_spans.py")
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    tiny = {"batch": 6, "block": 4800, "pool_blocks": 4, "programme_blocks": 4}
    on = tool.run("r128_batch", 2**31 + 99, 0.6, True, device="cpu", overrides=tiny)
    m = on["metrics"]
    assert m["cache_fills"] == 0
    assert 0 < m["enqueue_ms.kernel"] < m["enqueue_ms"]
    assert m["enqueue_ms.glue"] > 0 and m["setup_s.design"] > 0 and m["setup_s.pool"] > 0
    assert {"r128.update", "r128.kernel", "r128.tail", "r128.read"} <= set(on["spans_s"])
    assert len(on["enqueue_ms_each"]) == 20
    assert set(on["probe_ms"]) == {"r128.kernel", "r128.tail", "r128.fragments", "r128.windows",
                                   "r128.hist", "r128.radar", "self"}
    assert on["setup_parts"]["r128.design"] > 0 and on["setup_parts"]["pool"] > 0
    off = tool.run("r128_batch", 2**31 + 99, 0.6, False, device="cpu", overrides=tiny)
    assert off["spans_s"] == {} and "cache_fills" not in off["metrics"]
    assert not any(k.startswith(("enqueue_ms.", "setup_s.design")) for k in off["metrics"])
    cost = tool.on_cost("r128_batch", 1, device="cpu", overrides={"batch": 2, "block": 4800})
    assert cost["calls"] == {"False": 20, "True": 20}
    assert 0 < cost["span_ns"]["off"] < cost["span_ns"]["on"] < cost["span_ns"]["on_profiled"]
