"""One tiny run of each cell's loop on CPU tensors prints a result of the
contract's shape, traced and untraced."""

import json

import pytest

from portbench import harness

TINY = {
    "r128_batch": {"batch": 6, "block": 4800, "pool_blocks": 4, "programme_blocks": 4},
    "qc_batch": {"batch": 4, "block": 4800, "pool_blocks": 3, "programme_blocks": 3},
}
E2E = {"r128_batch": "xrt", "qc_batch": "xrt"}
# long enough on CPU tensors for a finished programme, and traced for the
# second programme
SECONDS = {"r128_batch": (0.3, 0.6), "qc_batch": (1.5, 3.0)}


@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("cell", sorted(TINY))
def test_tiny_run(cell, trace):
    c = harness.load_cell(cell, TINY[cell])
    r = harness.run_cell(c, 2**31 + 99, SECONDS[cell][trace], bool(trace), device="cpu")
    json.dumps(r)  # one JSON object
    keys = list(r)
    assert keys[:3] == ["correct", "attempted", "failed"] and keys[-1] == "checks"
    assert r["correct"] is True and r["failed"] == 0 and r["attempted"] > 0
    for name, chk in r["checks"].items():
        assert chk["value"] <= chk["limit"], name
    dev = r["device"]
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(dev)
    if trace:
        assert "busy_s" in dev and "window_s" in dev and dev["window_s"] > 0
        assert set(r["breakdown"]) == {"device_ops", "idle_gaps"}
        assert all(len(v) <= 10 for v in r["breakdown"].values())
        assert E2E[cell] not in r["metrics"] and "setup_s" not in r["metrics"]
        assert r["metrics"]["enqueue_ms"]["unit"] == "ms"
    else:
        assert set(r["metrics"]) == {E2E[cell], "setup_s"}
        assert r["metrics"][E2E[cell]]["value"] > 0
