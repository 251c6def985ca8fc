"""The port's parity sweep (tools/gpu_parity_check.py) and release gate
(tools/release_check_torch.py) as subprocesses on the CPU, all at once."""

import json
import os
import subprocess
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT = 240


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("torch_tools")
    parity = [sys.executable, "tools/gpu_parity_check.py", "bitmeter", "sigdist", "spectrum",
              "--quick", "--workers", "2"]
    gate = [sys.executable, "tools/release_check_torch.py", "--skip-suite"]
    cmds = {
        "parity_cpu": parity + ["--device", "cpu"],
        "parity_cuda": parity + ["--device", "cuda"],
        "gate_skip_gpu": gate + ["--skip-gpu", "--logdir", str(tmp / "skip")],
        "gate_gpu": gate + ["--logdir", str(tmp / "gpu")],
    }
    procs = {name: subprocess.Popen(cmd, cwd=ROOT, stdout=subprocess.PIPE,
                                    stderr=subprocess.PIPE, text=True)
             for name, cmd in cmds.items()}
    outs = {}
    try:
        for name, p in procs.items():
            try:
                out, err = p.communicate(timeout=TIMEOUT)
            except subprocess.TimeoutExpired:
                p.kill()
                out, err = p.communicate()
                err = f"timed out after {TIMEOUT} s\n{err}"
            outs[name] = (p.returncode, out, err)
    finally:  # an early failure must not leave the others running
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.communicate()
    return outs


def test_parity_check_on_cpu(runs):
    """--device cpu --quick: exit 0, says --quick first, one table line a
    family with every share of a bar <= 1, and the JSON last line."""
    rc, out, err = runs["parity_cpu"]
    assert rc == 0, out + err
    lines = out.strip().splitlines()
    assert "--quick" in lines[0]
    res = json.loads(lines[-1])
    assert res["ok"] is True and res["quick"] is True and res["device"] == "cpu"
    assert set(res["families"]) == {"bitmeter", "sigdist", "spectrum"}
    for fam, legs in res["families"].items():
        assert any(ln.startswith(f"[{fam:11s}] OK") for ln in lines), fam
        for leg in ("golden", "native"):
            assert legs[leg]["ok"] and 0 <= legs[leg]["share"] <= 1, (fam, leg, legs[leg])
        assert legs["golden"]["fixtures"] > 0
        for case in legs["native"]["cases"].values():
            assert case["streams"] == 2
            # CPU tensors run the plain versions: no kernel launches
            assert not any(case["launches"].values())


def test_parity_check_without_card_refuses(runs):
    if torch.cuda.is_available():
        pytest.skip("checks the card-less case")
    rc, out, err = runs["parity_cuda"]
    assert rc not in (0, None)
    assert not any(ln.startswith("{") for ln in out.splitlines()), out
    assert "no CUDA device" in err


def test_release_gate_cpu_steps(runs):
    """--skip-suite --skip-gpu: the CLI step on --cpu passes; every other
    step says SKIPPED, never PASS."""
    rc, out, err = runs["gate_skip_gpu"]
    assert rc == 0, out + err
    rows = {ln.split()[0]: ln.split()[1] for ln in out.splitlines()
            if ln.split() and ln.split()[0] in ("suite", "build", "chip_smoke", "parity", "cli")}
    assert rows == {"suite": "SKIPPED", "build": "SKIPPED", "chip_smoke": "SKIPPED",
                    "parity": "SKIPPED", "cli": "PASS"}, out
    assert "RELEASE GATE (meters_lv2_torch): PASS" in out


def test_release_gate_without_card_fails(runs):
    if torch.cuda.is_available():
        pytest.skip("checks the card-less case")
    rc, out, err = runs["gate_gpu"]
    assert rc == 1, out + err
    assert "RELEASE GATE (meters_lv2_torch): FAIL" in out
    for step in ("build", "chip_smoke", "parity"):
        assert any(ln.split()[:2] == [step, "FAIL"] for ln in out.splitlines()), (step, out)
