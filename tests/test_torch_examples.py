"""Run the port's examples (examples/torch_*.py) as real subprocesses on
the CPU (--cpu), all three at once, and check the lines that
tests/test_examples.py checks in the JAX package's examples."""

import os
import subprocess
import sys

import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXAMPLES = os.path.join(ROOT, "examples")
TIMEOUT = 240


@pytest.fixture(scope="module")
def outputs(tmp_path_factory):
    from meters_lv2_torch.io.wav import write_wav

    tmp = tmp_path_factory.mktemp("torch_examples")
    # 6 s each: the gated integrated loudness needs >= 50 M-points (5 s),
    # so shorter files would read -200 LUFS and mask a regression
    rng = np.random.default_rng(7)
    wavs = []
    for i in range(2):
        p = str(tmp / f"ex{i}.wav")
        write_wav(p, (0.2 * rng.standard_normal((2, 6 * 48000))).astype(np.float32), 48000)
        wavs.append(p)
    runs = {
        "batch_loudness": [os.path.join(EXAMPLES, "torch_batch_loudness.py"), *wavs],
        "streaming_monitor": [os.path.join(EXAMPLES, "torch_streaming_monitor.py")],
        "sharded_analysis": [os.path.join(EXAMPLES, "torch_sharded_analysis.py")],
    }
    procs = {name: subprocess.Popen([sys.executable, *args, "--cpu"], cwd=ROOT,
                                    stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for name, args in runs.items()}
    outs = {}
    try:
        for name, p in procs.items():
            try:
                out, _ = p.communicate(timeout=TIMEOUT)
            except subprocess.TimeoutExpired:
                p.kill()
                out, _ = p.communicate()
                out = f"timed out after {TIMEOUT} s\n{out}"
            outs[name] = (p.returncode, out)
    finally:  # an early failure must not leave the other examples running
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.communicate()
    return outs


def _ok(outputs, name):
    rc, out = outputs[name]
    assert rc == 0, f"{name} failed:\n{out[-3000:]}"
    return out


def test_batch_loudness(outputs):
    out = _ok(outputs, "batch_loudness")
    # both files loud enough for a finite gated I (about -8 LUFS)
    assert out.count("ADJUST") + out.count("PASS") == 2, out
    assert "-200.00" not in out, out
    assert "on cpu" in out


def test_streaming_monitor(outputs):
    out = _ok(outputs, "streaming_monitor")
    assert "final:" in out and "radar -> 240" in out, out
    # 240 s a revolution over the radar's 360 points at 48 kHz
    assert "radar interval = 32000 samples" in out, out


def test_sharded_analysis(outputs):
    out = _ok(outputs, "sharded_analysis")
    assert "stream 7:" in out and "checkpointed + restored" in out, out
    assert "4 ranks on cpu (gloo)" in out, out
    assert "-200.00" not in out, out

