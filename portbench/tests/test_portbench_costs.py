"""The kernels' counts reproduce PERF.md's bounds at B=256, T=48000."""

import pytest

from portbench import harness


def test_r128_at_256():
    flops, nbytes = harness.load_module("costs", "r128_fused").count(256, 2, 48000)
    assert round(flops / 1e9, 1) == 10.0
    assert flops / 67e12 > nbytes / 3.35e12  # bound by the operations: 0.149 ms
    assert flops / 67e12 * 1e3 == pytest.approx(0.149, abs=5e-4)


def test_spectrum_at_256():
    flops, nbytes = harness.load_module("costs", "spectrum_fused").count(256, 48000)
    assert round(flops / 1e9, 1) == 24.0
    assert flops / 67e12 * 1e3 == pytest.approx(0.358, abs=5e-4)
    # the 49.2 MB of input PERF.md names, and the band states in and out
    assert nbytes / 1e6 == pytest.approx(49.2 + 256 * 30 * 27 * 4 / 1e6, abs=0.05)


def test_truepeak_at_512_rows():
    flops, nbytes = harness.load_module("costs", "truepeak_fused").count(512, 48000)
    assert round(flops / 1e9, 1) == 10.4
    assert flops / 67e12 * 1e3 == pytest.approx(0.156, abs=5e-4)


def test_envelope_at_512_rows():
    flops, nbytes = harness.load_module("costs", "ballistics_env").count(512, 48000)
    assert nbytes / 3.35e12 > flops / 67e12  # bound by the bytes
    assert nbytes / 3.35e12 * 1e3 == pytest.approx(0.029, abs=5e-4)
