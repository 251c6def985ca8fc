"""The port's binding of the native meter engine (``native/engine.cc``).

  * the port's ``NativeEngine`` against the JAX package's binding, every
    one of the 17 kinds on one seeded signal: readouts equal bit for bit
    (both compile ``engine.cc`` with the code-generation flags of
    ``native/Makefile``: -O2 -std=c++17 -fPIC);
  * the port's meters on CPU tensors against the port's engine, every case
    of tests/test_native.py at its bars, through the readout mapping and
    the bars of ``tools/gpu_parity_check.py`` (one copy of each), plus the
    stereo correlation meter at 2e-3;
  * input validation, no compiler, and a second build under the lock that
    rebuilds nothing.

Skips only where no C++ compiler is on PATH.
"""

import os
import shutil
import sys

import numpy as np
import pytest
import torch

from signals import make_signal, make_surround
from meters_lv2_torch.runtime import native

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "tools"))
import gpu_parity_check as gpc  # noqa: E402

torch.set_num_threads(1)

FS = 48000


@pytest.fixture(autouse=True)
def _compiler():
    if shutil.which(os.environ.get("CXX", "g++")) is None:
        pytest.skip("no C++ compiler: the native engine cannot be built")


def _kind_signal(kind, C, T):
    """A tone and noise on each channel, with a silent stretch."""
    rng = np.random.default_rng([20, native.METER_KINDS[kind]])
    t = np.arange(T) / FS
    x = 0.3 * np.sin(2 * np.pi * rng.uniform(50, 12000, (C, 1)) * t) \
        + 0.2 * rng.standard_normal((C, T))
    x[:, T // 3:T // 3 + 2000] = 0.0
    return x.astype(np.float32)


def test_meter_kinds_match_jax():
    from meters_lv2_tpu.runtime import native as jnative

    assert native.METER_KINDS == jnative.METER_KINDS
    assert len(native.METER_KINDS) == 17


@pytest.mark.parametrize("kind", sorted(native.METER_KINDS))
def test_engine_equals_jax_binding(kind):
    """One signal through both bindings' engines, read after every block:
    the readouts are equal bit for bit."""
    from meters_lv2_tpu.runtime import native as jnative

    assert jnative.load() is not None
    arg = {"gonio": 4, "sigdist": 1, "bitmeter": 1, "surround": 5}.get(kind, 2)
    C = 2 if kind == "gonio" else arg
    x = _kind_signal(kind, C, 4000 * 6)
    ours, theirs = native.NativeEngine(kind, FS, arg), jnative.NativeEngine(kind, FS, arg)
    for b in range(6):
        blk = x[:, b * 4000:(b + 1) * 4000]
        ours.process(torch.from_numpy(blk) if b % 2 else blk)
        theirs.process(blk)
        a, j = ours.read(), theirs.read()
        assert a.dtype == np.float64 and a.shape == j.shape
        np.testing.assert_array_equal(a, j, err_msg=f"{kind} read {b}")
    ours.close()
    ours.close()  # idempotent


def _noise(seed, C, T, sigma):
    return (sigma * np.random.default_rng(seed).standard_normal((C, T))).astype(np.float32)


def _dr_signal():
    rng = np.random.default_rng(11)
    T = FS * 10  # > 3 windows so nf > 2
    env = (0.15 + 0.25 * np.sin(2 * np.pi * np.arange(T) / FS / 2.5)) ** 2
    return (env * rng.standard_normal((2, T))).astype(np.float32)


def _phasewheel_signal():
    rng = np.random.default_rng(17)
    t = np.arange(FS) / FS
    base = np.sin(2 * np.pi * 440 * t) + 0.5 * np.sin(2 * np.pi * 1870 * t)
    return np.stack([base + 0.02 * rng.standard_normal(FS),
                     np.roll(base, 7) + 0.02 * rng.standard_normal(FS)]).astype(np.float32)


def _stereoscope_signal():
    rng = np.random.default_rng(19)
    t = np.arange(FS) / FS
    return np.stack([np.sin(2 * np.pi * 440 * t) + 0.05 * rng.standard_normal(FS),
                     0.4 * np.sin(2 * np.pi * 440 * t) + 0.05 * rng.standard_normal(FS)]
                    ).astype(np.float32)


def _cor_signal():
    x = _noise(29, 2, 1024 * 10, 0.3)
    x[1] = 0.6 * x[0] + 0.4 * x[1]
    return x


# tests/test_native.py's cases: id -> (engine kind, stream channels, engine
# nchan argument, signal, block)
CASES = {
    "vu": ("vu", 2, 2, lambda: _noise(7, 2, 1024 * 20, 0.4), 1024),
    "iec1": ("iec1", 2, 2, lambda: _noise(7, 2, 1024 * 20, 0.4), 1024),
    "iec2": ("iec2", 2, 2, lambda: _noise(7, 2, 1024 * 20, 0.4), 1024),
    "kmeter": ("kmeter", 2, 2, lambda: _noise(7, 2, 1024 * 20, 0.4), 1024),
    "truepeak": ("truepeak", 2, 2, lambda: _noise(7, 2, 1024 * 20, 0.4), 1024),
    "r128": ("r128", 2, 2, lambda: make_signal("mix", 12.0), None),
    "spectrum": ("spectrum", 2, 2, lambda: _noise(2, 2, FS, 0.3), None),
    "msppm": ("msppm", 2, 2, lambda: _noise(4, 2, 1024 * 10, 0.4), 1024),
    "sigdist": ("sigdist", 1, 1, lambda: _noise(4, 2, 1024 * 10, 0.4)[:1], None),
    "sigdist_hot": ("sigdist", 1, 1, lambda: make_signal("hot", 2.0)[:1], None),
    "bitmeter": ("bitmeter", 1, 1,
                 lambda: np.array([0.0, 1.5, -0.25, np.nan, np.inf, 1e-42] * 50, np.float32)[None],
                 None),
    "dr14": ("dr14", 2, 2, _dr_signal, FS),
    "tpnrms": ("tpnrms", 2, 2, _dr_signal, FS),
    "gonio_os1": ("gonio", 2, 1, lambda: _noise(13, 2, FS, 0.3), None),
    "gonio_os4": ("gonio", 2, 4, lambda: _noise(13, 2, FS, 0.3), None),
    "phasewheel": ("phasewheel", 2, 2, _phasewheel_signal, None),
    "stereoscope": ("stereoscope", 2, 2, _stereoscope_signal, None),
    "surround": ("surround", 5, 5, lambda: _noise(23, 5, FS * 2, 0.3), FS),
    "stcorr": ("stcorr", 2, 2, _cor_signal, 1024),
}


@pytest.mark.parametrize("case_id", sorted(CASES))
def test_port_meter_matches_engine(case_id):
    """The port's meter on CPU tensors against its own NativeEngine on the
    same blocks, read once at the end, at tests/test_native.py's bars."""
    kind, C, arg, make, block = CASES[case_id]
    x = make()
    block = block or x.shape[1]
    case = gpc.Case(case_id, kind, FS, C, 1, 0, block, 1, arg if kind == "gonio" else 0)
    eng = native.NativeEngine(kind, FS, arg)
    side = gpc.PortSide(case, "cpu")
    for b in range(x.shape[1] // block):
        blk = x[:, b * block:(b + 1) * block]
        eng.process(blk)
        side.update(torch.from_numpy(blk)[None])
    # one read: the engine's goniometer extrema and the port's trace
    # extrema both span the whole stream
    share = float(gpc.compare(case, side.read(), eng.read()[None]).max())
    assert share <= 1.0, (case_id, share)


def test_surround8_and_44k_r128_match_engine():
    """Two shapes tests/test_native.py does not hold: surround8 (four
    pairs over eight channels) and R128 at 44.1 kHz in ragged blocks."""
    x = make_surround("mix", 2.0, nchan=8)
    case = gpc.Case("surround8", "surround", FS, 8, 1, 0, 1000, 1)
    eng, side = native.NativeEngine("surround", FS, 8), gpc.PortSide(case, "cpu")
    for b in range(x.shape[1] // 1000):
        blk = x[:, b * 1000:(b + 1) * 1000]
        eng.process(blk)
        side.update(torch.from_numpy(blk)[None])
    assert gpc.compare(case, side.read(), eng.read()[None]).max() <= 1.0
    x = make_signal("mix", 8.0, fs=44100)
    case = gpc.Case("r128_44k", "r128", 44100, 2, 1, 0, 44100, 1)
    eng, side = native.NativeEngine("r128", 44100, 2), gpc.PortSide(case, "cpu")
    for lo, hi in ((0, 30000), (30000, 100001), (100001, 352800)):
        eng.process(x[:, lo:hi])
        side.update(torch.from_numpy(x[:, lo:hi])[None])
    assert gpc.compare(case, side.read(), eng.read()[None]).max() <= 1.0


def test_process_validates_its_input():
    """A wrong channel count is a ValueError (the C side would read out of
    bounds); a tensor off the host is a TypeError (the caller copies it);
    the engine's own bounds and grain hold."""
    eng = native.NativeEngine("r128", FS, 2)
    with pytest.raises(ValueError):
        eng.process(np.zeros(1000, np.float32))  # mono into a stereo engine
    with pytest.raises(ValueError):
        eng.process(np.zeros((3, 1000), np.float32))
    with pytest.raises(ValueError):
        eng.process(torch.zeros(1, 1000))
    with pytest.raises(TypeError, match="cpu"):
        eng.process(torch.zeros(2, 1000, device="meta"))  # stands in for a card's tensor
    eng.process(torch.zeros(2, 1001))  # a CPU tensor, any length for R128
    gonio = native.NativeEngine("gonio", FS, 8)  # nchan is the oversample factor
    assert gonio.nchan == 2
    gonio.process(np.zeros((2, 64), np.float32))
    with pytest.raises(ValueError):
        native.NativeEngine("r128", FS, 6)  # the gain table covers 5
    with pytest.raises(ValueError):
        native.NativeEngine("surround", FS, 2)
    with pytest.raises(ValueError):
        native.NativeEngine("no-such-kind", FS, 2)
    vu = native.NativeEngine("vu", FS, 2)
    with pytest.raises(RuntimeError):
        vu.process(np.zeros((2, 1001), np.float32))  # the 4-sample grain
    vu.process(np.zeros((2, 1000), np.float32))


def test_no_compiler_raises(tmp_path, monkeypatch):
    """Without a compiler the engine raises, naming build.log; nothing
    falls back."""
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "native")
    monkeypatch.setenv("CXX", "no-such-compiler-for-this-test")
    with pytest.raises(RuntimeError, match="build.log"):
        native.NativeEngine("vu", FS, 2)
    assert "no-such-compiler" in (tmp_path / "native" / "build.log").read_text()


def test_build_is_stamped_and_leaves_native_alone(tmp_path, monkeypatch):
    """engine.cc builds into the given directory with a stamp; a second
    build under the lock rebuilds nothing (it succeeds even with the
    compiler gone); native/ is not written."""
    src = os.path.join(ROOT, "native")
    before = {f: os.stat(os.path.join(src, f)).st_mtime_ns for f in os.listdir(src)}
    lib = native.build_engine(tmp_path)
    assert lib == tmp_path / native.ENGINE_LIB_NAME and lib.exists()
    stamp = (tmp_path / (native.ENGINE_LIB_NAME + ".srchash")).read_text()
    mtime = lib.stat().st_mtime_ns
    monkeypatch.setenv("CXX", "no-such-compiler-for-this-test")
    assert native.build_engine(tmp_path) == lib
    assert lib.stat().st_mtime_ns == mtime
    assert (tmp_path / (native.ENGINE_LIB_NAME + ".srchash")).read_text() == stamp
    after = {f: os.stat(os.path.join(src, f)).st_mtime_ns for f in os.listdir(src)}
    assert after == before
