"""ctypes bindings to the native runtime: the WAV codec (``native/wavio.cc``)
and the streaming meter engine (``native/engine.cc``).

The WAV codec is the port's own loader: ``mt_wav_read``,
``mt_wav_read_batch``, ``mt_wav_write`` and ``mt_free``; without a compiler
callers fall back to the Python parser.

``NativeEngine`` binds the engine: an independent per-stream C++
implementation of all 17 meter kinds (``METER_KINDS``), kept as a
host-side reference that the port is checked against
(``tests/test_torch_native.py``, ``tools/gpu_parity_check.py``).  No meter
and no entry point of the port routes audio to it, and it has no fallback:
without a compiler it raises.

``g++`` compiles each source alone (both include only ``meters_native.h``)
into ``build/meters_lv2_torch/native/`` in the checkout; ``native/`` itself
is never written.  The engine takes the code-generation flags of
``native/Makefile`` (``-O2 -std=c++17 -fPIC``), so its readouts equal the
JAX package's build of the same source bit for bit.  A sidecar holds the
sha256 of the sources and flags, so a library is rebuilt only when they
change.  The builds go through ``runtime/build.py::locked_build``, as the
CUDA kernels' does: an ``fcntl.flock``, the stamp checked again under the
lock, and the library and its stamp moved into place with ``os.replace``,
so no process ever loads a half-written library.  Nothing runs at import
time.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
from pathlib import Path

import numpy as np
import torch

from .build import digest, locked_build

_ROOT = Path(__file__).resolve().parent.parent.parent
SRC_DIR = _ROOT / "native"
BUILD_DIR = _ROOT / "build" / "meters_lv2_torch" / "native"
LIB_NAME = "libmeters_wavio.so"
_SOURCES = ("wavio.cc", "meters_native.h")
CXX_FLAGS = ("-O2", "-std=c++17", "-fPIC", "-shared")
ENGINE_LIB_NAME = "libmeters_engine.so"
_ENGINE_SOURCES = ("engine.cc", "meters_native.h")

# the engine's meter kinds and their mt_meter_kind codes (native/meters_native.h)
METER_KINDS = {
    "vu": 0,
    "iec1": 1,
    "iec2": 2,
    "kmeter": 3,
    "truepeak": 4,
    "stcorr": 5,
    "r128": 6,
    "spectrum": 7,
    "msppm": 8,
    "sigdist": 9,
    "bitmeter": 10,
    "dr14": 11,
    "tpnrms": 12,
    "gonio": 13,  # nchan argument carries the oversample factor (1/2/4/8)
    "phasewheel": 14,
    "stereoscope": 15,
    "surround": 16,
}
# doubles of the largest readout (phasewheel: 1 + 2 * 4096)
_READ_CAP = 1 + 2 * 4096

_lib: ctypes.CDLL | None = None
_tried = False
_engines: dict[Path, ctypes.CDLL] = {}


def build(build_dir: Path = BUILD_DIR) -> Path | None:
    """Compile the WAV codec into ``build_dir`` unless an up-to-date one is
    there; its path, or None if no C++ compiler is found or it fails (the
    compiler's output is then in ``build.log`` there)."""
    build_dir = Path(build_dir)

    def link(tmp: Path) -> bool:
        cxx = shutil.which(os.environ.get("CXX", "g++"))
        if cxx is None:
            return False
        cmd = [cxx, *CXX_FLAGS, "-o", str(tmp), str(SRC_DIR / "wavio.cc"), "-lpthread"]
        r = subprocess.run(cmd, capture_output=True, text=True)
        (build_dir / "build.log").write_text(" ".join(cmd) + "\n" + r.stdout + r.stderr)
        return r.returncode == 0

    want = digest([SRC_DIR / name for name in _SOURCES], CXX_FLAGS)
    return locked_build(build_dir, LIB_NAME, want, link)


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    f32p = ctypes.POINTER(ctypes.c_float)
    lib.mt_wav_read.argtypes = [
        ctypes.c_char_p, ctypes.POINTER(f32p), ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int32),
    ]
    lib.mt_wav_read.restype = ctypes.c_int
    lib.mt_wav_read_batch.argtypes = [
        ctypes.POINTER(ctypes.c_char_p), ctypes.c_int32, ctypes.c_int32,
        ctypes.POINTER(f32p), ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_int32),
    ]
    lib.mt_wav_read_batch.restype = ctypes.c_int
    lib.mt_wav_write.argtypes = [
        ctypes.c_char_p, f32p, ctypes.c_int32, ctypes.c_int64, ctypes.c_int32,
        ctypes.c_int32,
    ]
    lib.mt_wav_write.restype = ctypes.c_int
    lib.mt_free.argtypes = [ctypes.c_void_p]
    lib.mt_free.restype = None
    return lib


def load() -> ctypes.CDLL | None:
    """The loaded WAV codec (built on first call), or None when it is
    unavailable: callers then use the Python parser."""
    global _lib, _tried
    if _lib is None and not _tried:
        _tried = True
        path = build()
        if path is not None:
            _lib = _bind(ctypes.CDLL(str(path)))
    return _lib


def _planar(ptr, nchan: int, nframes: int) -> np.ndarray:
    if nchan * nframes == 0:
        return np.zeros((nchan, nframes), np.float32)
    return np.ctypeslib.as_array(ptr, shape=(nchan * nframes,)).reshape(nchan, nframes).copy()


def _need() -> ctypes.CDLL:
    lib = load()
    if lib is None:
        raise RuntimeError("native WAV library unavailable (no C++ compiler, or it failed)")
    return lib


def wav_read(path: str):
    """Read a WAV file: (data [C, T] float32, rate).  Raises IOError on a
    decode error."""
    lib = _need()
    data = ctypes.POINTER(ctypes.c_float)()
    nchan, nframes, rate = ctypes.c_int32(), ctypes.c_int64(), ctypes.c_int32()
    rc = lib.mt_wav_read(os.fsencode(path), ctypes.byref(data), ctypes.byref(nchan),
                         ctypes.byref(nframes), ctypes.byref(rate))
    if rc != 0:
        raise IOError(f"mt_wav_read({path}) failed: {rc}")
    try:
        return _planar(data, nchan.value, nframes.value), rate.value
    finally:
        lib.mt_free(data)


def wav_read_batch(paths, workers: int = 0):
    """Decode many WAVs on the native thread pool (workers <= 0: one per
    hardware thread).  A list of (data [C, T] float32, rate); raises
    IOError on the first file that failed."""
    lib = _need()
    n = len(paths)
    c_paths = (ctypes.c_char_p * n)(*[os.fsencode(p) for p in paths])
    data = (ctypes.POINTER(ctypes.c_float) * n)()
    nchan = (ctypes.c_int32 * n)()
    nframes = (ctypes.c_int64 * n)()
    rate = (ctypes.c_int32 * n)()
    rc = (ctypes.c_int32 * n)()
    lib.mt_wav_read_batch(c_paths, n, workers, data, nchan, nframes, rate, rc)
    out = []
    try:
        for i in range(n):
            if rc[i] != 0:
                raise IOError(f"mt_wav_read({paths[i]}) failed: {rc[i]}")
            out.append((_planar(data[i], nchan[i], nframes[i]), int(rate[i])))
    finally:
        for i in range(n):
            if data[i]:
                lib.mt_free(data[i])
    return out


def wav_write(path: str, data: np.ndarray, rate: int, format: int = 32):
    """Write planar float32 [C, T] as WAV (format 16 = PCM16, 32 = float32)."""
    lib = _need()
    data = np.ascontiguousarray(data, np.float32)
    if data.ndim != 2:
        raise ValueError(f"expected [C, T] planar audio, got {data.shape}")
    c, t = data.shape
    rc = lib.mt_wav_write(os.fsencode(path), data.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                          c, t, rate, format)
    if rc != 0:
        raise IOError(f"mt_wav_write({path}) failed: {rc}")


def build_engine(build_dir: Path | None = None) -> Path | None:
    """Compile ``native/engine.cc`` alone into ``build_dir`` (default
    ``BUILD_DIR``) unless an up-to-date one is there; its path, or None if
    no C++ compiler is found or it fails (``build.log`` there says which)."""
    build_dir = Path(BUILD_DIR if build_dir is None else build_dir)

    def link(tmp: Path) -> bool:
        cxx_name = os.environ.get("CXX", "g++")
        cxx = shutil.which(cxx_name)
        if cxx is None:
            (build_dir / "build.log").write_text(f"no C++ compiler: {cxx_name} is not on PATH\n")
            return False
        cmd = [cxx, *CXX_FLAGS, "-o", str(tmp), str(SRC_DIR / "engine.cc"), "-lm"]
        r = subprocess.run(cmd, capture_output=True, text=True)
        (build_dir / "build.log").write_text(" ".join(cmd) + "\n" + r.stdout + r.stderr)
        return r.returncode == 0

    want = digest([SRC_DIR / name for name in _ENGINE_SOURCES], CXX_FLAGS)
    return locked_build(build_dir, ENGINE_LIB_NAME, want, link)


def load_engine() -> ctypes.CDLL:
    """The loaded engine library of ``BUILD_DIR`` (built on first call).
    Raises RuntimeError, naming ``build.log``, if it cannot be built."""
    build_dir = Path(BUILD_DIR)
    lib = _engines.get(build_dir)
    if lib is None:
        path = build_engine(build_dir)
        if path is None:
            raise RuntimeError(
                f"cannot build the native meter engine from {SRC_DIR / 'engine.cc'}: see "
                f"{build_dir / 'build.log'}")
        lib = ctypes.CDLL(str(path))
        lib.mt_engine_create.argtypes = [ctypes.c_int, ctypes.c_float, ctypes.c_int]
        lib.mt_engine_create.restype = ctypes.c_void_p
        lib.mt_engine_destroy.argtypes = [ctypes.c_void_p]
        lib.mt_engine_destroy.restype = None
        lib.mt_engine_process.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_float), ctypes.c_int64]
        lib.mt_engine_process.restype = ctypes.c_int
        lib.mt_engine_read.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_double), ctypes.c_int]
        lib.mt_engine_read.restype = ctypes.c_int
        _engines[build_dir] = lib
    return lib


class NativeEngine:
    """One stream of the native meter engine (a host-side reference).

    ``kind`` is a ``METER_KINDS`` key; ``nchan`` the stream's channels, or
    for ``gonio`` the oversample factor (the goniometer is stereo).  The
    engine validates its bounds (R128 up to 5 channels, the analyzers
    stereo, surround 3 to 8): ValueError outside them."""

    def __init__(self, kind: str, fs: float, nchan: int):
        if kind not in METER_KINDS:
            raise ValueError(f"bad meter kind {kind!r}: one of {sorted(METER_KINDS)}")
        self._lib = load_engine()
        self._h = self._lib.mt_engine_create(METER_KINDS[kind], fs, nchan)
        if not self._h:
            raise ValueError(f"the engine refuses {kind} with nchan={nchan}")
        self.kind = kind
        self.nchan = 2 if kind == "gonio" else nchan

    def process(self, x):
        """Feed planar ``[C, T]`` float32 audio, numpy or a CPU tensor; C
        must be the engine's channel count.  A tensor on a card raises
        TypeError: the caller copies it to the host.  Checked here, since
        the C side receives only T and reads C * T floats."""
        if isinstance(x, torch.Tensor):
            if x.device.type != "cpu":
                raise TypeError(f"NativeEngine runs on the host; got a tensor on {x.device} "
                                f"(copy it with .cpu())")
            x = x.detach().numpy()
        x = np.ascontiguousarray(x, np.float32)
        if x.ndim != 2 or x.shape[0] != self.nchan:
            raise ValueError(f"expected [C={self.nchan}, T] planar audio, got {x.shape}")
        rc = self._lib.mt_engine_process(
            self._h, x.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), x.shape[1])
        if rc != 0:
            raise RuntimeError(f"mt_engine_process({self.kind}) failed: {rc}")

    def read(self) -> np.ndarray:
        """The readout as float64, in the kind's layout
        (``native/meters_native.h``).  Like the C reference, reading resets
        the needles' and true peak's maxima and the goniometer's extrema."""
        out = np.zeros(_READ_CAP, np.float64)
        n = self._lib.mt_engine_read(
            self._h, out.ctypes.data_as(ctypes.POINTER(ctypes.c_double)), _READ_CAP)
        if n < 0:
            raise RuntimeError(f"mt_engine_read({self.kind}) failed: {n}")
        return out[:n]

    def close(self) -> None:
        if getattr(self, "_h", None):
            self._lib.mt_engine_destroy(self._h)
            self._h = None

    def __del__(self):
        self.close()
