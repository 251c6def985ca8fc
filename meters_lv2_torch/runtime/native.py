"""ctypes bindings to the native WAV codec (``native/wavio.cc``).

The port's own loader, for WAV I/O only: it binds ``mt_wav_read``,
``mt_wav_read_batch``, ``mt_wav_write`` and ``mt_free``.  The native meter
engine (``native/engine.cc``) stays a host-side cross-check of the JAX
package and is not bound here.

``g++`` compiles ``native/wavio.cc`` alone (it includes only
``meters_native.h``) into ``build/meters_lv2_torch/native/`` in the
checkout; ``native/`` itself is never written.  A sidecar holds the sha256
of the sources and flags, so the library is rebuilt only when they change.
The build goes through ``runtime/build.py::locked_build``, as the CUDA
kernels' does: an ``fcntl.flock``, the stamp checked again under the lock,
and the library and its stamp moved into place with ``os.replace``, so no
process ever loads a half-written library.  Nothing runs at import time.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
from pathlib import Path

import numpy as np

from .build import digest, locked_build

_ROOT = Path(__file__).resolve().parent.parent.parent
SRC_DIR = _ROOT / "native"
BUILD_DIR = _ROOT / "build" / "meters_lv2_torch" / "native"
LIB_NAME = "libmeters_wavio.so"
_SOURCES = ("wavio.cc", "meters_native.h")
CXX_FLAGS = ("-O2", "-std=c++17", "-fPIC", "-shared")

_lib: ctypes.CDLL | None = None
_tried = False


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
