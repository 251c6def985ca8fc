"""Build and load the port's CUDA kernels at first use.

``nvcc`` compiles every ``meters_lv2_torch/csrc/*.cu`` for ``sm_90a`` into
one shared library with a plain C interface,
``build/meters_lv2_torch/libmeters_torch_kernels.so`` in the checkout, and
``ctypes`` loads it.  A sidecar file holds the sha256 of the sources and
flags, so the library is rebuilt only when they change; an ``fcntl.flock``
serialises concurrent builds.  Nothing here runs at import time: a machine
without ``nvcc`` can import the package and use the plain CPU versions.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "meters_lv2_torch"
LIB_NAME = "libmeters_torch_kernels.so"
# IEEE fp32 throughout: no --use_fast_math (it would flush denormals and
# swap in approximate division); -Xptxas -v reports registers and spills
# into build.log
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)

_lib: ctypes.CDLL | None = None


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    candidates = [shutil.which("nvcc")]
    if CUDA_HOME:
        candidates.append(os.path.join(CUDA_HOME, "bin", "nvcc"))
    for c in candidates:
        if c and os.access(c, os.X_OK):
            return c
    raise RuntimeError(
        "nvcc not found: meters_lv2_torch builds its CUDA kernels from "
        "csrc/ with nvcc (put it on PATH or set CUDA_HOME)"
    )


def _digest(sources: list[Path]) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in sources:
        h.update(f.name.encode())
        h.update(f.read_bytes())
    return h.hexdigest()


def build() -> Path:
    """Compile csrc/*.cu into the shared library unless an up-to-date one
    exists; return its path.  Raises RuntimeError if nvcc fails."""
    sources = sorted(CSRC_DIR.glob("*.cu"))
    digest = _digest(sources)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    lib = BUILD_DIR / LIB_NAME
    sidecar = BUILD_DIR / (LIB_NAME + ".srchash")
    with open(BUILD_DIR / ".lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if (lib.exists() and sidecar.exists()
                and sidecar.read_text() == digest):
            return lib
        tmp = BUILD_DIR / f".{LIB_NAME}.{os.getpid()}.tmp"
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *map(str, sources)]
        r = subprocess.run(cmd, capture_output=True, text=True)
        (BUILD_DIR / "build.log").write_text(
            " ".join(cmd) + "\n" + r.stdout + r.stderr
        )
        if r.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(
                f"nvcc failed with exit code {r.returncode}:\n"
                f"{r.stderr[-6000:]}"
            )
        os.replace(tmp, lib)
        sidecar.write_text(digest)
    return lib


def kernels() -> ctypes.CDLL:
    """The loaded kernel library (built on first call), with the argument
    types of every entry point declared."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        vp, ci = ctypes.c_void_p, ctypes.c_int
        f = lib.r128_fused_launch
        f.restype = ci
        f.argtypes = (
            [vp] * 8  # x, z0, hist, kmat, sy, at, g, taps (device)
            + [ctypes.POINTER(ctypes.c_float)]  # gains (host)
            + [ci] * 3  # B, C, T
            + [vp] * 4  # p, z, hist_out, tpmax (device)
            + [vp]  # cudaStream_t
        )
        lib.meters_cuda_error_string.restype = ctypes.c_char_p
        lib.meters_cuda_error_string.argtypes = [ci]
        _lib = lib
    return _lib


def check(lib: ctypes.CDLL, rc: int, what: str) -> None:
    """Raise if a launcher returned a CUDA error code."""
    if rc != 0:
        msg = lib.meters_cuda_error_string(rc).decode()
        raise RuntimeError(f"{what}: CUDA error {rc} ({msg})")
