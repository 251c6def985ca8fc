"""Build and load the port's CUDA kernels at first use.

``nvcc`` compiles every ``meters_lv2_torch/csrc/*.cu`` for ``sm_90a``, one
process per source, all started together, and links the objects into one
shared library with a plain C interface,
``build/meters_lv2_torch/libmeters_torch_kernels.so`` in the checkout, which
``ctypes`` loads.  A sidecar file holds the sha256 of the sources (the
``*.cuh`` headers included) and flags, so the library is rebuilt only when
they change; an ``fcntl.flock`` serialises concurrent builds.  Nothing here
runs at import time: a machine without ``nvcc`` can import the package and
use the plain CPU versions.
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
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
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


def _run_all(cmds: list[list[str]]) -> list[tuple[list[str], int, str]]:
    """Run the commands concurrently; (cmd, exit code, output) of each."""
    procs = [
        (c, subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
        for c in cmds
    ]
    outs = [p.communicate()[0] for _, p in procs]
    return [(c, p.returncode, out) for (c, p), out in zip(procs, outs)]


def build() -> Path:
    """Compile csrc/*.cu into the shared library unless an up-to-date one
    exists; return its path.  Raises RuntimeError if nvcc fails."""
    sources = sorted(CSRC_DIR.glob("*.cu"))
    digest = _digest(sorted(CSRC_DIR.glob("*.cu*")))  # *.cu and *.cuh
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    lib = BUILD_DIR / LIB_NAME
    sidecar = BUILD_DIR / (LIB_NAME + ".srchash")
    with open(BUILD_DIR / ".lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if (lib.exists() and sidecar.exists()
                and sidecar.read_text() == digest):
            return lib
        nvcc = _nvcc()
        pid = os.getpid()
        objs = [BUILD_DIR / f".{src.stem}.{pid}.o" for src in sources]
        tmp = BUILD_DIR / f".{LIB_NAME}.{pid}.tmp"
        try:
            runs = _run_all([
                [nvcc, *NVCC_FLAGS, "-c", "-o", str(o), str(src)]
                for src, o in zip(sources, objs)
            ])
            if all(rc == 0 for _, rc, _ in runs):
                runs += _run_all([[nvcc, "-shared", "-o", str(tmp), *map(str, objs)]])
            (BUILD_DIR / "build.log").write_text(
                "\n".join(" ".join(c) + "\n" + out for c, _, out in runs)
            )
            for _, rc, out in runs:
                if rc != 0:
                    tmp.unlink(missing_ok=True)
                    raise RuntimeError(
                        f"nvcc failed with exit code {rc}:\n{out[-6000:]}"
                    )
        finally:
            for o in objs:
                o.unlink(missing_ok=True)
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
        cf = ctypes.c_float
        f = lib.ballistics_launch
        f.restype = ci
        f.argtypes = (
            [vp] * 5  # t, z1, z2, m, p (device)
            + [ci] * 2  # N, T
            + [cf] * 3  # w1, w2, w3
            + [ci]  # track_peak
            + [vp] * 4  # z1, z2, m, p out (device)
            + [vp]  # cudaStream_t
        )
        f = lib.truepeak_fused_launch
        f.restype = ci
        f.argtypes = (
            [vp, ci]  # x (device), row stride
            + [vp] * 6  # hist, z1, z2, m, p, taps (device)
            + [ci] * 2  # N, T
            + [cf] * 3  # w1, w2, w3
            + [vp] * 5  # z1, z2, m, p, hist out (device)
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
