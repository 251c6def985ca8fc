"""Build and load the port's CUDA kernels at first use.

``nvcc`` compiles every ``meters_lv2_torch/csrc/*.cu`` for ``sm_90a``, one
process per source, all started together, and links the objects into one
shared library with a plain C interface,
``build/meters_lv2_torch/libmeters_torch_kernels.so`` in the checkout, which
``ctypes`` loads.  A sidecar file holds the sha256 of the sources (the
``*.cuh`` headers included) and flags, so the library is rebuilt only when
they change.  ``locked_build``, shared with the WAV codec's build
(``runtime/native.py``), serialises concurrent builds with an
``fcntl.flock``, checks the sidecar again under the lock, and moves the
library and then its sidecar into place with ``os.replace``, so no process
loads a half-written library.  Nothing here runs at import time: a machine
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
from typing import Callable

from ..utils import profiler

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


def digest(sources: list[Path], flags) -> str:
    """sha256 of the flags and of each source's name and bytes."""
    h = hashlib.sha256(" ".join(flags).encode())
    for f in sources:
        h.update(f.name.encode())
        h.update(f.read_bytes())
    return h.hexdigest()


def locked_build(build_dir: Path, lib_name: str, want: str,
                 link: Callable[[Path], bool]) -> Path | None:
    """``build_dir/lib_name``, rebuilt unless its ``.srchash`` sidecar holds
    ``want``.  Under an flock on ``build_dir/.lock``, ``link(tmp)`` writes
    the library to a per-process temporary path and returns whether it
    succeeded (or raises); the library and then the sidecar are moved into
    place with ``os.replace``.  None if ``link`` failed."""
    build_dir = Path(build_dir)
    build_dir.mkdir(parents=True, exist_ok=True)
    lib = build_dir / lib_name
    sidecar = build_dir / (lib_name + ".srchash")
    with open(build_dir / ".lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if lib.exists() and sidecar.exists() and sidecar.read_text() == want:
            return lib
        pid = os.getpid()
        tmp = build_dir / f".{lib_name}.{pid}.tmp"
        tmp_sidecar = build_dir / f".{lib_name}.srchash.{pid}.tmp"
        try:
            if not link(tmp):
                return None
            os.replace(tmp, lib)
            tmp_sidecar.write_text(want)
            os.replace(tmp_sidecar, sidecar)
        finally:
            tmp.unlink(missing_ok=True)
            tmp_sidecar.unlink(missing_ok=True)
    return lib


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

    def link(tmp: Path) -> bool:
        nvcc = _nvcc()
        objs = [BUILD_DIR / f".{src.stem}.{os.getpid()}.o" for src in sources]
        try:
            with profiler.span("build.compile"):
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
                    raise RuntimeError(
                        f"nvcc failed with exit code {rc}:\n{out[-6000:]}"
                    )
        finally:
            for o in objs:
                o.unlink(missing_ok=True)
        return True

    # *.cu and *.cuh
    return locked_build(BUILD_DIR, LIB_NAME,
                        digest(sorted(CSRC_DIR.glob("*.cu*")), NVCC_FLAGS), link)


def kernels() -> ctypes.CDLL:
    """The loaded kernel library (built on first call), with the argument
    types of every entry point declared.  The first call is the span
    ``build.load`` (with ``build.compile`` inside when nvcc runs) and one
    ``cache.fill``, whose seconds the span holds."""
    global _lib
    if _lib is None:
        with profiler.span("build.load"):
            _lib = _load()
        profiler.count("cache.fill")
    return _lib


def _load() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build()))
    vp, ci = ctypes.c_void_p, ctypes.c_int
    f = lib.r128_fused_launch
    f.restype = ci
    f.argtypes = (
        [vp] * 6  # x, z0, hist, sy, at, g (device)
        + [ctypes.POINTER(ctypes.c_float)] * 3  # h, taps, gains (host)
        + [ci] * 3  # B, C, T
        + [vp, ci, ci]  # off (device, or None: full rate), fragm, n_slots
        + [vp] * 4  # p or seg, z, hist_out, tpmax (device)
        + [vp]  # cudaStream_t
    )
    cf = ctypes.c_float
    f = lib.ballistics_launch
    f.restype = ci
    f.argtypes = (
        [vp] * 5  # t, z1, z2, m, p (device)
        + [ci] * 2  # N, T
        + [cf] * 3  # w1, w2, w3
        + [ci] * 2  # track_peak, envelope
        + [ctypes.POINTER(ctypes.c_float)]  # envelope decrements c_k (host)
        + [vp] * 4  # z1, z2, m, p out (device)
        + [vp]  # cudaStream_t
    )
    f = lib.truepeak_fused_launch
    f.restype = ci
    f.argtypes = (
        [vp, ci]  # x (device), row stride
        + [vp] * 5  # hist, z1, z2, m, p (device)
        + [ctypes.POINTER(ctypes.c_float)]  # taps [4, 48] (host)
        + [ci] * 2  # N, T
        + [cf] * 3  # w1, w2, w3
        + [ci]  # envelope
        + [ctypes.POINTER(ctypes.c_float)]  # envelope decrements c_k (host)
        + [vp] * 5  # z1, z2, m, p, hist out (device)
        + [vp]  # cudaStream_t
    )
    f = lib.bitmeter_stats_launch
    f.restype = ci
    f.argtypes = (
        [vp, ci]  # x (device), row stride
        + [ci] * 2  # N, T
        + [vp] * 6  # hit, one, dset, flags, vmin, vmax (device, written in full)
        + [vp]  # cudaStream_t
    )
    f = lib.sigdist_fused_launch
    f.restype = ci
    f.argtypes = (
        [vp, ci]  # x (device), row stride
        + [ci] * 2  # N, T
        + [vp] * 7  # hist, n, mean, m2, total, time, integrating in (device)
        + [vp] * 6  # hist, n, mean, m2, total, time out (device, written in full)
        + [vp]  # cudaStream_t
    )
    f = lib.spectrum_fused_launch
    f.restype = ci
    f.argtypes = (
        [vp] * 8  # x, z0, v0, omega, kmat, sy, at, g (device)
        + [ci] * 2  # B, T
        + [vp] * 3  # val, peak, zf (device)
        + [vp]  # cudaStream_t
    )
    f = lib.surround_fused_launch
    f.restype = ci
    f.argtypes = (
        [vp] * 10  # x, km_z, zl, sel_a, sel_b, wv, km at, km g, lp at, lp sy (device)
        + [cf] * 3  # w1, 1 - w1, eps
        + [ci] * 3  # B, C, T
        + [vp] * 4  # kmz, zl, pk, pacc (device)
        + [vp]  # cudaStream_t
    )
    f = lib.surround_wide_launch
    f.restype = ci
    f.argtypes = lib.surround_fused_launch.argtypes
    f = lib.stft_fused_launch
    f.restype = ci
    f.argtypes = (
        [vp] * 4  # ext, win, tw, ptw (device; ptw None below W = 8192)
        + [ci] * 6  # B, L, W, hop, F, mode
        + [cf]  # thr
        + [vp] * 2  # out_a, out_b (device)
        + [vp]  # cudaStream_t
    )
    lib.stft_fused_body.restype = ci
    lib.stft_fused_body.argtypes = [ci]
    lib.meters_cuda_error_string.restype = ctypes.c_char_p
    lib.meters_cuda_error_string.argtypes = [ci]
    return lib


def check(lib: ctypes.CDLL, rc: int, what: str) -> None:
    """Raise if a launcher returned a CUDA error code."""
    if rc != 0:
        msg = lib.meters_cuda_error_string(rc).decode()
        raise RuntimeError(f"{what}: CUDA error {rc} ({msg})")
