#!/usr/bin/env python3
"""What bounds r128_fused: the kernel against its parent body, and ablations.

Run from the root of a checkout, on a machine with a CUDA card and nvcc:

    python3 tools/r128_probe.py [--rounds 3]

Each variant is meters_lv2_torch/csrc/r128_fused.cu with a few lines
replaced (or a source of its own), built with nvcc -Xptxas -v into
build/r128_probe/ (one process per variant, all started together) and
loaded with ctypes:

  parent       the body before its Hopper redesign
               (tools/r128_probe_parent.cu, a verbatim copy);
  kernel       the source as it is;
  always-8     8 producer warps a CTA at every batch (the kernel takes 4
               when the batch exceeds the SM count);
  always-4     4 producer warps a CTA at every batch;
  no-toeplitz  the producers skip y0 = x_blk @ K: wrong results;
  no-fir       the producers skip the true-peak FIR: wrong tpmax;
  loads-only   both cut: the bulk copies, x @ G, the state chain, s @ Sy,
               the power and the stores remain: wrong results;
  no-chain     the state warp hands over its states without computing them
               (it still waits for every unit and releases it): wrong
               results.

Inputs: 0.1 N(0, 1) samples (the main path's level) at T = 48000, a state
of 0.01 N(0, 1) and a history of 0.1 N(0, 1), from seed 0; seg mode at
fragm 2400 (22 slots) with offsets drawn from [0, 2400).  For each shape
(B, C) in (1, 2), (8, 2), (256, 2), (8, 5), (256, 5) and each mode: the
kernel's and the parent's results against the plain version at
chip_smoke.py's bars (each error over its bar, so <= 1 passes), whether
tpmax is bit-identical between the two bodies, and their CUDA-event median
ms over 7 launches, alternated parent, kernel, kernel, parent for
--rounds rounds.  Then every variant in turn at B=256 C=2 full rate, and
the variants that compute the function in turn at B=1 and B=8 (C=2) and
at B=256 C=5.  Then
the registers and spills ptxas reported for each variant's kernels and for
the package's own build (build/meters_lv2_torch/build.log), and the CTAs
an SM holds.  The last line is the card's name and power limit from
nvidia-smi.
"""

import argparse
import ctypes
import re
import shutil
import statistics
import subprocess
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
CSRC = ROOT / "meters_lv2_torch" / "csrc"
OUT = ROOT / "build" / "r128_probe"
FS = 48000
FRAGM = FS // 20
N_SLOTS = FS // FRAGM + 2
SHAPES = ((1, 2), (8, 2), (256, 2), (8, 5), (256, 5))
P_RTOL, P_FLOOR, Z_SCALE, TP_RTOL = 1e-5, 2e-6, 4e-6, 1e-6  # chip_smoke.py's bars

VARIANTS = {
    "parent": "tools/r128_probe_parent.cu",
    "kernel": [],
    "always-8": [("  return B > sms ? launch_mode", "  return false ? launch_mode")],
    "always-4": [("  return B > sms ? launch_mode", "  return true ? launch_mode")],
    "no-toeplitz": [("  for (int q = 1; q < 4; ++q) {\n    const float* e = px",
                     "  return;\n  for (int q = 1; q < 4; ++q) {\n    const float* e = px")],
    "no-fir": [("  float4 cur = ld4(fb);\n", "  return;\n  float4 cur = ld4(fb);\n")],
    "no-chain": [("    if (act) {\n      const int nb = min(kUb, nblk - kUb * u);",
                  "    if (false) {\n      const int nb = min(kUb, nblk - kUb * u);")],
}
VARIANTS["loads-only"] = VARIANTS["no-toeplitz"] + VARIANTS["no-fir"]
WRONG = ("no-toeplitz", "no-fir", "loads-only", "no-chain")  # timed only
OCCUPANCY = """
extern "C" int r128_occupancy(int C, int shared) {
  int n = -1;
  if (C == 2 && shared)
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, r128_fused_kernel<2, false, kProdShared>,
                                                  32 * (kProdShared + 1),
                                                  smem_bytes<2, kProdShared>());
  if (C == 2 && !shared)
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, r128_fused_kernel<2, false, kProdAlone>,
                                                  32 * (kProdAlone + 1),
                                                  smem_bytes<2, kProdAlone>());
  if (C == 5 && shared)
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, r128_fused_kernel<5, false, kProdShared>,
                                                  32 * (kProdShared + 1),
                                                  smem_bytes<5, kProdShared>());
  if (C == 5 && !shared)
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, r128_fused_kernel<5, false, kProdAlone>,
                                                  32 * (kProdAlone + 1),
                                                  smem_bytes<5, kProdAlone>());
  return n;
}
"""


def variant_source(name):
    spec = VARIANTS[name]
    if isinstance(spec, str):
        return (ROOT / spec).read_text()
    src = (CSRC / "r128_fused.cu").read_text()
    for old, new in spec:
        if src.count(old) != 1:
            sys.exit(f"tools/r128_probe.py: variant {name}: the text to replace is not in "
                     f"csrc/r128_fused.cu once: {old.strip()[:60]!r}")
        src = src.replace(old, new)
    return src + OCCUPANCY


def build_variants(names):
    """Write and compile the named variants; {name: (.so path, ptxas output)}."""
    sys.path.insert(0, str(ROOT))
    from meters_lv2_torch.runtime import build

    OUT.mkdir(parents=True, exist_ok=True)
    cmds, libs = [], {}
    for name in names:
        cu = OUT / f"{name}.cu"
        cu.write_text(variant_source(name))
        libs[name] = OUT / f"lib{name}.so"
        cmds.append([build._nvcc(), *build.NVCC_FLAGS, "-I", str(CSRC), "-shared", "-o",
                     str(libs[name]), str(cu)])
    out = {}
    for (cmd, rc, text), name in zip(build._run_all(cmds), names):
        if rc:
            sys.exit(f"nvcc failed for {cmd[-1]}:\n{text[-3000:]}")
        out[name] = (libs[name], text)
    return out


def ptxas_summary(text):
    """'C=2 full: 112 registers, spill 0/0 B' for each r128_fused_kernel
    instance in ptxas -v output."""
    lines, cur = [], None
    for ln in text.splitlines():
        m = re.search(r"Compiling entry function '(\S*r128_fused_kernel\S*)'", ln)
        if m:
            t = re.search(r"ILi(\d)ELb([01])E(?:Li(\d)E)?", m.group(1))
            cur = m.group(1) if t is None else (
                f"C={t.group(1)} {'seg' if t.group(2) == '1' else 'full'}"
                + (f" P={t.group(3)}" if t.group(3) else ""))
        elif "Compiling entry function" in ln:
            cur = None
        elif cur and "spill stores" in ln:
            s = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", ln)
            spill = f"spill {s.group(1)}/{s.group(2)} B"
        elif cur and "Used" in ln and "registers" in ln:
            regs = re.search(r"Used (\d+) registers", ln).group(1)
            lines.append(f"{cur}: {regs} registers, {spill}")
            cur = None
    return "; ".join(sorted(lines))


def launcher(path, parent):
    """The r128_fused_launch of a built variant, with its argument types."""
    vp, ci, fp = ctypes.c_void_p, ctypes.c_int, ctypes.POINTER(ctypes.c_float)
    f = ctypes.CDLL(str(path)).r128_fused_launch
    f.restype = ci
    head = [vp] * 8 + [fp] if parent else [vp] * 6 + [fp] * 3
    f.argtypes = head + [ci] * 3 + [vp, ci, ci] + [vp] * 5
    return f


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rounds", type=int, default=3)
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        sys.exit("tools/r128_probe.py: no CUDA device")
    sys.path.insert(0, str(ROOT))
    from meters_lv2_torch.ops import design, lti, r128_fused, resample
    from meters_lv2_torch.runtime import build

    shutil.rmtree(OUT, ignore_errors=True)
    built = build_variants(list(VARIANTS))
    build.kernels()  # the package's own build, for its build.log
    dev = torch.device("cuda", 0)
    op = lti.LTISystem(*design.k_weighting_state_space(FS)).op(128)
    w = op.tensors(dev)
    taps_dev = torch.as_tensor(resample.upsample4_taps(), device=dev).contiguous()
    taps_host = resample.upsample4_taps_host()
    h_host = (ctypes.c_float * 128)(*r128_fused.toeplitz_row(op).tolist())
    fns = {n: launcher(p, n == "parent") for n, (p, _) in built.items()}

    def run(name, x, z0, hist, gains, off):
        B, C, T = x.shape
        seg = off is not None
        out = (torch.empty((B, N_SLOTS) if seg else (B, T), device=dev),
               torch.empty((B, C, 4), device=dev), torch.empty((B, C, 47), device=dev),
               torch.empty((B,), device=dev))
        g = (ctypes.c_float * C)(*gains)
        head = ([x, z0, hist, w.kmat, w.sy, w.at, w.g, taps_dev] if name == "parent"
                else [x, z0, hist, w.sy, w.at, w.g])
        host = [g] if name == "parent" else [h_host, taps_host, g]
        rc = fns[name](*[t.data_ptr() for t in head], *host, B, C, T,
                       off.data_ptr() if seg else None, FRAGM if seg else 0,
                       N_SLOTS if seg else 0, *[o.data_ptr() for o in out],
                       torch.cuda.current_stream(dev).cuda_stream)
        if rc:
            raise RuntimeError(f"{name}: launch failed with CUDA error {rc}")
        return out

    def median_ms(fn):
        fn()
        times = []
        for _ in range(7):
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            fn()
            e1.record()
            e1.synchronize()
            times.append(e0.elapsed_time(e1))
        return statistics.median(times)

    def bar_ratios(got, ref, seg):
        """Each error over its bar (<= 1 passes): p (or seg), z, tpmax;
        and whether hist is bit-exact."""
        p, z, h, t = (v.double() for v in got)
        pr, zr, hr, tr = (v.double() for v in ref)
        if seg:
            rp = ((p - pr).abs() / (2e-6 * pr.abs() + 1e-9)).max().item()
        else:
            rp = ((p - pr).abs() / (P_RTOL * pr.abs() + P_FLOOR * pr.abs().max())).max().item()
        zs = zr.abs().amax(dim=(0, 1))
        rz = ((z - zr).abs() / (Z_SCALE * zs)).max().item()
        rt = ((t - tr).abs() / (TP_RTOL * tr.abs())).max().item()
        return rp, rz, rt, bool(torch.equal(h, hr))

    rng = np.random.default_rng(0)
    for B, C in SHAPES:
        x = torch.as_tensor(rng.standard_normal((B, C, FS), dtype=np.float32) * np.float32(0.1),
                            device=dev)
        z0 = torch.as_tensor(rng.standard_normal((B, C, 4), dtype=np.float32) * np.float32(0.01),
                             device=dev)
        hist = torch.as_tensor(rng.standard_normal((B, C, 47), dtype=np.float32) *
                               np.float32(0.1), device=dev)
        off = torch.as_tensor(rng.integers(0, FRAGM, B).astype(np.int32), device=dev)
        gains = (1.0,) * C
        for mode, o in (("full", None), ("seg", off)):
            kw = dict(off=o, fragm=FRAGM, n_slots=N_SLOTS) if o is not None else {}
            ref = r128_fused.fused_core_reference(x, z0, hist, gains, op, **kw)
            res = {n: run(n, x, z0, hist, gains, o) for n in ("parent", "kernel")}
            errs = {n: bar_ratios(v, ref, o is not None) for n, v in res.items()}
            same_tp = bool(torch.equal(res["parent"][3], res["kernel"][3]))
            ms = {"parent": [], "kernel": []}
            for _ in range(args.rounds):
                for n in ("parent", "kernel", "kernel", "parent"):
                    ms[n].append(median_ms(lambda: run(n, x, z0, hist, gains, o)))
            print(f"B={B} C={C} T={FS} {mode}: " + ", ".join(
                f"{n} {statistics.mean(v):.4f} ms (medians {[round(t, 4) for t in v]})"
                for n, v in ms.items())
                + "; error / bar (p, z, tpmax), hist exact: " + "; ".join(
                    f"{n} {e[0]:.3g}, {e[1]:.3g}, {e[2]:.3g}, {e[3]}" for n, e in errs.items())
                + f"; tpmax bit-identical to the parent: {same_tp}", flush=True)
        del x, z0, hist, ref, res

    for B, C in ((256, 2), (1, 2), (8, 2), (256, 5)):
        x = torch.as_tensor(rng.standard_normal((B, C, FS), dtype=np.float32) *
                            np.float32(0.1), device=dev)
        z0 = torch.zeros((B, C, 4), device=dev)
        hist = torch.zeros((B, C, 47), device=dev)
        gains = (1.0,) * C
        ref = r128_fused.fused_core_reference(x, z0, hist, gains, op)
        names = [n for n in VARIANTS if (B, C) == (256, 2) or n not in WRONG]
        ms = {n: [] for n in names}
        for _ in range(args.rounds):
            for n in names:
                ms[n].append(median_ms(lambda: run(n, x, z0, hist, gains, None)))
        for n, v in ms.items():
            note = (" (wrong results by design)" if n in WRONG else
                    " ; error / bar (p, z, tpmax), hist exact: {:.3g}, {:.3g}, {:.3g}, {}".format(
                        *bar_ratios(run(n, x, z0, hist, gains, None), ref, False)))
            print(f"B={B} C={C} T={FS} full, in turn: {n} {statistics.mean(v):.4f} ms "
                  f"(medians {[round(t, 4) for t in v]}){note}", flush=True)

    for n, (path, text) in built.items():
        lib = ctypes.CDLL(str(path))
        occ = ""
        if hasattr(lib, "r128_occupancy"):
            occ = "; CTAs an SM (P=4 / P=8): " + ", ".join(
                f"C={c} {lib.r128_occupancy(c, 1)} / {lib.r128_occupancy(c, 0)}" for c in (2, 5))
        print(f"ptxas {n}: {ptxas_summary(text)}{occ}")
    log = (build.BUILD_DIR / "build.log").read_text()
    print(f"ptxas, build/meters_lv2_torch/build.log: {ptxas_summary(log)}")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout.strip())


if __name__ == "__main__":
    main()
