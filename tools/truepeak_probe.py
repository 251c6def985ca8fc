#!/usr/bin/env python3
"""What bounds truepeak_fused's envelope body: time variants of the kernel.

Run from the root of a checkout, on a machine with a CUDA card and nvcc:

    python3 tools/truepeak_probe.py [--rows 512 8192] [--rounds 3]

Each variant is meters_lv2_torch/csrc/truepeak_fused.cu with a few lines
replaced, built with nvcc into build/truepeak_probe/ (one process per
variant, all started together) and loaded with ctypes.  Apart from the
first two, the variants compute wrong results on purpose and are timed
only:

  serial          the source as it is, its serial body;
  kernel          the source as it is, its envelope body;
  no-producers    the producers skip the FIR and the DP (they still stage
                  the samples, fill the ring and synchronise): the time of
                  the consumer's chain;
  no-chain        the consumer skips the chain (it still waits and
                  releases every slot): the time of the producers;
  shared-sched    5 warps, the consumer warp 4 beside producer warp 0 on
                  one scheduler (warps go to the SM's schedulers by index
                  mod 4);
  m-by-shuffle    the consumer forms max(m, z1 + z2) with a shuffle between
                  the partner lanes instead of leaving z in the ring for
                  the producers.

For each row count N at T=48000 (0.1 N(0, 1) samples from seed 0, true-peak
coefficients at 48 kHz), the CUDA-event median ms of each variant's
launch over 7 launches, the variants taken in turn for --rounds rounds.
The last line is the card's name and power limit from nvidia-smi.
"""

import argparse
import ctypes
import shutil
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
CSRC = ROOT / "meters_lv2_torch" / "csrc"
OUT = ROOT / "build" / "truepeak_probe"

VARIANTS = {
    "kernel": [],
    "no-producers": [
        ("    fir_lane(a.taps, win, lane, u);",
         "    for (int k = 0; k < kPer; ++k)\n"
         "      for (int ph = 0; ph < kPhases; ++ph) u[k][ph] = win[1 + lane + 32 * k + ph];"),
        ("      *reinterpret_cast<float4*>(ring + 8 * j) = ballistics::env_intercepts(ts, a.k1.w);\n"
         "      *reinterpret_cast<float4*>(ring + 8 * j + 4) = ballistics::env_intercepts(ts, a.k2.w);",
         "      *reinterpret_cast<float4*>(ring + 8 * j) = make_float4(ts[0], ts[1], ts[2], ts[3]);\n"
         "      *reinterpret_cast<float4*>(ring + 8 * j + 4) = make_float4(ts[3], ts[2], ts[1], ts[0]);"),
    ],
    "no-chain": [
        ("      if (live) {\n        // the intercepts", "      if (false) {\n        // the intercepts"),
    ],
    "shared-sched": [
        ("constexpr int kEnvWarps = 6;", "constexpr int kEnvWarps = 5;"),
        ("  if (warp == 0) {", "  if (warp == kRows) {"),
        ("  if (warp == 4) return;\n", ""),
        ("  const int pr = warp < 4 ? warp - 1 : kRows - 1;", "  const int pr = warp;"),
    ],
    "m-by-shuffle": [
        ("    z = env_carry_tree(z, w3, k, b[i]);\n    ring[8 * (g + i)] = z;",
         "    z = env_carry_tree(z, w3, k, b[i]);\n"
         "    mm = ballistics::max_nan(mm, __fadd_rn(z, __shfl_xor_sync(0xffu, z, 1)));"),
        ("                                             const ballistics::EnvCoeffs& k) {",
         "                                             const ballistics::EnvCoeffs& k, float& mm) {"),
        ("carry_groups(ring, g, ba, z, w3, k);", "carry_groups(ring, g, ba, z, w3, k, mm);"),
        ("carry_groups(ring, g + kAhead, bb, z, w3, k);",
         "carry_groups(ring, g + kAhead, bb, z, w3, k, mm);"),
        ("    float z = 0.f;\n", "    float z = 0.f, mm = -__int_as_float(0x7f800000);\n"),
        ("    if (valid) (second ? a.z2out : a.z1out)[row] = z;\n",
         "    if (valid) (second ? a.z2out : a.z1out)[row] = z;\n"
         "    if (valid && !second) a.mout[row] = ballistics::max_nan(a.m[row], mm);\n"),
        ("      mbar_wait(&s_empty[slot], ((blk - kSlots) / kSlots) & 1);\n      fold_m(slot);",
         "      mbar_wait(&s_empty[slot], ((blk - kSlots) / kSlots) & 1);"),
        ("    mbar_wait(&s_empty[blk % kSlots], (blk / kSlots) & 1);\n    fold_m(blk % kSlots);",
         "    mbar_wait(&s_empty[blk % kSlots], (blk / kSlots) & 1);"),
        ("    a.mout[row] = ballistics::max_nan(a.m[row], m);\n", ""),
    ],
}


def build_variants():
    """Write and compile every variant; returns {name: .so path}."""
    from meters_lv2_torch.runtime import build

    src = (CSRC / "truepeak_fused.cu").read_text()
    shutil.rmtree(OUT, ignore_errors=True)
    OUT.mkdir(parents=True)
    for h in CSRC.glob("*.cuh"):
        shutil.copy(h, OUT / h.name)
    flags = [f for f in build.NVCC_FLAGS if f not in ("-Xptxas", "-v")]
    cmds, libs = [], {}
    for name, patches in VARIANTS.items():
        text = src
        for old, new in patches:
            if text.count(old) != 1:
                sys.exit(f"tools/truepeak_probe.py: variant {name}: the line to replace is not "
                         f"in csrc/truepeak_fused.cu once: {old.strip()[:60]!r}")
            text = text.replace(old, new)
        cu = OUT / f"{name}.cu"
        cu.write_text(text)
        libs[name] = OUT / f"lib{name}.so"
        cmds.append([build._nvcc(), *flags, "-shared", "-o", str(libs[name]), str(cu)])
    for cmd, rc, out in build._run_all(cmds):
        if rc:
            sys.exit(f"nvcc failed for {cmd[-1]}:\n{out[-3000:]}")
    return libs


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rows", type=int, nargs="+", default=[512, 8192])
    ap.add_argument("--rounds", type=int, default=3)
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        sys.exit("tools/truepeak_probe.py: no CUDA device")
    sys.path.insert(0, str(ROOT))
    from meters_lv2_torch.ops import design, resample
    from meters_lv2_torch.ops.ballistics_core import coeffs_f32, envelope_decrements

    libs = build_variants()
    vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    fns = {}  # name: (launcher, envelope)
    for name, path in libs.items():
        f = ctypes.CDLL(str(path)).truepeak_fused_launch
        f.restype = ci
        f.argtypes = ([vp, ci] + [vp] * 5 + [ctypes.POINTER(cf)] + [ci] * 2 + [cf] * 3
                      + [ci, ctypes.POINTER(cf)] + [vp] * 5 + [vp])
        if name == "kernel":
            fns["serial"] = (f, 0)
        fns[name] = (f, 1)
    c = design.true_peak_ballistics(48000)
    w1, w2, w3 = coeffs_f32(c.w1, c.w2, c.w3)
    taps = (cf * 192)(*resample.upsample4_taps().reshape(-1).tolist())
    dec = (cf * 8)(*envelope_decrements(w1), *envelope_decrements(w2))
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    T = 48000
    for N in args.rows:
        x = torch.randn((N, T), generator=gen, device=dev) * 0.1
        h = torch.zeros((N, 47), device=dev)
        zs = [torch.zeros(N, device=dev) for _ in range(4)]
        out = torch.empty((4, N), device=dev)
        ho = torch.empty((N, 47), device=dev)
        stream = torch.cuda.current_stream(dev).cuda_stream
        ms = {name: [] for name in fns}
        for _ in range(args.rounds):
            for name, (f, envelope) in fns.items():
                def run():
                    rc = f(x.data_ptr(), T, h.data_ptr(), *[z.data_ptr() for z in zs], taps,
                           N, T, w1, w2, w3, envelope, dec,
                           *[out[i].data_ptr() for i in range(4)], ho.data_ptr(), stream)
                    if rc:
                        sys.exit(f"{name}: launch failed with CUDA error {rc}")
                run()
                times = []
                for _ in range(7):
                    e0 = torch.cuda.Event(enable_timing=True)
                    e1 = torch.cuda.Event(enable_timing=True)
                    e0.record()
                    run()
                    e1.record()
                    e1.synchronize()
                    times.append(e0.elapsed_time(e1))
                ms[name].append(statistics.median(times))
        print(f"N={N} T={T}: " + "; ".join(
            f"{name} {statistics.mean(v):.4f} ms (medians {[round(t, 4) for t in v]})"
            for name, v in ms.items()))
        del x
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout.strip())


if __name__ == "__main__":
    main()
