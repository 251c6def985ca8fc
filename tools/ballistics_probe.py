#!/usr/bin/env python3
"""What bounds ballistics.cu's envelope body: time variants of the kernel.

Run from the root of a checkout, on a machine with a CUDA card and nvcc:

    python3 tools/ballistics_probe.py [--rows 512 12672] [--rounds 3]

Each variant is meters_lv2_torch/csrc/ballistics.cu with a few lines
replaced, built with nvcc into build/ballistics_probe/ (one process per
variant, all started together) and loaded with ctypes.  The first six
variants and no-min compute the kernel's results; no-dp, no-chain and
shared-sched compute wrong results on purpose and are timed only:

  serial          the source as it is, its serial body;
  kernel          the source as it is, its envelope body (4 rows a CTA up
                  to 528 rows, else 16);
  rows-4          the envelope with 4 rows a CTA at every N;
  rows-16         the envelope with 16 rows a CTA at every N;
  no-rotation     the roles not rotated by the CTA's place on the SM (every
                  consumer on the scheduler of its CTA's warp 0);
  regs-6          the 16-row kernel held to 40 registers a thread, so that
                  six CTAs (96 rows) fit on an SM;
  no-min          __launch_bounds__ without its minimum of 1 CTA an SM
                  (ptxas then allocates fewer registers and schedules the
                  chain otherwise);
  no-dp           the producers skip the max-plus DP (they still load the
                  samples, fill the ring with them, fold m and synchronise):
                  the time of the consumer's chain;
  no-chain        the consumer copies b_1 instead of carrying the chain (it
                  still waits, stores z and releases every slot): the time
                  of the producers;
  shared-sched    a producer on the consumer's scheduler (role 4 produces,
                  role 5 idles).

For each row count N at T=48000 (0.3 U(0, 1) samples from seed 0, the BBC
PPM's coefficients at 48 kHz, no track_peak), the CUDA-event median ms of
each variant's launch over 7 launches, the variants taken in turn for
--rounds rounds.  The last line is the card's name and power limit from
nvidia-smi.
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
OUT = ROOT / "build" / "ballistics_probe"

VARIANTS = {
    "kernel": [],
    "rows-4": [("constexpr int kEnvFewRows = 528;", "constexpr int kEnvFewRows = 1 << 30;")],
    "rows-16": [("constexpr int kEnvFewRows = 528;", "constexpr int kEnvFewRows = 0;")],
    "no-rotation": [("    s_rot = S::kWarps == 8 ? (slot / 8) & 3 : 0;", "    s_rot = 0;")],
    "regs-6": [("__global__ void __launch_bounds__(EnvShape<R>::kWarps * 32, 1)",
                "__global__ void __launch_bounds__(EnvShape<R>::kWarps * 32, R == 16 ? 6 : 1)")],
    "no-min": [("__global__ void __launch_bounds__(EnvShape<R>::kWarps * 32, 1)",
                "__global__ void __launch_bounds__(EnvShape<R>::kWarps * 32)")],
    "no-dp": [
        ("      *reinterpret_cast<float4*>(ring) = ballistics::env_intercepts(ts, a.k1.w);\n"
         "      *reinterpret_cast<float4*>(ring + 4) = ballistics::env_intercepts(ts, a.k2.w);",
         "      *reinterpret_cast<float4*>(ring) = make_float4(ts[0], ts[1], ts[2], ts[3]);\n"
         "      *reinterpret_cast<float4*>(ring + 4) = make_float4(ts[3], ts[2], ts[1], ts[0]);"),
    ],
    "no-chain": [("    z = ballistics::env_carry_tree(z, w3, k, b[i]);", "    z = b[i].x;")],
    "shared-sched": [
        ("  if ((warp & 3) == 0) return;", "  if (warp == 5) return;"),
        ("  const int pw = warp - 1 - (warp >> 2);", "  const int pw = warp < 5 ? warp - 1 : warp - 2;"),
    ],
}


def build_variants():
    """Write and compile every variant; returns {name: .so path}."""
    from meters_lv2_torch.runtime import build

    src = (CSRC / "ballistics.cu").read_text()
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
                sys.exit(f"tools/ballistics_probe.py: variant {name}: the line to replace is not "
                         f"in csrc/ballistics.cu once: {old.strip()[:60]!r}")
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
    ap.add_argument("--rows", type=int, nargs="+", default=[512, 12672])
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--variants", nargs="+", default=["serial", *VARIANTS],
                    help="the variants to time (default: all)")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        sys.exit("tools/ballistics_probe.py: no CUDA device")
    sys.path.insert(0, str(ROOT))
    from meters_lv2_torch.ops import design
    from meters_lv2_torch.ops.ballistics_core import coeffs_f32, envelope_decrements

    libs = build_variants()
    vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    fns = {}  # name: (launcher, envelope)
    for name, path in libs.items():
        f = ctypes.CDLL(str(path)).ballistics_launch
        f.restype = ci
        f.argtypes = [vp] * 5 + [ci] * 2 + [cf] * 3 + [ci] * 2 + [ctypes.POINTER(cf)] + [vp] * 5
        if name == "kernel" and "serial" in args.variants:
            fns["serial"] = (f, 0)
        if name in args.variants:
            fns[name] = (f, 1)
    c = design.iec2_ppm(48000)
    w1, w2, w3 = coeffs_f32(c.w1, c.w2, c.w3)
    dec = (cf * 8)(*envelope_decrements(w1), *envelope_decrements(w2))
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    T = 48000
    for N in args.rows:
        t = torch.rand((N, T), generator=gen, device=dev) * 0.3
        zs = [torch.zeros(N, device=dev) for _ in range(4)]
        out = torch.empty((4, N), device=dev)
        stream = torch.cuda.current_stream(dev).cuda_stream
        ms = {name: [] for name in fns}
        for _ in range(args.rounds):
            for name, (f, envelope) in fns.items():
                def run():
                    rc = f(t.data_ptr(), *[z.data_ptr() for z in zs], N, T, w1, w2, w3, 0,
                           envelope, dec, *[out[i].data_ptr() for i in range(4)], stream)
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
            f"{name} {statistics.mean(v):.4f} ms (medians {[round(x, 4) for x in v]})"
            for name, v in ms.items()))
        del t
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout.strip())


if __name__ == "__main__":
    main()
