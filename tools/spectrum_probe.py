#!/usr/bin/env python3
"""What bounds spectrum_fused: time variants of the kernel at B=256 T=48000.

Run from the root of a checkout, on a machine with a CUDA card and nvcc:

    python3 tools/spectrum_probe.py [--rounds 3] [--carried 60]

Each variant is meters_lv2_torch/csrc/spectrum_fused.cu with a few lines
replaced (or a source of its own), built with nvcc into
build/spectrum_probe/ (one process per variant, all started together) and
loaded with ctypes:

  parent             the body before its Hopper redesign
                     (tools/spectrum_probe_parent.cu, a verbatim copy);
  kernel             the source as it is (3xTF32 products on mma.sync);
  fp32-products      the same warps and tiles with the products as IEEE fp32
                     FMAs on the CUDA cores (per lane and tile 2 M tiles x 2
                     rows x 2 columns: 8 FMAs per 8-byte load of the tile, the
                     rows' x loaded as float4 once per k-step): the A/B
                     against the kernel's 3xTF32 products;
  no-smoother        the smoother warp skips the smoothing (it still waits
                     for every block and refills the ring): wrong results;
  no-products        the product warps skip the mma.sync products and their
                     operand splits (they still load x, publish, wait and
                     write y^2): wrong results;
  no-copy            the smoother releases each slot without refilling it
                     (the products read the slot's y^2 as x): the time of
                     the x copies, wrong results;
  no-state           the state chain drops s @ At (s' = the G partials'
                     sum): wrong results;
  no-splits          the operands' TF32 splits skipped (the raw bits feed
                     all three passes): wrong results;
  one-pass           only the a_hi b_hi pass of the three: wrong results;
  floor              no-products and no-smoother together: wrong results;
  tile-order         the three TF32 passes of a tile back to back (the
                     kernel runs each pass over every tile of the k-step
                     before the next);
  phase-unroll1/4    the k-step loops unrolled 1 or 4 times (the kernel: 2);
  direct-recurrence  one lane per (stream, band) chaining the six 2x2 modal
                     sections sample by sample (tools/spectrum_probe_direct.cu).

For each variant: the CUDA-event median ms of a launch over 7 launches, the
variants taken in turn for --rounds rounds, on 0.3 N(0, 1) samples from
seed 0 with a filter state and smoother value from 0.25 s of noise; and,
for the variants that compute the function, val, peak and zf against the
plain version (max |err| over each leaf's scale).  Then the kernel against
the parent body at B=2 and B=8 (parent, kernel, kernel, parent for
--rounds rounds): a live meter's few streams.  Then --carried x 1 s at
B=8 carried through the kernel, the direct recurrence and the plain version
(each its own state): the worst error over the calls at band 0 and over
all bands.  The last line is the card's name and power limit from
nvidia-smi.  With --build VARIANT... it only builds those variants (as
chip_smoke.py does for the parent body, its yardstick) and exits.
"""

import argparse
import ctypes
import shutil
import statistics
import subprocess
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
CSRC = ROOT / "meters_lv2_torch" / "csrc"
OUT = ROOT / "build" / "spectrum_probe"
FS = 48000
SMALL_B = (2, 8)  # also timed: the kernel against the parent body alone

FP32_TILE = r'''// -- product tile: IEEE fp32 FMAs (the probe's fp32-products variant) ------
__device__ __forceinline__ int tile_pos(int jj, int ii) { return jj * 8 + ii; }

struct ARaw {
  float r0[8], r1[8];
};
using AFrag = ARaw;

__device__ __forceinline__ ARaw load_a(const float* base, int pitch, int kk, int g, int t) {
  ARaw a;
  const float4* p0 = reinterpret_cast<const float4*>(base + g * pitch + 8 * kk);
  const float4* p1 = reinterpret_cast<const float4*>(base + (g + 8) * pitch + 8 * kk);
  const float4 u0 = p0[0], u1 = p0[1], w0 = p1[0], w1 = p1[1];
  const float r0[8] = {u0.x, u0.y, u0.z, u0.w, u1.x, u1.y, u1.z, u1.w};
  const float r1[8] = {w0.x, w0.y, w0.z, w0.w, w1.x, w1.y, w1.z, w1.w};
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    a.r0[i] = r0[i];
    a.r1[i] = r1[i];
  }
  return a;
}

__device__ __forceinline__ void note_rows(uint32_t (&mag)[2], const ARaw& r) {
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    mag[0] = max(mag[0], abs_bits(r.r0[i]));
    mag[1] = max(mag[1], abs_bits(r.r1[i]));
  }
}

__device__ __forceinline__ AFrag split_a(const ARaw& r) { return r; }

struct BFrag {
  const float* col;  // the tile's columns 2t, 2t + 1
};

__device__ __forceinline__ BFrag load_b(const float* tile, int lane) {
  return BFrag{tile + 2 * (lane & 3)};
}

// per row of each tile: one 8-byte load (columns 2t, 2t + 1), 8 FMAs
template <int q0, int nq>
__device__ __forceinline__ void products(float (&c)[kMt][nq][4], const AFrag (&a)[kMt],
                                         const BFrag (&b)[nq]) {
#pragma unroll
  for (int q = q0; q < nq; ++q)
#pragma unroll
    for (int jj = 0; jj < 8; ++jj) {
      const float2 v = *reinterpret_cast<const float2*>(b[q].col + jj * 8);
#pragma unroll
      for (int m = 0; m < kMt; ++m) {
        c[m][q][0] = fmaf(a[m].r0[jj], v.x, c[m][q][0]);
        c[m][q][1] = fmaf(a[m].r0[jj], v.y, c[m][q][1]);
        c[m][q][2] = fmaf(a[m].r1[jj], v.x, c[m][q][2]);
        c[m][q][3] = fmaf(a[m].r1[jj], v.y, c[m][q][3]);
      }
    }
}
'''

VARIANTS = {
    "parent": "tools/spectrum_probe_parent.cu",
    "kernel": [],
    "fp32-products": "fp32",
    "no-smoother": [
        ("      smooth_block(sm.ring + slot * kS * kXp + lane * kXp, w_sm, st);\n", ""),
    ],
    "no-products": [
        ("        mma_tf32(c[m][q], av, bv[0], bv[1]);\n", ""),
    ],
    "no-copy": [
        ("      if (blk + kSlots < nblk) issue_x(sm, x, b0, nvalid, T, blk + kSlots, aligned, lane);",
         "      if (blk + kSlots < nblk && lane == 0) mbar_arrive(&sm.xfull[slot]);"),
    ],
    "no-state": [("        sn[k] = u + gin;", "        sn[k] = gin;")],
    "no-splits": [
        ("  hi = tf32_rna(f);\n  lo = __float_as_uint(f - __uint_as_float(hi)) + 0x1000u;",
         "  hi = __float_as_uint(f);\n  lo = hi;"),
    ],
    "one-pass": [("  for (int pass = 0; pass < 3; ++pass)\n", "  for (int pass = 2; pass < 3; ++pass)\n")],
    "tile-order": [
        ("  for (int pass = 0; pass < 3; ++pass)\n#pragma unroll\n"
         "    for (int q = q0; q < nq; ++q)\n",
         "  for (int q = q0; q < nq; ++q)\n#pragma unroll\n"
         "    for (int pass = 0; pass < 3; ++pass)\n"),
    ],
    "phase-unroll1": [("#pragma unroll 2\n  for (int kk = kb;", "#pragma unroll 1\n  for (int kk = kb;")],
    "phase-unroll4": [("#pragma unroll 2\n  for (int kk = kb;", "#pragma unroll 4\n  for (int kk = kb;")],
    "direct-recurrence": "tools/spectrum_probe_direct.cu",
}
VARIANTS["floor"] = VARIANTS["no-products"] + VARIANTS["no-smoother"]
# timed only
WRONG = ("no-smoother", "no-products", "no-copy", "no-state", "no-splits", "one-pass", "floor")
# CTAs resident on an SM, as the runtime computes it after a launch has set
# the kernel's attributes
OCCUPANCY = """
extern "C" int spectrum_occupancy() {
  int n = -1;
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, spectrum_fused_kernel, kThreads, kSmemBytes);
  return n;
}
"""


def variant_source(name):
    """The CUDA source text of a variant."""
    spec = VARIANTS[name]
    if isinstance(spec, str) and spec.endswith(".cu"):
        return (ROOT / spec).read_text()
    src = (CSRC / "spectrum_fused.cu").read_text()
    if spec == "fp32":
        head, rest = src.split("// -- product tile: 3xTF32", 1)
        _, tail = rest.split("// -- end product tile", 1)
        return head + FP32_TILE + "// -- end product tile" + tail
    for old, new in spec:
        if src.count(old) != 1:
            sys.exit(f"tools/spectrum_probe.py: variant {name}: the line to replace is not in "
                     f"csrc/spectrum_fused.cu once: {old.strip()[:60]!r}")
        src = src.replace(old, new)
    return src


def build_variants(names):
    """Write and compile the named variants; returns {name: .so path}."""
    sys.path.insert(0, str(ROOT))
    from meters_lv2_torch.runtime import build

    OUT.mkdir(parents=True, exist_ok=True)
    flags = [f for f in build.NVCC_FLAGS if f not in ("-Xptxas", "-v")]
    cmds, libs = [], {}
    for name in names:
        cu = OUT / f"{name}.cu"
        src = variant_source(name)
        if "spectrum_fused_kernel" in src:
            src += OCCUPANCY
        cu.write_text(src)
        libs[name] = OUT / f"lib{name}.so"
        cmds.append([build._nvcc(), *flags, "-shared", "-o", str(libs[name]), str(cu)])
    for cmd, rc, out in build._run_all(cmds):
        if rc:
            sys.exit(f"nvcc failed for {cmd[-1]}:\n{out[-3000:]}")
    return libs


def fused_launcher(path):
    """spectrum_fused_launch of a built variant, with its argument types."""
    vp, ci = ctypes.c_void_p, ctypes.c_int
    f = ctypes.CDLL(str(path)).spectrum_fused_launch
    f.restype = ci
    f.argtypes = [vp] * 8 + [ci] * 2 + [vp] * 4
    return f


def launch_fused(f, x, z0, v0, om, w):
    """One launch of a spectrum_fused_launch-compatible f; (val, peak, zf)."""
    import torch

    B, T = x.shape
    out = (torch.empty((B, 30), device=x.device), torch.empty((B, 30), device=x.device),
           torch.empty((B, 30, 12), device=x.device))
    rc = f(x.data_ptr(), z0.data_ptr(), v0.data_ptr(), om.data_ptr(), w.kmat.data_ptr(),
           w.sy.data_ptr(), w.at.data_ptr(), w.g.data_ptr(), B, T, *[o.data_ptr() for o in out],
           torch.cuda.current_stream(x.device).cuda_stream)
    if rc:
        raise RuntimeError(f"launch failed with CUDA error {rc}")
    return out


def direct_coefficients():
    """[30, 6, 9] float32: each band's six modal sections (a00 a01 a10 a11
    b0 b1 c0 c1 d), as ops/design.py cascade_modal_state_space builds them;
    checked against the banked system's composite matrices."""
    from meters_lv2_torch.ops import design

    out = []
    for f_m, bw in design.spectrum_band_frequencies(30):
        secs = []
        for s in design.bandpass_design(FS, f_m, bw, order=6):
            raw = design._biquad_state_space(s)
            try:
                m = design.modal_balance(*raw)
            except np.linalg.LinAlgError:
                m = raw
            if not all(np.isfinite(a).all() for a in m):
                m = raw
            secs.append(m)
        full = design.series_connect(secs)
        ref = design.cascade_modal_state_space(design.bandpass_design(FS, f_m, bw, order=6))
        if not all(np.array_equal(a, b) for a, b in zip(full, ref)):
            sys.exit("tools/spectrum_probe.py: the sections do not rebuild the banked system")
        out.append([[A[0, 0], A[0, 1], A[1, 0], A[1, 1], B[0, 0], B[1, 0], C[0, 0], C[0, 1],
                     D[0, 0]] for A, B, C, D in secs])
    return np.asarray(out, np.float32)


def median_ms(fn, x, z0, v0):
    """The CUDA-event median ms of fn(x, z0, v0) over 7 launches, after one."""
    import torch

    fn(x, z0, v0)
    times = []
    for _ in range(7):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        fn(x, z0, v0)
        e1.record()
        e1.synchronize()
        times.append(e0.elapsed_time(e1))
    return statistics.median(times)


def rel_errs(got, ref):
    """max |got - ref| over ref's scale for val, peak and zf (finite entries)."""
    import torch

    res = []
    for a, b in zip(got, ref):
        f = torch.isfinite(b)
        scale = b.abs()[f].max().item()
        res.append((a - b).abs()[f].max().item() / scale if scale else 0.0)
    return res


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--carried", type=int, default=60)
    ap.add_argument("--build", nargs="+", metavar="VARIANT", choices=list(VARIANTS),
                    help="only build these variants into build/spectrum_probe/ and exit")
    args = ap.parse_args()
    if args.build:
        build_variants(args.build)
        return
    import torch

    if not torch.cuda.is_available():
        sys.exit("tools/spectrum_probe.py: no CUDA device")
    sys.path.insert(0, str(ROOT))
    import meters_lv2_torch
    from meters_lv2_torch.ops import spectrum_fused

    shutil.rmtree(OUT, ignore_errors=True)
    libs = build_variants(list(VARIANTS))
    dev = torch.device("cuda", 0)
    spec = meters_lv2_torch.create("spectr30stereo", FS)
    op = spec.bank.op(128)
    w = op.tensors(dev)
    om = spec.set_speed(spec.init((), device=dev), 3.0).omega
    coef = torch.as_tensor(direct_coefficients(), device=dev)
    vp, ci = ctypes.c_void_p, ctypes.c_int
    direct = ctypes.CDLL(str(libs["direct-recurrence"])).spectrum_direct_launch
    direct.restype = ci
    direct.argtypes = [vp] * 5 + [ci] * 2 + [vp] * 4

    def run_direct(x, z0, v0):
        B, T = x.shape
        out = (torch.empty((B, 30), device=dev), torch.empty((B, 30), device=dev),
               torch.empty((B, 30, 12), device=dev))
        rc = direct(x.data_ptr(), z0.data_ptr(), v0.data_ptr(), om.data_ptr(), coef.data_ptr(),
                    B, T, *[o.data_ptr() for o in out], torch.cuda.current_stream(dev).cuda_stream)
        if rc:
            raise RuntimeError(f"direct-recurrence: launch failed with CUDA error {rc}")
        return out

    fns = {n: (lambda f: lambda x, z0, v0: launch_fused(f, x, z0, v0, om, w))(fused_launcher(p))
           for n, p in libs.items() if n != "direct-recurrence"}
    fns["direct-recurrence"] = run_direct

    def inputs(B, T, seed):
        g = np.random.default_rng(seed)
        warm = torch.as_tensor((0.3 * g.standard_normal((B, FS // 4))).astype(np.float32),
                               device=dev)
        yw, z0 = spec.bank.apply(warm, spec.bank.init((B,), device=dev))
        x = torch.as_tensor((0.3 * g.standard_normal((B, T))).astype(np.float32), device=dev)
        return x, z0.contiguous(), torch.mean(torch.square(yw), dim=-1).contiguous()

    B, T = 256, FS
    x, z0, v0 = inputs(B, T, 0)
    ref = spectrum_fused.fused_core_reference(x, z0, v0, om, op)
    errs = {}
    for name, fn in fns.items():
        got = fn(x, z0, v0)
        if name not in WRONG:
            errs[name] = rel_errs(got, ref)
    occ = {}
    for name, path in libs.items():
        lib = ctypes.CDLL(str(path))
        if hasattr(lib, "spectrum_occupancy"):
            occ[name] = lib.spectrum_occupancy()
    print("CTAs resident per SM: " + ", ".join(f"{n} {v}" for n, v in occ.items()))
    ms = {name: [] for name in fns}
    for _ in range(args.rounds):
        for name, fn in fns.items():
            ms[name].append(median_ms(fn, x, z0, v0))
    for name, v in ms.items():
        err = (" ; vs plain version: val {:.3g}, peak {:.3g}, zf {:.3g} of scale".format(
            *errs[name]) if name in errs else " (wrong results by design)")
        print(f"B={B} T={T}: {name} {statistics.mean(v):.4f} ms "
              f"(medians {[round(t, 4) for t in v]}){err}")
    print(f"A/B of the products: fp32-products {statistics.mean(ms['fp32-products']):.4f} ms, "
          f"3xtf32-products (the kernel) {statistics.mean(ms['kernel']):.4f} ms")
    del x, z0, v0, ref

    # a live meter's few streams: the kernel's 32-stream CTAs hold mostly
    # padding there, the parent's 8-stream ones less
    for Bs in SMALL_B:
        x, z0, v0 = inputs(Bs, T, 2)
        small = {n: [] for n in ("parent", "kernel")}
        for _ in range(args.rounds):
            for n in ("parent", "kernel", "kernel", "parent"):
                small[n].append(median_ms(fns[n], x, z0, v0))
        print(f"B={Bs} T={T}: " + ", ".join(
            f"{n} {statistics.mean(v):.4f} ms (medians {[round(t, 4) for t in v]})"
            for n, v in small.items()) + ", alternated parent, kernel, kernel, parent")
        del x, z0, v0

    # carried: each path keeps its own state, the same 1 s blocks
    Bc = 8
    xs, z0, v0 = inputs(Bc, args.carried * FS, 1)
    st = {n: (z0, v0) for n in ("kernel", "direct-recurrence", "plain")}
    worst = {n: {"band 0": [0.0] * 3, "all": [0.0] * 3} for n in ("kernel", "direct-recurrence")}
    for i in range(args.carried):
        xb = xs[:, i * FS:(i + 1) * FS].contiguous()
        outs = {}
        for n in st:
            f = (lambda a, b, c: spectrum_fused.fused_core_reference(a, b, c, om, op)) \
                if n == "plain" else fns[n]
            outs[n] = f(xb, *st[n])
            st[n] = (outs[n][2], outs[n][0])
        for n in worst:
            for k, sel in (("band 0", slice(0, 1)), ("all", slice(None))):
                e = rel_errs([o[:, sel] for o in outs[n]], [o[:, sel] for o in outs["plain"]])
                worst[n][k] = [max(a, b) for a, b in zip(worst[n][k], e)]
    for n, d in worst.items():
        print(f"carried {args.carried} x 1 s at B={Bc}, {n} vs the plain version, worst over "
              "the calls (val, peak, zf over each leaf's scale): " + "; ".join(
                  f"{k} {v[0]:.3g}, {v[1]:.3g}, {v[2]:.3g}" for k, v in d.items()))
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout.strip())


if __name__ == "__main__":
    main()
