#!/usr/bin/env python3
"""What bounds surround_fused: the kernel against its parent body, and cuts.

Run from the root of a checkout, on a machine with a CUDA card and nvcc:

    python3 tools/surround_probe.py [--rounds 3] [--variants NAME ...]

Each variant is meters_lv2_torch/csrc/surround_fused.cu (or the parent
body, tools/surround_probe_parent.cu, a verbatim copy of the body before its
Hopper redesign) with a few lines replaced, built with nvcc -Xptxas -v into
build/surround_probe/ (one process per variant, all started together) and
loaded with ctypes.  Both bodies export the same launcher:

  parent              the parent body as it is;
  parent-loads-only   each sample's work cut to a max of the loaded values
                      (the loads, the walk, the reductions and the stores
                      remain): results wrong, timing only;
  parent-no-pairs     the per-sample routed pair sums cut: pacc wrong;
  parent-no-kmeter    the per-sample K-meter sums (x^2 against G) cut:
                      km_z wrong;
  parent-no-walk      the chunk's serial walk cut to its stores (the
                      carried states stay at their entry values): carries
                      wrong;
  parent-prefetch     the next step's float4 loads issued into registers
                      before the current step's arithmetic (correct);
  kernel              the source as it is;
  kernel-split-N      the kernel with N CTAs (one cluster) a stream at every
                      batch, in place of its choice (correct where each
                      range is one chunk or N is 1);
  kernel-seg-16       16 samples of each block a stage, two stages
                      (correct);
  kernel-stages-N     N cp.async stages at every width (correct);
  kernel-narrow-tT-sN T threads and N stages at C = 3 (correct);
  kernel-threads-N    N threads (blocks a chunk) a CTA at every width
                      (correct);
  kernel-l2-none      the copies without their 128-byte L2 prefetch hint
                      (correct);
  kernel-l2-256       a 256-byte hint (correct);
  kernel-loads-only   each sample's work cut to a max of the staged values:
                      results wrong, timing only;
  kernel-no-pairs     the per-sample channel products cut: pacc wrong;
  kernel-no-walk      the chunk's serial walks cut: carries wrong.

The wide layout (meters_lv2_torch/csrc/surround_wide.cu, launcher
surround_wide_launch) has its own variants:

  wide-parent              tools/surround_wide_probe_parent.cu, a verbatim
                           copy of the wide body before its Hopper redesign;
  wide-parent-loads-only   each step's sample work cut to a max of the
                           loaded values and the pair rows' to a max of wv
                           (the loads, the exchange and its barriers, the
                           walk and the stores remain): timing only;
  wide-parent-no-pairs     the pair rows' per-step sums cut: pacc wrong;
  wide-parent-no-walk      the chunk's serial walk cut to its stores:
                           carries wrong;
  wide                     the source as it is;
  wide-stages-3            three ring slots (correct);
  wide-seg-16-stages-3     16 samples of each block a stage, three slots
                           (correct);
  wide-seg-8-stages-6      8 samples a stage, six slots (correct);
  wide-l2-128, -l2-none    the tensor copies' L2 promotion at 128 bytes or
                           none, in place of 256 (correct);
  wide-no-fence            the proxy fence before each stage's barrier
                           cut: timing only;
  wide-loads-only          each sample's work cut to a max of the copied
                           values (the copies, the exchange reads, the
                           barriers, the walks and the stores remain):
                           timing only;
  wide-no-products         the channel products cut: pacc wrong;
  wide-no-walk             the chunk-end walks cut: carries wrong.

The wide layout's correct variants are also checked bit for bit against the
narrow kernel (``kernel``) on km_z, zl and pk, the same operations.

Inputs at T = 48000, seed 0: gauss (0.3 N(0, 1), the level of the repo's
surround tests) and nonfinite (the same with NaN, +Inf and -Inf samples,
one of them in a stream's last block and one in the middle of a stream),
the meter's default routing, carried K-meter and lowpass states.  For each
(B, C) in (1, 5), (1, 8), (8, 5), (8, 8), (256, 5), (256, 8), (256, 3),
(256, 4) and
each input: the parents' and the kernels' results against the plain
version (ops/surround_fused.py::fused_core_reference) at chip_smoke.py's
bars (pk bit-exact, km_z 4e-6 of its scale, zl and pacc 1e-5, non-finite
values in the same places), whether two launches are bit-identical, and
their CUDA-event ms a launch (10 launches queued behind a sleep kernel, so
the host's launch time is hidden; median of 5), alternated parent, kernel,
wide-parent, wide, then the same in reverse, for --rounds rounds, beside
the byte bound (x and wv read once at 3.35 TB/s).  Then every variant in
turn at B = 256 (C = 8, 5 and 3), at B = 8 (C = 8 and 5) and at B = 1
(C = 5 and 8).  Then the registers and spills ptxas reported, and
from ``cuobjdump -sass`` each variant's static instructions by opcode class
and its loop bodies.  The last line is the card's name and power limit.

    python3 tools/surround_probe.py --host

times only the host's side of a launch at B = 256, C = 5: the parent's and
the kernel's launcher through ctypes and the package's wrapper
(ops/surround_fused.py::fused_core), each over runs of 100 calls that end
in a synchronize, the median run's us a call.

    python3 tools/surround_probe.py --host-roots PARENT . . PARENT

times only the wrapper's host time in the same way, with the package
imported from each tree in turn, one process a tree: PARENT a ``git
archive`` of another commit unpacked in a directory .gitignore lists.
"""

import argparse
import collections
import ctypes
import os
import re
import shutil
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
CSRC = ROOT / "meters_lv2_torch" / "csrc"
OUT = ROOT / "build" / "surround_probe"
FS = T = 48000
SHAPES = ((1, 5), (1, 8), (8, 5), (8, 8), (256, 5), (256, 8), (256, 3), (256, 4))
INPUTS = ("gauss", "nonfinite")
HBM = 3.35e12  # bytes/s, the H100 SXM data sheet

_PARENT = (ROOT / "tools" / "surround_probe_parent.cu").read_text()
_WPARENT = (ROOT / "tools" / "surround_wide_probe_parent.cu").read_text()


def _between(src, start, end):
    """The text of src from `start` up to (not including) `end`."""
    i = src.find(start)
    j = src.find(end, i)
    return src[i:j] if i >= 0 and j > i else "\0missing"


_P_SAMPLE = _between(_PARENT, "        for (int u = 0; u < 4; ++u) {\n",
                     "      }\n#pragma unroll\n      for (int c = 0; c < C; ++c) {\n"
                     "        sm.e[c][tid] = z[c];")
_P_PAIRS = _between(_PARENT, "#pragma unroll\n          for (int p = 0; p < P; ++p) {\n"
                    "            float ya", "        }\n      }\n#pragma unroll\n")
_P_LOADS = ("      for (int t0 = 0; t0 < kBlk; t0 += 4) {\n        float4 xv[C];\n#pragma unroll\n"
            "        for (int c = 0; c < C; ++c)\n"
            "          xv[c] = *reinterpret_cast<const float4*>(xb + (size_t)c * T + off + t0);\n"
            "        const float4 w4 = *reinterpret_cast<const float4*>(wv + off + t0);\n")
_P_PREFETCH = (
    "      float4 nx[C], nw;\n#pragma unroll\n      for (int c = 0; c < C; ++c)\n"
    "        nx[c] = *reinterpret_cast<const float4*>(xb + (size_t)c * T + off);\n"
    "      nw = *reinterpret_cast<const float4*>(wv + off);\n"
    "      for (int t0 = 0; t0 < kBlk; t0 += 4) {\n        float4 xv[C];\n#pragma unroll\n"
    "        for (int c = 0; c < C; ++c) xv[c] = nx[c];\n        const float4 w4 = nw;\n"
    "        if (t0 + 4 < kBlk) {\n#pragma unroll\n          for (int c = 0; c < C; ++c)\n"
    "            nx[c] = *reinterpret_cast<const float4*>(xb + (size_t)c * T + off + t0 + 4);\n"
    "          nw = *reinterpret_cast<const float4*>(wv + off + t0 + 4);\n        }\n")

VARIANTS = {
    "parent": ("parent", []),
    "parent-loads-only": ("parent", [(_P_SAMPLE, (
        "        for (int u = 0; u < 4; ++u) {\n#pragma unroll\n"
        "          for (int c = 0; c < C; ++c) pk[c] = fmaxf(pk[c], lane4(xv[c], u));\n"
        "          Q = fmaxf(Q, lane4(w4, u));\n        }\n"))]),
    "parent-no-pairs": ("parent", [(_P_PAIRS, "")]),
    "parent-no-kmeter": ("parent", [("            g0[c] = fmaf(q, gk0, g0[c]);\n"
                                     "            g1[c] = fmaf(q, gk1, g1[c]);\n", "")]),
    "parent-no-walk": ("parent", [(
        "        zl = fmaf(a128, zl, sm.e[tid][i]);\n"
        "        const float n0 = fmaf(at10, s1, at00 * s0) + sm.gin[tid][0][i];\n"
        "        const float n1 = fmaf(at11, s1, at01 * s0) + sm.gin[tid][1][i];\n"
        "        s0 = n0;\n        s1 = n1;\n", "")]),
    "parent-prefetch": ("parent", [(_P_LOADS, _P_PREFETCH)]),
    "kernel": ("kernel", []),
}
# the wide parent's cuts; each names the text it replaces in
# tools/surround_wide_probe_parent.cu
_WP_SAMPLE = _between(_WPARENT, "        for (int u = 0; u < 4; ++u) {\n          const float v = lane4(xv, u);",
                      "        yo = make_float4(")
_WP_PAIRS = _between(_WPARENT, "      if (pair && live) {\n        float4 yc[C];", "      buf ^= 1;")
VARIANTS.update({
    "wide-parent": ("wide-parent", []),
    "wide-parent-loads-only": ("wide-parent", [
        (_WP_SAMPLE, "        for (int u = 0; u < 4; ++u) {\n          pk = fmaxf(pk, lane4(xv, u));\n"
                     "          yv[u] = 0.f;\n        }\n"),
        (_WP_PAIRS, "      if (pair && live) {\n"
                    "        const float4 w4 = *reinterpret_cast<const float4*>(wv + off + t0);\n"
                    "        Q = fmaxf(Q, fmaxf(fmaxf(w4.x, w4.y), fmaxf(w4.z, w4.w)));\n      }\n")]),
    "wide-parent-no-pairs": ("wide-parent", [(_WP_PAIRS, "")]),
    "wide-parent-no-walk": ("wide-parent", [(
        "        zl = fmaf(a128, zl, sm.e[c][i]);\n"
        "        const float n0 = fmaf(at10, s1, at00 * s0) + sm.gin[c][0][i];\n"
        "        const float n1 = fmaf(at11, s1, at01 * s0) + sm.gin[c][1][i];\n"
        "        s0 = n0;\n        s1 = n1;\n", "")]),
    "wide": ("wide", []),
})
# the kernel's own variants; each names the text it replaces in
# meters_lv2_torch/csrc/surround_fused.cu (absent from the parent body)
_K_SPLIT = ("  const int split = choose_split(B, nblk, C, Dims<C>::kThreads, sms,\n"
            "                                 Dims<C>::kStages * Dims<C>::kTile * 4);\n",)
_K_STAGES = "  static constexpr int kStages = C == 3 ? 4 : C == 4 ? 3 : 2;"
_K_THREADS = "  static constexpr int kThreads = C == 3 ? 192 : C == 4 ? 128 : 64;"
_K_SEG = "constexpr int kSeg = 8;"
_K_COPY = '"cp.async.cg.shared.global.L2::128B [%0], [%1], 16;\\n"'
for _n in (1, 8):  # each range one chunk where there are several CTAs
    VARIANTS[f"kernel-split-{_n}"] = ("kernel", [(_K_SPLIT[0], f"  const int split = {_n};\n")])
for _n in (2, 3):
    VARIANTS[f"kernel-stages-{_n}"] = ("kernel", [(_K_STAGES, f"  static constexpr int kStages = {_n};")])
for _t, _n in ((128, 3), (128, 4), (192, 3)):  # C = 3 only
    VARIANTS[f"kernel-narrow-t{_t}-s{_n}"] = ("kernel", [
        (_K_THREADS, f"  static constexpr int kThreads = C == 3 ? {_t} : C == 4 ? 128 : 64;"),
        (_K_STAGES, f"  static constexpr int kStages = C == 3 ? {_n} : C == 4 ? 3 : 2;")])
VARIANTS["kernel-seg-16"] = ("kernel", [(_K_SEG, "constexpr int kSeg = 16;"),
                                        (_K_STAGES, "  static constexpr int kStages = 2;")])
for _n in (64, 128):
    VARIANTS[f"kernel-threads-{_n}"] = ("kernel", [(_K_THREADS, f"  static constexpr int kThreads = {_n};")])
VARIANTS["kernel-l2-none"] = ("kernel", [(_K_COPY, _K_COPY.replace(".L2::128B", ""))])
VARIANTS["kernel-l2-256"] = ("kernel", [(_K_COPY, _K_COPY.replace("128B", "256B"))])
_K_SAMPLE = ("          // -- one sample of every channel --\n", "          // -- end of the sample --\n")
VARIANTS["kernel-loads-only"] = ("kernel", [(_K_SAMPLE, (
    "#pragma unroll\n          for (int c = 0; c < C; ++c) pk[c] = fmaxf(pk[c], lane4(xv[c], u));\n"
    "          S[NS - 1] = fmaxf(S[NS - 1], lane4(xv[C], u));\n"))])
VARIANTS["kernel-no-pairs"] = ("kernel", [(
    "#pragma unroll\n          for (int i = 0; i < C; ++i) {\n#pragma unroll\n"
    "            for (int j = i; j < C; ++j) S[tri<C>(i, j)] = fmaf(wy[i], z[j], S[tri<C>(i, j)]);\n"
    "            S[NM + i] = fmaf(wr, z[i], S[NM + i]);\n          }\n", "")])
VARIANTS["kernel-no-walk"] = ("kernel", [
    ("    if (warp == 0 && lane < C) {\n#pragma unroll 4\n      for (int i = 0; i < nb; ++i) {\n",
     "    if (false) {\n      for (int i = 0; i < nb; ++i) {\n"),
    ("    } else if (warp == 0 && lane == C) {\n      for", "    } else if (false) {\n      for"),
    ("    } else if (warp == 1 && lane < C && rank == 0) {\n", "    } else if (false) {\n")])
# the wide source's own variants; each names the text it replaces in
# meters_lv2_torch/csrc/surround_wide.cu (absent from the wide parent)
_W_STAGES, _W_SEG = "constexpr int kStages = 2;", "constexpr int kSeg = 32;"
_W_PROMOTE = "constexpr CUtensorMapL2promotion kPromote = CU_TENSOR_MAP_L2_PROMOTION_L2_256B;"
_W_FENCE = "    asm volatile(\"fence.proxy.async.shared::cta;\" ::: \"memory\");\n    __syncthreads();"
_W_OWN = ("          const float v = lane4(xv, u);\n          const float q = v * v;\n"
          "          pk = fmaxf(pk, q);\n          g0 = fmaf(q, lane4(G0, u), g0);\n"
          "          g1 = fmaf(q, lane4(G1, u), g1);\n          z = fmaf(om1, z, w1 * (v + eps));\n"
          "          yv[4 * h + u] = z;\n")
_W_PRODUCTS = ("          const float wt = lane4(W, u), r = lane4(SY, u), wr = wt * r;\n",
               "          Q = fmaf(wr, r, Q);\n")
_W_WALK0 = "      for (int i = 0; i < nb; ++i) {\n        const float e = __shfl_sync(kFull, z, i);\n        const float h0"
_W_WALK1 = "      for (int i = 0; i < nb; ++i) {\n        const float e = __shfl_sync(kFull, z, i);\n        if (lane == i)"
VARIANTS.update({
    "wide-stages-3": ("wide", [(_W_STAGES, "constexpr int kStages = 3;")]),
    "wide-seg-16-stages-3": ("wide", [(_W_SEG, "constexpr int kSeg = 16;"),
                                      (_W_STAGES, "constexpr int kStages = 3;")]),
    "wide-seg-8-stages-6": ("wide", [(_W_SEG, "constexpr int kSeg = 8;"),
                                     (_W_STAGES, "constexpr int kStages = 6;")]),
    "wide-l2-128": ("wide", [(_W_PROMOTE, _W_PROMOTE.replace("256B", "128B"))]),
    "wide-l2-none": ("wide", [(_W_PROMOTE, _W_PROMOTE.replace("L2_256B", "NONE"))]),
    "wide-no-fence": ("wide", [(_W_FENCE, "    __syncthreads();")]),
    "wide-loads-only": ("wide", [
        (_W_OWN, "          pk = fmaxf(pk, lane4(xv, u));\n          yv[4 * h + u] = 0.f;\n"),
        (_W_PRODUCTS, "          Q = fmaxf(Q, lane4(W, u));\n#pragma unroll\n"
                      "          for (int d = 1; d < kMaxD; ++d)\n"
                      "            if (d < nd) S[d] = fmaxf(S[d], lane4(yo[d], u));\n")]),
    "wide-no-products": ("wide", [(_W_PRODUCTS, "          Q = fmaf(lane4(W, u), lane4(SY, u), Q);\n")]),
    "wide-no-walk": ("wide", [(_W_WALK0, _W_WALK0.replace("i < nb", "i < 0")),
                              (_W_WALK1, _W_WALK1.replace("i < nb", "i < 0"))]),
})
CORRECT = {"parent", "parent-prefetch", "kernel", "wide-parent", "wide"} | {
    n for n in VARIANTS if n.startswith(("kernel-split-", "kernel-stages-", "kernel-seg-",
                                         "kernel-l2-", "kernel-threads-", "kernel-narrow-",
                                         "wide-stages-", "wide-seg-", "wide-l2-"))}


WIDE_BASES = ("wide", "wide-parent")


def variant_source(name):
    base, patches = VARIANTS[name]
    src = {"parent": lambda: _PARENT, "wide-parent": lambda: _WPARENT,
           "kernel": lambda: (CSRC / "surround_fused.cu").read_text(),
           "wide": lambda: (CSRC / "surround_wide.cu").read_text()}[base]()
    for old, new in patches:
        if isinstance(old, tuple):  # the text between two markers, the markers kept
            i, j = src.find(old[0]), src.find(old[1])
            if i < 0 or j < i or src.count(old[0]) != 1:
                return None
            src = src[:i + len(old[0])] + new + src[j:]
            continue
        if src.count(old) != 1:
            return None  # the text is not in this source (the kernel before its redesign)
        src = src.replace(old, new)
    return src


def build_variants(names):
    """Write and compile the named variants that apply to the sources;
    {name: (.so path, ptxas output)}."""
    from meters_lv2_torch.runtime import build

    OUT.mkdir(parents=True, exist_ok=True)
    cmds, libs, kept = [], {}, []
    for name in names:
        src = variant_source(name)
        if src is None:
            print(f"variant {name}: its text is not in the source; skipped", flush=True)
            continue
        cu = OUT / f"{name}.cu"
        cu.write_text(src)
        libs[name] = OUT / f"lib{name}.so"
        kept.append(name)
        cmds.append([build._nvcc(), *build.NVCC_FLAGS, "-I", str(CSRC), "-shared", "-o",
                     str(libs[name]), str(cu)])
    out = {}
    for (cmd, rc, text), name in zip(build._run_all(cmds), kept):
        if rc:
            sys.exit(f"nvcc failed for {cmd[-1]}:\n{text[-3000:]}")
        out[name] = (libs[name], text)
    return out


def ptxas_summary(text):
    """'<kernel>: N registers, spill S/L B, smem B' for each surround kernel
    in ptxas -v output."""
    lines, cur, spill = [], None, ""
    for ln in text.splitlines():
        m = re.search(r"Compiling entry function '(\S*surround\S*)'", ln)
        if m:
            cur, spill = m.group(1), ""
        elif "Compiling entry function" in ln:
            cur = None
        elif cur and "spill stores" in ln:
            s = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", ln)
            spill = f"spill {s.group(1)}/{s.group(2)} B"
        elif cur and "Used" in ln and "registers" in ln:
            regs = re.search(r"Used (\d+) registers", ln).group(1)
            s = re.search(r"(\d+) bytes smem", ln)
            lines.append(f"{cur[-40:]}: {regs} registers, {spill}"
                         + (f", static smem {s.group(1)} B" if s else ""))
            cur = None
    return "; ".join(sorted(lines))


def _cuobjdump():
    from torch.utils.cpp_extension import CUDA_HOME

    for c in (shutil.which("cuobjdump"), os.path.join(CUDA_HOME or "", "bin", "cuobjdump")):
        if c and os.access(c, os.X_OK):
            return c
    return None


def sass_counts(lib):
    """{kernel name: (static instruction count, Counter of opcode classes,
    [loop body sizes])} for the surround kernels of a built library."""
    tool = _cuobjdump()
    if tool is None:
        return {}
    text = subprocess.run([tool, "-sass", str(lib)], capture_output=True, text=True).stdout
    out, name, ins = {}, None, []

    def close():
        if name and "surround" in name:
            ops = collections.Counter(op.split(".")[0] for _, op, _ in ins if op != "NOP")
            addr = {a: i for i, (a, _, _) in enumerate(ins)}
            loops = []
            for i, (a, op, rest) in enumerate(ins):
                t = re.search(r"0x([0-9a-f]+)", rest) if op.startswith("BRA") else None
                if t and int(t.group(1), 16) < a and int(t.group(1), 16) in addr:
                    loops.append(i - addr[int(t.group(1), 16)] + 1)
            out[name] = (sum(ops.values()), ops, loops)

    for ln in text.splitlines():
        m = re.search(r"Function : (\S+)", ln)
        if m:
            close()
            name, ins = m.group(1), []
            continue
        m = re.match(r"\s*/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)\s*(.*)", ln)
        if m and name:
            ins.append((int(m.group(1), 16), m.group(2), m.group(3)))
    close()
    return out


def launcher(path, wide=False):
    vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib = ctypes.CDLL(str(path))
    f = lib.surround_wide_launch if wide else lib.surround_fused_launch
    f.restype = ci
    f.argtypes = [vp] * 10 + [cf] * 3 + [ci] * 3 + [vp] * 4 + [vp]
    return f


def surround_inputs(C, B, kind, dev):
    """fused_core's arguments on ``dev`` (module docstring): chip_smoke.py's
    surround_args, seed 0."""
    from chip_smoke import surround_args

    return surround_args(C, B, T, 0, dev, None, kind == "nonfinite")


def wrapper_host_time(root):
    """The wrapper of the tree at ``root`` (module docstring, --host-roots)."""
    import torch

    sys.path.insert(0, os.path.abspath(root))
    from meters_lv2_torch.ops import surround_fused

    a = surround_inputs(5, 256, "gauss", torch.device("cuda", 0))
    surround_fused.fused_core(*a)  # build and warm
    per = []
    for _ in range(7):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(100):
            surround_fused.fused_core(*a)
        per.append((time.perf_counter() - t0) / 100 * 1e6)
        torch.cuda.synchronize()
    print(f"wrapper host time, B=256 C=5 ({root}): {statistics.median(per):.1f} us a call "
          f"(runs of 100: {[round(p, 1) for p in per]})", flush=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--variants", nargs="+", default=list(VARIANTS))
    ap.add_argument("--host", action="store_true",
                    help="only the host's time to enqueue a launch (see the docstring)")
    ap.add_argument("--host-roots", nargs="+", metavar="DIR",
                    help="only the wrapper's host time from each tree, in this order")
    ap.add_argument("--host-of", metavar="DIR", help=argparse.SUPPRESS)
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        sys.exit("tools/surround_probe.py: no CUDA device")
    smi = ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"]
    if args.host_of:
        wrapper_host_time(args.host_of)
        return
    if args.host_roots:
        for root in args.host_roots:  # one process a tree: each imports its own package
            subprocess.run([sys.executable, __file__, "--host-of", root], check=True)
        print(subprocess.run(smi, capture_output=True, text=True).stdout.strip())
        return
    sys.path.insert(0, str(ROOT))
    from chip_smoke import compare_surround
    from meters_lv2_torch.ops import surround_fused
    from meters_lv2_torch.runtime import build

    names = ["parent", "kernel"] if args.host else [n for n in VARIANTS if n in args.variants]
    shutil.rmtree(OUT, ignore_errors=True)
    built = build_variants(names)
    build.kernels()  # the package's own build, for its build.log
    dev = torch.device("cuda", 0)
    fns = {n: launcher(p, VARIANTS[n][0] in WIDE_BASES) for n, (p, _) in built.items()}
    prepared = {}

    def prepare(a):
        """The launcher's arguments for fused_core's arguments ``a``, and
        the output views: built once, so a launch is the ctypes call alone."""
        if id(a) not in prepared:
            x, kz, zl, sa, sb, km_sys, lp_sys, w1, wv = a
            B, C, _ = x.shape
            P = sa.shape[0]
            km, lp = km_sys.op(32).tensors(dev), lp_sys.op(128).tensors(dev)
            o = torch.empty(B * C * 4 + B * P * 3, device=dev)
            outs = (o[:B * C * 2].view(B, C, 2), o[B * C * 2:B * C * 3].view(B, C, 1),
                    o[B * C * 3:B * C * 4].view(B, C), o[B * C * 4:].view(B, P, 3))
            argv = (x.data_ptr(), kz.data_ptr(), zl.data_ptr(), sa.data_ptr(), sb.data_ptr(),
                    wv.data_ptr(), km.at.data_ptr(), km.g.data_ptr(), lp.at.data_ptr(),
                    lp.sy.data_ptr(), float(np.float32(w1)), float(np.float32(1.0 - w1)),
                    surround_fused.lowpass_eps(w1), B, C, T, *(t.data_ptr() for t in outs),
                    torch.cuda.current_stream(dev).cuda_stream)
            prepared[id(a)] = (a, argv, outs)  # a kept: its id stays unique
        return prepared[id(a)][1:]

    def launch(name, a):
        argv, outs = prepare(a)
        rc = fns[name](*argv)
        if rc:
            raise RuntimeError(f"{name}: launch failed with CUDA error {rc}")
        return outs

    def bits(u, v):
        return all(torch.equal(p.view(torch.int32), q.view(torch.int32)) for p, q in zip(u, v))

    def check(name, a, ref, tag):
        """chip_smoke.py's compare_surround (its line printed); two launches
        compared bit for bit; a wide variant's km_z, zl and pk against the
        narrow kernel's bit for bit."""
        got = [t.clone() for t in launch(name, a)]
        again = launch(name, a)
        torch.cuda.synchronize()
        _, errs = compare_surround(got, ref, f"{name}, {tag}")
        out = ("ok" if not errs else "FAILS: " + "; ".join(errs)) + (
            "" if bits(got, again) else "; two launches DIFFER")
        if VARIANTS[name][0] in WIDE_BASES and "kernel" in fns:
            narrow = [t.clone() for t in launch("kernel", a)]
            torch.cuda.synchronize()
            out += ("; km_z, zl, pk bit-identical to the narrow kernel" if bits(got[:3], narrow[:3])
                    else "; km_z, zl, pk DIFFER from the narrow kernel")
        return out

    def ms(name, a, reps=10):
        launch(name, a)  # warm
        times = []
        for _ in range(5):
            torch.cuda._sleep(2_000_000)  # ~1 ms: the launches queue behind it
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            for _ in range(reps):
                launch(name, a)
            e1.record()
            e1.synchronize()
            times.append(e0.elapsed_time(e1) / reps)
        return statistics.median(times)

    def fmt(v):
        return f"{statistics.mean(v):.5f} ms (medians {[round(t, 5) for t in v]})"

    if args.host:
        a = surround_inputs(5, 256, "gauss", dev)
        calls = {n: (lambda n=n: launch(n, a)) for n in fns}
        calls["fused_core (the package's wrapper)"] = lambda: surround_fused.fused_core(*a)
        for name, fn in calls.items():
            per = []
            for _ in range(5):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for _ in range(100):
                    fn()
                per.append((time.perf_counter() - t0) / 100 * 1e6)
                torch.cuda.synchronize()
            print(f"host enqueue, B=256 C=5: {name} {statistics.median(per):.1f} us a call "
                  f"(runs of 100: {[round(p, 1) for p in per]})", flush=True)
        print(subprocess.run(smi, capture_output=True, text=True).stdout.strip())
        return
    pair = [n for n in ("parent", "kernel", "wide-parent", "wide") if n in fns]
    for B, C in SHAPES:
        for kind in INPUTS:
            a = surround_inputs(C, B, kind, dev)
            ref = surround_fused.fused_core_reference(*a)
            checks = [f"{n} {check(n, a, ref, f'B={B} C={C} {kind}')}" for n in pair]
            res = {n: [] for n in pair}
            if kind == "gauss":
                for _ in range(args.rounds):
                    for n in pair + pair[::-1]:
                        res[n].append(ms(n, a))
            bound = (B * C * T + T) * 4 / HBM * 1e3
            print(f"B={B} C={C} T={T} {kind}: "
                  + "".join(f"{n} {fmt(v)}, " for n, v in res.items() if v)
                  + f"byte bound {bound:.5f} ms; vs the plain version: " + "; ".join(checks),
                  flush=True)
            prepared.clear()
            del a, ref
    for B, C in ((256, 8), (256, 5), (256, 3), (8, 8), (8, 5), (1, 5), (1, 8)):
        a = surround_inputs(C, B, "gauss", dev)
        ref = surround_fused.fused_core_reference(*a)
        res, refused = {n: [] for n in fns}, {}
        for _ in range(args.rounds):
            for n in fns:
                if n in refused:
                    continue
                try:
                    res[n].append(ms(n, a))
                except RuntimeError as e:  # a variant's ring beyond the shared memory
                    refused[n] = str(e)
        for n, why in refused.items():
            print(f"B={B} C={C} gauss, in turn: {n} does not launch: {why}", flush=True)
            del res[n]
        for n, v in res.items():
            note = "" if n in CORRECT else " (wrong results by design)"
            ok = f"; {check(n, a, ref, f'B={B} C={C}')}" if n in CORRECT else ""
            print(f"B={B} C={C} gauss, in turn: {n} {fmt(v)}{note}{ok}", flush=True)
        prepared.clear()
        del a, ref
    for n, (path, text) in built.items():
        print(f"ptxas {n}: {ptxas_summary(text)}")
        for kern, (count, ops, loops) in sass_counts(path).items():
            top = ", ".join(f"{k} {v}" for k, v in ops.most_common(14))
            print(f"sass {n} {kern[-36:]}: {count} instructions (static); loop bodies {loops}; {top}")
    log = (build.BUILD_DIR / "build.log").read_text()
    print(f"ptxas, build/meters_lv2_torch/build.log: {ptxas_summary(log)}")
    print(subprocess.run(smi, capture_output=True, text=True).stdout.strip())


if __name__ == "__main__":
    main()
