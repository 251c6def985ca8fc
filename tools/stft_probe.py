#!/usr/bin/env python3
"""What bounds stft_fused: the kernel against its parent body, and cuts.

Run from the root of a checkout, on a machine with a CUDA card and nvcc:

    python3 tools/stft_probe.py [--rounds 3] [--variants NAME ...]

Each variant is meters_lv2_torch/csrc/stft_fused.cu (or the parent body,
tools/stft_probe_parent.cu, a verbatim copy of the body before its Hopper
redesign) with a few lines replaced, built with nvcc -Xptxas -v into
build/stft_probe/ (one process per variant, all started together) and
loaded with ctypes:

  parent              the parent body as it is;
  parent-no-atan2     its two atan2f calls a bin replaced by 0 (phase 0);
  parent-no-passes    its Stockham passes after the first skipped: the first
                      pass's loads, DFT and stores and the epilogue remain;
  parent-no-dft       every in-register DFT and twiddle product skipped:
                      the loads, the stores, the twiddle loads and the
                      barriers remain;
  parent-no-twiddles  the twiddle loads and their fold replaced by constants;
  parent-no-barriers  every __syncthreads removed (shared memory races);
  parent-no-stores    the epilogue computes every bin but stores nothing
                      (the stores sit behind a test no frame passes);
  parent-fft-only     the epilogue skipped (one store a thread remains);
  kernel              the source as it is;
  kernel-poly         the kernel with atan2f replaced by a polynomial atan2
                      (ATAN2_POLY below: one division, the Cephes atanf
                      polynomial): the A/B of that lever;
  kernel-two-atan2    the phase difference as two atan2 on every bin, not
                      one of X_R conj(X_L): the A/B of the one atan2;
  kernel-inline-apart the two-atan2 fallback inlined (the kernel calls it
                      out of line);
  kernel-no-atan2     the kernel with phase difference 0;
  kernel-fft-only     the kernel with no epilogue (one store a thread);
  kernel-cta-barrier  each channel's named barrier (bar.sync id, threads)
                      and the hand-over's replaced by __syncthreads: the two
                      channels' FFTs coupled again;
  kernel-no-vote      the phase computed on every bin (no warp vote);
  kernel-no-twiddles  the passes' twiddle loads replaced by constants;
  kernel-no-exchange  no hand-over between the channels (each reads its
                      own Z where the other's values would be);
  kernel-hot-loads    every CTA's first pass reads stream 0's first frame
                      (L1- and L2-resident): the cost of the sample loads;
  kernel-no-window    the window's loads replaced by 1;
  kernel-stcs         the outputs stored with st.global.cs (evict first):
                      L2 kept for the frames' overlapping samples;
  kernel-no-stores    the epilogue computes every output but stores none.

The parents, kernel, kernel-poly, kernel-two-atan2, kernel-inline-apart,
kernel-no-vote and kernel-stcs compute the function; the other variants
compute wrong results by design and are timed only.  Inputs: tests/test_torch_cuda.py::stft_inputs
(0.3 N(0, 1) plus a 997 Hz sine, seed W + B) at W = 8192, hop 1920, F = 25.
For B = 1, 8 and 256 and each mode (raw, phasewheel, stereoscope): the
parent's and the kernel's results against the plain version
(tests/test_torch_cuda.py::stft_close, whose bars chip_smoke.py uses: the
worst error and the breaches), and their CUDA-event median ms over 7
launches through ctypes (no Python wrapper in the timed span), alternated
parent, kernel, kernel, parent for --rounds rounds.  Then every variant in
turn at B = 256 in the phase wheel's mode, and the parent, the kernel and
kernel-no-vote on a sparse spectrum (a sine over noise at 1e-7: most bins
below the threshold, where the vote skips the phase).  Then, from ``cuobjdump
-sass`` of each variant's library, the instructions of the W = 8192 kernel
by opcode class (static counts; the size of each loop body, found from its
backward branch, beside them), and the registers and spills ptxas reported
for each variant and for the package's own build
(build/meters_lv2_torch/build.log).  The last line is the card's name and
power limit from nvidia-smi.

    python3 tools/stft_probe.py --analyzer-roots PARENT . . PARENT

times only the phasewheel and stereoscope meters, as chip_smoke.py's phase
times does (ms per update, host enqueue, torch.profiler device time per
update and the STFT kernel's part), from each tree in turn, one process a
tree: PARENT a ``git archive`` of another commit unpacked in a directory
.gitignore lists.
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
OUT = ROOT / "build" / "stft_probe"
W, HOP, F = 8192, 1920, 25
THR = {"raw": 0.0, "phasewheel": 1e-6, "stereoscope": 1e-20}  # chip_smoke.py's
MODES = ("raw", "phasewheel", "stereoscope")
BATCHES = (1, 8, 256)

_PARENT_PASS = "  for (int p = 1; p < LOG2N / 4; ++p, Ns *= 16) stockham_pass<LOG2N, 16>(z, tw, tid, Ns);\n"
_PARENT_ODD = "  if constexpr (LOG2N % 4 != 0) stockham_pass<LOG2N, (1 << (LOG2N % 4))>(z, tw, tid, Ns);\n"
_PARENT_EPI = "  for (int k = tid; k < N; k += kThreads) {\n"
_PHASE_DIFF = "// the phase of r less the phase of l where r conj(l) could lose the angle:"
# atan2f(y, x) from one IEEE division and the Cephes atanf polynomial
# (meters_lv2_tpu/ops/pallas_stft.py::_atan2's coefficients, reduced to
# |a| <= tan(pi/8), the octant added in one rounding, atan2f's signed zeros,
# infinities and NaN kept): the kernel-poly variant's phase
ATAN2_POLY = """__device__ __forceinline__ float atan2_poly(float y, float x) {
  constexpr float kTanPi8 = 0.41421356237309503f;
  constexpr float kPi4Hi = 0.785398006439209f;       // pi/4 to 21 bits
  constexpr float kPi4Lo = 1.5695823663008923e-07f;  // pi/4 - kPi4Hi
  const float ax = fabsf(x), ay = fabsf(y);
  const float mx = fmaxf(ax, ay), mn = fminf(ax, ay);
  const bool inf2 = mn == __int_as_float(0x7f800000);  // both infinite: the ratio is 1
  const bool red = inf2 || mn > kTanPi8 * mx;
  const float s = mx > 0x1p126f ? 0.25f : 1.f;  // keeps mn + mx finite, exactly
  const float q = (red ? s * mn - s * mx : s * mn) / (red ? s * mn + s * mx : s * mx);
  const float a = (inf2 || mx == 0.f) ? 0.f : q;
  const float z = a * a;
  const float p = fmaf(fmaf(fmaf(8.05374449538e-2f, z, -1.38776856032e-1f), z,
                            1.99777106478e-1f), z, -3.33329491539e-1f);
  const float at = fmaf(a * z, p, a);
  const bool swap = ay > ax, neg = __float_as_int(x) < 0;
  float n = red ? 1.f : 0.f;
  n = swap ? 2.f - n : n;
  n = neg ? 4.f - n : n;
  const float t = fmaf(n, kPi4Hi, fmaf(n, kPi4Lo, swap != neg ? -at : at));
  return (x != x || y != y) ? x + y : copysignf(t, y);
}


"""
VARIANTS = {
    "parent": ("parent", []),
    "parent-no-atan2": ("parent", [
        ("edge ? 0.f : atan2f(im[0], re[0])", "0.f"),
        ("edge ? 0.f : atan2f(im[1], re[1])", "0.f")]),
    "parent-no-passes": ("parent", [(_PARENT_PASS, ""), (_PARENT_ODD, "")]),
    "parent-no-dft": ("parent", [
        ("    dft_reg<R>(v);\n", ""), ("    dft_reg<16>(v);\n", ""),
        ("      v[r] = cmul(v[r], w);\n", "      v[r] = make_float2(v[r].x + w.x, v[r].y + w.y);\n")]),
    "parent-no-twiddles": ("parent", [
        ("      float2 w = tw[k < N ? k : k - N];\n      if (k >= N) w = make_float2(-w.x, -w.y);\n",
         "      const float2 w = make_float2(0.9f, 0.1f * r);\n")]),
    "parent-no-barriers": ("parent", [("__syncthreads();", "", 3)]),
    "parent-no-stores": ("parent", [
        ("        out_a[o] = re[c];\n        out_b[o] = im[c];\n",
         "        if (f < 0) { out_a[o] = re[c]; out_b[o] = im[c]; }\n"),
        ("      out_a[o] = ok ? phr - phl : 0.f;\n      out_b[o] = ok ? fmaxf(pl, pr) : -100.f;\n",
         "      if (f < 0) { out_a[o] = ok ? phr - phl : 0.f; out_b[o] = ok ? fmaxf(pl, pr) : -100.f; }\n"),
        ("      out_a[o] = ok ? pos : 0.5f;\n      out_b[o] = ok ? lv : 0.f;\n",
         "      if (f < 0) { out_a[o] = ok ? pos : 0.5f; out_b[o] = ok ? lv : 0.f; }\n")]),
    "parent-fft-only": ("parent", [
        (_PARENT_EPI, "  if (tid < 2) out_a[(size_t)blockIdx.x * 2 + tid] = z[sw(tid)].x;\n"
                      "  for (int k = tid; k < 0; k += kThreads) {\n")]),
    "kernel": ("kernel", []),
    "kernel-poly": ("kernel", [
        (_PHASE_DIFF, ATAN2_POLY + _PHASE_DIFF),
        ("= atan2f(fmaf", "= atan2_poly(fmaf"),
        ("return atan2f(r.y, r.x) - atan2f(l.y, l.x);",
         "return atan2_poly(r.y, r.x) - atan2_poly(l.y, l.x);")]),
    "kernel-two-atan2": ("kernel", [
        ("  if (!(m >= 0x1p-100f && m <= 0x1p100f)) return phase_difference_apart(l, r);",
         "  return phase_difference_apart(l, r);")]),
    "kernel-inline-apart": ("kernel", [("__device__ __noinline__ float phase_difference_apart(",
                                        "__device__ __forceinline__ float phase_difference_apart(")]),
    "kernel-no-atan2": ("kernel", [
        ("d = bin == 0 || bin == kN - 1 ? 0.f : phase_difference(l, r);", "d = 0.f;")]),
    "kernel-fft-only": ("kernel", [
        ("  epilogue<kMode>(",
         "  if (threadIdx.x < 2) out_a[(size_t)blockIdx.x * 2 + threadIdx.x] = zs[threadIdx.x].x;\n"
         "  if (false) epilogue<kMode>(")]),
    "kernel-cta-barrier": ("kernel", [
        ('  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(n) : "memory");',
         "  __syncthreads();")]),
    "kernel-no-vote": ("kernel", [("if (__any_sync(0xffffffffu, ok)) ", "")]),
    "kernel-no-twiddles": ("kernel", [
        ("v[r] = cmul(v[r], t[NS * (r - 1)]);", "v[r] = cmul(v[r], make_float2(0.9f, 0.1f * r));")]),
    "kernel-no-exchange": ("kernel", [
        ("  bar_sync(3 + j / 32, 64);  // warp j / 32 of each channel\n"
         "  const float2* zo = zs + (1 - c) * kN;", "  const float2* zo = zs + c * kN;")]),
    "kernel-hot-loads": ("kernel", [
        ("first_pass(ext + ((size_t)b * 2 + c) * L + (size_t)hop * (f + 1), win, z, j);",
         "first_pass(ext + (size_t)c * L + hop, win, z, j);")]),
    "kernel-no-window": ("kernel", [
        ("const float2 s = x2[kM * r], w = w2[jj + kM * r];",
         "const float2 s = x2[kM * r], w = make_float2(1.f, 1.f);")]),
    "kernel-stcs": ("kernel", [
        ("    oa[bin] = r.x;\n    ob[bin] = r.y;\n",
         "    __stcs(oa + bin, r.x);\n    __stcs(ob + bin, r.y);\n")]),
    "kernel-no-stores": ("kernel", [
        ("    oa[bin] = r.x;\n    ob[bin] = r.y;\n",
         "    if (thr == 1234.5f) {\n      oa[bin] = r.x;\n      ob[bin] = r.y;\n    }\n")]),
}
CORRECT = ("parent", "kernel", "kernel-poly", "kernel-two-atan2", "kernel-inline-apart",
           "kernel-no-vote", "kernel-stcs")


def variant_source(name):
    base, patches = VARIANTS[name]
    path = ROOT / "tools" / "stft_probe_parent.cu" if base == "parent" else CSRC / "stft_fused.cu"
    src = path.read_text()
    for old, new, *count in patches:
        want = count[0] if count else 1
        if src.count(old) != want:
            sys.exit(f"tools/stft_probe.py: variant {name}: the text to replace is not in "
                     f"{path.name} {want} time(s): {old.strip()[:60]!r}")
        src = src.replace(old, new)
    return src


def new_signature(src):
    """Whether the source's launcher takes the pass twiddle table (ptw)."""
    return "const float* ptw," in src


def build_variants(names):
    """Write and compile the named variants; {name: (.so path, ptxas output, new signature)}."""
    sys.path.insert(0, str(ROOT))
    from meters_lv2_torch.runtime import build

    OUT.mkdir(parents=True, exist_ok=True)
    cmds, libs, sigs = [], {}, {}
    for name in names:
        cu = OUT / f"{name}.cu"
        src = variant_source(name)
        cu.write_text(src)
        sigs[name] = new_signature(src)
        libs[name] = OUT / f"lib{name}.so"
        cmds.append([build._nvcc(), *build.NVCC_FLAGS, "-I", str(CSRC), "-shared", "-o",
                     str(libs[name]), str(cu)])
    out = {}
    for (cmd, rc, text), name in zip(build._run_all(cmds), names):
        if rc:
            sys.exit(f"nvcc failed for {cmd[-1]}:\n{text[-3000:]}")
        out[name] = (libs[name], text, sigs[name])
    return out


def ptxas_summary(text):
    """'<kernel>: N registers, spill S/L B' for each stft_fused kernel in
    ptxas -v output."""
    lines, cur, spill = [], None, ""
    for ln in text.splitlines():
        m = re.search(r"Compiling entry function '(\S*stft_(?:fused|hopper|generic)_kernel\S*)'", ln)
        if m:
            cur = m.group(1)
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


def _cuobjdump():
    from torch.utils.cpp_extension import CUDA_HOME

    for c in (shutil.which("cuobjdump"), os.path.join(CUDA_HOME or "", "bin", "cuobjdump")):
        if c and os.access(c, os.X_OK):
            return c
    return None


def sass_counts(lib):
    """{kernel name: (static instruction count, Counter of opcode classes,
    [loop body sizes])} for the W = 8192 kernels of a built library (the
    parent's stft_fused_kernel<12>, the Hopper body's one a mode), from
    cuobjdump -sass."""
    tool = _cuobjdump()
    if tool is None:
        return {}
    text = subprocess.run([tool, "-sass", str(lib)], capture_output=True, text=True).stdout
    out, name, ins = {}, None, []

    def close():
        if name and ("stft_hopper_kernel" in name or "stft_fused_kernelILi12E" in name):
            ops = collections.Counter(op.split(".")[0] for _, op, _ in ins if op != "NOP")
            addr = {a: i for i, (a, _, _) in enumerate(ins)}
            loops = []
            for i, (a, op, rest) in enumerate(ins):
                t = re.search(r"`\(\.L_x_\d+\)|0x([0-9a-f]+)", rest) if op.startswith("BRA") else None
                if t and t.group(1) and int(t.group(1), 16) < a and int(t.group(1), 16) in addr:
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


def launcher(path, new):
    """The stft_fused_launch of a built variant, with its argument types."""
    vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    f = ctypes.CDLL(str(path)).stft_fused_launch
    f.restype = ci
    f.argtypes = [vp] * (4 if new else 3) + [ci] * 6 + [cf] + [vp] * 3
    return f


def analyzer_times(root):
    """phasewheel and stereoscope from the tree at ``root``, as chip_smoke.py's
    phase times runs them: B=256 streams, 60 updates cycling over 12 flat
    1 s blocks of 0.1 N(0, 1) stereo samples (seed 0), best of 2 runs ended
    by a host copy; the host's enqueue time per update; torch.profiler's
    device time per update over 10 updates and the STFT kernel's part."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    sys.path.insert(0, os.path.abspath(root))
    import meters_lv2_torch

    B, FS, N = 256, 48000, 60
    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(0)
    xs = [torch.as_tensor(rng.standard_normal((B, 2, FS), dtype=np.float32) * np.float32(0.1),
                          device=dev) for _ in range(12)]
    for name in ("phasewheel", "stereoscope"):
        m = meters_lv2_torch.create(name, FS)
        runs, enqueue = [], []
        for _ in range(2):
            _, st = m.process(m.init((B,), device=dev), xs[0])  # warm
            st = m.init((B,), device=dev)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for i in range(N):
                out, st = m.process(st, xs[i % len(xs)])
            enqueue.append(time.perf_counter() - t0)
            torch.cuda.synchronize()
            [v.cpu() for v in out.values()]
            runs.append(time.perf_counter() - t0)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for i in range(10):
                out, st = m.process(st, xs[i % len(xs)])
            torch.cuda.synchronize()
        ev = [(e.key, e.self_device_time_total) for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA and not e.is_user_annotation]
        dev_us = sum(t for _, t in ev) / 10
        stft_us = sum(t for k, t in ev if "stft_" in k) / 10
        print(f"{name} ({root}): {min(runs) / N * 1e3:.3f} ms per update (runs "
              f"{[round(r, 4) for r in runs]} s for {N}); host enqueue "
              f"{[round(e / N * 1e3, 3) for e in enqueue]} ms per update; device time "
              f"{dev_us:.1f} us per update, the STFT kernel {stft_us:.1f} us of it", flush=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--variants", nargs="+", default=list(VARIANTS))
    ap.add_argument("--analyzer-roots", nargs="+", metavar="DIR",
                    help="only time phasewheel and stereoscope from each tree, in this order")
    ap.add_argument("--analyzers-of", metavar="DIR", help=argparse.SUPPRESS)
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        sys.exit("tools/stft_probe.py: no CUDA device")
    if args.analyzers_of:
        analyzer_times(args.analyzers_of)
        return
    if args.analyzer_roots:
        for root in args.analyzer_roots:  # one process a tree: each imports its own package
            subprocess.run([sys.executable, __file__, "--analyzers-of", root], check=True)
        print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True).stdout.strip())
        return
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "tests"))
    from meters_lv2_torch.ops import stft_fused
    from meters_lv2_torch.runtime import build
    from test_torch_cuda import stft_close, stft_inputs

    names = [n for n in VARIANTS if n in args.variants]
    shutil.rmtree(OUT, ignore_errors=True)
    built = build_variants(names)
    build.kernels()  # the package's own build, for its build.log
    dev = torch.device("cuda", 0)
    tw = stft_fused.twiddles(W, dev)
    ptw = stft_fused.pass_twiddles(W, dev) if hasattr(stft_fused, "pass_twiddles") else None
    fns = {n: (launcher(p, new), new) for n, (p, _, new) in built.items()}

    def run(name, ext, win, mode):
        fn, new = fns[name]
        B, _, L = ext.shape
        D = W // 2
        shape = (B, 2, F, D) if mode == "raw" else (B, F, D)
        a = torch.empty(shape, device=dev)
        b = torch.empty(shape, device=dev)
        tabs = [tw.data_ptr(), ptw.data_ptr()] if new else [tw.data_ptr()]
        rc = fn(ext.data_ptr(), win.data_ptr(), *tabs, B, L, W, HOP, F,
                stft_fused.MODES[mode], THR[mode], a.data_ptr(), b.data_ptr(),
                torch.cuda.current_stream(dev).cuda_stream)
        if rc:
            raise RuntimeError(f"{name}: launch failed with CUDA error {rc}")
        return a, b

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

    def fmt(v):
        return f"{statistics.mean(v):.4f} ms (medians {[round(t, 4) for t in v]})"

    pair = [n for n in ("parent", "kernel") if n in fns]
    inputs = {}
    for B in BATCHES:
        ext, win, _ = stft_inputs(B, W, HOP, F, W + B, dev)
        inputs[B] = (ext, win)
        raw = stft_fused.plain_frames(ext, win, HOP, "raw", 0.0)
        for mode in MODES:
            ref = raw if mode == "raw" else stft_fused.plain_frames(ext, win, HOP, mode, THR[mode])
            checks = []
            for n in pair:
                err, errs = stft_close(run(n, ext, win, mode), ref, raw, mode, THR[mode])
                checks.append(f"{n} err {err:.3g} {'ok' if not errs else errs}")
            ms = {n: [] for n in pair}
            for _ in range(args.rounds):
                for n in (pair + pair[::-1]):
                    ms[n].append(median_ms(lambda: run(n, ext, win, mode)))
            print(f"B={B} W={W} hop {HOP} F={F} {mode}: "
                  + ", ".join(f"{n} {fmt(v)}" for n, v in ms.items())
                  + "; vs the plain version: " + "; ".join(checks), flush=True)
            del ref
        del raw

    ext, win = inputs[256]
    ms = {n: [] for n in names}
    for _ in range(args.rounds):
        for n in names:
            ms[n].append(median_ms(lambda: run(n, ext, win, "phasewheel")))
    for n, v in ms.items():
        note = " (wrong results by design)" if n not in CORRECT else ""
        print(f"B=256 phasewheel, in turn: {n} {fmt(v)}{note}", flush=True)

    # a sparse spectrum, where the warp vote skips phases: a 997 Hz sine at
    # 0.5 over noise at 1e-7 (most bins fall below thr = 1e-6)
    quiet = [n for n in ("parent", "kernel", "kernel-no-vote") if n in fns]
    if "kernel" in fns:
        t = np.arange(ext.shape[-1]) / 48000
        sparse = (0.5 * np.sin(2 * np.pi * 997 * t)
                  + 1e-7 * np.random.default_rng(1).standard_normal(ext.shape))
        xs = torch.as_tensor(sparse.astype(np.float32), device=dev)
        _, lv = run("kernel", xs, win, "phasewheel")
        below = (lv == -100).float().mean().item()
        ms = {n: [] for n in quiet}
        for _ in range(args.rounds):
            for n in quiet + quiet[::-1]:
                ms[n].append(median_ms(lambda: run(n, xs, win, "phasewheel")))
        print(f"B=256 phasewheel, sparse input ({100 * below:.1f} % of the bins below thr): "
              + ", ".join(f"{n} {fmt(v)}" for n, v in ms.items()), flush=True)
        del xs

    for n, (path, text, _) in built.items():
        print(f"ptxas {n}: {ptxas_summary(text)}")
        for kern, (count, ops, loops) in sass_counts(path).items():
            top = ", ".join(f"{k} {v}" for k, v in ops.most_common(14))
            print(f"sass {n} {kern}: {count} instructions (static); loop bodies {loops}; {top}")
    log = (build.BUILD_DIR / "build.log").read_text()
    print(f"ptxas, build/meters_lv2_torch/build.log: {ptxas_summary(log)}")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout.strip())


if __name__ == "__main__":
    main()
