#!/usr/bin/env python3
"""What bounds bitmeter_stats: the kernel against its parent body, and cuts.

Run from the root of a checkout, on a machine with a CUDA card and nvcc:

    python3 tools/bitmeter_probe.py [--rounds 3] [--variants NAME ...]

Each variant is meters_lv2_torch/csrc/bitmeter_stats.cu (or the parent
body, tools/bitmeter_probe_parent.cu, a verbatim copy of the body before its
Hopper redesign) with a few lines replaced, built with nvcc -Xptxas -v into
build/bitmeter_probe/ (one process per variant, all started together) and
loaded with ctypes.  Both bodies export the same launcher; the parent's
outputs are zeroed (vmin filled with +inf) before its launches, outside the
timed span, as its wrapper did:

  parent              the parent body as it is;
  parent-no-match     __match_any_sync replaced by one group per warp (the
                      numbers' ballot): counts wrong, timing only;
  parent-no-atomics   the leaders' shared atomics replaced by a register
                      sink (their popcounts stay): counts wrong;
  parent-no-fold      the fold, the dset loop and every global atomic after
                      the main loop removed: outputs unwritten;
  parent-no-zero      the shared counters not zeroed: counts wrong;
  parent-lane-flags   the five flag ballots and popcounts a segment replaced
                      by per-lane counters reduced once (correct);
  parent-chunk-N      kChunk = N samples a CTA (1024 .. 65536; 65536 is one
                      CTA a row at T = 48000) (correct);
  kernel              the source as it is;
  kernel-chunks-N     the kernel with N CTAs (one cluster) a row at every
                      batch, in place of its choice (correct);
  kernel-no-hs        the kernel's bit-sliced (Harley-Seal) sums and their
                      transposes cut from the fast path (its words are
                      computed and xored): counts wrong;
  kernel-no-generic   the generic pass never runs: counts wrong wherever a
                      sample leaves the fast path;
  kernel-no-cluster   the cluster's sums and the output stores cut (each CTA
                      stops after its own flush): outputs unwritten;
  kernel-loads-only   the loads, the a choice, the flushes, the cluster's
                      sums and the outputs remain; every sample's words and
                      counting cut.

Inputs, tests/test_torch_bitmeter_body.py::bitmeter_rows at T = 48000,
seed 0: gauss (0.1 N(0, 1), the main path's level); diverse (gauss times
2^U(-60, 60), as tests/test_torch_stats.py::_weird_rows' third row);
square (one exponent a row); silence (zeros with one sample in 1,000 of
gauss); denormal (random mantissas with exponent 0, random sign).
For B = 1, 8 and 256 and each input: the parent's and the kernel's results
against the plain version (every field exact), and their CUDA-event ms a
launch (10 launches queued behind a sleep kernel, so the host's launch time
is hidden; median of 5), alternated parent, kernel, kernel, parent for
--rounds rounds.  Then every variant in turn at B = 256 on gauss and on
diverse, and at B = 8 on gauss and on silence.  Then, from ``cuobjdump -sass`` of each variant's library, the
bitmeter kernel's static instructions by opcode class and the size of each
loop body (found from its backward branch), and the registers and spills
ptxas reported.  The last line is the card's name and power limit from
nvidia-smi.

    python3 tools/bitmeter_probe.py --host

times only the host's side of a launch at B = 256: the parent's and the
kernel's launcher through ctypes and the package's wrapper
(ops/bitmeter_stats.py), each over runs of 100 calls that end in a
synchronize, the median run's us a call.

    python3 tools/bitmeter_probe.py --update-roots PARENT . . PARENT

times only the bit meter's update, as tools/meter_times.py runs it (B=256,
channel 0 of [256, 2, 48000] blocks of 0.1 N(0, 1), rows strided): ms per
update over 60 updates, the host's enqueue, and from one torch.profiler
pass over 10 updates the device time per update, the bitmeter kernel's
part, and the device launches per update by name; from each tree in turn,
one process a tree: PARENT a ``git archive`` of another commit unpacked in
a directory .gitignore lists.
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
OUT = ROOT / "build" / "bitmeter_probe"
T = 48000
BATCHES = (1, 8, 256)
INPUTS = ("gauss", "diverse", "square", "silence", "denormal")

_P_MATCH = "    const unsigned grp = __match_any_sync(kFull, is_num ? e : 256u);\n"
_P_FLAGS = ("    c_nan += __popc(__ballot_sync(kFull, in && e == 255u && m != 0u));\n"
            "    c_inf += __popc(__ballot_sync(kFull, in && e == 255u && m == 0u));\n"
            "    c_den += __popc(__ballot_sync(kFull, in && e == 0u && m != 0u));\n"
            "    c_zero += __popc(__ballot_sync(kFull, in && e == 0u && m == 0u));\n"
            "    c_pos += __popc(__ballot_sync(kFull, is_num && (bits >> 31) == 0u));\n")
_P_LANE_FLAGS = ("    c_nan += in && e == 255u && m != 0u;\n"
                 "    c_inf += in && e == 255u && m == 0u;\n"
                 "    c_den += in && e == 0u && m != 0u;\n"
                 "    c_zero += in && e == 0u && m == 0u;\n"
                 "    c_pos += is_num && (bits >> 31) == 0u;\n")
_P_FLUSH = "  if (lane == 0) {\n    atomicAdd(&s_flag[0], c_nan);\n"
_P_REDUCE = ("  c_nan = __reduce_add_sync(kFull, c_nan);\n"
             "  c_inf = __reduce_add_sync(kFull, c_inf);\n"
             "  c_den = __reduce_add_sync(kFull, c_den);\n"
             "  c_zero = __reduce_add_sync(kFull, c_zero);\n"
             "  c_pos = __reduce_add_sync(kFull, c_pos);\n")
_P_FOLD = "  // fold (e, k) into absolute positions j = e_eff + k\n"

VARIANTS = {
    "parent": ("parent", []),
    "parent-no-match": ("parent", [(_P_MATCH, "    const unsigned grp = __ballot_sync(kFull, is_num);\n")]),
    "parent-no-atomics": ("parent", [
        ("  int lo = kInfBits, hi = 0;  // per lane\n",
         "  int lo = kInfBits, hi = 0;  // per lane\n  int sink = 0;\n"),
        ("      atomicAdd(&s_exp[e], __popc(grp));\n", "      sink += __popc(grp);\n"),
        ("        if (n) atomicAdd(&s_bit[e][k], n);\n", "        sink ^= n << (k & 7);\n"),
        ("  lo = __reduce_min_sync(kFull, lo);\n",
         "  if (sink == 0x7fffffff) s_flag[0] = sink;\n  lo = __reduce_min_sync(kFull, lo);\n")]),
    "parent-no-fold": ("parent", [(_P_FOLD, "  if (tid == 0 && s_exp[1] == 12345) hit[row * kNpos] = "
                                            "s_bit[0][0] + s_flag[0] + s_min;\n  return;\n")]),
    "parent-no-zero": ("parent", [
        ("  for (int i = tid; i < kExp * kMan; i += kThreads) (&s_bit[0][0])[i] = 0;\n"
         "  for (int i = tid; i < kExp; i += kThreads) s_exp[i] = 0;\n", "")]),
    "parent-lane-flags": ("parent", [(_P_FLAGS, _P_LANE_FLAGS), (_P_FLUSH, _P_REDUCE + _P_FLUSH)]),
    "kernel": ("kernel", []),
}
for _n in (1024, 2048, 8192, 16384, 65536):
    VARIANTS[f"parent-chunk-{_n}"] = ("parent", [("constexpr int kChunk = 4096;",
                                                  f"constexpr int kChunk = {_n};")])
# the kernel's own variants; each names the text it replaces in
# meters_lv2_torch/csrc/bitmeter_stats.cu
_K_CHOICE = "  const int want = (2 * sms + N - 1) / N;\n"
for _n in (1, 2, 4, 8):
    VARIANTS[f"kernel-chunks-{_n}"] = ("kernel", [(_K_CHOICE, f"  const int want = {_n};\n")])
VARIANTS["kernel-no-hs"] = ("kernel", [
    *[(f"    s{q} |= hs_pair<P>(h{h}, t{t}, u.{w}, v.{w});", f"    s{q} |= u.{w} ^ v.{w};")
      for q, h, t, w in (("d", "d", "d", "d"), ("l", "lo", "l", "lo"), ("h", "hi", "h", "hi"),
                         ("o", "o", "q", "o"))],
    ("      hs_sixteens(hd, sd, tr);\n      hs_sixteens(hlo, sl, tr);\n"
     "      hs_sixteens(hhi, sh, tr);\n      hs_sixteens(ho, so, tr);\n",
     "      st.dgen += (sd ^ sl ^ sh ^ so) == 0x12345678u;\n")])
_K_GENERIC = ("    if (__any_sync(kFull, slow != 0u)) {\n", "    if (false) {\n")
VARIANTS["kernel-no-generic"] = ("kernel", [_K_GENERIC])
VARIANTS["kernel-no-cluster"] = ("kernel", [
    ("  cluster_arrive();  // zeroed: the others may add into the first CTA's counters\n", ""),
    ("  cluster_wait();  // every CTA's counters are zeroed\n", "  return;\n")])
VARIANTS["kernel-loads-only"] = ("kernel", [
    _K_GENERIC, ("    if (fast) {\n", "    if (false) {\n"),
    ("    const unsigned a0 = (w[0] >> 28) & 7u;\n",
     "    for (int i = 1; i < 4 * kSlots; ++i) st.dgen ^= w[i];\n"
     "    const unsigned a0 = (w[0] >> 28) & 7u;\n")])
CORRECT = {"parent", "parent-lane-flags", "kernel"} | {
    n for n in VARIANTS if n.startswith(("parent-chunk-", "kernel-chunks-"))}


def variant_source(name):
    base, patches = VARIANTS[name]
    path = ROOT / "tools" / "bitmeter_probe_parent.cu" if base == "parent" else CSRC / "bitmeter_stats.cu"
    src = path.read_text()
    for old, new in patches:
        if src.count(old) != 1:
            return None  # the text is not in this source (the kernel before its redesign)
        src = src.replace(old, new)
    return src


def build_variants(names):
    """Write and compile the named variants that apply to the sources;
    {name: (.so path, ptxas output)}."""
    sys.path.insert(0, str(ROOT))
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
    """'<kernel>: N registers, spill S/L B, smem B' for each bitmeter kernel
    in ptxas -v output."""
    lines, cur, spill, smem = [], None, "", ""
    for ln in text.splitlines():
        m = re.search(r"Compiling entry function '(\S*bitmeter\S*)'", ln)
        if m:
            cur, spill, smem = m.group(1), "", ""
        elif "Compiling entry function" in ln:
            cur = None
        elif cur and "spill stores" in ln:
            s = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", ln)
            spill = f"spill {s.group(1)}/{s.group(2)} B"
            s = re.search(r"(\d+) bytes stack frame", ln)
            spill += f", stack {s.group(1)} B" if s else ""
        elif cur and "Used" in ln and "registers" in ln:
            regs = re.search(r"Used (\d+) registers", ln).group(1)
            s = re.search(r"(\d+) bytes smem", ln)
            smem = f", smem {s.group(1)} B" if s else ""
            lines.append(f"{cur}: {regs} registers, {spill}{smem}")
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
    [loop body sizes])} for the bitmeter kernels of a built library, from
    cuobjdump -sass."""
    tool = _cuobjdump()
    if tool is None:
        return {}
    text = subprocess.run([tool, "-sass", str(lib)], capture_output=True, text=True).stdout
    out, name, ins = {}, None, []

    def close():
        if name and "bitmeter" in name:
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


def launcher(path):
    vp, ci = ctypes.c_void_p, ctypes.c_int
    f = ctypes.CDLL(str(path)).bitmeter_stats_launch
    f.restype = ci
    f.argtypes = [vp, ci, ci, ci] + [vp] * 6 + [vp]
    return f


def update_times(root):
    """The bit meter's update from the tree at ``root`` (module docstring)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    sys.path.insert(0, os.path.abspath(root))
    import meters_lv2_torch

    B, FS, N = 256, 48000, 60
    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(0)
    xs = [torch.as_tensor(rng.standard_normal((B, 2, FS), dtype=np.float32) * np.float32(0.1),
                          device=dev)[:, 0] for _ in range(12)]
    m = meters_lv2_torch.create("bitmeter", FS)
    runs, enqueue = [], []
    for _ in range(2):
        st = m.update(m.init((B,), device=dev), xs[0])  # warm
        st = m.init((B,), device=dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(N):
            st = m.update(st, xs[i % len(xs)])
        enqueue.append(time.perf_counter() - t0)
        out = m.read(st)[0]
        torch.cuda.synchronize()
        [v.cpu() for v in out.values()]
        runs.append(time.perf_counter() - t0)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for i in range(10):
            st = m.update(st, xs[i % len(xs)])
        torch.cuda.synchronize()
    ev = [(e.key, e.self_device_time_total, e.count) for e in prof.key_averages()
          if e.device_type == DeviceType.CUDA and not e.is_user_annotation]
    dev_us = sum(t for _, t, _ in ev) / 10
    kern_us = sum(t for k, t, _ in ev if "bitmeter" in k) / 10
    launches = sum(c for _, _, c in ev) / 10
    names = "; ".join(f"{k[:60]} x{c / 10:g}" for k, _, c in sorted(ev, key=lambda e: -e[2]))
    print(f"bitmeter update ({root}): {min(runs) / N * 1e3:.4f} ms per update (runs "
          f"{[round(r, 4) for r in runs]} s for {N}); host enqueue "
          f"{[round(e / N * 1e3, 4) for e in enqueue]} ms per update; device time "
          f"{dev_us:.1f} us per update, the bitmeter kernel {kern_us:.1f} us of it; "
          f"{launches:g} device launches per update: {names}", flush=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--variants", nargs="+", default=list(VARIANTS))
    ap.add_argument("--update-roots", nargs="+", metavar="DIR",
                    help="only time the bit meter's update from each tree, in this order")
    ap.add_argument("--update-of", metavar="DIR", help=argparse.SUPPRESS)
    ap.add_argument("--host", action="store_true",
                    help="only the host's time to enqueue a launch (see the docstring)")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        sys.exit("tools/bitmeter_probe.py: no CUDA device")
    smi = ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"]
    if args.update_of:
        update_times(args.update_of)
        return
    if args.update_roots:
        for root in args.update_roots:  # one process a tree: each imports its own package
            subprocess.run([sys.executable, __file__, "--update-of", root], check=True)
        print(subprocess.run(smi, capture_output=True, text=True).stdout.strip())
        return
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "tests"))
    from meters_lv2_torch.ops import bitmeter_stats
    from meters_lv2_torch.runtime import build
    from test_torch_bitmeter_body import bitmeter_rows

    names = ["parent", "kernel"] if args.host else [n for n in VARIANTS if n in args.variants]
    shutil.rmtree(OUT, ignore_errors=True)
    built = build_variants(names)
    build.kernels()  # the package's own build, for its build.log
    dev = torch.device("cuda", 0)
    fns = {n: launcher(p) for n, (p, _) in built.items()}
    bufs = {}

    def outputs(B):
        if B not in bufs:
            i32 = dict(dtype=torch.int32, device=dev)
            bufs[B] = dict(hit=torch.empty((B, 280), **i32), one=torch.empty((B, 280), **i32),
                           dset=torch.empty((B, 23), **i32), flags=torch.empty((5, B), **i32),
                           vmin=torch.empty(B, device=dev), vmax=torch.empty(B, device=dev))
        return bufs[B]

    def prefill(o):
        for k in ("hit", "one", "dset", "flags", "vmax"):
            o[k].zero_()
        o["vmin"].fill_(float("inf"))

    def launch(name, x, o):
        rc = fns[name](x.data_ptr(), x.stride(0), x.shape[0], x.shape[1], o["hit"].data_ptr(),
                       o["one"].data_ptr(), o["dset"].data_ptr(), o["flags"].data_ptr(),
                       o["vmin"].data_ptr(), o["vmax"].data_ptr(),
                       torch.cuda.current_stream(dev).cuda_stream)
        if rc:
            raise RuntimeError(f"{name}: launch failed with CUDA error {rc}")

    def check(name, x):
        o = outputs(x.shape[0])
        prefill(o)
        launch(name, x, o)
        ref = bitmeter_stats.bitmeter_stats_reference(x)
        torch.cuda.synchronize()
        got = dict(zip(bitmeter_stats.FLAGS, o["flags"]))
        got.update({k: o[k] for k in ("hit", "one", "dset", "vmin", "vmax")})
        bad = [k for k in ref if not torch.equal(got[k], ref[k])]
        return "exact" if not bad else "DIFFERS in " + ",".join(bad)

    def ms(name, x, reps=10):
        o = outputs(x.shape[0])
        if name.startswith("parent"):
            prefill(o)
        launch(name, x, o)  # warm
        times = []
        for _ in range(5):
            torch.cuda._sleep(2_000_000)  # ~1 ms: the launches queue behind it
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            for _ in range(reps):
                launch(name, x, o)
            e1.record()
            e1.synchronize()
            times.append(e0.elapsed_time(e1) / reps)
        return statistics.median(times)

    def fmt(v):
        return f"{statistics.mean(v):.5f} ms (medians {[round(t, 5) for t in v]})"

    if args.host:
        x = torch.as_tensor(bitmeter_rows("gauss", 256, T), device=dev)
        o = outputs(256)
        calls = {n: (lambda n=n: launch(n, x, o)) for n in fns}
        calls["bitmeter_stats (the package's wrapper)"] = lambda: bitmeter_stats.bitmeter_stats(x)
        for name, fn in calls.items():
            per = []
            for _ in range(5):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for _ in range(100):
                    fn()
                per.append((time.perf_counter() - t0) / 100 * 1e6)
                torch.cuda.synchronize()
            print(f"host enqueue, B=256 gauss: {name} {statistics.median(per):.1f} us a call "
                  f"(runs of 100: {[round(p, 1) for p in per]})", flush=True)
        print(subprocess.run(smi, capture_output=True, text=True).stdout.strip())
        return
    pair = [n for n in ("parent", "kernel") if n in fns]
    inputs = {}
    for B in BATCHES:
        for kind in INPUTS:
            x = torch.as_tensor(bitmeter_rows(kind, B, T), device=dev)
            inputs[(B, kind)] = x
            checks = [f"{n} {check(n, x)}" for n in pair]
            res = {n: [] for n in pair}
            for _ in range(args.rounds):
                for n in pair + pair[::-1]:
                    res[n].append(ms(n, x))
            print(f"B={B} T={T} {kind}: " + ", ".join(f"{n} {fmt(v)}" for n, v in res.items())
                  + "; vs the plain version: " + "; ".join(checks), flush=True)
    for B, kind in ((256, "gauss"), (256, "diverse"), (8, "gauss"), (8, "silence")):
        x = inputs[(B, kind)]
        res = {n: [] for n in fns}
        for _ in range(args.rounds):
            for n in fns:
                res[n].append(ms(n, x))
        for n, v in res.items():
            note = "" if n in CORRECT else " (wrong results by design)"
            ok = f"; {check(n, x)}" if n in CORRECT else ""
            print(f"B={B} {kind}, in turn: {n} {fmt(v)}{note}{ok}", flush=True)
    for n, (path, text) in built.items():
        print(f"ptxas {n}: {ptxas_summary(text)}")
        for kern, (count, ops, loops) in sass_counts(path).items():
            top = ", ".join(f"{k} {v}" for k, v in ops.most_common(16))
            print(f"sass {n} {kern[:50]}: {count} instructions (static); loop bodies {loops}; {top}")
    log = (build.BUILD_DIR / "build.log").read_text()
    print(f"ptxas, build/meters_lv2_torch/build.log: {ptxas_summary(log)}")
    print(subprocess.run(smi, capture_output=True, text=True).stdout.strip())


if __name__ == "__main__":
    main()
