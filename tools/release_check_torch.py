#!/usr/bin/env python3
"""Release gate of the PyTorch port: every acceptance surface of
meters_lv2_torch, one PASS / FAIL / SKIPPED summary (the port's counterpart
of tools/release_check.py, which stays the JAX package's gate).

  1. suite        the port's CPU tests: pytest tests/test_torch_*.py
                  -m "not slow" (they hold the port against the JAX package,
                  so they need its dependencies; --skip-suite to omit)
  2. build        nvcc builds every kernel (runtime/build.py::kernels());
                  the spills are read from build/meters_lv2_torch/build.log
  3. chip_smoke   python3 chip_smoke.py; its last line must parse with
                  "ok": true
  4. parity       tools/gpu_parity_check.py over every family, both legs
  5. cli          python -m meters_lv2_torch --meters all --json on two WAVs
                  it writes (48 kHz float, 44.1 kHz PCM16 resampled on
                  ingest): with --cpu always, and on the card against the
                  --cpu run (chip_smoke.py's phase ingest bars)

Steps 2-4 and the card half of step 5 need a CUDA card (--skip-gpu omits
them and prints them SKIPPED; without a card and without --skip-gpu they
FAIL).  There is no bench step: the port's bench comes with its benchmark
(ROADMAP A1).  Each step writes its log to --logdir.  Exit 0 only if every
step that ran passed.

    python3 tools/release_check_torch.py [--skip-suite] [--skip-gpu] [--logdir DIR]
"""

from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def tail_line(path: str) -> str:
    with open(path, "rb") as f:  # a bounded read: logs can be large
        f.seek(max(0, os.path.getsize(path) - 8192))
        lines = [ln.strip() for ln in f.read().decode(errors="replace").splitlines() if ln.strip()]
    return lines[-1] if lines else ""


def run(name, cmd, logdir, timeout, env=None):
    """Run one command with its output in logdir/release_torch_<name>.log."""
    path = os.path.join(logdir, f"release_torch_{name}.log")
    t0 = time.time()
    with open(path, "w") as log:
        try:
            rc = subprocess.run(cmd, cwd=ROOT, stdout=log, stderr=subprocess.STDOUT,
                                timeout=timeout, env=env).returncode
            note = ""
        except subprocess.TimeoutExpired:
            rc, note = -1, f"timed out after {timeout} s"
    return {"name": name, "rc": rc, "s": time.time() - t0, "log": path,
            "tail": note or tail_line(path)[:160]}


def last_json_ok(res) -> dict:
    """A step passes only if its last line is JSON with "ok": true."""
    try:
        ok = json.loads(tail_line(res["log"])).get("ok") is True
    except ValueError:
        ok = False
    if res["rc"] == 0 and not ok:
        res["rc"], res["tail"] = 1, "last line is not JSON with \"ok\": true"
    elif ok:
        res["tail"] = '"ok": true'
    return res


def build_step(logdir) -> dict:
    py = sys.executable
    res = run("build", [py, "-c", "from meters_lv2_torch.runtime import build; build.kernels(); "
                                  "print('built', build.BUILD_DIR / build.LIB_NAME)"],
              logdir, timeout=900)
    log = os.path.join(ROOT, "build", "meters_lv2_torch", "build.log")
    if res["rc"] == 0 and os.path.exists(log):
        text = open(log).read()
        spills = [m for m in re.findall(r"(\d+) bytes spill stores, (\d+) bytes spill loads", text)
                  if m != ("0", "0")]
        fns = len(re.findall(r"Compiling entry function", text))
        res["tail"] = (f"{fns} entry functions; {len(spills)} with spills"
                       + (f" (stores/loads {spills})" if spills else ""))
    return res


def write_wavs(tmp: str) -> list:
    """Two short stereo WAVs (a 48 kHz float and a 44.1 kHz PCM16), seeded."""
    sys.path.insert(0, ROOT)
    import numpy as np

    from meters_lv2_torch.io.wav import write_wav

    rng = np.random.default_rng(20)
    paths = []
    for i, (rate, fmt) in enumerate(((48000, 32), (44100, 16))):
        t = np.arange(int(1.2 * rate)) / rate
        x = 0.3 * np.sin(2 * np.pi * (440 + 220 * i) * t) + 0.05 * rng.standard_normal((2, t.size))
        p = os.path.join(tmp, f"release{i}.wav")
        write_wav(p, x.astype(np.float32), rate, format=fmt)
        paths.append(p)
    return paths


def cli_step(logdir, gpu: bool) -> dict:
    """The batch CLI over generated WAVs with --cpu, and on the card
    against it."""
    py = sys.executable
    with tempfile.TemporaryDirectory(dir=logdir) as tmp:
        paths = write_wavs(tmp)
        base = [py, "-m", "meters_lv2_torch", *paths, "--meters", "all", "--json",
                "--target-rate", "48000"]
        res = run("cli_cpu", base + ["--cpu"], logdir, timeout=900)
        if res["rc"] != 0 or not gpu:
            res["name"] = "cli"
            if res["rc"] == 0:
                res["tail"] = (f"--cpu over {len(paths)} files"
                               + ("" if gpu else " (card half skipped)"))
            return res
        card = run("cli_cuda", base, logdir, timeout=900)
        card["name"] = "cli"
        if card["rc"] != 0:
            return card
        sys.path.insert(0, ROOT)
        from chip_smoke import json_compare  # the bars of phase ingest's CLI check

        errs = []
        try:
            with open(card["log"]) as a, open(res["log"]) as b:
                json_compare(json.loads(a.read()), json.loads(b.read()), "cli", errs)
        except ValueError as e:
            errs.append(f"not JSON: {e}")
        card["s"] += res["s"]
        if errs:
            card["rc"], card["tail"] = 1, f"card vs --cpu: {len(errs)} differ: {errs[:3]}"
        else:
            card["tail"] = f"card JSON equals --cpu at the ingest bars ({len(paths)} files)"
        return card


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--skip-suite", action="store_true", help="omit the CPU tests")
    ap.add_argument("--skip-gpu", action="store_true",
                    help="omit the steps that need the card (build, chip_smoke, parity, the "
                         "CLI's card half)")
    ap.add_argument("--logdir", default=os.path.join(ROOT, "build", "release_torch"))
    args = ap.parse_args(argv)
    os.makedirs(args.logdir, exist_ok=True)
    py = sys.executable
    results = []

    if args.skip_suite:
        results.append({"name": "suite", "skipped": True})
    else:
        env = dict(os.environ, JAX_PLATFORMS="cpu")
        tests = sorted(os.path.join("tests", f) for f in os.listdir(os.path.join(ROOT, "tests"))
                       if f.startswith("test_torch_") and f.endswith(".py"))
        results.append(run("suite", [py, "-m", "pytest", *tests, "-q", "-m", "not slow",
                                     "-p", "no:cacheprovider"], args.logdir, 3600, env))
    gpu_names = ("build", "chip_smoke", "parity")
    if args.skip_gpu:
        results += [{"name": n, "skipped": True} for n in gpu_names]
    else:
        import torch

        if not torch.cuda.is_available():
            results += [{"name": n, "rc": 1, "s": 0.0, "log": "-",
                         "tail": "no CUDA device (pass --skip-gpu for the CPU steps only)"}
                        for n in gpu_names]
        else:
            results.append(build_step(args.logdir))
            results.append(last_json_ok(run("chip_smoke", [py, "chip_smoke.py"], args.logdir,
                                            1800)))
            results.append(last_json_ok(run("parity", [py, "tools/gpu_parity_check.py"],
                                            args.logdir, 1800)))
    results.append(cli_step(args.logdir, gpu=not args.skip_gpu))

    print()
    print(f"{'step':12s} {'status':>7s} {'secs':>7s}  last line  [log]")
    ok = True
    for r in results:
        if r.get("skipped"):
            print(f"{r['name']:12s} {'SKIPPED':>7s} {'-':>7s}")
            continue
        ok &= r["rc"] == 0
        print(f"{r['name']:12s} {'PASS' if r['rc'] == 0 else 'FAIL':>7s} {r['s']:7.1f}  "
              f"{r['tail']}  [{r['log']}]")
    print()
    print("RELEASE GATE (meters_lv2_torch):", "PASS" if ok else "FAIL")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
