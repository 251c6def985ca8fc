#!/usr/bin/env python3
"""Per-update time, host enqueue and device time of port meters on one card.

    python3 tools/meter_times.py [--root DIR] [--meters dBTPstereo dr14stereo ...]

Imports meters_lv2_torch from DIR (default: this checkout), so that two
trees can be compared in one call on one card: run it once per tree, in
turns (parent, change, change, parent).  Each meter runs as chip_smoke.py's
phase times runs it: B=256 streams, 60 updates cycling over 12 flat 1 s
blocks of 0.1 N(0, 1) samples (48 kHz, stereo [256, 2, 48000]; channel 0
for the mono-input meters), best of 2 runs ended by a host copy, with the
host's enqueue time per update and torch.profiler's device time per update
over 10 updates.  One line per meter, then the card's name and power limit.
"""

import argparse
import os
import subprocess
import sys
import time

FS, B, N = 48000, 256, 60
STEREO = {"dBTPstereo": (B, 2), "BBCstereo": (B, 2), "DINstereo": (B, 2), "dr14stereo": (B,),
          "TPnRMSstereo": (B,), "spectr30stereo": (B,)}
MONO_INPUT = {"bitmeter", "SigDistHist"}
DOWNMIX = {"spectr30stereo"}  # update(..., stereo=True): the [B, 2, T] block downmixed


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    ap.add_argument("--meters", nargs="+", default=["dBTPstereo", "dr14stereo", "TPnRMSstereo",
                                                    "bitmeter"])
    args = ap.parse_args()
    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        sys.exit("tools/meter_times.py: no CUDA device")
    sys.path.insert(0, os.path.abspath(args.root))
    import meters_lv2_torch

    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(0)
    blocks = [torch.as_tensor(rng.standard_normal((B, 2, FS), dtype=np.float32) * np.float32(0.1),
                              device=dev) for _ in range(12)]
    for name in args.meters:
        m = meters_lv2_torch.create(name, FS)
        batch = STEREO.get(name, (B,))
        xs = [b[:, 0] if name in MONO_INPUT else b for b in blocks]
        kw = {"stereo": True} if name in DOWNMIX else {}
        runs, enqueue = [], []
        for _ in range(2):
            st = m.update(m.init(batch, device=dev), xs[0], **kw)  # warm
            st = m.init(batch, device=dev)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for i in range(N):
                st = m.update(st, xs[i % len(xs)], **kw)
            enqueue.append(time.perf_counter() - t0)
            out = m.read(st)[0]
            torch.cuda.synchronize()
            [v.cpu() for v in (out.values() if isinstance(out, dict) else [out])]
            runs.append(time.perf_counter() - t0)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for i in range(10):
                st = m.update(st, xs[i % len(xs)], **kw)
            torch.cuda.synchronize()
        dev_us = sum(e.self_device_time_total for e in prof.key_averages()
                     if e.device_type == DeviceType.CUDA and not e.is_user_annotation) / 10
        print(f"{name} ({args.root}): {min(runs) / N * 1e3:.3f} ms per update, "
              f"{B * N / min(runs):.1f} x-realtime (runs {[round(r, 4) for r in runs]} s); host "
              f"enqueue {[round(e / N * 1e3, 3) for e in enqueue]} ms per update; device time "
              f"{dev_us:.1f} us per update")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip())


if __name__ == "__main__":
    main()
