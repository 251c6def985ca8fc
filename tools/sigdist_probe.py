#!/usr/bin/env python3
"""sigdist_fused alone against its bound and against the plain ops it
replaced, at the mastering batch.

Run from the root of a checkout, on a machine with a CUDA card and nvcc:

    python3 tools/sigdist_probe.py [--batch 4096]

The block is [B, 2, 48000] float32 and the kernel reads its channel 0, a
row stride of 96,000 samples, as the mastering_qc cell feeds it: quiet
rows (0.01 N(0, 1), -40 dBFS RMS, a warp's samples in a few bins) and loud
ones (0.4 N(0, 1) clipped to [-1, 1], -8 dBFS RMS).  For each, on a state
with history: the CUDA-event ms a launch (10 launches queued behind a
sleep kernel, so the host's launch time is hidden; median of 5),
alternated with the plain update (``SigDistMeter._plain_update`` on the
same state and block) over three rounds; the plain update's device
operations (torch.profiler); the bound (the block's channel 0 and the
state read once, the state written once, at 3.35 TB/s); and the card's
name and power limit from nvidia-smi.
"""

from __future__ import annotations

import argparse
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
FS = 48000
HBM = 3.35e12


def card() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "unknown"


def timed(fn, reps=10):
    """The median over 5 tries of the CUDA-event ms a call, reps calls
    queued behind a sleep kernel."""
    import torch

    fn()  # warm
    times = []
    for _ in range(5):
        torch.cuda._sleep(2_000_000)  # ~1 ms: the launches queue behind it
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        for _ in range(reps):
            fn()
        e1.record()
        e1.synchronize()
        times.append(e0.elapsed_time(e1) / reps)
    return statistics.median(times)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=4096)
    args = ap.parse_args()

    import torch

    sys.path.insert(0, str(ROOT))
    from meters_lv2_torch.models.sigdist import SigDistMeter

    if not torch.cuda.is_available():
        sys.exit("no CUDA device")
    dev = torch.device("cuda", 0)
    B, T = args.batch, FS
    meter = SigDistMeter(FS)
    block = torch.empty((B, 2, T), device=dev)
    x = block[:, 0]  # [B, T], row stride 2T
    # the block's channel 0 in; the state (361 + 6 words a row) in and out
    state_bytes = B * (361 + 6) * 4
    bound_ms = 1e3 * (B * T * 4 + 2 * state_bytes) / HBM
    print(f"B={B} T={T}, channel 0 of [B, 2, T] (row stride {x.stride(0)}); bound "
          f"{bound_ms:.4f} ms ({B * T * 4 / 1e6:.1f} MB in, state {state_bytes / 1e6:.1f} MB "
          f"each way) at 3.35 TB/s", flush=True)
    gen = torch.Generator(device=dev).manual_seed(0)
    for kind, scale in (("quiet", 0.01), ("loud", 0.4)):
        block.normal_(generator=gen).mul_(scale).clamp_(-1, 1)
        st = meter._plain_update(meter.init((B,), device=dev), x)  # a state with history
        ms_k, ms_p = [], []
        for r in range(3):
            for w in ("kp" if r % 2 == 0 else "pk"):
                if w == "k":
                    ms_k.append(timed(lambda: meter.update(st, x)))
                else:
                    ms_p.append(timed(lambda: meter._plain_update(st, x), reps=3))
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            meter._plain_update(st, x)
            torch.cuda.synchronize()
        n_ops = sum(e.count for e in prof.key_averages() if e.device_time_total > 0)
        k = statistics.mean(ms_k)
        print(f"{kind}: kernel {k:.4f} ms a launch (medians {[round(t, 4) for t in ms_k]}), "
              f"{100 * bound_ms / k:.1f} % of the bound; plain update "
              f"{statistics.mean(ms_p):.3f} ms (medians {[round(t, 3) for t in ms_p]}), "
              f"{n_ops} device operations", flush=True)
    print(f"card: {card()}")


if __name__ == "__main__":
    main()
