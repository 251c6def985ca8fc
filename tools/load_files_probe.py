#!/usr/bin/env python3
"""Where load_files' time goes, with its resampling on the card and on
CPU tensors, on one card.

    python3 tools/load_files_probe.py [--rounds 2]

Writes chip_smoke.py's phase-ingest collection (256 stereo WAVs of 4-12 s,
a quarter at 44.1 kHz; PCM16, PCM24, float32; seed 17) into a temporary
directory, then times ``load_files(target_rate=48000, device=...)`` with
the card and the CPU in turns (card, CPU, CPU, card, each round), and the
pieces of each: the native decode, the resampling of the 44.1 kHz files
(each file from host array to host array, the card synchronised) and the
assembly.  Also one 8 s stereo file resampled alone, the median of 5 warm
calls a device, and the resampler's design.  One line each, with the
card's name and power limit.
"""

import argparse
import os
import statistics
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rounds", type=int, default=2)
    args = ap.parse_args()
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        sys.exit("tools/load_files_probe.py: no CUDA device")
    sys.path[:0] = [ROOT]
    from chip_smoke import FS, INGEST_N, INGEST_SECONDS, ingest_write
    from meters_lv2_torch.io import batch as io_batch
    from meters_lv2_torch.ops.resample import RationalResampler, resample_signal
    from meters_lv2_torch.runtime import native

    gpu = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    dev = torch.device("cuda", 0)
    if native.load() is None:
        sys.exit("tools/load_files_probe.py: the native WAV library did not build")

    def resample_host(x, r, d):
        return resample_signal(torch.as_tensor(x, device=d), r, FS).cpu().numpy()

    with tempfile.TemporaryDirectory(prefix="load_files_probe_") as tmp:
        paths = ingest_write(tmp, "s", INGEST_N, 2, *INGEST_SECONDS, 17)
        io_batch.load_files(paths[:8], target_rate=FS, device=dev)  # first use on the card
        times = {"card": [], "cpu": []}
        parts = {"card": [], "cpu": []}
        for _ in range(args.rounds):
            for name in ("card", "cpu", "cpu", "card"):
                d = dev if name == "card" else torch.device("cpu")
                t0 = time.perf_counter()
                io_batch.load_files(paths, target_rate=FS, device=d)
                times[name].append(time.perf_counter() - t0)
                t0 = time.perf_counter()
                decoded = native.wav_read_batch(paths)
                t1 = time.perf_counter()
                n44 = sum(r != FS for _, r in decoded)
                arrs = [resample_host(x, r, d) if r != FS else x for x, r in decoded]
                t2 = time.perf_counter()
                io_batch.assemble(arrs, FS)
                t3 = time.perf_counter()
                parts[name].append((t1 - t0, t2 - t1, t3 - t2))
                del decoded, arrs
        for name in ("card", "cpu"):
            dec, res, asm = (statistics.median(p[k] for p in parts[name]) for k in range(3))
            print(f"load_files_probe: {INGEST_N} files ({n44} at 44.1 kHz), resampling on "
                  f"{'the card' if name == 'card' else 'CPU tensors'}: load_files "
                  f"{[round(t, 4) for t in times[name]]} s (median "
                  f"{statistics.median(times[name]):.4f}); by piece, medians: decode {dec:.4f} s, "
                  f"resample {res:.4f} s, assemble {asm:.4f} s [{gpu}]")
        x = np.random.default_rng(0).standard_normal((2, 8 * 44100)).astype(np.float32)
        for name, d in (("card", dev), ("cpu", torch.device("cpu"))):
            resample_host(x, 44100, d)
            ts = []
            for _ in range(5):
                t0 = time.perf_counter()
                resample_host(x, 44100, d)
                ts.append(time.perf_counter() - t0)
            print(f"load_files_probe: one 8 s stereo file 44.1 -> 48 kHz, host array to host "
                  f"array, on {'the card' if name == 'card' else 'CPU tensors'}: median "
                  f"{statistics.median(ts) * 1e3:.3f} ms of {[round(t * 1e3, 3) for t in ts]} "
                  f"[{gpu}]")
        t0 = time.perf_counter()
        RationalResampler(44100, FS)
        print(f"load_files_probe: RationalResampler(44100, 48000) design "
              f"{(time.perf_counter() - t0) * 1e3:.3f} ms (host) [{gpu}]")


if __name__ == "__main__":
    main()
