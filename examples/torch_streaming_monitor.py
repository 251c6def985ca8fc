"""Example: a streaming monitoring session with runtime controls, on the
PyTorch port.

    python examples/torch_streaming_monitor.py [--cpu]

Simulates a live monitoring session over a synthetic programme feed:
- EBU R128 with 500 ms-cadence I/LRA readouts (the reference GUI's view)
  and a mid-session radar-speed change (set_radar_speed, CTL_RADARTIME),
- the 30-band spectrum, whose display speed is changed on the fly
  (set_speed),
- snapshot reads every 4 s of stream time.

The controls are state, so the same update code keeps running across the
changes.  Runs on the CUDA card unless --cpu is passed.
"""

import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def main(device):
    import torch

    from meters_lv2_torch.models.ebur128 import EbuR128Meter
    from meters_lv2_torch.models.spectrum import SpectrumAnalyzer

    fs = 48000
    ebu = EbuR128Meter(fs, nchan=2, runtime_radar_speed=True, track_cadence=True)
    spec = SpectrumAnalyzer(fs, speed=1.0)
    se = ebu.init((), device=device)
    ss = spec.init((), device=device)

    rng = np.random.default_rng(0)
    chunk = fs // 4  # 250 ms blocks
    t_global = 0.0
    for i in range(80):  # 20 s of programme
        t = (np.arange(chunk) + i * chunk) / fs
        level = 0.15 + 0.1 * np.sin(2 * np.pi * 0.1 * t)
        x = np.stack([
            level * np.sin(2 * np.pi * 440 * t) + 0.03 * rng.standard_normal(chunk),
            level * np.sin(2 * np.pi * 660 * t) + 0.03 * rng.standard_normal(chunk),
        ]).astype(np.float32)
        xd = torch.as_tensor(x, device=device)
        se = ebu.update(se, xd)
        ss = spec.update(ss, xd, stereo=True)
        t_global += chunk / fs

        if i == 40:
            # live control changes; the same update code keeps running
            se = ebu.set_radar_speed(se, 240.0)
            ss = spec.set_speed(ss, 8.0)
            print(f"[{t_global:5.2f}s] radar -> 240 s/rev, display speed -> 8")

        if (i + 1) % 16 == 0:
            out, _ = ebu.read(se, cadence_500ms=True)
            sp, _ = spec.read(ss)
            print(
                f"[{t_global:5.2f}s] M {float(out['loudness_M']):6.1f} "
                f"S {float(out['loudness_S']):6.1f} "
                f"I {float(out['integrated']):6.1f} LUFS  "
                f"LRA {float(out['lra']):4.1f} LU  "
                f"spectrum peak band {int(sp['bands'].argmax())}"
            )

    out, _ = ebu.read(se, cadence_500ms=True)
    print(
        f"final: I = {float(out['integrated']):.2f} LUFS, "
        f"LRA = {float(out['lra']):.2f} LU, "
        f"dBTP = {20 * np.log10(max(float(out['dbtp']), 1e-9)):.2f}, "
        f"radar interval = {int(out['radar_spd'])} samples  (on {device})"
    )


if __name__ == "__main__":
    import torch

    if "--cpu" not in sys.argv and not torch.cuda.is_available():
        sys.exit("no CUDA device: pass --cpu to run on the CPU")
    main("cpu" if "--cpu" in sys.argv else "cuda")
