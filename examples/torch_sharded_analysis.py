"""Example: whole-file loudness analysis sharded over ranks, with sharded
checkpoints, on the PyTorch port.

    python examples/torch_sharded_analysis.py [--cpu]

Starts 4 ranks (parallel/mesh.launch, one process each) on a dp 2 x sp 2
mesh: streams across 'dp', TIME across 'sp' (the filter states cross the
shards as an affine handoff, the fragment windows as halos, the histograms
as a psum).  Each rank meters only its own block of the batch: R128 with
its true peak, the 30-band spectrum, dBTP and a DIN needle, each as one
whole-file analysis, then checkpoints its block of the R128 readout and
restores it bit for bit.  On the card the 4 ranks share it through gloo
with host-staged collectives (parallel/mesh.py's backend rule; NCCL wants
a card a rank); with --cpu they run on CPU tensors.
"""

import os
import sys
import tempfile

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

FS = 48000
DP, SP = 2, 2


def programmes(B, T):
    """[B, 2, T] stereo test programmes (tones gated on and off)."""
    t = np.arange(T) / FS
    x = np.stack([
        (0.1 + 0.05 * k) * np.sin(2 * np.pi * (220 + 60 * k) * t)
        * (np.sin(2 * np.pi * 0.25 * t) > -0.3)
        for k in range(B)
    ]).astype(np.float32)
    return np.stack([x, 0.8 * x], axis=1)


def rank_main(rank, device, ckpt):
    """One rank: its block of every analysis, gathered whole for printing,
    and its checkpoint round trip."""
    import torch

    from meters_lv2_torch.models.ebur128 import EbuR128Meter
    from meters_lv2_torch.models.needle import DINMeter
    from meters_lv2_torch.models.spectrum import SpectrumAnalyzer
    from meters_lv2_torch.models.truepeak import TruePeakMeter
    from meters_lv2_torch.parallel import gather_outputs, make_mesh, shard_time
    from meters_lv2_torch.parallel.meters_sharded import analyze_needle, analyze_truepeak
    from meters_lv2_torch.parallel.r128_sharded import OUT_SPECS, analyze_r128
    from meters_lv2_torch.parallel.spectrum_sharded import analyze_spectrum
    from meters_lv2_torch.utils.state import load_state_sharded, save_state_sharded

    mesh = make_mesh(DP, SP, device=device)
    # 8 programmes of 10 s (an sp shard must hold >= 3 s, the short-term
    # window; the gated integrated loudness needs >= 5 s of M-points)
    xs = torch.from_numpy(programmes(4 * DP, FS * 10))
    x = shard_time(mesh, xs)  # this rank's [4, 2, 5 s] block
    out = analyze_r128(EbuR128Meter(FS, nchan=2), x, mesh)
    sread, _ = analyze_spectrum(SpectrumAnalyzer(FS), x, mesh)
    mono = x[:, 0, :]
    tp = analyze_truepeak(TruePeakMeter(FS), mono, mesh)
    din = analyze_needle(DINMeter(FS), mono, mesh, ref_level_db=-22.0)

    # checkpoint this rank's block of the R128 readout without a gather
    save_state_sharded(out, ckpt, mesh)
    back = load_state_sharded(out, ckpt, mesh)
    same = all(torch.equal(back[k], out[k]) for k in out)

    whole = gather_outputs({k: out[k] for k in ("integrated", "lra", "dbtp")}, mesh, OUT_SPECS)
    whole.update(gather_outputs({"bands": sread["bands"], "peak": tp["peak"], "din": din}, mesh))
    return {"backend": mesh.backend, "staged": mesh.staged, "device": str(mesh.device),
            "same": same, "out": {k: v.cpu() for k, v in whole.items()}}


def main(device):
    from meters_lv2_torch.parallel import launch

    with tempfile.TemporaryDirectory() as tmp:
        ckpt = os.path.join(tmp, "r128_out")
        res = launch(rank_main, DP * SP, device, ckpt, device=device)
        files = sorted(os.listdir(ckpt))
    r0 = res[0]
    print(f"mesh: dp={DP} x sp={SP}, {len(res)} ranks on {r0['device'].split(':')[0]} "
          f"({r0['backend']}{', host-staged' if r0['staged'] else ''})")
    out = r0["out"]
    print("per-stream results (sharded: streams over dp, time over sp):")
    for b in range(out["integrated"].shape[0]):
        print(f"  stream {b}: I = {float(out['integrated'][b]):7.2f} LUFS  "
              f"LRA = {float(out['lra'][b]):5.2f} LU  "
              f"dBTP = {20 * np.log10(max(float(out['dbtp'][b]), 1e-10)):7.2f}")
    b0 = out["bands"][0].numpy()
    print(f"stream 0 spectrum: peak band {int(b0.argmax())} at {b0.max():.1f} dB "
          "(time-sharded over 'sp')")
    print(f"stream 0 dBTP {20 * np.log10(max(float(out['peak'][0]), 1e-10)):6.2f}"
          f"  DIN needle {float(out['din'][0]):.3f}  (same mesh, whole-file sharded)")
    if not all(r["same"] for r in res):
        sys.exit("a rank's restored checkpoint differs from its readout")
    print(f"checkpointed + restored shard-by-shard: {', '.join(files)}")


if __name__ == "__main__":
    import torch

    if "--cpu" not in sys.argv and not torch.cuda.is_available():
        sys.exit("no CUDA device: pass --cpu to run on the CPU")
    main("cpu" if "--cpu" in sys.argv else "cuda")
