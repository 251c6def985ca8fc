"""Example: batch loudness QA over WAV files with the PyTorch port.

    python examples/torch_batch_loudness.py /path/to/wavs/*.wav [--cpu]

Decodes the files with the native codec (io/batch.load_files), meters them
as one right-padded batch through MeterPipeline (R128 with its true peak,
and DR-14), each file over exactly its own length (run_stream_ragged), and
prints an EBU R128 compliance report per file.  Runs on the CUDA card
unless --cpu is passed (then on CPU tensors, through the kernels' plain
versions).
"""

import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def main(paths, device):
    import torch

    from meters_lv2_torch.io.batch import load_files
    from meters_lv2_torch.models.dr14 import DR14Meter
    from meters_lv2_torch.models.ebur128 import EbuR128Meter
    from meters_lv2_torch.parallel.pipeline import MeterPipeline

    batch = load_files(paths, device=device)
    B, C, T = batch.data.shape
    fs = batch.rate
    pipe = MeterPipeline(
        {"r128": EbuR128Meter(fs, nchan=C), "dr14": DR14Meter(fs, nchan=C)}, nchan=C)
    chunk = fs * 2
    x = torch.as_tensor(batch.data, device=device)
    lengths = [int(n) - int(n) % 4 for n in batch.lengths]  # the meters' 4-sample grain
    st = pipe.run_stream_ragged(pipe.init((B,), device=device), x, lengths, chunk)
    outs, _ = pipe.read(st)
    r128, dr = outs["r128"], outs["dr14"]
    print(f"{'file':40s} {'I LUFS':>8s} {'LRA':>6s} {'dBTP':>7s} {'DR':>4s} EBU-R128  on {device}")
    for i, p in enumerate(paths):
        I = float(r128["integrated"][i])
        lra = float(r128["lra"][i])
        tp = 20 * np.log10(max(float(r128["dbtp"][i]), 1e-12))
        drv = float(dr["dr_total"][i])
        ok = (-23.5 <= I <= -22.5) and tp <= -1.0
        print(f"{p[:40]:40s} {I:8.2f} {lra:6.2f} {tp:7.2f} {drv:4.1f} "
              f"{'PASS' if ok else 'ADJUST'}")


if __name__ == "__main__":
    paths = [a for a in sys.argv[1:] if a != "--cpu"]
    if not paths:
        print(__doc__)
        sys.exit(2)
    import torch

    if "--cpu" not in sys.argv and not torch.cuda.is_available():
        sys.exit("no CUDA device: pass --cpu to run on the CPU")
    main(paths, "cpu" if "--cpu" in sys.argv else "cuda")
