"""The readings the check's limits are set from, on the card.

    python3 -m portbench.calibrate --workload <cell> --seconds <s> --seeds <n> ... \
        [--control-seeds <n> ...]

For each seed, in one process: the cell's set-up and window as a run makes
them, the program's numbers against the reference (the lower readings),
and for the control seeds the numbers of the control, the reference in
float32 with TF32 products standing in the program's place (the upper
readings), with ``control_correct``, the verdict of the cell's limits on
the control's numbers, which has to be false.  One JSON line a seed.  The
benchmark's own runs never run the control.
"""

from __future__ import annotations

import argparse
import json
import sys
import time


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="portbench.calibrate")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    args = ap.parse_args(argv)

    import os

    for v in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
        os.environ[v] = "1"
    import torch

    torch.set_num_threads(1)

    from portbench import harness
    from portbench.reference.lti import CONTROL

    if not torch.cuda.is_available():
        print("portbench.calibrate: no CUDA card", file=sys.stderr)
        return 3
    cell = harness.load_cell(args.workload)
    for seed in args.seeds:
        t0 = time.perf_counter()
        r = harness.run_cell(cell, seed, args.seconds, False, device="cuda",
                             control=CONTROL if seed in args.control_seeds else None)
        line = {"seed": seed, "correct": r["correct"], "control_correct": r.get("control_correct"),
                "program": {k: c["value"] for k, c in r["checks"].items()},
                "control": r.get("control"), "gaps": r["gaps"],
                "control_gaps": r.get("control_gaps"), "metrics": r["metrics"],
                "check_s": r["check_s"], "run_s": time.perf_counter() - t0}
        print(json.dumps(line), flush=True)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    return 0


if __name__ == "__main__":
    sys.exit(main())
