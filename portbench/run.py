"""Run one cell of the benchmark once on the card and print one JSON line.

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The last line of standard output is the result: ``correct``, ``attempted``,
``failed``, ``metrics`` (the cell's end-to-end metrics, or with ``--trace
1`` its per-layer ones), ``device`` and, traced, ``breakdown``; ``checks``
comes last, each number the check compared with its limit, and the same
numbers are the last lines on standard error.  With no CUDA card, or fewer
than the cell asks for, or with jax, jaxlib, flax or meters_lv2_tpu loaded
once the window has closed, it prints no result and exits non-zero.  The
program's kernels build into ``build/meters_lv2_torch`` of the checkout on
the first run and load from there after.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import os  # noqa: E402

# one process with one CPU thread a library: the port's path on the card
# needs no CPU threads, and idle OpenMP workers spinning beside the host
# thread that launches the kernels would make the host's time noisier
for _v in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
    os.environ[_v] = "1"

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

CHECKOUT = Path(__file__).resolve().parent.parent


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="portbench.run")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    # any cache a library keeps goes to fixed places inside the checkout
    cache = CHECKOUT / "build" / "portbench"
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")

    import torch

    from portbench import harness, system  # noqa: F401  (system imports the program)

    cell = harness.load_cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"portbench: the cell needs {cell.chips} CUDA card(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 3
    torch.set_num_threads(1)
    torch.cuda.set_device(0)
    result = harness.run_cell(cell, args.seed, args.seconds, bool(args.trace),
                              device="cuda", t_start=T_START)
    bad = harness.forbidden_loaded()
    if bad:
        print(f"portbench: forbidden modules loaded: {', '.join(bad)}", file=sys.stderr)
        return 4
    print(f"correct: {result['correct']}", file=sys.stderr)
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stdout.write(json.dumps(result) + "\n")
    sys.stdout.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
