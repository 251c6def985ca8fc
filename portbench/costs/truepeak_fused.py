"""truepeak_fused: the dBTP function's work on [rows, T] (one channel a row).

fp32 operations a sample, as PERF.md counts the function (424): the FIR,
4 phases of 48 taps (384), |.| of the 4 phases (4), and 4 ballistics steps
on the oversampled stream of 9 each (two attacks of 4 and the group's
release and max, 36).  Bytes: every input sample read once; the 47-sample
resampler history and the four states in and out.
"""

OPS_PER_SAMPLE = 2 * 4 * 48 + 4 + 4 * 9


def count(rows: int, T: int) -> tuple[float, float]:
    """(fp32 operations, bytes)."""
    return float(OPS_PER_SAMPLE * rows * T), float(4 * (rows * T + 2 * rows * (47 + 4)))
