"""ballistics_env: the PPM ballistics function's work on [rows, T] rectified
samples (the envelope body of csrc/ballistics.cu computes the same function).

fp32 operations a sample, as PERF.md counts the function (9): two attacks
of 4 (compare, subtract, multiply-add) and the group's release and max.
Bytes: every input sample read once; the states z1, z2, m in and out.
"""

OPS_PER_SAMPLE = 9


def count(rows: int, T: int) -> tuple[float, float]:
    """(fp32 operations, bytes)."""
    return float(OPS_PER_SAMPLE * rows * T), float(4 * (rows * T + 2 * rows * 3))
