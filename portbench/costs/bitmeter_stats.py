"""bitmeter_stats: the bit meter's field statistics of [rows, T] float32
samples (one row a stream).

Integer operations a sample, the word operations the function needs
before its positional counts (16): decoding the exponent and the mantissa
(a shift and two masks, 3), classifying the sample (NaN, Inf, zero,
denormal, normal, positive: 6 compares), the five flag counts (5), and
the |x| min and max of the normals (2).  The positional counts of hit,
one and dset are bit-sliced adds whose number a sample falls with the
samples counted together, and are left out, so the count is a floor; the
bound is the bytes at any row count.  Bytes: every input sample read
once; out, a row's 583 positional counters (hit and one 280 each, dset
23) and its 7 scalar ones (five flags, min, max).
"""

OPS_PER_SAMPLE = 3 + 6 + 5 + 2
COUNTERS_PER_ROW = 280 + 280 + 23 + 5 + 2


def count(rows: int, T: int) -> tuple[float, float]:
    """(integer operations, bytes)."""
    return float(OPS_PER_SAMPLE * rows * T), float(4 * (rows * T + rows * COUNTERS_PER_ROW))
