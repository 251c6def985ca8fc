"""spectrum_fused: the 30-band function's work on a [rows, T] mono block.

fp32 operations a band-sample, as PERF.md counts the function (65): six
biquads of 5 MACs (60), the square (1), the smoother v + w (q - v) (3), the
peak max (1).  Bytes: every input sample read once; the band filter states
(12 a band) in and out, the smoothed value and its peak out.
"""

BANDS = 30
OPS_PER_BAND_SAMPLE = 6 * 5 * 2 + 1 + 3 + 1


def count(rows: int, T: int) -> tuple[float, float]:
    """(fp32 operations, bytes)."""
    flops = OPS_PER_BAND_SAMPLE * rows * T * BANDS
    nbytes = 4 * (rows * T + rows * BANDS * (2 * 12 + 3))
    return float(flops), float(nbytes)
