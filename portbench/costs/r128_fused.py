"""r128_fused: the R128 function's work on a [rows, C, T] block.

fp32 operations a channel-sample, as PERF.md counts the function (406):
the true-peak FIR, 4 phases of 48 taps (192 MACs, 384); the C reference's
K-weighting recursion (x' = p - b1 z1 - b2 z2: 4; y = a0 x' + a1 z1 + a2 z2
- c3 z3 - c4 z4: 9; z3 += y, z4 += z3: 2); the power (square, gain, channel
sum: 3); the peak (max of the 4 phases' |.|: 4).  Bytes: every input sample
read once; written only what the meter keeps: the fragment power sums
(fs / 20 samples a fragment), the peak a stream, and the filter and
resampler states (4 + 47 a channel) in and out.
"""

OPS_PER_CHANNEL_SAMPLE = 384 + 15 + 3 + 4


def count(rows: int, chans: int, T: int, fs: int = 48000) -> tuple[float, float]:
    """(fp32 operations, bytes)."""
    flops = OPS_PER_CHANNEL_SAMPLE * rows * chans * T
    frags = -(-T // (fs // 20))
    nbytes = 4 * (rows * chans * T + rows * (frags + 1) + 2 * rows * chans * (4 + 47))
    return float(flops), float(nbytes)
