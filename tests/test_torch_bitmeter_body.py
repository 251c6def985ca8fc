"""bitmeter_stats.cu's Hopper body emulated in numpy against the plain version.

The CUDA kernel (meters_lv2_torch/csrc/bitmeter_stats.cu) runs only on the
card; here its arithmetic runs warp by warp in numpy, with the kernel's
index arithmetic: the row in float4s from the 16-byte boundary at or
before its start (h = the start's element offset mod 4), 512-sample
warp-blocks split over the cluster's CTAs and their eight warps, the
butterfly transpose (five xor shuffles, a rotate and a bit select), the
Harley-Seal counters of the four fast-path words and their sixteens, the
warp's a chosen at each block, the generic pass with its distinct-a loop,
the cluster's sum and the hit window from a prefix sum.  Every field must
equal bitmeter_stats_reference exactly (integer counts; min/max of the
same floats), for every input kind, misalignment, cluster size and tail.
"""

import numpy as np
import pytest
import torch

from meters_lv2_torch.ops.bitmeter_stats import FLAGS, NMAN, NPOS, bitmeter_stats_reference

FULL = np.uint32(0xFFFFFFFF)
LANE = np.arange(32, dtype=np.uint32)
MASKS = {16: 0x0000FFFF, 8: 0x00FF00FF, 4: 0x0F0F0F0F, 2: 0x33333333, 1: 0x55555555}
K_ONE, K_CNT, K_DSET, K_FLAG, K_MIN, K_MAX, K_ACC = 0, 288, 544, 576, 579, 580, 581


def u32(v):
    return np.asarray(v, dtype=np.uint64).astype(np.uint32)


def rotl(y, r):
    y, r = y.astype(np.uint64), r.astype(np.uint64) & 31
    return u32(((y << r) | (y >> ((32 - r) & 31))) & 0xFFFFFFFF)


def make_tr():
    """make_tr: each lane's rotations (R(j) = lane & j)."""
    rot, prev = [], np.zeros(32, np.int64)
    for j in (16, 8, 4, 2, 1):
        r = (LANE & j).astype(np.int64)
        rot.append((r - prev) & 31)
        prev = r
    return rot + [(-prev) & 31]


ROT = make_tr()


def transpose32(x, exact=True):
    """The kernel's transpose32 over the 32 lanes of x (odd lanes rotated
    left by one unless exact)."""
    x = rotl(x, ROT[0])
    for k, j in enumerate((16, 8, 4, 2, 1)):
        m = np.uint32(MASKS[j])
        y = x[LANE ^ j]  # __shfl_xor_sync
        x = (x & m) | (y & ~m)
        if k < 4 or exact:
            x = rotl(x, ROT[k + 1])
    return x


def popc(x):
    return np.array([bin(int(v)).count("1") for v in x], dtype=np.int64)


def shl_c(x, s):
    """x << s with s clamped to 32 (__funnelshift_lc(0, x, s))."""
    s = np.minimum(s.astype(np.uint64), 32)
    return u32((x.astype(np.uint64) << s) & 0xFFFFFFFF)


def hi_c(x, b):
    """__funnelshift_lc(x, 0, b): the high word of x << b."""
    return u32((x.astype(np.uint64) << np.minimum(b.astype(np.uint64), 32)) >> 32)


def csa(a, b, c):
    u = a ^ b
    return (a & b) | (u & c), u ^ c  # (h, l)


class Hs:
    def __init__(self):
        self.ones = self.twos = self.fours = self.eights = np.zeros(32, np.uint32)
        self.c16 = np.zeros(32, np.int64)

    def round16(self, xs):
        """The kernel's eight hs_pair<P> calls; returns the sixteens word."""
        for p in range(8):
            x0, x1 = xs[2 * p], xs[2 * p + 1]
            if p % 2 == 0:
                self.ta, self.ones = csa(self.ones, x0, x1)
                continue
            tb, self.ones = csa(self.ones, x0, x1)
            if p % 4 == 1:
                self.fa, self.twos = csa(self.twos, self.ta, tb)
                continue
            self.fb, self.twos = csa(self.twos, self.ta, tb)
            if p == 3:
                self.ea, self.fours = csa(self.fours, self.fa, self.fb)
            else:
                eb, self.fours = csa(self.fours, self.fa, self.fb)
                sixteens, self.eights = csa(self.eights, self.ea, eb)
        return sixteens

    def sixteens(self, s16):
        if (s16 != 0).any():
            self.c16 = self.c16 + popc(transpose32(s16, False))

    def take(self):
        n = (16 * self.c16 + popc(transpose32(self.ones, False))
             + 2 * popc(transpose32(self.twos, False)) + 4 * popc(transpose32(self.fours, False))
             + 8 * popc(transpose32(self.eights, False)))
        self.__init__()
        return n


class Lane:
    def __init__(self):
        self.lo = np.full(32, 0xFFFFFFFF, np.uint32)
        self.hi = np.zeros(32, np.uint32)
        self.nnan = self.ninf = self.nden = self.dgen = np.zeros(32, np.int64)


def fast_words(w, a28, st, slow):
    fast = (w & np.uint32(0x70000000)) == a28
    b = (w >> np.uint32(23)) & np.uint32(31)
    field = (w & np.uint32(0x7FFFFF)) | np.uint32(0x800000)
    s = np.where(fast, b, 32).astype(np.uint32)
    bf = np.where(fast, b, 0).astype(np.uint32)
    fm = np.where(fast, FULL, 0).astype(np.uint32)
    ab = w & np.uint32(0x7FFFFFFF)
    st.lo = np.minimum(st.lo, ab | ~fm)
    st.hi = np.maximum(st.hi, ab & fm)
    slow |= ((w + w) & ~fm) != 0
    return (w & np.uint32(0x807FFFFF) & fm, shl_c(field, s), hi_c(field, bf),
            shl_c(np.ones(32, np.uint32), s))


def generic_step(w, take, st, acc):
    e = (w >> np.uint32(23)) & np.uint32(0xFF)
    m = w & np.uint32(0x7FFFFF)
    nonfinite = e == 255
    num = take & ~nonfinite
    normal = num & (e != 0)
    st.nnan = st.nnan + (take & nonfinite & (m != 0))
    st.ninf = st.ninf + (take & nonfinite & (m == 0))
    st.nden = st.nden + (num & (e == 0))
    ab = w & np.uint32(0x7FFFFFFF)
    st.lo = np.where(normal, np.minimum(st.lo, ab), st.lo)
    st.hi = np.where(normal, np.maximum(st.hi, ab), st.hi)
    if not num.any():
        return
    ee = np.where(normal, e, 1).astype(np.uint32)
    a, b = ee >> np.uint32(5), ee & np.uint32(31)
    field = np.where(num, m | np.where(normal, np.uint32(0x800000), np.uint32(0)), 0).astype(np.uint32)
    st.dgen = st.dgen + popc(transpose32(np.where(num, w & np.uint32(0x807FFFFF), 0).astype(np.uint32),
                                         False))
    tlo = transpose32(shl_c(field, b))
    thi = transpose32(hi_c(field, b))
    to = transpose32(np.where(normal, shl_c(np.ones(32, np.uint32), b), 0).astype(np.uint32))
    rem = int(np.sum(num.astype(np.uint64) << LANE.astype(np.uint64)))
    while rem:
        ag = int(a[(rem & -rem).bit_length() - 1])
        gm = num & (a == ag)
        g = np.uint32(int(np.sum(gm.astype(np.uint64) << LANE.astype(np.uint64))))
        rem &= ~int(g)
        acc[K_ONE + 32 * ag + LANE] += popc(tlo & g)
        acc[K_ONE + 32 * ag + 32 + LANE] += popc(thi & g)
        acc[K_CNT + 32 * ag + LANE] += popc(to & g)


def flush_a(A, hlo, hhi, ho, acc):
    clo, chi, co = hlo.take(), hhi.take(), ho.take()
    acc[K_ONE + 32 * A + LANE] += clo
    acc[K_ONE + 32 * A + 32 + LANE] += chi
    acc[K_CNT + 32 * A + LANE] += co


def warp_run(mem, start, T, h, blocks, acc):
    """One warp over its warp-blocks of a row whose element 0 lies at
    mem[start] (start - h is a multiple of 4)."""
    hd, hlo, hhi, ho = Hs(), Hs(), Hs(), Hs()
    st, A = Lane(), 0
    for blk in blocks:
        w = np.zeros((16, 32), np.uint32)
        for j in range(4):
            q = blk * 128 + 32 * j + LANE.astype(np.int64)
            for i in range(4):
                t = 4 * q - h + i
                ok = (t >= 0) & (t < T)
                w[4 * j + i] = np.where(ok, mem[np.clip(start + t, 0, len(mem) - 1)], 0)
        a0 = (w[0] >> np.uint32(28)) & np.uint32(7)
        support = int(((A != 0) & (a0 == A)).sum())
        if support < 16:
            cand = (a0 >= 1) & (a0 <= 6)
            if cand.any():
                na = int(a0[np.argmax(cand)])
                ns = int((a0 == na).sum())
                if na != A and ns > support:
                    if A != 0:
                        flush_a(A, hlo, hhi, ho, acc)
                    A, support = na, ns
        fast = support >= 16
        a28 = np.uint32(A << 28) if fast else FULL
        slow = np.zeros(32, bool)
        if fast:
            words = [fast_words(w[i], a28, st, slow) for i in range(16)]
            for k, hs in enumerate((hd, hlo, hhi, ho)):
                hs.sixteens(hs.round16([wd[k] for wd in words]))
        if not fast or slow.any():
            for i in range(16):  # the kernel loads these again
                take = ((w[i] + w[i]) != 0) & ((w[i] & np.uint32(0x70000000)) != a28)
                if take.any():
                    generic_step(w[i], take, st, acc)
    if A != 0:
        flush_a(A, hlo, hhi, ho, acc)
    acc[K_DSET + LANE] += hd.take() + st.dgen
    for k, n in enumerate((st.nnan, st.ninf, st.nden)):
        acc[K_FLAG + k] += int(n.sum())
    acc[K_MIN] = min(acc[K_MIN], int(st.lo.min()))
    acc[K_MAX] = max(acc[K_MAX], int(st.hi.max()))


def choose_cluster(N, T, sms=132):
    blocks = (T + 3 + 512 - 1) // 512
    want = (2 * sms + N - 1) // N
    return 1 << (max(1, min(16, want, blocks)).bit_length() - 1)


def emulate(x, h=0, csize=None):
    """The kernel on x [N, T] float32, each row starting at element offset h
    (mod 4) of a float4 boundary; the outputs as bitmeter_stats returns them."""
    N, T = x.shape
    csize = csize or choose_cluster(N, T)
    out = {k: np.zeros((N, NPOS) if k in ("hit", "one") else (N, NMAN) if k == "dset" else N,
                       np.int64) for k in ("hit", "one", "dset", *FLAGS)}
    vmin, vmax = np.zeros(N, np.float32), np.zeros(N, np.float32)
    for r in range(N):
        mem = np.concatenate([np.zeros(h, np.uint32), x[r].view(np.uint32)])
        nq = (T + h + 3) // 4
        nb = (nq + 127) // 128
        per = (nb + csize - 1) // csize
        total = np.zeros(K_ACC, np.int64)
        total[K_MIN] = 0xFFFFFFFF
        for rank in range(csize):
            acc = np.zeros(K_ACC, np.int64)
            acc[K_MIN] = 0xFFFFFFFF
            b1 = min(nb, (rank + 1) * per)
            for warp in range(8):
                warp_run(mem, h, T, h, range(rank * per + warp, b1, 8), acc)
            total[:K_MIN] += acc[:K_MIN]
            total[K_MIN] = min(total[K_MIN], acc[K_MIN])
            total[K_MAX] = max(total[K_MAX], acc[K_MAX])
        P = np.cumsum(total[K_CNT:K_CNT + 256])
        den = total[K_FLAG + 2]
        for j in range(NPOS):
            out["hit"][r, j] = (P[min(j, 255)] - (P[min(j - 24, 255)] if j >= 24 else 0)
                                + (den if 1 <= j <= NMAN else 0))
        out["one"][r] = total[K_ONE:K_ONE + NPOS]
        assert not total[K_ONE + NPOS:K_ONE + 288].any()
        out["dset"][r] = total[K_DSET:K_DSET + NMAN]
        out["nan"][r], out["inf"][r] = total[K_FLAG], total[K_FLAG + 1]
        out["den"][r] = den
        out["zero"][r] = T - P[255] - den - total[K_FLAG] - total[K_FLAG + 1]
        out["pos"][r] = P[255] + den - total[K_DSET + 31]
        mn = int(total[K_MIN])
        vmin[r] = np.inf if mn == 0xFFFFFFFF else np.uint32(mn).view(np.float32)
        vmax[r] = np.uint32(total[K_MAX]).view(np.float32)
    res = {k: torch.from_numpy(v.astype(np.int32)) for k, v in out.items()}
    res.update(vmin=torch.from_numpy(vmin), vmax=torch.from_numpy(vmax))
    return res


def bitmeter_rows(kind, N, T, seed=0):
    """[N, T] float32 of one input kind, from numpy seed ``seed``: gauss (0.1
    N(0, 1), the main path's level), diverse (gauss times 2^U(-60, 60)),
    square (one exponent a row: +-0.7 2^-(row mod 8), period 100), silence
    (zeros with one sample in 1,000 of gauss), denormal (random mantissas,
    exponent 0, random sign), every_exponent (32 distinct exponents in every
    32-sample segment, all 254 normal ones across a row, and NaN, +-Inf and
    +-0), loud (gauss times 30,000: exponents on both sides of 128)."""
    rng = np.random.default_rng(seed)
    g = (0.1 * rng.standard_normal((N, T))).astype(np.float32)
    if kind == "gauss":
        return g
    if kind == "diverse":
        return g * np.float32(2.0) ** rng.integers(-60, 60, (N, T)).astype(np.float32)
    if kind == "square":
        amp = (0.7 * 2.0 ** -(np.arange(N) % 8)).astype(np.float32)[:, None]
        return amp * np.where((np.arange(T) // 50) % 2 == 0, 1.0, -1.0).astype(np.float32)[None]
    if kind == "silence":
        return np.where(rng.random((N, T)) < 1e-3, g, np.float32(0.0)).astype(np.float32)
    if kind == "denormal":
        bits = rng.integers(1, 1 << 23, (N, T), dtype=np.int64)
        bits |= rng.integers(0, 2, (N, T), dtype=np.int64) << 31
        return bits.astype(np.uint32).view(np.float32)
    if kind == "every_exponent":
        e = (np.arange(T) * 37) % 254 + 1
        m = rng.integers(0, 1 << 23, T)
        bits = (e << 23) | m | (rng.integers(0, 2, T) << 31)
        bits[5::97] = 0x7FC00001
        bits[7::101] = 0x7F800000
        bits[9::103] = 0xFF800000
        bits[11::107] = 0x80000000
        bits[13::109] = 0
        return bits.astype(np.uint32).view(np.float32)[None].repeat(N, 0)
    if kind == "loud":
        return g * np.float32(3e4)  # a = 4 samples beside a = 3 ones
    raise ValueError(kind)


def check(x, **kw):
    got = emulate(x, **kw)
    ref = bitmeter_stats_reference(torch.from_numpy(np.ascontiguousarray(x)))
    for k in ref:
        assert got[k].dtype == ref[k].dtype, k
        assert torch.equal(got[k], ref[k]), k


def test_transpose32_is_the_bit_transpose():
    x = np.random.default_rng(1).integers(0, 1 << 32, 32, dtype=np.uint64).astype(np.uint32)
    bits = (x[:, None] >> np.arange(32, dtype=np.uint32)) & 1  # [lane, bit]
    want = (bits.T.astype(np.uint64) << np.arange(32, dtype=np.uint64)).sum(1).astype(np.uint32)
    np.testing.assert_array_equal(transpose32(x), want)


def test_harley_seal_counts_every_bit():
    rng = np.random.default_rng(2)
    hs, words = Hs(), []
    for _ in range(5):
        xs = [rng.integers(0, 1 << 32, 32, dtype=np.uint64).astype(np.uint32) for _ in range(16)]
        words += xs
        hs.sixteens(hs.round16(xs))
    stack = np.stack(words)  # [80, 32 lanes]
    want = [int(((stack >> np.uint32(L)) & 1).sum()) for L in range(32)]
    np.testing.assert_array_equal(hs.take(), want)


@pytest.mark.parametrize("kind", ["gauss", "diverse", "square", "silence", "denormal",
                                  "every_exponent", "loud"])
def test_body_matches_plain(kind):
    check(bitmeter_rows(kind, 3, 3000 if kind != "every_exponent" else 2600))


@pytest.mark.parametrize("h", [1, 2, 3])
@pytest.mark.parametrize("T", [3, 511, 513, 4097])
def test_body_misaligned_rows_and_tails(h, T):
    check(bitmeter_rows("gauss", 1, T, seed=T + h), h=h)


@pytest.mark.parametrize("csize", [1, 2, 3, 8, 16])
def test_body_cluster_sizes(csize):
    x = np.concatenate([bitmeter_rows("gauss", 1, 8200), bitmeter_rows("diverse", 1, 8200, seed=4)])
    check(x, csize=csize)


def test_cluster_choice():
    assert choose_cluster(1, 48000) == 16 and choose_cluster(8, 48000) == 16
    assert choose_cluster(64, 48000) == 4 and choose_cluster(256, 48000) == 2
    assert choose_cluster(512, 48000) == 1 and choose_cluster(1, 3) == 1
    assert choose_cluster(1, 4096) == 8
