"""stft_fused's kernel bodies, emulated in numpy float32 on the CPU, against
the plain version (ops/stft_fused.py::plain_frames).

The CUDA bodies (csrc/stft_fused.cu) cannot run here, so this file repeats
their arithmetic in numpy, with the kernel's own index arithmetic, and holds
the emulation to the plain version at the bars tests/test_torch_cuda.py::
stft_close holds the kernel to on the card (unchanged: STFT_RAW_TOL,
STFT_POW_RTOL / ATOL, phase_bar, STFT_POS_TOL, STFT_FLIP_REL).  Each window
runs the body ``stft_fused.body`` names:

  * the Hopper body (W = 8192): pass 1 reads z[jj + 256 r] of DFT jj < 256
    and writes output r to row jj, column r ^ (jj mod 16); pass 2 reads
    sw(jj) + 256 r, twiddles by pass_twiddles row 16 (r - 1) + jj mod 16 and
    writes row 16 (jj / 16) + r, column (jj mod 16) ^ r; pass 3 reads the
    same positions, twiddles by row 240 + 256 (r - 1) + jj and writes
    Z[jj + 256 r] in natural order; then the pairs (k, N - k), k < N/2
    (k = 0 paired with bin N/2), of thread j = k mod 256, i = k / 256, their
    hand-over slots, and the phase wheel's phase difference from
    phase_difference;
  * the generic body (W = 256 .. 4096): the same pass 1, radix-16 passes
    with twiddles from the one table e^{-i pi k / N} folded past N, the odd
    radix's pass, the untangle one bin at a time and atan2f.

atan2f is atan2 in float64 rounded to float32 here, every fp32 FMA of the phase
difference is rounded once (product and sum in float64, then to float32);
the FFTs' butterflies are rounded per operation (the kernel contracts some
into FMAs: a difference of float32 rounding, far inside the bars).  The
phase wheel's phase difference (one atan2f of X_R conj(X_L) and the
multiple of 2 pi the quadrants fix) is held to the difference of two atan2
in float64, unwrapped, near the product's +-pi cut, on the axes and at
+-0, +-inf and NaN, where the JAX polynomial atan2
(meters_lv2_tpu/ops/pallas_stft.py::_atan2) is shown to miss; and in the
body to the plain version's difference, unwrapped.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from meters_lv2_torch.ops import stft_fused
from meters_lv2_tpu.ops import pallas_stft
from test_torch_cuda import (EXACT_PHASE_TOL, dphi_unwrapped_ok, exact_part_inputs, stft_close,
                             stft_inputs)

torch.set_num_threads(1)

F32, F64 = np.float32, np.float64
R16 = np.arange(16)
BREV4 = np.array([int(f"{r:04b}"[::-1], 2) for r in R16])


def fma(a, b, c):
    """fmaf: the product and the sum in float64, rounded once to float32."""
    return (np.asarray(a, F64) * np.asarray(b, F64) + np.asarray(c, F64)).astype(F32)


def sw(i):
    """The kernel's shared-memory swizzle: the low four bits of i XORed by
    the next four."""
    return i ^ ((i >> 4) & 15)


def brev(r, bits):
    return np.array([int(f"{v:0{bits}b}"[::-1], 2) for v in np.atleast_1d(r)])


def rot16(re, im, k):
    """d e^{-2 pi i k / 16} as rot16 computes it, float32."""
    a, b, h = F32(0.92387953251128674), F32(0.38268343236508977), F32(0.70710678118654752)
    if k == 0:
        return re, im
    if k == 4:
        return im, -re
    c, s = {1: (a, b), 2: (h, h), 3: (b, a), 5: (-b, a), 6: (-h, h), 7: (-a, b)}[k]
    return re * c + im * s, im * c - re * s


def dft_reg(re, im):
    """dft_reg<R> on the last axis (R = 2, 4, 8, 16): radix-2 decimation in
    frequency, output k at position brev(k)."""
    R = re.shape[-1]
    re, im = re.copy(), im.copy()
    for s in range(R.bit_length() - 1):
        half = R >> (s + 1)
        for i in range(R // 2):
            p = i & (half - 1)
            lo = ((i - p) << 1) + p
            ar, ai = re[..., lo].copy(), im[..., lo].copy()
            br, bi = re[..., lo + half].copy(), im[..., lo + half].copy()
            re[..., lo], im[..., lo] = ar + br, ai + bi
            re[..., lo + half], im[..., lo + half] = rot16(ar - br, ai - bi, p * (8 // half))
    return re, im


def cmul(ar, ai, wr, wi):
    return ar * wr - ai * wi, ar * wi + ai * wr


def windowed_z(ext, win, hop, F):
    """z[m] = x[2m] w[2m] + i x[2m+1] w[2m+1] of every frame: [B, 2, F, W/2]
    float32 (re, im), as pass 1 loads them."""
    W = win.shape[-1]
    idx = hop * (np.arange(F)[:, None] + 1) + np.arange(W)
    fr = ext[..., idx] * win  # float32 products
    return fr[..., 0::2], fr[..., 1::2]


def first_pass(zr, zi, N, swizzle=True):
    """Pass 1 of both bodies: DFT jj < N/16 of z[jj + N/16 r], output r to
    row jj, column r ^ (jj mod 16).  Returns the physical array (re, im)."""
    M = N // 16
    jj = np.arange(M)
    vr, vi = dft_reg(zr[..., jj[:, None] + M * R16], zi[..., jj[:, None] + M * R16])
    phys = 16 * jj[:, None] + (R16 ^ (jj[:, None] & 15))
    assert np.array_equal(np.sort(phys.ravel()), np.arange(N)), "pass 1 writes a permutation"
    Sr, Si = np.empty_like(zr), np.empty_like(zi)
    Sr[..., phys], Si[..., phys] = vr[..., BREV4], vi[..., BREV4]
    return Sr, Si


def hopper_fft(zr, zi, ptw):
    """The Hopper body's three passes on [..., 4096]; Z in natural order."""
    N = 4096
    Sr, Si = first_pass(zr, zi, N)
    jj = np.arange(256)
    tr, ti = ptw[:, 0], ptw[:, 1]
    for NS, base in ((16, 0), (256, 15 * 16)):
        src = sw(jj)[:, None] + 256 * R16
        vr, vi = Sr[..., src], Si[..., src]
        t = base + NS * (R16[1:] - 1) + (jj[:, None] & (NS - 1))  # [256, 15]
        vr[..., 1:], vi[..., 1:] = cmul(vr[..., 1:], vi[..., 1:], tr[t], ti[t])
        vr, vi = dft_reg(vr, vi)
        if NS == 16:
            jm = jj[:, None] & 15
            dst = (jj[:, None] - jm) * 16 + 16 * R16 + (jm ^ R16)
        else:
            dst = jj[:, None] + 256 * R16
        assert np.array_equal(np.sort(dst.ravel()), np.arange(N)), "a pass writes a permutation"
        Sr, Si = np.empty_like(Sr), np.empty_like(Si)
        Sr[..., dst], Si[..., dst] = vr[..., BREV4], vi[..., BREV4]
    return Sr, Si


def generic_fft(zr, zi, tw, N):
    """The generic body's passes (radix 16, then the odd radix) with
    twiddles from tw = e^{-i pi k / N}, k < N, folded past N; Z in natural
    order."""
    L2 = N.bit_length() - 1
    Sr, Si = first_pass(zr, zi, N)
    radices = [16] * (L2 // 4 - 1) + ([1 << (L2 % 4)] if L2 % 4 else [])
    Ns = 16
    for R in radices:
        M = N // R
        j = np.arange(M)
        r = np.arange(R)
        src = sw(j[:, None] + r * M)
        vr, vi = Sr[..., src], Si[..., src]
        jm = j & (Ns - 1)
        k = r[None, 1:] * (jm * ((2 * N // R) // Ns))[:, None]
        wr = np.where(k < N, tw[np.where(k < N, k, k - N), 0], -tw[np.where(k < N, k, k - N), 0])
        wi = np.where(k < N, tw[np.where(k < N, k, k - N), 1], -tw[np.where(k < N, k, k - N), 1])
        vr[..., 1:], vi[..., 1:] = cmul(vr[..., 1:], vi[..., 1:], wr, wi)
        vr, vi = dft_reg(vr, vi)
        dst = sw((j - jm)[:, None] * R + jm[:, None] + r * Ns)
        assert np.array_equal(np.sort(dst.ravel()), np.arange(N)), "a pass writes a permutation"
        Sr, Si = np.empty_like(Sr), np.empty_like(Si)
        out = brev(r, R.bit_length() - 1)
        Sr[..., dst], Si[..., dst] = vr[..., out], vi[..., out]
        Ns *= R
    nat = sw(np.arange(N))
    return Sr[..., nat], Si[..., nat]


def untangle(pr, pi, qr, qi, wr, wi):
    """The Hopper body's pair: (X[k], X[N-k]) from Z[k], Z[N-k], w."""
    ex, ey = pr + qr, pi - qi
    ox, oy = pi + qi, qr - pr
    tx, ty = wr * ox - wi * oy, wr * oy + wi * ox
    h = F32(0.5)
    return (h * (ex + tx), h * (ey + ty)), (h * (ex - tx), h * (ty - ey))


def hopper_pairs():
    """(k, hi bin) of every (thread j, pair i) of a channel, k = j + 256 i."""
    j, i = np.meshgrid(np.arange(256), np.arange(8), indexing="ij")
    k = j + 256 * i
    kh = np.where((i == 0) & (k == 0), 2048, 4096 - k)
    return k.ravel(), kh.ravel()


def atan2f(y, x):
    """atan2f of float32 arguments: atan2 in float64, rounded to float32
    (the CUDA library's is within 3 ulp of it, its special values exact)."""
    with np.errstate(all="ignore"):
        return np.arctan2(np.asarray(y, F32).astype(F64), np.asarray(x, F32).astype(F64)).astype(F32)


def phase_difference(l, r):
    """csrc/stft_fused.cu::phase_difference, float32: atan2(r) - atan2(l) for
    (re, im) pairs l and r, from one atan2f of r conj(l) and the multiple of
    2 pi the quadrants fix; two atan2f where the range is unsafe."""
    (lr, li), (rr, ri) = l, r
    with np.errstate(all="ignore"):
        m = np.fmax(np.abs(lr), np.abs(li)) * np.fmax(np.abs(rr), np.abs(ri))
        fast = (m >= F32(2.0 ** -100)) & (m <= F32(2.0 ** 100))
        w = atan2f(fma(ri, lr, -(rr * li)), fma(rr, lr, ri * li))
        ql = np.copysign(np.where(np.signbit(lr), F32(3), F32(1)), li)
        qr = np.copysign(np.where(np.signbit(rr), F32(3), F32(1)), ri)
        k = np.rint(fma(-w, F32(0.15915493667125702), F32(0.125) * (qr - ql)))
        d = fma(k, F32(6.2831854820251465), fma(k, F32(-1.7484555314695172e-07), w))
        return np.where(fast, d, atan2f(ri, rr) - atan2f(li, lr)).astype(F32)


def hopper_combine(Xr, Xi, mode, thr, N):
    """The Hopper body's outputs of every bin from both channels' X [B, 2, F, N]."""
    bins = np.arange(N)
    l, r = (Xr[:, 0], Xi[:, 0]), (Xr[:, 1], Xi[:, 1])
    with np.errstate(all="ignore"):
        pl, pr = (np.where(bins == N - 1, F32(0), x * x + y * y).astype(F32) for x, y in (l, r))
        if mode == "phasewheel":
            ok = (pl >= thr) & (pr >= thr)
            d = np.where((bins == 0) | (bins == N - 1), F32(0), phase_difference(l, r))
            return np.where(ok, d, F32(0)), np.where(ok, np.fmax(pl, pr), F32(-100))
        return combine((pl, np.sqrt(pl)), (pr, np.sqrt(pr)), mode, thr)


def epilogue_values(Xr, Xi, bins, mode, thr, N, phase):
    """The generic body's (power, phase | sqrt power) of one channel's bins,
    float32."""
    with np.errstate(all="ignore"):
        P = np.where(bins == N - 1, F32(0), Xr * Xr + Xi * Xi).astype(F32)
        if mode == "stereoscope":
            return P, np.sqrt(P)
        ph = np.where((bins == 0) | (bins == N - 1), F32(0), phase(Xi, Xr))
        return P, ph.astype(F32)


def combine(l, r, mode, thr):
    (pl, a), (pr, b) = l, r
    with np.errstate(all="ignore"):
        if mode == "phasewheel":
            ok = (pl >= thr) & (pr >= thr)
            return np.where(ok, b - a, F32(0)), np.where(ok, np.fmax(pl, pr), F32(-100))
        lv = np.where(np.isnan(pl) | np.isnan(pr), pl + pr, np.fmax(pl, pr))
        ok = (pl >= thr) | (pr >= thr)
        den = np.fmax(np.fmax(a, b), np.sqrt(F32(1e-30)))
        pos = F32(0.5) + F32(0.5) * (b - a) / den
        return np.where(ok, pos, F32(0.5)), np.where(ok, lv, F32(0))


def emulate(ext, win, hop, mode, thr):
    """The body stft_fused.body(W) names, on numpy float32 ext [B, 2, L] and
    win [W]: outputs as analyzer_frames returns them."""
    W = win.shape[-1]
    N = W // 2
    F = (ext.shape[-1] - W) // hop
    thr = F32(thr)
    zr, zi = windowed_z(ext, win, hop, F)
    tw = stft_fused.twiddles(W, "cpu").numpy()
    if stft_fused.body(W) == "hopper":
        Zr, Zi = hopper_fft(zr, zi, stft_fused.pass_twiddles(W, "cpu").numpy())
        k, kh = hopper_pairs()
        lo, hi = untangle(Zr[..., k], Zi[..., k], Zr[..., (N - k) & (N - 1)],
                          Zi[..., (N - k) & (N - 1)], tw[k, 0], tw[k, 1])
        first = k == 0  # bin N/2, its own pair
        h = untangle(Zr[..., N // 2], Zi[..., N // 2], Zr[..., N // 2], Zi[..., N // 2],
                     tw[N // 2, 0], tw[N // 2, 1])[0]
        hi = tuple(np.where(first, v[..., None], u) for u, v in zip(hi, h))
        Xr, Xi = np.empty_like(Zr), np.empty_like(Zi)
        Xr[..., k], Xi[..., k], Xr[..., kh], Xi[..., kh] = lo[0], lo[1], hi[0], hi[1]
        assert np.array_equal(np.sort(np.concatenate([k, kh])), np.arange(N)), "pairs cover bins"
        if mode == "raw":
            return Xr, Xi
        # the hand-over: the left channel's low bins into its slot k, the
        # right channel's high bins into its slot N - k (N/2 for k = 0)
        slot = np.full((2, N), -1)
        slot[0, k], slot[1, kh] = 1, 1
        assert (slot[0, kh] == -1).all() and (slot[1, k] == -1).all(), "slots a thread's own"
        return hopper_combine(Xr, Xi, mode, thr, N)
    Zr, Zi = generic_fft(zr, zi, tw, N)
    kk = np.arange(N)
    kc = (N - kk) & (N - 1)
    h = F32(0.5)
    pr, pi, qr, qi = Zr[..., kk], Zi[..., kk], Zr[..., kc], Zi[..., kc]
    er, ei, orr, oi = h * (pr + qr), h * (pi - qi), h * (pi + qi), h * (qr - pr)
    Xr = er + tw[:, 0] * orr - tw[:, 1] * oi
    Xi = ei + tw[:, 0] * oi + tw[:, 1] * orr
    if mode == "raw":
        return Xr, Xi
    v = epilogue_values(Xr, Xi, kk, mode, thr, N, atan2f)
    return combine(tuple(u[:, 0] for u in v), tuple(u[:, 1] for u in v), mode, thr)


def frame_inputs(B, W, hop, F, nonfinite):
    """tests/test_torch_cuda.py::stft_inputs on the CPU; with ``nonfinite``
    also a NaN on frame 0's first sample (stream 1, left) and +Inf on the
    last frame's last sample (stream 2, right)."""
    ext, win, skip = stft_inputs(B, W, hop, F, W + B, "cpu", nonfinite)
    if nonfinite:
        ext[1, 0, hop] = math.nan
        ext[2, 1, hop * F + W - 1] = math.inf
    return ext, win, skip


def test_body_of_each_window():
    """W = 8192 runs the Hopper body, every other power of two from 256 to
    4096 the generic one; pass_twiddles is the Hopper body's table alone."""
    assert {W: stft_fused.body(W) for W in (256, 512, 1024, 2048, 4096, 8192)} == {
        256: "generic", 512: "generic", 1024: "generic", 2048: "generic", 4096: "generic",
        8192: "hopper"}
    for W in (128, 3000, 16384):
        with pytest.raises(ValueError):
            stft_fused.body(W)
    with pytest.raises(ValueError):
        stft_fused.pass_twiddles(4096, "cpu")
    t = stft_fused.pass_twiddles(8192, "cpu").numpy().astype(F64)
    r = np.arange(1, 16)[:, None]
    want = np.concatenate([(r * np.arange(16) / 256).ravel(), (r * np.arange(256) / 4096).ravel()])
    np.testing.assert_allclose(t[:, 0], np.cos(2 * np.pi * want), atol=6e-8)
    np.testing.assert_allclose(t[:, 1], -np.sin(2 * np.pi * want), atol=6e-8)


def test_hopper_pairs_cover_each_bin_once():
    """Every bin of a channel is one thread's lo or hi bin, once."""
    k, kh = hopper_pairs()
    assert np.array_equal(np.sort(np.concatenate([k, kh])), np.arange(4096))
    assert (k < 2048).all() and ((kh >= 2048) & (kh < 4096)).all()


@pytest.mark.parametrize("nonfinite", [False, True])
@pytest.mark.parametrize("F", [1, 25])
@pytest.mark.parametrize("hop", [1920, 1764])
@pytest.mark.parametrize("W", [256, 1024, 8192])
@pytest.mark.parametrize("mode", ["raw", "phasewheel", "stereoscope"])
def test_emulated_body_matches_plain(mode, W, hop, F, nonfinite):
    B = 3
    ext, win, skip = frame_inputs(B, W, hop, F, nonfinite)
    thr = 1e-6 if mode == "phasewheel" else 1e-20
    got = emulate(ext.numpy(), win.numpy(), hop, mode, thr)
    got = tuple(torch.from_numpy(np.ascontiguousarray(g)) for g in got)
    ref = stft_fused.plain_frames(ext, win, hop, mode, thr)
    raw = stft_fused.plain_frames(ext, win, hop, "raw", thr)
    assert got[0].shape == ref[0].shape
    _, errs = stft_close(got, ref, raw, mode, thr, skip)
    assert not errs, errs


PHASE_DIFF_TOL = 6e-7  # rad: two atan2f within 3 ulp each, the difference rounded


def phase_pairs(n, seed, log2_mag):
    """n pairs (l, r) of float32 (re, im): uniform angles, a quarter of the
    pairs with r within 1e-7 rad of l + pi or l - pi (the product's angle at
    +-pi), a tenth on the axes (re or im an exact +-0), magnitudes 2^u with u
    uniform in +-log2_mag."""
    rng = np.random.default_rng(seed)
    al, ar = rng.uniform(-np.pi, np.pi, n), rng.uniform(-np.pi, np.pi, n)
    q = n // 4
    ar[:q] = al[:q] + np.pi * np.sign(rng.standard_normal(q)) + 1e-7 * rng.standard_normal(q)
    ar = np.angle(np.exp(1j * ar))
    ax = rng.integers(0, 4, n // 10) * (np.pi / 2)
    al[q:q + n // 10], ar[-(n // 10):] = ax, -ax
    ml, mr = (2.0 ** rng.uniform(-log2_mag, log2_mag, n) for _ in range(2))
    l = ((ml * np.cos(al)).astype(F32), (ml * np.sin(al)).astype(F32))
    r = ((mr * np.cos(ar)).astype(F32), (mr * np.sin(ar)).astype(F32))
    return l, r


@pytest.mark.parametrize("log2_mag", [10, 50, 70])
def test_phase_difference_against_float64(log2_mag):
    """phase_difference against atan2(r) - atan2(l) in float64, unwrapped
    (in [-2 pi, 2 pi], as the plain version's difference of two phases),
    near the product's +-pi cut and on the axes too: within PHASE_DIFF_TOL,
    as the two-atan2 path is.  At 2^70 some products leave [2^-100, 2^100]
    and take that path."""
    l, r = phase_pairs(200000, log2_mag, log2_mag)
    got = phase_difference(l, r).astype(F64)
    want = (np.arctan2(r[1].astype(F64), r[0].astype(F64))
            - np.arctan2(l[1].astype(F64), l[0].astype(F64)))
    assert np.abs(got - want).max() <= PHASE_DIFF_TOL
    two = (atan2f(r[1], r[0]) - atan2f(l[1], l[0])).astype(F64)
    assert np.abs(two - want).max() <= PHASE_DIFF_TOL


@pytest.mark.parametrize("nonfinite", [False, True])
@pytest.mark.parametrize("hop", [1920, 1764])
def test_emulated_dphi_is_the_plain_difference_unwrapped(hop, nonfinite):
    """The Hopper body's dphi is phi_R - phi_L itself, in [-2 pi, 2 pi], not
    a value 2 pi away (tests/test_torch_cuda.py::dphi_unwrapped_ok)."""
    ext, win, skip = frame_inputs(3, 8192, hop, 25, nonfinite)
    got = emulate(ext.numpy(), win.numpy(), hop, "phasewheel", 1e-6)
    ref = stft_fused.plain_frames(ext, win, hop, "phasewheel", 1e-6)
    raw = stft_fused.plain_frames(ext, win, hop, "raw", 1e-6)
    assert dphi_unwrapped_ok(tuple(torch.from_numpy(g) for g in got), ref, raw, skip)


SPECIALS = [0.0, -0.0, math.inf, -math.inf, 1.5, -1.5, math.nan]


@pytest.mark.parametrize("side", ["left", "right"])
@pytest.mark.parametrize("y", SPECIALS)
@pytest.mark.parametrize("x", SPECIALS)
def test_phase_difference_specials(x, y, side):
    """One channel's X = (x, y) from +-0, +-inf, NaN and +-1.5, the other's
    (0.3, -1.2): atan2's answers, signed zeros and infinities included (a
    wrong one is off by pi/4 or more), NaN in, NaN out; the exact-zero and
    non-finite vectors take the two-atan2 path."""
    v, o = (F32(x), F32(y)), (F32(0.3), F32(-1.2))
    l, r = (v, o) if side == "left" else (o, v)
    got = phase_difference(l, r)
    want = (np.arctan2(F64(r[1]), F64(r[0])) - np.arctan2(F64(l[1]), F64(l[0])))
    if np.isnan(want):
        assert np.isnan(got)
    else:
        assert abs(float(got) - want) <= PHASE_DIFF_TOL, (l, r, got, want)


@pytest.mark.parametrize("y,x,want", [(-0.0, -1.0, -math.pi), (-0.0, -0.0, -math.pi),
                                      (math.inf, math.inf, math.pi / 4),
                                      (-math.inf, -math.inf, -3 * math.pi / 4)])
def test_jax_polynomial_misses_the_specials(y, x, want):
    """The JAX kernel's polynomial atan2 gives +pi for y = -0 with x < 0 and
    NaN for inf / inf; the port's phase difference of X_R = (x, y) against
    X_L = (1, 0) keeps atan2f's answers (within PHASE_DIFF_TOL: x + 2 pi k
    rounds once)."""
    jax_ans = float(pallas_stft._atan2(jnp.float32(y), jnp.float32(x)))
    assert not abs(jax_ans - want) <= 1.0  # off by 2 pi, or NaN
    got = phase_difference((F32(1), F32(0)), (F32(x), F32(y)))
    assert abs(float(got) - want) <= PHASE_DIFF_TOL


def raw_phase_difference(re, im, N):
    """phi_R - phi_L from raw (re, im) [B, 2, F, N] with atan2 in float32
    and the edge bins' phase 0, and whether each power is NaN."""
    with np.errstate(all="ignore"):
        ph = np.arctan2(im, re).astype(F32)
        ph[..., 0] = ph[..., N - 1] = 0
        P = re * re + im * im
    return ph[:, 1] - ph[:, 0], np.isnan(P[:, 0]) | np.isnan(P[:, 1])


@pytest.mark.parametrize("W", [256, 8192])
def test_emulated_phase_bins_with_exact_zero_and_inf_parts(W):
    """The phase wheel's mode at thr = -1 (every bin whose powers are not
    NaN passes) on bins with exact +-0 and +-inf parts: dphi equals
    atan2(im, re) of the same body's raw bins, right minus left, within
    EXACT_PHASE_TOL (a wrong signed zero or infinity is off by pi/4 or
    more), and the bins with a NaN power read (0, -100)."""
    hop = 100
    ext, win = exact_part_inputs(W, hop)
    with np.errstate(all="ignore"):
        re, im = emulate(ext, win, hop, "raw", -1.0)
        dphi, level = emulate(ext, win, hop, "phasewheel", -1.0)
    want, nan = raw_phase_difference(re, im, W // 2)
    zero = ((re == 0) | (im == 0)) & ~np.isnan(re * re + im * im)
    inf = (np.isinf(re) | np.isinf(im)) & ~np.isnan(re * re + im * im)
    assert zero.sum() > 100 and inf.sum() > 0  # the cases are there
    assert (np.signbit(re[zero]) | np.signbit(im[zero])).any()  # -0 among them
    assert ((dphi == 0) & (level == -100))[nan].all()
    np.testing.assert_allclose(dphi[~nan], want[~nan], rtol=0, atol=EXACT_PHASE_TOL)
