"""surround_fused.cu's Hopper body emulated in numpy against the plain version.

The CUDA kernel (meters_lv2_torch/csrc/surround_fused.cu) runs only on the
card; here its decomposition runs in numpy float32, with the kernel's
arithmetic order: a stream's 128-sample blocks split over `split` CTAs
(contiguous ranges of ceil(nblk / split) blocks, chunks of 128 blocks), each
block's zero-state sums (peak, x^2 against G's columns, the lowpass from
zero, the channel products S_ij = sum wv y_i y_j and R_c = sum wv r y_c,
Q = sum wv r^2), the chunk's lowpass walk from the CTA's zero state, each
block's correction with its entry state and the CTA's U_c = sum a^i (R_c +
z_c Q) and V = sum a^2i Q, the stream's carries stepped block by block from
its entry state (as the first CTA walks its range and the gathered blocks of
the others, giving each CTA's lowpass entry state Z), the CTAs' sums with
their Z, and the one-hot contraction over every channel.  It is held against fused_core_reference at the card's bars
(tests/test_torch_cuda.py: pk bit-exact, km_z 4e-6 of its scale, zl and
pacc 1e-5, non-finite values in the same places) and, composed into the
pair integrators, against the JAX package's XLA path.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import meters_lv2_torch as mt
from meters_lv2_torch.ops import surround_fused
from meters_lv2_tpu.models import create as jax_create
from meters_lv2_tpu.ops import pallas_surround

torch.set_num_threads(1)

FS = 48000
F32, F64 = np.float32, np.float64
SUR_Z_SCALE, SUR_TOL = 4e-6, 1e-5  # tests/test_torch_cuda.py's bars
XLA_RTOL, XLA_SCALE = 1e-5, 1e-6  # tests/test_torch_surround.py's CORE bars
PAIRS = [[0, 0], [1, 1], [0, 1], [2, 3]]


def fma(a, b, c):
    """fmaf in float32: the product is exact in float64, one rounding for
    the sum (a second one, to float32, is as rare as it is small)."""
    return (np.asarray(a, F64) * np.asarray(b, F64) + np.asarray(c, F64)).astype(F32)


def tri(C, i, j):
    return i * C - i * (i - 1) // 2 + (j - i)


def km_step(s0, s1, at):
    """km_step: s' = s @ At as the walk takes it."""
    at00, at01, at10, at11 = at
    return fma(at10, s1, F32(at00 * s0)), fma(at11, s1, F32(at01 * s0))


def threads(C):
    """Dims<C>::kThreads: blocks a chunk, one a thread."""
    return 192 if C == 3 else 128 if C == 4 else 64


def choose_split(B, nblk, C, sms=132):
    """The launcher's choose_split; cap is the ring's floats
    (Dims<C>::kStages stages)."""
    stages = 4 if C == 3 else 3 if C == 4 else 2
    cap = stages * (C + 1) * 2 * threads(C) * 4
    want = min(8, -(-sms // B), nblk)
    if want <= 1:
        return 1
    per = min(threads(C), -(-nblk // want))
    split = -(-nblk // per)
    return split if split <= 8 and (nblk - per) * 3 * C <= cap else 1


def block_sums(xb, wvb, g, sy, w1, om1, eps):
    """One thread's block for every (stream, block) at once: xb [..., C,
    128], wvb [..., 128].  Returns pk, z (end value), g0, g1 [..., C] and
    S [..., NS] (S_ij, then R_c, then Q)."""
    C = xb.shape[-2]
    nm = C * (C + 1) // 2
    shape = xb.shape[:-2]
    pk = np.zeros(shape + (C,), F32)
    z = np.zeros(shape + (C,), F32)
    g0 = np.zeros(shape + (C,), F32)
    g1 = np.zeros(shape + (C,), F32)
    S = np.zeros(shape + (nm + C + 1,), F32)
    with np.errstate(invalid="ignore", over="ignore"):
        for t in range(128):
            v = xb[..., t]
            q = (v * v).astype(F32)
            pk = np.fmax(pk, q)
            g0 = fma(q, g[t, 0], g0)
            g1 = fma(q, g[t, 1], g1)
            z = fma(om1, z, (w1 * (v + eps)).astype(F32))
            wt = wvb[..., t]
            r = sy[t]
            wr = (wt * r).astype(F32)
            wy = (wt[..., None] * z).astype(F32)
            for i in range(C):
                for j in range(i, C):
                    S[..., tri(C, i, j)] = fma(wy[..., i], z[..., j], S[..., tri(C, i, j)])
                S[..., nm + i] = fma(wr, z[..., i], S[..., nm + i])
            S[..., -1] = fma(wr, r, S[..., -1])
    return pk, z, g0, g1, S


def cta_summary(blk, ops):
    """One CTA over its range, from its blocks' sums ``blk`` = (pk, z, g0,
    g1, S) of block_sums, each [B, n, ...].  Returns (pk [B, C], s [B, NS])
    as the kernel's Summary holds them."""
    _, _, a128, _ = ops
    pk_b, z_b, _, _, S_b = blk
    B, n, C = z_b.shape
    nm = C * (C + 1) // 2
    wz = np.zeros((B, C), F32)
    wa = F32(1.0)
    tot = np.zeros((B, nm + C + 1), F32)
    chunk = threads(C)
    with np.errstate(invalid="ignore", over="ignore"):
        for c0 in range(0, n, chunk):
            zin = np.zeros((B, min(chunk, n - c0), C), F32)
            ai = np.zeros(min(chunk, n - c0), F32)
            for k, i in enumerate(range(c0, min(n, c0 + chunk))):
                zin[:, k] = wz
                wz = fma(a128, wz, z_b[:, i])
                ai[k] = wa
                wa = F32(wa * a128)
            S = S_b[:, c0:c0 + zin.shape[1]].copy()  # [B, nb, NS]
            R = S[..., nm:nm + C].copy()
            Q = S[..., -1].copy()
            for i in range(C):
                for j in range(i, C):
                    k = tri(C, i, j)
                    zz = (zin[..., i] * zin[..., j]).astype(F32)
                    S[..., k] = fma(zz, Q, fma(zin[..., j], R[..., i], fma(zin[..., i], R[..., j],
                                                                        S[..., k])))
            S[..., nm:nm + C] = (ai[:, None] * fma(zin, Q[..., None], R)).astype(F32)
            S[..., -1] = (F32(1) * ai * ai * Q).astype(F32)
            tot = (tot + S.sum(axis=1, dtype=F32)).astype(F32)
    return pk_b.max(axis=1), tot


def body(x, kmz, zl0, sa, sb, ops, w1, wv, split):
    """The kernel's result for x [B, C, T] with `split` CTAs a stream."""
    g, at, a128, sy = ops
    B, C, T = x.shape
    nm = C * (C + 1) // 2
    om1, eps = F32(1.0 - w1), F32(surround_fused.lowpass_eps(w1))
    nblk = T // 128
    per = -(-nblk // split)
    blk = block_sums(np.moveaxis(x.reshape(B, C, nblk, 128), 1, 2),
                     np.broadcast_to(wv.reshape(nblk, 128), (B, nblk, 128)), g, sy, F32(w1), om1,
                     eps)
    sums = [cta_summary([a[:, q * per:(q + 1) * per] for a in blk], ops) for q in range(split)]
    _, e_b, g0_b, g1_b, _ = blk
    zl, s0, s1 = zl0[..., 0].copy(), kmz[..., 0].copy(), kmz[..., 1].copy()
    zent = []
    with np.errstate(invalid="ignore", over="ignore"):
        for k in range(nblk):  # the carries, block by block from the entry state
            if k % per == 0:
                zent.append(zl)
            zl = fma(a128, zl, e_b[:, k])
            s0, s1 = km_step(s0, s1, at)
            s0, s1 = (s0 + g0_b[:, k]).astype(F32), (s1 + g1_b[:, k]).astype(F32)
        s = np.stack([s0, s1], -1)
    pk, pacc = combine(sums, zent, sa, sb)
    return s, zl[..., None], pk, pacc


@np.errstate(invalid="ignore", over="ignore")
def combine(sums, zent, sa, sb):
    """The first CTA's end: the CTAs' peaks, their sums (pk [B, C], s [B,
    NS]) composed with their lowpass entry states zent[q] [B, C] in rank
    order, and the one-hot contraction over every channel.  (pk, pacc)."""
    B, C = zent[0].shape
    nm = C * (C + 1) // 2
    pk = np.zeros((B, C), F32)
    for pk_q, _ in sums:
        pk = np.fmax(pk, pk_q)
    mtot = np.zeros((B, nm), F32)
    for q, (_, tq) in enumerate(sums):
        for i in range(C):
            for j in range(i, C):
                k = tri(C, i, j)
                Zi, Zj = zent[q][:, i], zent[q][:, j]
                mtot[:, k] = (mtot[:, k] + fma((Zi * Zj).astype(F32), tq[:, -1],
                              fma(Zj, tq[:, nm + i], fma(Zi, tq[:, nm + j], tq[:, k])))
                              ).astype(F32)
    full = np.empty((B, C, C), F32)
    for i in range(C):
        for j in range(C):
            full[:, i, j] = mtot[:, tri(C, min(i, j), max(i, j))]
    P = sa.shape[0]
    pacc = np.zeros((B, P, 3), F32)
    for p in range(P):
        for k, (ra, rb) in enumerate(((sa, sb), (sa, sa), (sb, sb))):
            v = np.zeros(B, F32)
            for i in range(C):
                for j in range(C):
                    v = fma(F32(ra[p, i] * rb[p, j]), full[:, i, j], v)
            pacc[:, p, k] = v
    return pk, pacc


def inputs(C, B, T, seed, pairs=None, nonfinite=()):
    """fused_core's arguments as torch CPU tensors (x of 0.3 N(0, 1) with
    the samples ``nonfinite`` (b, c, t, value) set, carried states), and the
    kernel's operator leaves (g [128, 2], at [4], a128, sy [128]) as
    float32."""
    m = mt.create(f"surround{C}", FS)
    rng = np.random.default_rng(seed)
    x = (0.3 * rng.standard_normal((B, C, T))).astype(F32)
    kz = (0.01 * rng.random((B, C, 2))).astype(F32)
    zl = (0.05 * rng.standard_normal((B, C, 1))).astype(F32)
    for b, c, t, v in nonfinite:
        x[b, c, t] = v
    sel = m._sel(None if pairs is None else torch.tensor(pairs, dtype=torch.float32), "cpu")
    wv, _ = m.cor._ema_weights(T, "cpu")
    args = (torch.from_numpy(x), torch.from_numpy(kz), torch.from_numpy(zl), *sel, m.km.sys,
            m.cor.lp, m.cor.w1, wv)
    km_op, lp_op = m.km.sys.op(32), m.cor.lp.op(128)
    ops = (np.asarray(km_op.g, F32), np.asarray(km_op.at, F32).reshape(4),
           F32(np.asarray(lp_op.at).reshape(())), np.asarray(lp_op.sy, F32).reshape(128))
    return m, args, ops


def emulate(args, ops, split):
    x, kz, zl, sa, sb, _, _, w1, wv = args
    return body(x.numpy(), kz.numpy(), zl.numpy(), sa.numpy(), sb.numpy(), ops, w1, wv.numpy(),
                split)


@np.errstate(invalid="ignore")
def assert_card_bars(got, ref):
    """tests/test_torch_cuda.py::_assert_surround_close on numpy leaves."""
    for n, a, b in zip(("km_z", "zl", "pk", "pacc"), got, ref):
        a, b = np.asarray(a, F64), np.asarray(b, F64)
        f = np.isfinite(b)
        np.testing.assert_array_equal(np.isfinite(a), f, err_msg=n)
        if n in ("km_z", "pk"):
            np.testing.assert_array_equal(np.isnan(a), np.isnan(b), err_msg=n)
            np.testing.assert_array_equal(a[np.isinf(b)], b[np.isinf(b)], err_msg=n)
        if n == "pk":
            np.testing.assert_array_equal(np.nan_to_num(a, nan=0.0), np.nan_to_num(b, nan=0.0))
        elif n == "km_z":
            scale = np.where(f, b, 0.0).__abs__().max(axis=(0, 1))
            assert np.all(np.where(f, np.abs(a - b), 0.0) <= SUR_Z_SCALE * scale), n
        elif f.any():
            assert np.abs(a - b)[f].max() <= SUR_TOL * np.abs(b)[f].max(), n


def plain(args):
    return [t.numpy() for t in surround_fused.fused_core_reference(*args)]


@pytest.mark.parametrize("C", [3, 4, 5, 6, 7, 8])
def test_body_matches_plain_at_every_width(C):
    """T = 48000 (375 blocks) split as the launcher splits 3 streams (8
    CTAs of 47 blocks, the last 46), with the meter's routing."""
    _, args, ops = inputs(C, 3, 48000, C)
    split = choose_split(3, 375, C)
    assert split == 8
    assert_card_bars(emulate(args, ops, split), plain(args))


@pytest.mark.parametrize("split", [1, 6, 7, 8])
def test_body_splits_and_chunks(split):
    """375 blocks over 1 (six chunks of 64, the last of 55), 6 (63 each,
    the last 60), 7 and 8 CTAs a stream: the ranges and chunks compose to
    the same result."""
    _, args, ops = inputs(5, 2, 48000, 11, PAIRS)
    assert_card_bars(emulate(args, ops, split), plain(args))


@pytest.mark.parametrize("B,T,C,split", [
    (256, 48000, 8, 1), (132, 48000, 5, 1), (100, 48000, 8, 6), (100, 48000, 3, 2),
    (8, 48000, 8, 8), (1, 48000, 3, 8), (1, 128, 5, 1), (8, 1280, 8, 5), (1, 55296, 8, 8),
    (1, 65536, 8, 1), (1, 131200, 3, 8), (1, 196736, 3, 1), (1, 480000, 5, 1)])
def test_split_choice(B, T, C, split):
    """One CTA a stream once the streams fill the SMs; else one chunk a
    CTA, at most 8 (a portable cluster), and the other CTAs' blocks within
    the first one's ring; longer blocks take one CTA."""
    assert choose_split(B, T // 128, C) == split


@pytest.mark.parametrize("T,split", [(128, 1), (256, 2), (1280, 10), (1280, 4)])
def test_body_short_blocks(T, split):
    """One block a CTA, ranges of two blocks and ranges not a divisor."""
    _, args, ops = inputs(8, 3, T, T + split, PAIRS)
    assert_card_bars(emulate(args, ops, split), plain(args))


@pytest.mark.parametrize("C", [3, 5, 8])
def test_nonfinite_channel_reaches_every_pair(C):
    """NaN, +Inf and -Inf samples: inside a CTA's range, in a stream's last
    block and on a CTA's first block.  Every pair of a poisoned stream is
    non-finite (C3), the clean stream's are finite, and the K-meter state
    has the plain version's NaN and Inf."""
    bad = [(0, C - 1, 300, np.nan), (1, 1, 47900, np.inf), (2, 0, 47 * 128 * 5, -np.inf)]
    _, args, ops = inputs(C, 4, 48000, 20 + C, nonfinite=bad)
    got = emulate(args, ops, 8)
    assert_card_bars(got, plain(args))
    assert not np.isfinite(got[3][:3]).any() and np.isfinite(got[3][3]).all()
    assert np.isinf(got[0][1]).any()  # the last block's +Inf reaches km_z as +Inf


@pytest.mark.parametrize("n_blocks", [1, 2, 3, 5])
@pytest.mark.parametrize("entry", [(0, np.inf), (1, np.inf), (0, np.nan), (1, -np.inf)])
def test_nonfinite_entry_state(entry, n_blocks):
    """A non-finite K-meter entry state stepped over ranges of 1, 2, 3 and
    5 blocks has the plain version's NaN and Inf; a non-finite lowpass
    entry state leaves zl and every pair non-finite."""
    comp, v = entry
    split = 2
    _, args, ops = inputs(5, 2, 128 * n_blocks * split, 40 + n_blocks)
    args[1][0, 2, comp] = v
    args[2][1, 3, 0] = v
    got, ref = emulate(args, ops, split), plain(args)
    assert_card_bars(got, ref)
    assert not np.isfinite(got[3][1]).any() and np.isfinite(got[3][0]).all()


def test_body_matches_jax_xla_path():
    """Composed into the pair integrators, the emulated body agrees with
    the JAX package's unfused XLA core (re-routed pairs, carried states)."""
    C, B, T = 5, 3, 48000
    jm, tm = jax_create(f"surround{C}", FS), mt.create(f"surround{C}", FS)
    _, args, ops = inputs(C, B, T, 5, PAIRS)
    x, kz, zl = (a.numpy() for a in args[:3])
    zp = (0.01 * np.random.default_rng(6).random((B, 4, 3))).astype(F32)
    sj = jm._sel(jnp.asarray(PAIRS, jnp.float32), jnp.float32)
    kj, zlj, zpj, pkj = jm._xla_core(jnp.asarray(x), jnp.asarray(kz), jnp.asarray(zl),
                                     jnp.asarray(zp), *sj)
    kmz, zlo, pk, pacc = emulate(args, ops, choose_split(B, T // 128, C))
    _, decay = tm.cor._ema_weights(T, "cpu")
    zpt = (zp * F32(decay) + pacc).astype(F32)
    np.testing.assert_array_equal(pk, np.asarray(pkj))
    for n, a, b in (("km_z", kmz, kj), ("zl", zlo, zlj), ("zp", zpt, zpj)):
        a, b = np.asarray(a, F64), np.asarray(b, F64)
        assert np.all(np.abs(a - b) <= XLA_RTOL * np.abs(b) + XLA_SCALE * np.abs(b).max()), n


# -- the wide layout: csrc/surround_wide.cu's decomposition ---------------------

LANES, SEG, STAGES, MAX_PER = 32, 32, 2, 64  # the kernel's kLanes, kSeg, kStages, kMaxPer


def swz(lane, h, seg=SEG):
    """The kernel's swz(): the float offset of a lane's 4 samples h in its
    row of a box of kLanes rows x seg samples, as the tensor copy's swizzle
    (16-byte pieces XORed with the row's 128-byte line, modulo the row's
    pieces) places them."""
    rb = 4 * seg
    return lane * seg + 4 * (h ^ ((lane * rb >> 7) & (rb // 16 - 1)))


def wide_nd(C, c):
    """The products row c sums: S_{c, c+d mod C} for d < wide_nd(C, c)."""
    return C // 2 + 1 if C % 2 or c < C // 2 else C // 2


def wide_split(B, nblk, C, sms=132, stages=STAGES):
    """The wide launcher's choose_split; cap is the ring's floats."""
    want = min(8, -(-sms // B), nblk)
    if want <= 1:
        return 1
    split = max(want, -(-nblk // MAX_PER))
    if split > 8:
        return 1
    per = -(-nblk // split)
    cap = stages * (C + 1) * LANES * SEG
    return -(-nblk // per) if (nblk - per) * 3 * C <= cap else 1


def butterfly(v):
    """warp_sum over the last axis (32 lanes): the xor butterfly, float32."""
    idx = np.arange(LANES)
    for o in (16, 8, 4, 2, 1):
        v = (v + v[..., idx ^ o]).astype(F32)
    return v[..., 0]


@np.errstate(invalid="ignore", over="ignore")
def wide_block_sums(xb, wvb, lanes, g, sy, w1, om1, eps):
    """Every (stream, row, block) at once, stage by stage as the kernel runs
    them: xb [B, C, nblk, 128], wvb [nblk, 128], lanes [nblk] each block's
    lane in its chunk.  A stage's slot holds each block's SEG samples at
    the swizzled offsets swz(lane, h) (wv in row C); the lane writes its
    zero-state lowpass outputs over its x there, and each row then reads
    the other rows' outputs at the same offsets.  Returns pk, z, g0, g1, R,
    Q [B, C, nblk] and S [B, C, nblk, C // 2 + 1] (row c's products, d = 0
    .. wide_nd - 1)."""
    B, C, nblk, _ = xb.shape
    shape = (B, C, nblk)
    pk, z, g0, g1, R, Q = (np.zeros(shape, F32) for _ in range(6))
    S = np.zeros(shape + (C // 2 + 1,), F32)
    # where sample 4 h + u of each block's segment sits in its row of the box
    pos = np.array([[swz(j, h) - j * SEG + u for h in range(SEG // 4) for u in range(4)]
                    for j in lanes])
    for s0 in range(0, 128, SEG):
        slot = np.full((B, C + 1, nblk, SEG), np.nan, F32)
        np.put_along_axis(slot[:, :C], np.broadcast_to(pos, (B, C, nblk, SEG)),
                          xb[..., s0:s0 + SEG], -1)
        np.put_along_axis(slot[:, C], np.broadcast_to(pos, (B, nblk, SEG)),
                          np.broadcast_to(wvb[:, s0:s0 + SEG], (B, nblk, SEG)), -1)
        yv = np.zeros(shape + (SEG,), F32)
        for u in range(SEG):  # own channel: outputs over x
            v = np.take_along_axis(slot[:, :C], pos[None, None, :, u:u + 1], -1)[..., 0]
            q = (v * v).astype(F32)
            pk = np.fmax(pk, q)
            g0 = fma(q, g[s0 + u, 0], g0)
            g1 = fma(q, g[s0 + u, 1], g1)
            z = fma(om1, z, (w1 * (v + eps)).astype(F32))
            yv[..., u] = z
        np.put_along_axis(slot[:, :C], np.broadcast_to(pos, (B, C, nblk, SEG)), yv, -1)
        for u in range(SEG):  # each row's share of the products
            at = pos[None, :, u:u + 1]
            wt = np.take_along_axis(slot[:, C], at, -1)[..., 0][:, None]
            r = sy[s0 + u]
            wr = (wt * r).astype(F32)
            y = yv[..., u]
            wy = (wt * y).astype(F32)
            for c in range(C):
                for d in range(wide_nd(C, c)):
                    other = np.take_along_axis(slot[:, (c + d) % C], at, -1)[..., 0]
                    S[:, c, :, d] = fma(wy[:, c], other, S[:, c, :, d])
            R = fma(wr, y, R)
            Q = fma(wr, F32(r), Q)
    return pk, z, g0, g1, R, Q, S


@np.errstate(invalid="ignore", over="ignore")
def wide_cta(blk, ops, rank, entry):
    """One CTA over its range, from wide_block_sums' arrays cut to the range
    ([B, C, n, ...]): the chunk walks of each row (every lane alike), the
    corrections, the per-lane sums over the chunks and the warp butterflies.
    ``entry`` (zl0 [B, C], s0, s1) is walked on in the first CTA.  Returns
    (pk [B, C], s [B, NS]) as its Summary holds them, and (wx, s0, s1)."""
    g, at, a128, sy = ops
    pk_b, z_b, g0_b, g1_b, R_b, Q_b, S_b = blk
    B, C, n = z_b.shape
    nm, md = C * (C + 1) // 2, C // 2 + 1
    wz = np.zeros((B, C), F32)
    wa = F32(1.0)
    wx, s0, s1 = (a.copy() for a in entry)
    tot = np.zeros((B, C, LANES, md), F32)
    U = np.zeros((B, C, LANES), F32)
    V = np.zeros((B, C, LANES), F32)
    for c0 in range(0, n, LANES):
        nb = min(LANES, n - c0)
        zin = np.zeros((B, C, LANES), F32)
        ai = np.zeros(LANES, F32)
        for i in range(nb):
            e = z_b[:, :, c0 + i]
            zin[..., i], ai[i] = wz, wa
            wz = fma(a128, wz, e)
            wa = F32(wa * a128)
            if rank == 0:
                wx = fma(a128, wx, e)
                s0, s1 = km_step(s0, s1, at)
                s0 = (s0 + g0_b[:, :, c0 + i]).astype(F32)
                s1 = (s1 + g1_b[:, :, c0 + i]).astype(F32)
        R = R_b[:, :, c0:c0 + nb]
        Q = Q_b[:, :, c0:c0 + nb]
        zl_ = zin[..., :nb]
        for c in range(C):
            for d in range(wide_nd(C, c)):
                e = (c + d) % C
                ze, Re = zl_[:, e], R[:, e]
                corr = fma((zl_[:, c] * ze).astype(F32), Q[:, c],
                           fma(ze, R[:, c], fma(zl_[:, c], Re, S_b[:, c, c0:c0 + nb, d])))
                tot[:, c, :nb, d] = (tot[:, c, :nb, d] + corr).astype(F32)
        U[..., :nb] = fma(ai[:nb], fma(zl_, Q, R), U[..., :nb])
        V[..., :nb] = fma((ai[:nb] * ai[:nb]).astype(F32), Q, V[..., :nb])
    s = np.zeros((B, nm + C + 1), F32)
    for c in range(C):
        for d in range(wide_nd(C, c)):
            e = (c + d) % C
            s[:, tri(C, min(c, e), max(c, e))] = butterfly(tot[:, c, :, d])
        s[:, nm + c] = butterfly(U[:, c])
    s[:, -1] = butterfly(V[:, 0])
    return (pk_b.max(axis=2), s), (wx, s0, s1)


@np.errstate(invalid="ignore", over="ignore")
def wide_body(x, kmz, zl0, sa, sb, ops, w1, wv, split):
    """csrc/surround_wide.cu's result for x [B, C, T] with `split` CTAs a
    stream (ranges of ceil(nblk / split) blocks, chunks of 32)."""
    g, at, a128, sy = ops
    B, C, T = x.shape
    nblk = T // 128
    per = -(-nblk // split)
    om1, eps = F32(1.0 - w1), F32(surround_fused.lowpass_eps(w1))
    lanes = (np.arange(nblk) % per) % LANES
    blk = wide_block_sums(x.reshape(B, C, nblk, 128), wv.reshape(nblk, 128), lanes, g, sy,
                          F32(w1), om1, eps)
    entry = (zl0[..., 0].copy(), kmz[..., 0].copy(), kmz[..., 1].copy())
    sums, zent = [], [entry[0]]
    for q in range(split):
        sl = slice(q * per, min(nblk, (q + 1) * per))
        sq, walked = wide_cta([a[:, :, sl] for a in blk], ops, q, entry)
        sums.append(sq)
        if q == 0:
            wx, s0, s1 = walked
    # the first CTA walks on through the gathered blocks
    _, e_b, g0_b, g1_b = blk[:4]
    for k in range(per, nblk):
        if k % per == 0:
            zent.append(wx)
        wx = fma(a128, wx, e_b[:, :, k])
        s0, s1 = km_step(s0, s1, at)
        s0, s1 = (s0 + g0_b[:, :, k]).astype(F32), (s1 + g1_b[:, :, k]).astype(F32)
    pk, pacc = combine(sums, zent, sa, sb)
    return np.stack([s0, s1], -1), wx[..., None], pk, pacc


def wide_emulate(args, ops, split):
    x, kz, zl, sa, sb, _, _, w1, wv = args
    return wide_body(x.numpy(), kz.numpy(), zl.numpy(), sa.numpy(), sb.numpy(), ops, w1,
                     wv.numpy(), split)


@pytest.mark.parametrize("seg", [8, 16, 32])
def test_wide_swizzle(seg):
    """swz() is the tensor copy's swizzle of a box of 32 rows x seg
    samples (byte offset bits 4.. XORed with the offset's 128-byte line,
    modulo the row's 16-byte pieces), a permutation of each row's pieces,
    and conflict-free: the 8 lanes of each quarter-warp reading piece h
    touch 8 different 16-byte bank groups."""
    rb, pieces = 4 * seg, seg // 4
    for j in range(LANES):
        got = [swz(j, h, seg) for h in range(pieces)]
        want = [(j * rb + 16 * h) ^ ((((j * rb + 16 * h) >> 7) & (pieces - 1)) << 4)
                for h in range(pieces)]
        assert [4 * g for g in got] == want
        assert sorted(g - j * seg for g in got) == list(range(0, seg, 4))
    for h in range(pieces):
        for q in range(0, LANES, 8):
            assert len({(swz(j, h, seg) // 4) % 8 for j in range(q, q + 8)}) == 8


@pytest.mark.parametrize("C", [3, 4, 5, 6, 7, 8])
def test_wide_rows_sum_every_product_once(C):
    """The rows' shares S_{c, c+d mod C} cover the C(C+1)/2 channel products
    once each, and no row sums more than one product above another."""
    got = [tuple(sorted((c, (c + d) % C))) for c in range(C) for d in range(wide_nd(C, c))]
    assert sorted(got) == [(i, j) for i in range(C) for j in range(i, C)]
    assert max(wide_nd(C, c) for c in range(C)) - min(wide_nd(C, c) for c in range(C)) <= 1


@pytest.mark.parametrize("C", [3, 4, 5, 6, 7, 8])
def test_wide_body_matches_plain_at_every_width(C):
    """T = 48000 (375 blocks) split as the wide launcher splits 3 streams (8
    CTAs of 47 blocks, two chunks each, the last 46), the meter's routing;
    km_z, zl and pk bit-identical to the narrow kernel's emulation."""
    _, args, ops = inputs(C, 3, 48000, C)
    split = wide_split(3, 375, C)
    assert split == 8
    got = wide_emulate(args, ops, split)
    assert_card_bars(got, plain(args))
    narrow = emulate(args, ops, choose_split(3, 375, C))
    for a, b in zip(got[:3], narrow[:3]):
        np.testing.assert_array_equal(a.view(np.int32), b.view(np.int32))


@pytest.mark.parametrize("split", [1, 2, 6, 8])
def test_wide_body_splits_and_chunks(split):
    """375 blocks over 1 CTA (11 chunks of 32, the last of 23), 2 (188 and
    187 blocks), 6 (63 each, the last 60) and 8 CTAs a stream, runtime
    pairs: the ranges, chunks and lanes compose to the same result."""
    _, args, ops = inputs(5, 2, 48000, 11, PAIRS)
    assert_card_bars(wide_emulate(args, ops, split), plain(args))


@pytest.mark.parametrize("B,T,C,split", [
    (256, 48000, 8, 1), (132, 48000, 5, 1), (100, 48000, 8, 6), (17, 48000, 5, 8),
    (8, 48000, 8, 8), (1, 48000, 3, 8), (1, 128, 5, 1), (8, 1280, 8, 5), (1, 1280, 8, 5),
    (1, 65536, 8, 8), (1, 65664, 8, 1), (1, 131200, 3, 1), (40, 48000, 5, 6)])
def test_wide_split_choice(B, T, C, split):
    """One CTA a stream once the streams fill the SMs; else an SM each in
    all, at most 8 (a portable cluster), ranges of at most 64 blocks (two
    chunks), as even as the blocks allow; longer blocks take one CTA."""
    assert wide_split(B, T // 128, C) == split


@pytest.mark.parametrize("T,split", [(128, 1), (256, 2), (1280, 5), (4224, 1), (4224, 2),
                                     (8320, 3), (8320, 1)])
def test_wide_body_short_and_partial_chunks(T, split):
    """One block, ranges of one block, 33 blocks (a chunk and a lane), 65
    blocks over 3 CTAs (22, 22, 21), and 65 in one CTA (two chunks and one
    block): partial chunks and ranges."""
    _, args, ops = inputs(8, 3, T, T + split, PAIRS)
    assert_card_bars(wide_emulate(args, ops, split), plain(args))


@pytest.mark.parametrize("C", [3, 5, 8])
def test_wide_nonfinite_channel_reaches_every_pair(C):
    """NaN, +Inf and -Inf samples inside a stage, in a stream's last block
    and on a CTA's first block: every pair of a poisoned stream is
    non-finite (C3), the clean stream's are finite, km_z has the plain
    version's NaN and Inf."""
    bad = [(0, C - 1, 300, np.nan), (1, 1, 47900, np.inf), (2, 0, 47 * 128 * 5, -np.inf)]
    _, args, ops = inputs(C, 4, 48000, 20 + C, nonfinite=bad)
    got = wide_emulate(args, ops, 8)
    assert_card_bars(got, plain(args))
    assert not np.isfinite(got[3][:3]).any() and np.isfinite(got[3][3]).all()
    assert np.isinf(got[0][1]).any()


@pytest.mark.parametrize("entry", [(0, np.inf), (1, np.nan), (1, -np.inf)])
def test_wide_nonfinite_entry_state(entry):
    """A non-finite K-meter or lowpass entry state over a stream split in
    two: the plain version's NaN and Inf in km_z, zl and every pair."""
    comp, v = entry
    _, args, ops = inputs(5, 2, 128 * 70, 41)
    args[1][0, 2, comp] = v
    args[2][1, 3, 0] = v
    got = wide_emulate(args, ops, 2)
    assert_card_bars(got, plain(args))
    assert not np.isfinite(got[3][1]).any() and np.isfinite(got[3][0]).all()


@pytest.mark.parametrize("C", [5, 8])
def test_wide_body_matches_jax_wide_interpret(C):
    """The emulated wide body against the JAX package's wide kernel,
    _fused_core_wide, in interpret mode (re-routed pairs, carried states),
    composed into the pair integrators, at tests/test_torch_variants.py's
    interpret bars: pk exact, km_z 2e-5 relative, zl and zp 2e-4 relative
    (atol 1e-8)."""
    B, T = 3, 1280
    jm, tm = jax_create(f"surround{C}", FS), mt.create(f"surround{C}", FS)
    _, args, ops = inputs(C, B, T, 30 + C, PAIRS)
    x, kz, zl = (a.numpy() for a in args[:3])
    zp = (0.01 * np.random.default_rng(7).random((B, 4, 3))).astype(F32)
    sj = jm._sel(jnp.asarray(PAIRS, jnp.float32), jnp.float32)
    kj, zlj, pkj, paccj = pallas_surround._fused_core_wide(
        jnp.asarray(x), jnp.asarray(kz), jnp.asarray(zl), *sj, jm.km.sys.op(32),
        jm.cor.lp.op(128), jm.cor.w1, jm.cor.w2, interpret=True)
    kmz, zlo, pk, pacc = wide_emulate(args, ops, wide_split(B, T // 128, C))
    _, decay = tm.cor._ema_weights(T, "cpu")
    zpt = (zp * F32(decay) + pacc).astype(F32)
    zpj = zp * F32((1.0 - jm.cor.w2) ** T) + np.asarray(paccj)
    np.testing.assert_array_equal(pk, np.asarray(pkj))
    np.testing.assert_allclose(kmz, np.asarray(kj), rtol=2e-5)
    for what, a, b in (("zl", zlo, np.asarray(zlj)), ("zp", zpt, zpj)):
        np.testing.assert_allclose(a, b, rtol=2e-4, atol=1e-8, err_msg=what)
