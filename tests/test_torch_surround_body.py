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
    return s, zl[..., None], pk, pacc


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
