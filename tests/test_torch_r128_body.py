"""r128_fused's kernel body, emulated in numpy on the CPU, against the plain
version (ops/r128_fused.py::fused_core_reference).

The CUDA body (csrc/r128_fused.cu) cannot run here, so this file repeats
its arithmetic in numpy, with the kernel's own index arithmetic, and holds
the emulation to the plain version at the bars chip_smoke.py and
tests/test_torch_cuda.py hold the kernel to on the card: p within 1e-5
relative plus 2e-6 of the call's max p, z within 4e-6 of each component's
scale, hist bit-exact, tpmax within 1e-6 relative, the same NaN and Inf
positions; seg sums within 2e-6 relative.  Every fp32 FMA is rounded once
(product and sum in float64, then to float32).  What it emulates:

  * y0 = x_blk @ K as the triangle of the Toeplitz matrix only: for output
    i = 32 q + 4 r + k (lane r of its block), taps m < 32 q through the
    lane's float4 window over the block (the chunk at e - 4 (a + 1), its
    element 4 + k - bb, m = 4 a + bb), then the last 32 taps from a copy of
    the block's first 32 samples behind 32 zeros; NaN below the block's
    last non-finite sample (the dense product's rule);
  * the true-peak FIR through the lane's window (element 1 + k + bb of the
    chunk at 4 a, tap 4 a + bb), with upsample4::frame_ok's rule;
  * x @ G as eight lane partials of 16 samples (q, then k) summed in the
    state warp's tree, s @ At and s @ Sy as FMA chains, the power as
    fma(y * y, gain, p) in channel order;
  * seg mode: each block's sums before and after its fragment boundary in
    (q, k) order, the eight lanes' xor tree, and the open slot carried in
    block order, each slot stored when it closes.

The emulated FIR is bit-identical to upsample4::fir's order (so is the
kernel's, which makes tpmax bit-identical to the parent kernel's), and
without the triangle's NaN rule the non-finite positions of p differ from
the plain version's (test_triangle_nan_rule_is_needed).  The plain version
is also held against the Pallas kernel in interpret mode on the emulation's
signal, at tests/test_torch_r128_fused.py's and test_torch_variants.py's
bars (that kernel's bf16 passes).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from meters_lv2_torch.ops import design, lti, r128_fused, resample
from meters_lv2_tpu.ops import lti as j_lti
from meters_lv2_tpu.ops import pallas_r128
from test_torch_cuda import inject_nonfinite

torch.set_num_threads(1)

FS = 48000
BLK = 128
NH = 47
F32, F64 = np.float32, np.float64
R = np.arange(8)  # a block's lanes
QRK = (4, 8, 4)  # output i = 32 q + 4 r + k


@pytest.fixture(scope="module")
def op():
    return lti.LTISystem(*design.k_weighting_state_space(FS)).op(BLK)


def _gains(C):
    return (2.0,) if C == 1 else r128_fused.gains_f32(design.R128_CHAN_GAIN[:C])


def fma(a, b, c):
    with np.errstate(invalid="ignore", over="ignore"):
        return (np.asarray(a, F64) * np.asarray(b, F64) + np.asarray(c, F64)).astype(F32)


def frames(x, hist):
    """[B, C, nblk, 176] block frames: position 0 a pad, 1..47 the halo,
    48..175 the block (the kernel's ring at 128 j)."""
    full = np.concatenate([hist, x], axis=-1)
    nblk = x.shape[-1] // BLK
    p = np.arange(1, 176)
    fr = np.zeros(x.shape[:2] + (nblk, 176), F32)
    fr[..., 1:] = full[..., BLK * np.arange(nblk)[:, None] + p[None, :] - 1]
    return fr


def frame_span(fr):
    """(lo, hi): each frame's first and last non-finite position (INT_MAX
    and -1 where none)."""
    bad = ~np.isfinite(fr)
    bad[..., 0] = False
    pos = np.arange(176)
    lo = np.where(bad, pos, np.iinfo(np.int32).max).min(-1)
    hi = np.where(bad, pos, -1).max(-1)
    return lo, hi


def toeplitz(h, xb, nan_rule, hi):
    """y0 [..., 128] of the blocks xb [..., 128] as the kernel sums them."""
    y = np.zeros(xb.shape[:-1] + QRK, F32)
    for q in range(1, 4):
        e0 = 32 * q + 4 * R
        for a in range(8 * q):
            for bb in range(4):
                for k in range(4):
                    v = xb[..., e0 - 4 * (a + 1) + 4 + k - bb]
                    y[..., q, :, k] = fma(h[4 * a + bb], v, y[..., q, :, k])
    zb = np.concatenate([np.zeros(xb.shape[:-1] + (32,), F32), xb[..., :32]], axis=-1)
    e = 32 + 4 * R
    for a in range(8):
        for bb in range(4):
            for q in range(4):
                for k in range(4):
                    v = zb[..., e - 4 * (a + 1) + 4 + k - bb]
                    y[..., q, :, k] = fma(h[32 * q + 4 * a + bb], v, y[..., q, :, k])
    y = y.reshape(xb.shape)
    if nan_rule:  # the dense product's zeros: outputs below the last non-finite x
        last = np.where(hi >= 48, hi - 48, -1)
        y = np.where(np.arange(BLK) < last[..., None], F32(np.nan), y)
    return y


def fir_window(taps, fr):
    """up [..., 128, 4] through the lanes' windows: sample i = 32 q + 4 r + k
    reads the chunk at 4 a, element 1 + k + bb, for tap 4 a + bb."""
    base = (32 * np.arange(4)[:, None] + 4 * R[None, :])  # [q, r]
    u = np.zeros(fr.shape[:-1] + QRK + (4,), F32)
    for a in range(12):
        for bb in range(4):
            for k in range(4):
                v = fr[..., base + 4 * a + 1 + k + bb]
                for ph in range(4):
                    u[..., k, ph] = fma(taps[ph, 4 * a + bb], v, u[..., k, ph])
    return u.reshape(fr.shape[:-1] + (BLK, 4))


def fir_direct(taps, fr):
    """upsample4::fir: sample t, phase ph, taps ascending from 0."""
    t = np.arange(BLK)
    u = np.zeros(fr.shape[:-1] + (BLK, 4), F32)
    for i in range(48):
        v = fr[..., 1 + t + i]
        for ph in range(4):
            u[..., ph] = fma(taps[ph, i], v, u[..., ph])
    return u


def emulate(x, z0, hist, gains, op, off=None, fragm=None, n_slots=None, nan_rule=True):
    """The kernel body on x [B, C, T]: (p or seg, z, hist', tpmax) as numpy."""
    B, C, T = x.shape
    nblk = T // BLK
    h = r128_fused.toeplitz_row(op)
    taps = resample.upsample4_taps()
    G, Sy, At = (np.asarray(getattr(op, k), F32) for k in ("g", "sy", "at"))
    fr = frames(x, hist)
    xb = fr[..., 48:]
    lo, hi = frame_span(fr)
    y0 = toeplitz(h, xb, nan_rule, hi)
    up = fir_window(taps, fr)
    first = 1 + np.arange(BLK)
    ok = (hi[..., None] < 0) | ((lo[..., None] >= first) & (hi[..., None] <= first + NH))
    a = np.abs(up)
    tp = np.where(ok[..., None] & ~np.isnan(a), a, F32(0)).max(axis=(1, 2, 3, 4))

    # x @ G: lane r's partial over its samples 32 q + 4 r + k, q then k
    gp = np.zeros((B, C, nblk, 8, 4), F32)
    for q in range(4):
        for k in range(4):
            j = 32 * q + 4 * R + k
            gp = fma(xb[..., j][..., None], G[j], gp)
    with np.errstate(invalid="ignore", over="ignore"):
        gin = ((gp[..., 0, :] + gp[..., 1, :]) + (gp[..., 2, :] + gp[..., 3, :])) + (
            (gp[..., 4, :] + gp[..., 5, :]) + (gp[..., 6, :] + gp[..., 7, :]))
    s = np.array(z0, F32)
    s_in = np.empty((B, C, nblk, 4), F32)
    for j in range(nblk):
        s_in[:, :, j] = s
        sn = np.empty_like(s)
        with np.errstate(invalid="ignore", over="ignore"):
            for k in range(4):
                v = s[..., 0] * At[0, k]
                for m in range(1, 4):
                    v = fma(s[..., m], At[m, k], v)
                sn[..., k] = v + gin[:, :, j, k]
        s = sn
    st = (s_in[..., 0:1] * Sy[0]).astype(F32)
    for m in range(1, 4):
        st = fma(s_in[..., m:m + 1], Sy[m], st)
    with np.errstate(invalid="ignore", over="ignore"):
        yv = y0 + st
        p = np.zeros((B, nblk, BLK), F32)
        for c in range(C):
            p = fma(yv[:, c] * yv[:, c], F32(gains[c]), p)
    hist_out = np.ascontiguousarray(x[..., T - NH:])
    if off is None:
        return p.reshape(B, T), s, hist_out, tp
    return seg_sums(p, np.asarray(off), fragm, n_slots), s, hist_out, tp


def seg_sums(p, off, fragm, n_slots):
    """Seg mode from p [B, nblk, 128] as the kernel sums it."""
    B, nblk, _ = p.shape
    pl = p.reshape(B, nblk, *QRK).transpose(0, 1, 3, 2, 4).reshape(B, nblk, 8, 16)
    i = (32 * np.arange(4)[:, None] + np.arange(4)[None, :]).reshape(16)  # q, k order
    seg = np.zeros((B, n_slots), F32)
    for b in range(B):
        pos = int(off[b]) + BLK * np.arange(nblk)
        slot = pos // fragm
        rem = fragm - (pos - slot * fragm)
        head = np.zeros((nblk, 8), F32)
        tail = np.zeros((nblk, 8), F32)
        with np.errstate(invalid="ignore"):
            for n in range(16):
                j = i[n] + 4 * R  # lane r's n-th sample
                v = pl[b, :, :, n]
                before = j[None, :] < rem[:, None]
                head = np.where(before, head + v, head)
                tail = np.where(before, tail, tail + v)
            for o in (1, 2, 4):
                head = head + head[:, R ^ o]
                tail = tail + tail[:, R ^ o]
        cur, acc = -1, F32(0)
        for j in range(nblk):
            lo_s = int(slot[j])
            if lo_s != cur:
                if 0 <= cur < n_slots:
                    seg[b, cur] = acc
                cur, acc = lo_s, F32(0)
            acc = F32(acc + head[j, 0])
            if rem[j] < BLK:
                if lo_s < n_slots:
                    seg[b, lo_s] = acc
                cur, acc = lo_s + 1, tail[j, 0]
        if 0 <= cur < n_slots:
            seg[b, cur] = acc
    return seg


def _inputs(B, C, T, seed, nonfinite=False):
    rng = np.random.default_rng(seed)
    x = (0.3 * rng.standard_normal((B, C, T))).astype(F32)
    z0 = (0.01 * rng.standard_normal((B, C, 4))).astype(F32)
    h0 = (0.1 * rng.standard_normal((B, C, NH))).astype(F32)
    if nonfinite:
        inject_nonfinite(x, h0)
    return x, z0, h0


def _plain(x, z0, h0, gains, op, flat=False, **kw):
    B, C, T = x.shape
    if "off" in kw:
        kw = dict(kw, off=torch.from_numpy(np.asarray(kw["off"], np.int32)))
    xt = torch.from_numpy(x.reshape(B, C * T) if flat else x)
    return [v.numpy() for v in r128_fused.fused_core_reference(
        xt, torch.from_numpy(z0), torch.from_numpy(h0), gains, op, **kw)]


def _same_nonfinite(a, b):
    np.testing.assert_array_equal(np.isnan(a), np.isnan(b))
    inf = np.isinf(b)
    np.testing.assert_array_equal(np.isinf(a), inf)
    np.testing.assert_array_equal(a[inf], b[inf])


def assert_core_close(got, ref):
    """The card's bars (tests/test_torch_cuda.py _assert_core_close)."""
    p, z, h, t = (np.asarray(v, F64) for v in got)
    pr, zr, hr, tr = (np.asarray(v, F64) for v in ref)
    for a, b in ((p, pr), (z, zr), (t, tr)):
        _same_nonfinite(a, b)
    fin, zf, tf = np.isfinite(pr), np.isfinite(zr), np.isfinite(tr)
    pmax = np.abs(pr[fin]).max()
    zscale = np.abs(np.where(zf, zr, 0)).max(axis=(0, 1))
    with np.errstate(invalid="ignore"):  # Inf - Inf off the finite masks
        assert np.all(np.abs(p - pr)[fin] <= 1e-5 * np.abs(pr[fin]) + 2e-6 * pmax)
        assert np.all(np.where(zf, np.abs(z - zr), 0) <= 4e-6 * zscale)
        assert np.all(np.abs(t - tr)[tf] <= 1e-6 * np.abs(tr[tf]))
    np.testing.assert_array_equal(h, hr)


def assert_seg_close(seg, ref):
    seg, ref = np.asarray(seg, F64), np.asarray(ref, F64)
    np.testing.assert_array_equal(np.isnan(seg), np.isnan(ref))
    f = np.isfinite(ref)
    assert np.all(np.abs(seg - ref)[f] <= 2e-6 * np.abs(ref[f]) + 1e-9)


def test_lane_map_and_taps_cover_the_triangle():
    """The (q, r, k) -> i map is a permutation of the block, and each
    output's taps through parts A and B are m = 0 .. i once each, reading
    x[i - m] (the zero pad where i - m < 0)."""
    i = (32 * np.arange(4)[:, None, None] + 4 * R[None, :, None] + np.arange(4)).reshape(-1)
    assert sorted(i.tolist()) == list(range(BLK))
    for q in range(4):
        for r in range(8):
            for k in range(4):
                out = 32 * q + 4 * r + k
                taps = {}
                for a in range(8 * q):
                    for bb in range(4):
                        taps[4 * a + bb] = 32 * q + 4 * r - 4 * (a + 1) + 4 + k - bb
                for a in range(8):
                    for bb in range(4):
                        taps[32 * q + 4 * a + bb] = 4 * r - 4 * (a + 1) + 4 + k - bb
                assert sorted(taps) == list(range(32 * q + 32))
                assert all(j == out - m for m, j in taps.items())
                assert all(0 <= taps[m] < BLK for m in range(32 * q))


@pytest.mark.parametrize("flat", [False, True])
@pytest.mark.parametrize("C", [1, 2, 3, 4, 5])
def test_body_matches_plain(op, C, flat):
    """10 blocks: two full units of four and a last unit of two."""
    x, z0, h0 = _inputs(3, C, 1280, 20 + C)
    gains = _gains(C)
    assert_core_close(emulate(x, z0, h0, gains, op), _plain(x, z0, h0, gains, op, flat=flat))


@pytest.mark.parametrize("C,T,fs", [(1, 2560, 48000), (2, 2560, 48000), (3, 2304, 44100),
                                    (5, 4480, 48000), (2, 128, 48000)])
def test_body_seg_mode_matches_plain(op, C, T, fs):
    fragm = fs // 20
    n_slots = T // fragm + 2
    x, z0, h0 = _inputs(4, C, T, 30 + C)
    off = np.random.default_rng(C).integers(0, fragm, 4).astype(np.int32)
    gains = _gains(C)
    got = emulate(x, z0, h0, gains, op, off=off, fragm=fragm, n_slots=n_slots)
    ref = _plain(x, z0, h0, gains, op, off=off, fragm=fragm, n_slots=n_slots)
    assert got[0].shape == (4, n_slots)
    assert_seg_close(got[0], ref[0])
    full = emulate(x, z0, h0, gains, op)
    for a, b in zip(got[1:], full[1:]):
        np.testing.assert_array_equal(a, b)
    assert_core_close(full, _plain(x, z0, h0, gains, op))


def test_body_carried_matches_plain(op):
    """Six 0.1 s calls (38 blocks: nine units and a last of two), each side
    carrying its own state and history; seg mode on the same inputs with
    the offset advancing by the call's length."""
    C, T, fragm = 2, 4864, 2400
    n_slots = T // fragm + 2
    gains = _gains(C)
    rng = np.random.default_rng(7)
    xs = (0.3 * rng.standard_normal((6, 3, C, T))).astype(F32)
    z = {"emu": np.zeros((3, C, 4), F32), "plain": np.zeros((3, C, 4), F32)}
    h = {"emu": np.zeros((3, C, NH), F32), "plain": np.zeros((3, C, NH), F32)}
    off0 = rng.integers(0, fragm, 3)
    for i, x in enumerate(xs):
        off = ((off0 + i * T) % fragm).astype(np.int32)
        got = emulate(x, z["emu"], h["emu"], gains, op)
        ref = _plain(x, z["plain"], h["plain"], gains, op)
        assert_core_close(got, ref)
        seg = emulate(x, z["emu"], h["emu"], gains, op, off=off, fragm=fragm, n_slots=n_slots)
        seg_r = _plain(x, z["plain"], h["plain"], gains, op, off=off, fragm=fragm,
                       n_slots=n_slots)
        assert_seg_close(seg[0], seg_r[0])
        z["emu"], h["emu"] = got[1], got[2]
        z["plain"], h["plain"] = ref[1], ref[2]


@pytest.mark.parametrize("C,seg", [(1, False), (2, False), (5, False), (2, True), (3, True)])
def test_body_nonfinite_matches_plain(op, C, seg):
    """NaN and +-Inf at block and unit edges, in the history, and in a block
    beside clean ones (tests/test_torch_cuda.py inject_nonfinite)."""
    x, z0, h0 = _inputs(6, C, 2560, 40 + C, nonfinite=True)
    gains = _gains(C)
    got = emulate(x, z0, h0, gains, op)
    assert_core_close(got, _plain(x, z0, h0, gains, op))
    if seg:
        off = np.random.default_rng(C).integers(0, 2400, 6).astype(np.int32)
        kw = dict(off=off, fragm=2400, n_slots=3)
        assert_seg_close(emulate(x, z0, h0, gains, op, **kw)[0],
                         _plain(x, z0, h0, gains, op, **kw)[0])


def test_triangle_nan_rule_is_needed(op):
    """Without the rule, outputs before a block's non-finite sample stay
    finite where the dense product makes them NaN."""
    x, z0, h0 = _inputs(6, 2, 2560, 42, nonfinite=True)
    gains = _gains(2)
    p = emulate(x, z0, h0, gains, op, nan_rule=False)[0]
    pr = _plain(x, z0, h0, gains, op)[0]
    assert not np.array_equal(np.isnan(p), np.isnan(pr))


@pytest.mark.parametrize("nonfinite", [False, True])
def test_fir_window_is_fir_order(nonfinite):
    """The lanes' window FIR gives upsample4::fir's oversamples bit for bit
    (NaN positions included): tpmax stays the parent kernel's."""
    x, _, h0 = _inputs(6, 2, 2560, 50, nonfinite=nonfinite)
    fr = frames(x, h0)
    taps = resample.upsample4_taps()
    a, b = fir_window(taps, fr), fir_direct(taps, fr)
    np.testing.assert_array_equal(np.isnan(a), np.isnan(b))
    np.testing.assert_array_equal(np.nan_to_num(a), np.nan_to_num(b))


def test_toeplitz_row_is_checked(op):
    """The kernel takes K's first row: the wrapper checks that K is the
    lower-triangular Toeplitz matrix of it, and refuses another operator
    before it builds anything."""
    np.testing.assert_array_equal(r128_fused.toeplitz_row(op), np.asarray(op.kmat[0], F32))
    bad = lti.LTIBlockOp(kmat=op.kmat.copy(), sy=op.sy, at=op.at, g=op.g, block=BLK, d=4, m=1,
                         p=1)
    bad.kmat[5, 3] = 1.0  # above the diagonal
    with pytest.raises(ValueError, match="Toeplitz"):
        r128_fused.toeplitz_row(bad)
    bad = lti.LTIBlockOp(kmat=op.kmat.copy(), sy=op.sy, at=op.at, g=op.g, block=BLK, d=4, m=1,
                         p=1)
    bad.kmat[7, 9] *= 2  # one diagonal entry off
    x = torch.zeros(2, 2, 256)
    with pytest.raises(ValueError, match="Toeplitz"):
        r128_fused._fused_core_cuda(x, torch.zeros(2, 2, 4), torch.zeros(2, 2, NH), (1.0, 1.0),
                                    bad)


@pytest.mark.parametrize("C,seg", [(2, False), (5, False), (2, True)])
def test_plain_matches_pallas_interpret(op, C, seg):
    """The plain version against the Pallas kernel in interpret mode on the
    emulation's signal (with its non-finite-free inputs), at
    tests/test_torch_r128_fused.py's and test_torch_variants.py's bars."""
    x, z0, h0 = _inputs(3, C, 2560, 60 + C)
    gains = _gains(C)
    kw = {}
    if seg:
        kw = dict(off=np.random.default_rng(1).integers(0, 2400, 3).astype(np.int32), fragm=2400,
                  n_slots=3)
    jkw = dict(kw, off=jnp.asarray(kw["off"])) if seg else {}
    jsys = j_lti.LTISystem(*design.k_weighting_state_space(FS))
    pj, zj, hj, tj = (np.asarray(v) for v in pallas_r128.fused_core(
        jnp.asarray(x), jnp.asarray(z0), jnp.asarray(h0), gains, jsys.op(BLK), interpret=True,
        **jkw))
    p, z, hh, tp = _plain(x, z0, h0, gains, op, **kw)
    if seg:
        np.testing.assert_allclose(p, pj, rtol=2e-4, atol=1e-5 * 2400)
    else:
        np.testing.assert_allclose(p, pj, rtol=2e-4, atol=1e-5)
    np.testing.assert_allclose(z, zj, rtol=1e-4, atol=1e-4)
    np.testing.assert_array_equal(hh, hj)
    np.testing.assert_allclose(tp, tj, rtol=1e-4)
