"""spectrum_fused's kernel body, emulated in numpy on the CPU, against the
plain version (ops/spectrum_fused.py::fused_core_reference).

The CUDA body (csrc/spectrum_fused.cu) cannot run here, so this file
repeats its arithmetic in numpy and holds the emulation to the plain
version at the bar chip_smoke.py holds the kernel to on the card: val,
block peak and zf within SPEC_TOL = 1e-5 of each leaf's scale (max |ref|
over its finite values), with the same NaN and Inf positions.  What it
emulates:

  * the products x_k @ K, x_k @ G (four partials over rows 32w..32w+31 of G,
    summed in that order) and s_k @ Sy in 3xTF32: every operand split into
    hi = tf32(a) and lo = tf32(a - hi), the mantissa rounded to 10 bits
    by the kernel's integer operations (half an ulp added, the low 13 bits
    cleared, carries kept as the 32-bit word keeps them), a - hi's NaN the
    card's 0x7fffffff, and a product taken as a_lo b_hi + a_hi b_lo +
    a_hi b_hi, summed in float64 and rounded to float32 (the tensor cores'
    own fp32 accumulation is not modelled: it adds about 2^-23 of the
    largest partial sum);
  * the flag path: a (stream, block) whose x or incoming state holds a
    value the split does not carry (|bits| >= 0x7f7ff000: every NaN and
    infinity), or whose outputs 120..127 of x_k @ K come out non-finite,
    is computed densely in fp32, y[i] = NaN below the block's last
    non-finite x;
  * the state chain s @ At + gx and the smoother v = fma(w, q - v, v)
    sample by sample, with its non-finite flags, as the kernel orders them.

A single-pass TF32 product misses the bar (test_single_pass_tf32_misses_the_bar),
so the split is what meets it.  The plain version is also held against the
Pallas kernel in interpret mode on the emulation's signal, at 2e-4
relative as in tests/test_torch_spectrum.py (that kernel's bf16 hi/lo
passes).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import meters_lv2_torch as mt
from meters_lv2_torch.ops import lti, spectrum_fused
from meters_lv2_tpu.models.spectrum import SpectrumAnalyzer as JSpectrum
from meters_lv2_tpu.ops import pallas_spectrum

torch.set_num_threads(1)

FS = 48000
BLK = 128
SPEC_TOL = 1e-5  # chip_smoke.py SPEC_TOL
PALLAS_RTOL = 2e-4  # tests/test_torch_spectrum.py PALLAS_RTOL

F32, F64 = np.float32, np.float64


@pytest.fixture(scope="module")
def spec():
    return mt.create("spectr30stereo", FS)


SPLIT_MAX = 0x7F7FF000  # |bits| from which the split is no rounding
CARD_NAN = np.array(0x7FFFFFFF, np.uint32).view(F32)  # what the card's arithmetic returns


def tf32(a):
    """a rounded to TF32 (10 mantissa bits, to nearest, ties away from zero)
    as the kernel's tf32_rna does it: half an ulp added to the bits, the low
    13 cleared, in a 32-bit word.  Finite values past SPLIT_MAX round to an
    infinity, and a NaN with its top mantissa bits set carries into the sign
    (0x7fffffff gives -0) or out of the word (0xffffffff gives +0)."""
    u = np.asarray(a, F32).view(np.uint32).astype(np.uint64)
    return ((u + 0x1000) & 0xFFFFE000).astype(np.uint32).view(F32)


def split(a):
    a = np.asarray(a, F32)
    hi = tf32(a)
    with np.errstate(invalid="ignore"):  # Inf - Inf, NaN - x
        d = a - hi
    return hi, tf32(np.where(np.isnan(d), CARD_NAN, d))


def unsplit_rows(a, axis):
    """Rows of a holding a value the split does not carry."""
    mag = np.asarray(a, F32).view(np.uint32) & 0x7FFFFFFF
    return (mag >= SPLIT_MAX).any(axis=axis)


def x3(a, b, eq, single=False):
    """The 3xTF32 product of a and b (einsum ``eq``) in float64; with
    ``single`` the one-pass TF32 product tf32(a) tf32(b)."""
    ah, al = split(a)
    bh, bl = split(b)
    with np.errstate(invalid="ignore"):  # Inf * 0, Inf - Inf: the flag path's rows
        p = np.einsum(eq, ah.astype(F64), bh.astype(F64))
        if single:
            return p
        return (np.einsum(eq, al.astype(F64), bh.astype(F64))
                + np.einsum(eq, ah.astype(F64), bl.astype(F64)) + p)


def emulate(x, z0, v0, om, op, single=False, flag_from_x=True):
    """The kernel body on x [B, T] (T % 128 == 0), z0 [B, NB, 12], v0
    [B, NB], omega om, the banked operator op: (val, peak, zf).  With
    ``flag_from_x`` False an x row is flagged only from its products: a
    NaN that the split turns into zeros then slips through, which is why
    the kernel flags rows from x itself."""
    K, Sy, At, G = (np.asarray(getattr(op, k), F32) for k in ("kmat", "sy", "at", "g"))
    B, T = x.shape
    nb = K.shape[0]
    s = np.array(z0, F32)
    q = np.empty((B, nb, T), F32)
    tri = np.tril(np.ones((BLK, BLK), bool)).T  # [j, i]: j <= i
    for k in range(T // BLK):
        xk = x[:, k * BLK:(k + 1) * BLK]
        parts = [x3(xk[:, 32 * w:32 * w + 32], G[:, 32 * w:32 * w + 32], "bj,njc->bnc",
                    single).astype(F32) for w in range(4)]
        xK = x3(xk, K, "bj,nji->bni", single)
        with np.errstate(invalid="ignore"):
            y = (xK + x3(s, Sy, "bnm,nmi->bni", single)).astype(F32)
        fx = ~np.isfinite(xK[:, :, BLK - 8:]).all(axis=2)
        if flag_from_x:
            fx |= unsplit_rows(xk, 1)[:, None]
        flag = fx | unsplit_rows(s, 2)
        for b, n in zip(*np.nonzero(flag)):  # the flag path, dense fp32
            xr = xk[b].astype(F64)
            with np.errstate(invalid="ignore"):
                low = np.where(tri, xr[:, None] * K[n].astype(F64), 0.0).sum(axis=0)
                u = (s[b, n].astype(F64)[:, None] * Sy[n].astype(F64)).sum(axis=0)
            bad = np.nonzero(~np.isfinite(xk[b]))[0]
            low = low.astype(F32)
            if bad.size:
                low[:bad[-1]] = np.nan
            y[b, n] = low + u.astype(F32)
            if fx[b, n]:
                for w in range(4):
                    with np.errstate(invalid="ignore"):
                        parts[w][b, n] = (xr[32 * w:32 * w + 32, None]
                                          * G[n, 32 * w:32 * w + 32].astype(F64)).sum(axis=0)
        with np.errstate(invalid="ignore"):
            gin = ((parts[0] + parts[1]) + parts[2]) + parts[3]
            u = np.einsum("bnm,nmc->bnc", s.astype(F64), At.astype(F64)).astype(F32)
        s = u + gin
        with np.errstate(over="ignore", invalid="ignore"):
            q[:, :, k * BLK:(k + 1) * BLK] = y * y
    return smooth(q, v0, om) + (s,)


def smooth(q, v0, om):
    """The smoother sample by sample, v = fma(w, q - v, v), with the kernel's
    non-finite flags; (val, peak)."""
    w = F32(om)
    v = np.array(v0, F32)
    pk = np.full(v.shape, -np.inf, F32)
    nan = np.isnan(v) | (not w < 1)
    pos, neg = v == np.inf, v == -np.inf
    late = np.zeros(v.shape, bool)
    with np.errstate(invalid="ignore", over="ignore"):
        for t in range(q.shape[-1]):
            qq = q[..., t]
            v = (F64(w) * (qq - v).astype(F64) + v.astype(F64)).astype(F32)
            pk = np.fmax(pk, v)
            nan |= np.isnan(qq)
            pos |= qq == np.inf
            neg |= qq == -np.inf
            if t % BLK:
                late |= ~np.isfinite(qq)
    both = nan | (pos & neg)
    val = np.where(np.isfinite(v), v, np.where(both, np.nan, np.where(neg, -np.inf, np.inf)))
    peak = np.where(late | both, np.nan, np.where(pos, np.inf, pk))
    return val.astype(F32), peak.astype(F32)


def plain(x, z0, v0, om, op):
    return [t.numpy() for t in spectrum_fused.fused_core_reference(
        torch.from_numpy(x), torch.from_numpy(z0), torch.from_numpy(v0),
        torch.tensor(om, dtype=torch.float32), op)]


def bands(op, sel):
    """The banked operator of the bands in ``sel``."""
    return lti.LTIBlockOp(*(getattr(op, k)[sel] for k in ("kmat", "sy", "at", "g")),
                          block=op.block, d=op.d, m=op.m, p=op.p)


def inputs(spec, B, T, seed):
    """x [B, T], and a filter state and smoother value at a stream's real
    scale (0.25 s of noise through the plain bank), as chip_smoke.py."""
    g = np.random.default_rng(seed)
    warm = torch.as_tensor((0.3 * g.standard_normal((B, FS // 4))).astype(F32))
    yw, z0 = spec.bank.apply(warm, spec.bank.init((B,), device="cpu"))
    v0 = torch.mean(torch.square(yw), dim=-1)
    return (0.3 * g.standard_normal((B, T))).astype(F32), z0.numpy(), v0.numpy()


def omega(speed):
    return F32(1.0 - np.exp(-2.0 * np.pi * speed / FS))


def leaf_errs(got, ref):
    """Each leaf's max |got - ref| over its scale, after checking that the
    non-finite values agree."""
    out = []
    for name, a, b in zip(("val", "peak", "zf"), got, ref):
        assert np.array_equal(np.isnan(a), np.isnan(b)), name
        inf = np.isinf(b)
        assert np.array_equal(np.isinf(a), inf) and np.array_equal(a[inf], b[inf]), name
        f = np.isfinite(b)
        scale = np.abs(b[f]).max() if f.any() else 0.0
        out.append(np.abs(a[f].astype(F64) - b[f]).max() / scale if scale else 0.0)
    return out


@pytest.mark.parametrize("band", [0, 29])
def test_emulation_matches_plain_carried(spec, band):
    """10 x 1 s carried at band 0 (24.8 Hz, the poles nearest the unit
    circle) and band 29 (12.7 kHz), each path keeping its own state."""
    op = bands(spec.bank.op(BLK), [band])
    x, z0, v0 = inputs(spec, 2, 10 * FS, band)
    z0, v0 = z0[:, band:band + 1], v0[:, band:band + 1]
    om = omega(3.0)
    se, sp = (z0, v0), (z0, v0)
    for i in range(10):
        xb = np.ascontiguousarray(x[:, i * FS:(i + 1) * FS])
        e = emulate(xb, se[0], se[1], om, op)
        p = plain(xb, sp[0], sp[1], om, op)
        errs = leaf_errs(e, p)
        assert max(errs) <= SPEC_TOL, (i, errs)
        se, sp = (e[2], e[0]), (p[2], p[0])


def test_single_pass_tf32_misses_the_bar(spec):
    """One TF32 pass (no lo terms) is what the split avoids: over 1 s at
    band 16 it misses SPEC_TOL."""
    op = bands(spec.bank.op(BLK), [16])
    x, z0, v0 = inputs(spec, 2, FS, 16)
    z0, v0 = z0[:, 16:17], v0[:, 16:17]
    p = plain(x, z0, v0, omega(3.0), op)
    assert max(leaf_errs(emulate(x, z0, v0, omega(3.0), op), p)) <= SPEC_TOL
    assert max(leaf_errs(emulate(x, z0, v0, omega(3.0), op, single=True), p)) > SPEC_TOL


def test_tf32_split():
    """hi + lo carries a float32 to 2^-21 of it (round to nearest twice);
    hi has 10 mantissa bits.  Past SPLIT_MAX it does not: an infinity keeps
    hi = Inf (lo = -0 from the card's NaN), a finite value that rounds up
    becomes Inf, and the NaNs 0x7fffffff and 0xffffffff become signed zeros
    in both parts, which is why the kernel flags rows from x itself."""
    a = np.random.default_rng(0).standard_normal(10000).astype(F32) * F32(1e3)
    hi, lo = split(a)
    assert not (hi.view(np.uint32) & 0x1FFF).any()
    assert np.all(np.abs(hi.astype(F64) + lo - a) <= 2.0 ** -21 * np.abs(a))
    assert tf32(F32(1.0 + 2.0 ** -11)) == F32(1.0 + 2.0 ** -10)  # ties away from zero
    hi, lo = split(np.array([np.inf, -np.inf], F32))
    assert np.array_equal(hi, [np.inf, -np.inf]) and not lo.any()
    big = np.array([0x7F7FEFFF, 0x7F7FF000], np.uint32).view(F32)
    assert np.isfinite(tf32(big[0])) and tf32(big[1]) == np.inf
    assert np.array_equal(unsplit_rows(big[:, None], 1), [False, True])
    nans = np.array([0x7FFFFFFF, 0xFFFFFFFF, 0x7FC00000], np.uint32).view(F32)
    hi, lo = split(nans)
    assert np.array_equal(hi.view(np.uint32)[:2], [0x80000000, 0]) and np.isnan(hi[2])
    assert not lo.any()
    assert unsplit_rows(nans[:, None], 1).all()


def _inject(x, z0, v0):
    """chip_smoke.py spectrum_kernel_cases' NaN/+-Inf rows (B=7 T=1024)."""
    T = x.shape[1]
    x[0, 37], x[1, T - 1], x[2, 0] = np.nan, np.inf, -np.inf
    x[3, 130], x[3, 200], x[4, 128] = np.inf, -np.inf, np.inf
    v0[5, 3], v0[5, 4], v0[5, 5] = np.inf, np.nan, -np.inf
    z0[5, 7, 2] = np.inf


def _inject_card_nans(x):
    """NaNs as the card's arithmetic makes them (0.5 (L + R) with a NaN, or
    +Inf against -Inf): chip_smoke.py spectrum_kernel_cases' rows."""
    u = x.view(np.uint32)
    u[0, 37], u[1, 300], u[2, 0], u[2, 900] = 0x7FFFFFFF, 0xFFFFFFFF, 0x7FFFFFFF, 0xFFFFFFFF
    u[3, 127] = 0x7FFFFFFF


@pytest.mark.parametrize("flag_from_x", [True, False])
def test_emulation_card_nans(spec, flag_from_x):
    """x holding 0x7fffffff and 0xffffffff (B=5 T=1024): the split turns
    them into zeros, so only a flag taken from x itself gives the plain
    version's NaNs; flagged from the products alone, val, peak and zf come
    out finite where the plain version's are NaN."""
    op = spec.bank.op(BLK)
    x, z0, v0 = inputs(spec, 5, 1024, 17)
    _inject_card_nans(x)
    om = omega(3.0)
    p = plain(x, z0, v0, om, op)
    assert np.isnan(p[0][:4]).all() and np.isfinite(p[0][4]).all()
    e = emulate(x, z0, v0, om, op, flag_from_x=flag_from_x)
    if flag_from_x:
        assert max(leaf_errs(e, p)) <= SPEC_TOL
    else:
        assert np.isfinite(e[0][:4]).all()


@pytest.mark.parametrize("case", ["nonfinite", "nan omega", "partial tile", "one block"])
def test_emulation_matches_plain_cases(spec, case):
    """chip_smoke.py's kernel cases: NaN/+-Inf in x, z0 and v0 (B=7
    T=1024), a NaN omega (B=5 T=256), B=13 T=1024, B=4 T=128."""
    op = spec.bank.op(BLK)
    B, T, speed = {"nonfinite": (7, 1024, 3.0), "nan omega": (5, 256, float("nan")),
                   "partial tile": (13, 1024, 3.0), "one block": (4, 128, 3.0)}[case]
    x, z0, v0 = inputs(spec, B, T, B + T)
    if case == "nonfinite":
        _inject(x, z0, v0)
    om = omega(speed)
    errs = leaf_errs(emulate(x, z0, v0, om, op), plain(x, z0, v0, om, op))
    assert max(errs) <= SPEC_TOL, errs


def test_emulation_matches_plain_omega_change(spec):
    """omega 1 -> 8 between two chained calls (B=8 T=2 x 512)."""
    op = spec.bank.op(BLK)
    x, z0, v0 = inputs(spec, 8, 1024, 11)
    e = emulate(x[:, :512], z0, v0, omega(1.0), op)
    p = plain(x[:, :512].copy(), z0, v0, omega(1.0), op)
    e = emulate(x[:, 512:], e[2], e[0], omega(8.0), op)
    p = plain(x[:, 512:].copy(), p[2], p[0], omega(8.0), op)
    assert max(leaf_errs(e, p)) <= SPEC_TOL


def test_plain_matches_pallas_interpret_on_the_emulated_signal(spec):
    """On one signal (B=3 T=256): the emulation against the plain version,
    and the plain version against the Pallas kernel in interpret mode."""
    jm = JSpectrum(FS)
    x, z0, v0 = inputs(spec, 3, 256, 5)
    om = omega(3.0)
    p = plain(x, z0, v0, om, spec.bank.op(BLK))
    assert max(leaf_errs(emulate(x, z0, v0, om, spec.bank.op(BLK)), p)) <= SPEC_TOL
    j = [np.asarray(a) for a in pallas_spectrum.fused_core(
        jnp.asarray(x), jnp.asarray(z0), jnp.asarray(v0), jnp.asarray(om),
        jm.bank.op(BLK), interpret=True)]
    for name, a, b in zip(("val", "peak", "zf"), p, j):
        if name == "zf":  # per band: each band's state scale
            scale = np.abs(b).max(axis=(0, 2), keepdims=True)
            assert np.all(np.abs(a - b) <= PALLAS_RTOL * scale), name
        else:
            assert np.allclose(a, b, rtol=PALLAS_RTOL, atol=0.0), name
