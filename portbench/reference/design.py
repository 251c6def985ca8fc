"""Host-side (float64 numpy) filter/coefficient design: a frozen copy.

The part of ``meters_lv2_torch/ops/design.py`` that the plain reference
calls, copied as the benchmark was written, so that the reference works
out every filter tap, resampler tap and ballistics constant again without
importing the program under test.  Later changes to the program's design
do not reach the reference.

All coefficient formulas are re-derived from the published standards the
reference implements (ITU-R BS.1770 / EBU R128 K-weighting, IEC 60268-10/17
ballistics, IEC 61260 1/3-octave bands) and verified numerically against the
reference implementation:

- K-weighting combined biquad + integrator correction:
  ebumeter/ebu_r128_proc.cc:263-293 (``detect_init``)
- zita-resampler windowed sinc of the 4x true-peak filter:
  zita-resampler/resampler-table.cc:29-75
- IEC 61260 band-pass bilinear design:
  src/spectr.c:89-206 (``bandpass_setup``)

Design runs in float64 on the host (as the reference implicitly does via
``double`` math) and ships float32 constants to the device.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np

# ---------------------------------------------------------------------------
# Ballistics constants (IEC 60268-10, true peak, correlation)
# Sources: iec2ppmdsp.cc:90-96, truepeakdsp.cc:148-157, stcorrdsp.cc:85-93.
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class BallisticsCoeffs:
    """Dual attack/release peak-filter constants (PPM family)."""

    w1: float  # fast attack coefficient
    w2: float  # slow attack coefficient
    w3: float  # release (decay) multiplier per sample
    g: float  # readout gain


def iec2_ppm(fs: float) -> BallisticsCoeffs:
    """BBC / EBU PPM (IEC 60268-10 Type IIa/IIb)."""
    fs = float(fs)
    return BallisticsCoeffs(w1=200.0 / fs, w2=860.0 / fs, w3=1.0 - 4.0 / fs, g=0.5141)


def true_peak_ballistics(fs: float) -> BallisticsCoeffs:
    """Type-II-style ballistics evaluated on the 4x oversampled stream."""
    fs = float(fs)
    return BallisticsCoeffs(
        w1=4000.0 / fs / 4.0, w2=17200.0 / fs / 4.0, w3=1.0 - 7.0 / fs / 4.0, g=0.502
    )


def stcorr_coeffs(fs: float, flp: float = 2000.0, tcf: float = 0.3) -> tuple[float, float]:
    """Stereo correlation one-pole constants (w1 lowpass, w2 averaging)."""
    fs = float(fs)
    return 6.28 * flp / fs, 1.0 / (tcf * fs)


# ---------------------------------------------------------------------------
# K-weighting (ITU-R BS.1770) — shelf+HP biquad with double-integrator
# correction, matching ebu_r128_proc.cc:263-293.
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class KWeighting:
    a0: float
    a1: float
    a2: float
    b1: float
    b2: float
    c3: float
    c4: float


def k_weighting(fs: float) -> KWeighting:
    fs = float(fs)
    r = 1.0 / math.tan(4712.3890 / fs)
    w1 = r / 1.12201
    w2 = r * 1.12201
    u1 = u2 = 1.4085 + 210.0 / fs
    a = u1 * w1
    b = w1 * w1
    c = u2 * w2
    d = w2 * w2
    r = 1 + a + b
    a0 = (1 + c + d) / r
    a1 = (2 - 2 * d) / r
    a2 = (1 - c + d) / r
    b1 = (2 - 2 * b) / r
    b2 = (1 - a + b) / r
    r = 48.0 / fs
    a = 4.9886075 * r
    b = 6.2298014 * r * r
    r = 1 + a + b
    a *= 2 / r
    b *= 4 / r
    c3 = a + b
    c4 = b
    r = 1.004995 / r
    return KWeighting(a0=a0 * r, a1=a1 * r, a2=a2 * r, b1=b1, b2=b2, c3=c3, c4=c4)


def k_weighting_state_space(fs: float) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """K-weighting as a 4-state LTI system (A, B, C, D), float64.

    Per-sample recurrence (ebu_r128_proc.cc:319-328)::

        x' = p - b1*z1 - b2*z2
        y  = a0*x' + a1*z1 + a2*z2 - c3*z3 - c4*z4
        (z1, z2, z3, z4) <- (x', z1, z3 + y, z4 + z3)

    with state order s = (z1, z2, z3, z4).
    """
    k = k_weighting(fs)
    ca1 = k.a1 - k.a0 * k.b1
    ca2 = k.a2 - k.a0 * k.b2
    A = np.array(
        [
            [-k.b1, -k.b2, 0.0, 0.0],
            [1.0, 0.0, 0.0, 0.0],
            [ca1, ca2, 1.0 - k.c3, -k.c4],
            [0.0, 0.0, 1.0, 1.0],
        ],
        dtype=np.float64,
    )
    B = np.array([[1.0], [0.0], [k.a0], [0.0]], dtype=np.float64)
    C = np.array([[ca1, ca2, -k.c3, -k.c4]], dtype=np.float64)
    D = np.array([[k.a0]], dtype=np.float64)
    return A, B, C, D


# EBU R128 channel gains for (L, R, C, Ls, Rs); mono is counted twice
# (ebu_r128_proc.cc:29, 329-330).
R128_CHAN_GAIN = np.array([1.0, 1.0, 1.0, 1.41, 1.41], dtype=np.float64)


# ---------------------------------------------------------------------------
# The 4x true-peak upsampling filter of zita-resampler's windowed sinc
# (resampler-table.cc:29-75).
# ---------------------------------------------------------------------------


def _sinc(x: np.ndarray) -> np.ndarray:
    x = np.abs(x)
    out = np.ones_like(x)
    nz = x >= 1e-6
    xpi = x[nz] * math.pi
    out[nz] = np.sin(xpi) / xpi
    return out


def _wind(x: np.ndarray) -> np.ndarray:
    x = np.abs(x)
    out = np.zeros_like(x)
    inside = x < 1.0
    xpi = x[inside] * math.pi
    out[inside] = 0.384 + 0.500 * np.cos(xpi) + 0.116 * np.cos(2.0 * xpi)
    return out


def upsample4_kernel(hl: int = 24) -> np.ndarray:
    """4x polyphase interpolation kernel, shape [4, 2*hl].

    Derived from the two-sided MAC in resampler.cc:215-229 with
    setup(fs, 4*fs, 1, hl=24, frel=1.0) as used by truepeakdsp.cc:150.
    The oversampled stream is::

        up[4*t + ph] = sum_{k=-hl}^{hl-1} x[t - hl - k] * h(k + ph/4)

    i.e. output phase ph is a causal FIR over x[t-2*hl+1 .. t] with taps
    kern[ph, i] = h(hl - 1 - i + ph/4) applied to x[t - (2*hl-1) + i].
    Phase 0 reduces to a pure delay of hl samples (h(k) = delta[k]).
    """
    npha = 4
    taps = np.zeros((npha, 2 * hl), dtype=np.float64)
    for ph in range(npha):
        # y = sum_k x[t_now - hl - k] * h(k): x index t-hl-k maps to window
        # position i = (2*hl - 1) - (hl + k) = hl - 1 - k  (i: oldest=0).
        # So taps_in_window_order[i] = h(hl - 1 - i + ph/4).
        i = np.arange(2 * hl)
        tw = (hl - 1 - i) + ph / npha
        taps[ph] = 1.0 * _sinc(tw) * _wind(tw / hl)
    return taps


# ---------------------------------------------------------------------------
# IEC 61260 1/3-octave band-pass bank (spectr.c:89-206)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class BiquadCoeffs:
    """Direct-form-II-transposed biquad y = b0*x + z1; z1 = b1*x - a1*y + z2;
    z2 = b2*x - a2*y."""

    b0: float
    b1: float
    b2: float
    a1: float
    a2: float


def spectrum_band_frequencies(n_bands: int = 30) -> list[tuple[float, float]]:
    """Center frequency and bandwidth for each 1/3-octave band.

    centers 1000*2^((i-16)/3) Hz, bw = f2 - f1 with f1,2 = fm*2^(∓1/6)
    (spectrumlv2.c:100-117).
    """
    out = []
    b = 3.0
    f1f = 2.0 ** (-1.0 / (2.0 * b))
    f2f = 2.0 ** (1.0 / (2.0 * b))
    for i in range(n_bands):
        x = i - 16
        f_m = (2.0 ** (x / b)) * 1000.0
        bw = f_m * f2f - f_m * f1f
        out.append((f_m, bw))
    return out


def bandpass_design(rate: float, freq: float, band: float, order: int = 6) -> list[BiquadCoeffs]:
    """Bilinear-transform band-pass design; returns `order` biquad stages.

    Faithful float64 reimplementation of bandpass_setup (spectr.c:89-206):
    complex analog band-pass prototype poles mapped through the bilinear
    transform, cascade normalised to unity gain at the center frequency.
    """
    assert order > 0 and order % 2 == 0 and order <= 6
    wc = 2.0 * math.pi * freq / rate
    ww = 2.0 * math.pi * band / rate
    wl = wc - ww / 2.0
    wu = wc + ww / 2.0
    if wu > math.pi - 1e-9:
        wu = math.pi - 1e-9
    if wl < 1e-9:
        wl = 1e-9
    wu *= 0.5
    wl *= 0.5
    assert wu > wl

    c_a = math.cos(wu + wl) / math.cos(wu - wl)
    c_b = 1.0 / math.tan(wu - wl)
    w = 2.0 * math.atan(math.sqrt(math.tan(wu) * math.tan(wl)))

    c_a2 = c_a * c_a
    c_b2 = c_b * c_b
    ab_2 = 2.0 * c_a * c_b

    stages: list[list[float]] = []  # [a1, a2, b0, b1, b2] per stage
    for i in range(order // 2):
        omega = math.pi / 2.0 + (2 * i + 1) * math.pi / (2.0 * order)
        p = complex(math.cos(omega), math.sin(omega))
        c = (1.0 + p) / (1.0 - p)
        d = 2.0 * (c_b - 1.0) * c + 2.0 * (1.0 + c_b)
        v = (4.0 * (c_b2 * (c_a2 - 1.0) + 1.0)) * c
        v = v + 8.0 * (c_b2 * (c_a2 - 1.0) - 1.0)
        v = v * c
        v = v + 4.0 * (c_b2 * (c_a2 - 1.0) + 1.0)
        v = complex(v) ** 0.5

        u0 = complex(ab_2 + (-v).real + ab_2 * c.real, (-v).imag + ab_2 * c.imag)
        u1 = complex(ab_2 + v.real + ab_2 * c.real, v.imag + ab_2 * c.imag)

        for pc, odd in ((u0 / d, 0), (u1 / d, 1)):
            a1 = -2.0 * pc.real
            a2 = pc.real * pc.real + pc.imag * pc.imag
            b0 = 1.0
            b1 = -2.0 if odd else 2.0
            b2 = 1.0
            stages.append([a1, a2, b0, b1, b2])

    # normalise cascade gain at the center frequency w
    cos_w = math.cos(-w)
    sin_w = math.sin(-w)
    cos_w2 = math.cos(-2.0 * w)
    sin_w2 = math.sin(-2.0 * w)
    ch = complex(1.0, 0.0)
    cb = complex(1.0, 0.0)
    for a1, a2, b0, b1, b2 in stages:
        ch *= complex((1.0 + b1 * cos_w) + cos_w2, (b1 * sin_w) + sin_w2)
        cb *= complex((1.0 + a1 * cos_w) + a2 * cos_w2, (a1 * sin_w) + a2 * sin_w2)
    scale = (cb / ch).real
    stages[0][2] *= scale
    stages[0][3] *= scale
    stages[0][4] *= scale

    return [BiquadCoeffs(b0=s[2], b1=s[3], b2=s[4], a1=s[0], a2=s[1]) for s in stages]


def modal_balance(A, B, C, D, exact_blocks: bool = True):
    """Similarity-transform (A,B,C,D) to a balanced real modal form.

    Eigen-decomposes A into real 2x2 rotation blocks (complex pairs) /
    1x1 blocks and diagonally balances each mode so per-mode input and
    output gains match.  Input-output behaviour is unchanged in exact
    arithmetic, but float32 execution conditions dramatically better for
    high-Q systems (the 25 Hz IEC 61260 bands have poles at radius
    1 - 1e-5 where direct-form states cancel catastrophically).

    With ``exact_blocks`` (default) the modal A is constructed
    ANALYTICALLY from the eigenvalues — each complex pair lambda gives the
    exact 2x2 block [[Re, Im], [-Im, Re]], real eigenvalues give exact 1x1
    diagonal entries, and every off-block entry is exactly 0.0 (instead of
    the ~1e-14 similarity-transform residue Ti @ A @ T leaves).  Exact
    zeros are load-bearing for ops/pallas_spectrum: matrix powers of an
    exactly-block-diagonal A stay exactly block-diagonal, so the per-block
    state propagator A^T decomposes into per-mode 2x2 rotations the kernel
    can run as exact-f32 VPU elementwise FMAs instead of a 6-pass bf16
    GEMM.  The O(1e-14) perturbation of the transfer function is orders of
    magnitude below the f32 noise floor.
    """
    A = np.asarray(A, np.float64)
    B = np.asarray(B, np.float64)
    C = np.asarray(C, np.float64)
    D = np.asarray(D, np.float64)
    w, V = np.linalg.eig(A)
    d = A.shape[0]
    used = np.zeros(d, bool)
    cols = []  # real basis columns
    blocks = []  # (offset, eigenvalue, is_pair)
    for i in range(d):
        if used[i]:
            continue
        if abs(w[i].imag) < 1e-12:
            blocks.append((len(cols), w[i], False))
            cols.append(V[:, i].real)
            used[i] = True
        else:
            # find the conjugate partner
            j = None
            for k in range(i + 1, d):
                if not used[k] and abs(w[k] - np.conj(w[i])) < 1e-8 * max(1, abs(w[i])):
                    j = k
                    break
            blocks.append((len(cols), w[i], True))
            cols.append(V[:, i].real)
            cols.append(V[:, i].imag)
            used[i] = True
            if j is not None:
                used[j] = True
    T = np.stack(cols, axis=1)
    Ti = np.linalg.inv(T)
    if exact_blocks:
        # A v = lambda v with v = vr + i*vi gives A [vr vi] = [vr vi] @
        # [[Re, Im], [-Im, Re]] exactly, so this IS Ti @ A @ T up to the
        # eigensolver's O(1e-12) residue — minus the residue.
        Am = np.zeros((d, d))
        for off, lam, is_pair in blocks:
            if is_pair:
                Am[off, off] = lam.real
                Am[off, off + 1] = lam.imag
                Am[off + 1, off] = -lam.imag
                Am[off + 1, off + 1] = lam.real
            else:
                Am[off, off] = lam.real
    else:
        Am = Ti @ A @ T
    Bm = Ti @ B
    Cm = C @ T
    # per-state diagonal balancing: scale so |B| and |C| rows match
    bn = np.maximum(np.abs(Bm).sum(1), 1e-30)
    cn = np.maximum(np.abs(Cm).sum(0), 1e-30)
    s = np.sqrt(cn / bn)  # x' = s*x equalises drive (s*B) vs read (C/s)
    # couple the 2x2 blocks: use a shared scale per conjugate pair so the
    # rotation structure is preserved
    i = 0
    while i < d:
        if i + 1 < d and abs(Am[i, i + 1]) > 1e-12 and abs(Am[i + 1, i]) > 1e-12:
            sh = math.sqrt(s[i] * s[i + 1])
            s[i] = s[i + 1] = sh
            i += 2
        else:
            i += 1
    S = np.diag(1.0 / s)
    Si = np.diag(s)
    return Si @ Am @ S, Si @ Bm, Cm @ S, D


def series_connect(
    systems: list[tuple],
) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Series-connect (A, B, C, D) systems (first feeds second, ...).

    The composite A is block LOWER-triangular: diagonal blocks are the
    section A's, strictly-lower blocks the feed couplings B_i @ C_j
    chains.  Powers of A stay in the same block structure with EXACT
    structural zeros (0*x + 0*y sums stay 0.0 in IEEE).
    """
    A_tot = np.zeros((0, 0))
    B_tot = np.zeros((0, 1))
    C_tot = np.zeros((1, 0))
    D_tot = np.eye(1)
    for A, B, C, D in systems:
        A = np.asarray(A, np.float64)
        B = np.asarray(B, np.float64)
        C = np.asarray(C, np.float64)
        D = np.asarray(D, np.float64)
        n0 = A_tot.shape[0]
        n1 = A.shape[0]
        A_new = np.zeros((n0 + n1, n0 + n1))
        A_new[:n0, :n0] = A_tot
        A_new[n0:, :n0] = B @ C_tot
        A_new[n0:, n0:] = A
        B_new = np.vstack([B_tot, B @ D_tot])
        C_new = np.hstack([D @ C_tot, C])
        D_new = D @ D_tot
        A_tot, B_tot, C_tot, D_tot = A_new, B_new, C_new, D_new
    return A_tot, B_tot, C_tot, D_tot


def _biquad_state_space(s: BiquadCoeffs) -> tuple[np.ndarray, ...]:
    A = np.array([[-s.a1, 1.0], [-s.a2, 0.0]])
    B = np.array([[s.b1 - s.a1 * s.b0], [s.b2 - s.a2 * s.b0]])
    C = np.array([[1.0, 0.0]])
    D = np.array([[s.b0]])
    return A, B, C, D


def cascade_modal_state_space(
    stages: list[BiquadCoeffs],
) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Cascade of per-stage BALANCED 2x2 modal sections.

    Each biquad is transformed to its own exact modal form first (a 2x2
    eigenproblem — perfectly conditioned, unlike eigendecomposing the
    whole clustered-pole cascade, where LAPACK's cluster-splitting error
    can push modal eigenvalues OUTSIDE the unit circle; measured: the
    exactified 12-state parallel modal form of the low 1/3-octave bands
    diverges in f32 while this form stays stable).  The composite A is
    block lower-triangular with exact 2x2 rotation diagonal blocks and
    exact structural zeros above — a structure matrix powers preserve,
    so the per-block propagator A^T decomposes into <= d/2 lane-shifted
    per-lane FMAs (see ops/pallas_spectrum).  This is the classic
    numerically-robust cascade-of-second-order-sections topology, in
    state-space block form.
    """
    def section(s):
        raw = _biquad_state_space(s)
        try:
            m = modal_balance(*raw)
        except np.linalg.LinAlgError:
            return raw  # defective (repeated real pole): keep companion
        if not all(np.isfinite(x).all() for x in m):
            return raw
        return m

    return series_connect([section(s) for s in stages])
