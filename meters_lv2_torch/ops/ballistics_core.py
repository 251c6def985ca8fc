"""PPM / true-peak attack-release recurrence over a [N, T] batch of rows.

Counterpart of ``meters_lv2_tpu/ops/pallas_ballistics.py``
(``ballistics_pallas``, both bodies).  Per row, per 4-sample group
(iec2ppmdsp.cc:47-80, truepeakdsp.cc:58-107)::

    z1 *= w3; z2 *= w3                    # release, once per group
    for each of the 4 samples t:
        if t > z1: z1 += w1 * (t - z1)    # conditional attack
        if t > z2: z2 += w2 * (t - z2)
        if t > p:  p = t                  # raw peak (track_peak only)
    m = max(m, z1 + z2)

A NaN sample compares false and is skipped; ``max`` propagates a NaN as
``torch.maximum`` does.  Entry clamps, ``m``/``p`` zeroing and the read
reset stay with the caller (ops/ballistics.py): they happen once per
``update()``, not per sample.

``envelope=True`` selects the group-envelope body (the JAX kernel's
``group_env``, pallas_ballistics.py:61-107).  Each sample step is
z' = max(z, (1-w) z + w t), a max of monotone affine maps, so a group is
exactly z' = max_k (w3 a^k z + b_k), k = 0..4, a = 1 - w, where b_k, the
best intercept over attack subsets of size k, comes from a max-plus DP over
the group's samples that never reads the carried state.  The port
evaluates the candidates as d + (b_k - d c_k), d = w3 z, c_k = 1 - a^k, and
the DP's attacks as serial steps (``ballistics_envelope_reference``).  A
NaN sample cannot attack: it enters the DP as -inf, and a candidate that
adds -inf to +inf counts as -inf (a NaN-dropping max, ``torch.fmax``), so
a group holding a NaN and a +Inf, or a +Inf after its first sample, gives
the serial body's +Inf (the JAX envelope gives NaN there).  The output max
over the five candidates drops NaN too: a NaN candidate arises only from
a carried z of +Inf meeting a b_k of -inf, where the serial body keeps
+Inf; a NaN carried z makes every candidate NaN and stays NaN.  Within
2e-6 relative (1e-7 absolute) of the serial body, the bar of
tests/test_ballistics_envelope.py.

``ballistics`` launches the hand-written CUDA kernel (csrc/ballistics.cu)
for CUDA tensors and runs the plain PyTorch version,
``ballistics_reference`` or ``ballistics_envelope_reference``, only for
tensors on the CPU.  The kernel does the same float32 operations in the
same order, so on the card it is bit-exact to the plain version of the body
it runs.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from .lti import check_tensor

# Kernel launches since import (or since a caller reset it), the serial
# body's and the envelope body's apart.  Only the CUDA branch of
# ballistics() counts.
launch_count = 0
envelope_launch_count = 0


def f32(v: float) -> float:
    """v rounded to float32 (the JAX package's jnp.float32(v))."""
    return float(np.float32(v))


def coeffs_f32(w1: float, w2: float, w3: float) -> tuple[float, float, float]:
    """The coefficients rounded to float32 once, as the kernel and the plain
    version both use them."""
    return f32(w1), f32(w2), f32(w3)


def envelope_ok(w1: float, w2: float) -> bool:
    """True when the envelope body holds for the float32 coefficients:
    0 <= w <= 1 for w1 and w2, so that every attack step
    z' = max(z, (1 - w) z + w t) is monotone in z.  True peak's
    w2 = 4300 / fs passes 1 below fs = 4,300 Hz."""
    return all(0.0 <= w <= 1.0 for w in coeffs_f32(w1, w2, 0.0)[:2])


def envelope_decrements(w: float) -> tuple[float, float, float, float]:
    """c_k = 1 - (1 - w)^k, k = 1..4 (w the float32 coefficient), each taken
    in float64 and rounded to float32 once; c_1 is w itself.  The kernel
    gets these values."""
    a = 1.0 - float(np.float32(w))
    return tuple(f32(1.0 - a**k) for k in range(1, 5))


def ballistics_reference(
    t_abs: torch.Tensor,
    z1: torch.Tensor,
    z2: torch.Tensor,
    m: torch.Tensor,
    p: torch.Tensor,
    *,
    w1: float,
    w2: float,
    w3: float,
    track_peak: bool,
):
    """Plain PyTorch version: the grouped loop of the JAX package's
    ``ops/ballistics._scan_ballistics``, one torch op per float32 step.

    Args:
      t_abs: [N, T] rectified samples, T % 4 == 0.
      z1, z2, m, p: [N] carried states (p is returned unchanged unless
        ``track_peak``).

    Returns (z1, z2, m, p), each [N].
    """
    N, T = t_abs.shape
    if T % 4:
        raise ValueError(f"T={T} must be a multiple of 4")
    w1, w2, w3 = coeffs_f32(w1, w2, w3)
    # [G, 4, N]: each step reads one contiguous row of samples
    tg = t_abs.reshape(N, T // 4, 4).permute(1, 2, 0).contiguous()
    for tb in tg:
        z1 = z1 * w3
        z2 = z2 * w3
        for ti in tb:
            z1 = torch.where(ti > z1, z1 + w1 * (ti - z1), z1)
            z2 = torch.where(ti > z2, z2 + w2 * (ti - z2), z2)
            if track_peak:
                p = torch.where(ti > p, ti, p)
        m = torch.maximum(m, z1 + z2)
    return z1, z2, m, p


def _envelope_intercepts(ts: torch.Tensor, w: float) -> torch.Tensor:
    """The max-plus DP of every group at once: ts [4, ...] the group's
    samples (NaN already -inf); returns b_1..b_4 stacked as [4, ...].

    b_k after sample j is the best result of k attacks among samples 0..j
    on a zero state: an attack is the serial step b + w (t_j - b), so the
    DP rounds as the serial chain does.  A candidate that is NaN (-inf
    meeting +inf) is dropped (fmax).  The steps that can only give -inf
    (b_3 and b_4 before samples 2 and 3) are left out."""
    ninf = torch.tensor(float("-inf"), dtype=ts.dtype, device=ts.device)

    def att(b, j):
        return b + (ts[j] - b) * w

    b1 = ts[0] * w
    b2 = torch.fmax(ninf, att(b1, 1))
    b1 = torch.maximum(b1, ts[1] * w)
    b3 = torch.fmax(ninf, att(b2, 2))
    b2 = torch.fmax(b2, att(b1, 2))
    b1 = torch.maximum(b1, ts[2] * w)
    b4 = torch.fmax(ninf, att(b3, 3))
    b3 = torch.fmax(b3, att(b2, 3))
    b2 = torch.fmax(b2, att(b1, 3))
    b1 = torch.maximum(b1, ts[3] * w)
    return torch.stack([b1, b2, b3, b4])


def ballistics_envelope_reference(
    t_abs: torch.Tensor,
    z1: torch.Tensor,
    z2: torch.Tensor,
    m: torch.Tensor,
    p: torch.Tensor,
    *,
    w1: float,
    w2: float,
    w3: float,
    track_peak: bool,
):
    """Plain PyTorch version of the envelope body, the same float32
    operations in the same order as the kernel's ``group_env_step``.

    The intercepts b_k do not depend on the carried state, so they are
    computed for every group at once; only the state update loops over the
    groups: z' = fmax over d and d + (b_k - d c_k), k = 1..4, with d = w3 z
    and c_k = 1 - (1 - w)^k (``envelope_decrements``), for z1 and z2
    together, then m = max(m, z1 + z2) (NaN-propagating).  d a^k + b_k is
    the same value, but a^k rounded to float32 biases the decay of every
    group by up to half an ulp of a^k, which the recurrence multiplies by
    about 1 / w (over 48,000 samples at 48 kHz that form left the serial
    kernel by 1.43e-6 in z1, over the 2e-6 relative bar); c_k carries its
    rounding on the small decrement instead.  The raw peak takes the max over the group's
    samples with NaN as -inf, then a NaN-propagating max with p.

    Arguments and returns as ``ballistics_reference``.
    """
    N, T = t_abs.shape
    if T % 4:
        raise ValueError(f"T={T} must be a multiple of 4")
    w1, w2, w3 = coeffs_f32(w1, w2, w3)
    c1, c2 = envelope_decrements(w1), envelope_decrements(w2)
    tg = t_abs.reshape(N, T // 4, 4).permute(2, 1, 0)  # [4, G, N]
    ts = torch.where(tg == tg, tg, float("-inf"))
    # [G, 4, 2, N]: per group, b_k of z1 and z2
    b = torch.stack([_envelope_intercepts(ts, w1), _envelope_intercepts(ts, w2)],
                    dim=1).permute(2, 0, 1, 3).contiguous()
    ck = torch.tensor([[[c1[k]], [c2[k]]] for k in range(4)], dtype=t_abs.dtype,
                      device=t_abs.device)  # [4, 2, 1]
    z = torch.stack([z1, z2])
    for bg in b:
        d = z * w3
        c = d + (bg - d * ck)
        z = torch.fmax(torch.fmax(torch.fmax(torch.fmax(d, c[0]), c[1]), c[2]), c[3])
        m = torch.maximum(m, z[0] + z[1])
    if track_peak:
        # the group maxima hold no NaN, so folding them into p group by
        # group (the kernel) or all at once selects the same value
        pg = torch.maximum(torch.maximum(ts[0], ts[1]), torch.maximum(ts[2], ts[3]))
        p = torch.maximum(p, pg.amax(dim=0))
    return z[0], z[1], m, p


def _ballistics_cuda(t_abs, z1, z2, m, p, w1, w2, w3, track_peak, envelope=False):
    global launch_count, envelope_launch_count
    from ..runtime import build

    device = t_abs.device
    if t_abs.ndim != 2:
        raise ValueError(f"t_abs must be [N, T], got {tuple(t_abs.shape)}")
    N, T = t_abs.shape
    if N < 1 or T < 4 or T % 4:
        raise ValueError(f"need N >= 1 and T a positive multiple of 4, got N={N} T={T}")
    check_tensor("t_abs", t_abs, (N, T), device)
    if t_abs.data_ptr() % 16:
        raise ValueError("t_abs must be 16-byte aligned (the kernel stages it with bulk copies)")
    for name, v in (("z1", z1), ("z2", z2), ("m", m), ("p", p)):
        check_tensor(name, v, (N,), device)
    w1, w2, w3 = coeffs_f32(w1, w2, w3)
    out = torch.empty((4, N), dtype=torch.float32, device=device)
    env_dec = (ctypes.c_float * 8)(*envelope_decrements(w1), *envelope_decrements(w2))
    lib = build.kernels()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = lib.ballistics_launch(
            t_abs.data_ptr(), z1.data_ptr(), z2.data_ptr(), m.data_ptr(),
            p.data_ptr(), N, T, w1, w2, w3, int(bool(track_peak)), int(bool(envelope)),
            env_dec, out[0].data_ptr(), out[1].data_ptr(), out[2].data_ptr(),
            out[3].data_ptr(), stream,
        )
    build.check(lib, rc, "ballistics_launch")
    if envelope:
        envelope_launch_count += 1
    else:
        launch_count += 1
    return out[0], out[1], out[2], out[3]


def ballistics(
    t_abs: torch.Tensor,
    z1: torch.Tensor,
    z2: torch.Tensor,
    m: torch.Tensor,
    p: torch.Tensor,
    *,
    w1: float,
    w2: float,
    w3: float,
    track_peak: bool,
    envelope: bool = False,
):
    """The recurrence over t_abs [N, T]; arguments and returns as
    ``ballistics_reference``; ``envelope`` selects the group-envelope body,
    which raises outside its domain (``envelope_ok``).  A CUDA tensor goes
    to the CUDA kernel (contiguous float32 inputs); a CPU tensor to the
    plain version of the body."""
    if envelope and not envelope_ok(w1, w2):
        raise ValueError(f"the envelope body needs 0 <= w1, w2 <= 1, got w1={w1} w2={w2}")
    if t_abs.device.type == "cuda":
        return _ballistics_cuda(t_abs, z1, z2, m, p, w1, w2, w3, track_peak, envelope)
    if t_abs.device.type == "cpu":
        ref = ballistics_envelope_reference if envelope else ballistics_reference
        return ref(t_abs, z1, z2, m, p, w1=w1, w2=w2, w3=w3, track_peak=track_peak)
    raise ValueError(f"no ballistics for device {t_abs.device}")
