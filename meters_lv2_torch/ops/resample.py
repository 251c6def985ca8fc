"""Polyphase oversampling as batched block matmuls: 4x for true-peak
detection, 1/2/4/8x for the goniometer's trace, and the arbitrary-ratio
resampler of mixed-rate ingest.  Counterpart of
``meters_lv2_tpu/ops/resample.py``.

The oversampled stream is

    up[4*t + ph] = sum_{i=0}^{47} taps[ph, i] * x[t - 47 + i]

(see ops/design.upsample4_kernel).  Phase 0 is a pure hl-sample delay, so
the reference's alignment, including its zero prefeed at init
(truepeakdsp.cc:159-168), is reproduced by zero history at stream start.
The 47-sample input history is carried across blocks for streaming use.

Each 128-sample block is one overlapping frame of 47 + 128 inputs times a
dense [175, 512] block matrix, exactly as the JAX package evaluates it.
One consequence is kept on purpose: a non-finite input sample meets the
matrix's zeros (x * 0 = NaN), so it turns every oversample of its frame
that it does not feed into NaN, and NaN oversamples are skipped.  The CUDA
kernel (csrc/r128_fused.cu) reproduces that rule.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from .design import rational_resample_kernel, upsample4_kernel, upsample_poly_kernel
from .lti import canonical_device, matmul

_HL = 24  # zita half-length: 48 taps, 47 samples of history

_BLOCK_MATS: dict[tuple, np.ndarray] = {}
_BLOCK_MATS_ON: dict[tuple, torch.Tensor] = {}
_TAPS_HOST = None


def upsample4_taps() -> np.ndarray:
    """[4, 48] float32 phase filters (float64 design)."""
    return upsample4_kernel(_HL).astype(np.float32)


def upsample4_taps_host() -> ctypes.Array:
    """upsample4_taps() as a host float[192], cached: what the CUDA
    launchers copy into their kernels' parameters."""
    global _TAPS_HOST
    if _TAPS_HOST is None:
        _TAPS_HOST = (ctypes.c_float * 192)(*upsample4_taps().reshape(-1).tolist())
    return _TAPS_HOST


def _block_matrix(taps: np.ndarray, tb: int) -> np.ndarray:
    """Dense block operator M [tb + K - 1, factor*tb] with
    M[j+i, factor*j + ph] = taps[ph, i]: one matmul produces factor*tb
    outputs from tb inputs + (K-1)-sample halo."""
    factor, K = taps.shape
    key = (taps.tobytes(), tb)
    if key not in _BLOCK_MATS:
        M = np.zeros((tb + K - 1, factor * tb), np.float32)
        for j in range(tb):
            for ph in range(factor):
                M[j : j + K, factor * j + ph] = taps[ph]
        _BLOCK_MATS[key] = M
    return _BLOCK_MATS[key]


def _block_matrix_on(taps: np.ndarray, tb: int, device) -> torch.Tensor:
    device = canonical_device(device)
    key = (taps.tobytes(), tb, device)
    if key not in _BLOCK_MATS_ON:
        _BLOCK_MATS_ON[key] = torch.as_tensor(
            _block_matrix(taps, tb), device=device
        )
    return _BLOCK_MATS_ON[key]


def _frames(xp: torch.Tensor, T: int, nh: int, tb: int = 128):
    """Yield (frames [..., nblk, step + nh], step) for the main run of
    tb-sample blocks and one remainder block over xp = [hist ++ x]."""
    *batch, _ = xp.shape
    main = (T // tb) * tb
    segments = []
    if main:
        segments.append((0, main, tb))
    if T - main:
        segments.append((main, T, T - main))
    for start, end, step in segments:
        seg = xp[..., start : end + nh]  # [..., L + nh]
        L = end - start
        nblk = L // step
        blocks = seg[..., :L].reshape(*batch, nblk, step)
        tail = seg[..., L:][..., None, :]  # [..., 1, nh]
        if step >= nh:
            heads = torch.cat([blocks[..., 1:, :nh], tail], dim=-2)
        else:
            # step < nh: heads overlap several blocks
            heads = torch.stack(
                [seg[..., (n + 1) * step : (n + 1) * step + nh]
                 for n in range(nblk)],
                dim=-2,
            )
        yield torch.cat([blocks, heads], dim=-1), step


def _upsample_blocked(
    x: torch.Tensor, hist: torch.Tensor, taps_np: np.ndarray, tb: int = 128
) -> tuple[torch.Tensor, torch.Tensor]:
    """x [..., T], hist [..., K-1] -> (up [..., factor*T], new_hist)."""
    factor, K = taps_np.shape
    nh = K - 1
    *batch, T = x.shape
    xp = torch.cat([hist, x], dim=-1)  # [..., nh + T]
    outs = []
    for frames, step in _frames(xp, T, nh, tb):
        M = _block_matrix_on(taps_np, step, x.device)
        y = matmul(frames, M)
        outs.append(y.reshape(*batch, -1))
    up = outs[0] if len(outs) == 1 else torch.cat(outs, dim=-1)
    return up, xp[..., -nh:]


def upsample4_absmax(
    x: torch.Tensor, hist: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """max |4x-oversampled stream| over the block, reduced per frame matmul
    (the full 4T stream is never assembled).  TruePeakdsp::process_max
    (truepeakdsp.cc:109-131) over one block.  Returns (absmax [...],
    new_hist)."""
    taps_np = upsample4_taps()
    nh = taps_np.shape[1] - 1
    *batch, T = x.shape
    xp = torch.cat([hist, x], dim=-1)
    best = torch.zeros(batch, dtype=x.dtype, device=x.device)
    for frames, step in _frames(xp, T, nh):
        M = _block_matrix_on(taps_np, step, x.device)
        av = matmul(frames, M).abs()
        # reference `if (v > m) m = v` (truepeakdsp.cc:111-122): NaN
        # comparisons are false, so NaN oversamples are skipped, not
        # propagated (0 is the max identity here; +/-Inf still registers)
        av = torch.where(torch.isnan(av), 0.0, av)
        best = torch.maximum(best, av.amax(dim=(-2, -1)))
    return best, xp[..., -nh:]


def upsample4(
    x: torch.Tensor, hist: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """Upsample a block 4x.

    Args:
      x: [..., T] input block.
      hist: [..., 47] carried history (zeros at stream start).

    Returns:
      (up, new_hist): up [..., 4*T] oversampled stream aligned like the
      reference (up[4t+ph] uses inputs ... x[t]); new_hist [..., 47].
    """
    return _upsample_blocked(x, hist, upsample4_taps())


def upsample_taps(factor: int, hl: int) -> np.ndarray:
    """[factor, 2*hl] float32 polyphase filters for integer-factor
    oversampling (float64 design)."""
    return upsample_poly_kernel(factor, hl).astype(np.float32)


def upsample_init(batch_shape=(), hl: int = _HL, device="cuda") -> torch.Tensor:
    """History buffer of 2*hl-1 zeros (equivalent to the zero prefeed)."""
    return torch.zeros((*tuple(batch_shape), 2 * hl - 1), dtype=torch.float32, device=device)


def upsample4_init(batch_shape=(), dtype=torch.float32, device="cuda") -> torch.Tensor:
    """The 4x true-peak upsampler's history: 2*24-1 = 47 zeros (equivalent
    to the zero prefeed)."""
    return torch.zeros((*tuple(batch_shape), 2 * _HL - 1), dtype=dtype, device=device)


def upsample(x: torch.Tensor, hist: torch.Tensor, taps) -> tuple[torch.Tensor, torch.Tensor]:
    """Integer-factor polyphase upsampling (generalises upsample4).

    x [..., T], hist [..., 2*hl-1], taps [factor, 2*hl] (numpy or tensor)
    -> (up [..., factor*T], new_hist).  The goniometer's optional 2x/4x/8x
    oversampling (gui/goniometer.c:155-189, hlen=12).
    """
    if isinstance(taps, torch.Tensor):
        taps = taps.detach().cpu().numpy()
    return _upsample_blocked(x, hist, np.asarray(taps, np.float32))


def composed_smooth_taps(
    taps_np: np.ndarray, hpw: float, n_sm: int = 4
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Fold a one-pole smoother into polyphase upsampling taps (float64 on
    the host).

    The goniometer's trace smoother ``lp += hpw*(d - lp)``
    (gui/goniometer.c:400-409) runs on the oversampled stream, but its pole
    (1-hpw) ~ 3e-4 .. 3e-3 is near-memoryless: to below an f32 ulp it is the
    ``n_sm``-tap FIR sm[k] = hpw (1-hpw)^k (residual (1-hpw)^n_sm <= ~1e-10
    of the signal).  Convolved into the upsampling taps, oversampling and
    smoothing become one overlapping-block matmul.

    Outputs t < n_sm-1 of a block need oversampled samples from before the
    block; the caller evaluates them by the exact recurrence identity

        trace_t = sum_{k<=t} sm[k] d_{t-k} + (1-hpw)^(t+1) s0

    with s0 the carried smoother state; C/pow below give that row form over
    the window [hist(K-1) | x_0 x_1].

    Returns (taps_c [os, nh'+1], C [n_sm-1, K+1], pow [n_sm-1]), float32;
    taps_c feeds ``_block_matrix`` with nh' = (os*K + n_sm - 2)//os history
    samples (os > 1 callers zero-pad the K-1-sample history on the left;
    the pad corrupts exactly the outputs C replaces).
    """
    os_, K = np.asarray(taps_np).shape
    nh = K - 1
    t64 = np.asarray(taps_np, np.float64)
    sm = float(hpw) * (1.0 - float(hpw)) ** np.arange(n_sm, dtype=np.float64)
    # oversampled-domain impulse response: H[ph + os*(nh - i)] = taps[ph, i]
    H = np.zeros(os_ * K, np.float64)
    for ph in range(os_):
        for i in range(K):
            H[ph + os_ * (nh - i)] = t64[ph, i]
    Hc = np.convolve(H, sm)
    nmax = len(Hc) - 1
    nhp = nmax // os_
    taps_c = np.zeros((os_, nhp + 1), np.float64)
    for ph in range(os_):
        for ip in range(nhp + 1):
            n = ph + os_ * (nhp - ip)
            if 0 <= n <= nmax:
                taps_c[ph, ip] = Hc[n]
    # exact first-output rows over [hist(nh) | x_0 x_1]
    C = np.zeros((n_sm - 1, K + 1), np.float64)
    for m in range(n_sm - 1):
        for k in range(m + 1):
            j, php = divmod(m - k, os_)  # d_{m-k}: input j, phase php
            for i in range(K):
                col = j + i
                if 0 <= col <= K:
                    C[m, col] += sm[k] * t64[php, i]
    powv = (1.0 - float(hpw)) ** np.arange(1, n_sm, dtype=np.float64)
    return (
        taps_c.astype(np.float32),
        C.astype(np.float32),
        powv.astype(np.float32),
    )


class RationalResampler:
    """Arbitrary-ratio polyphase resampler, zita-equivalent, as cycle GEMMs.

    The reference's generic Resampler (resampler.cc:67-120,171-262) handles
    any fs_in -> fs_out.  With n = fs_out/gcd phases and s = fs_in/gcd
    inputs a cycle, every cycle of n outputs is one product of an
    overlapping input frame [s + 2h - 1] with a dense [F, n] matrix: all
    cycles batch into one matrix product (``lti.matmul``, IEEE fp32).

    Streaming: apply() carries a 2h-1 sample history; a fresh (zeros)
    history reproduces the reference primed with 2h-1 zero samples.
    """

    def __init__(self, fs_in: int, fs_out: int, hl: int = 32, frel: float | None = None):
        W, n, s, h = rational_resample_kernel(fs_in, fs_out, hl, frel)
        self.fs_in, self.fs_out = int(fs_in), int(fs_out)
        self.n, self.s, self.h = n, s, h
        self.nh = 2 * h - 1
        self.F = s + self.nh  # frame length a cycle
        Wc = np.zeros((self.F, n), np.float32)
        for p in range(n):
            b = (p * s) // n
            Wc[b : b + 2 * h, p] = W[p]
        self._Wc = Wc
        self._Wc_on: dict[torch.device, torch.Tensor] = {}

    def init(self, batch_shape=(), device="cuda") -> torch.Tensor:
        return torch.zeros((*tuple(batch_shape), self.nh), dtype=torch.float32, device=device)

    def _matrix(self, device) -> torch.Tensor:
        device = canonical_device(device)
        if device not in self._Wc_on:
            self._Wc_on[device] = torch.as_tensor(self._Wc, device=device)
        return self._Wc_on[device]

    def apply(self, x: torch.Tensor, hist: torch.Tensor):
        """x [..., T] (T % s == 0), hist [..., 2h-1] ->
        (y [..., T*n/s], new_hist)."""
        *batch, T = x.shape
        s, nh = self.s, self.nh
        if T % s:
            raise ValueError(f"block length {T} is not a multiple of {s} inputs a cycle")
        ncyc = T // s
        z = torch.cat([hist, x.to(torch.float32)], dim=-1)  # [..., nh + T]
        if ncyc == 0:
            return z.new_zeros((*batch, 0)), z[..., -nh:]
        blocks = z[..., nh:].reshape(*batch, ncyc, s)
        if s >= nh:
            # the head of cycle c (z[c*s : c*s+nh]) is the tail of block
            # c-1; cycle 0's head is the carried history
            heads = torch.cat([z[..., None, :nh], blocks[..., :-1, s - nh:]], dim=-2)
        else:
            # nh spans several blocks: ceil(nh/s) shifted reshapes of z
            cols = []
            done = 0
            while done < nh:
                w = min(s, nh - done)
                seg = z[..., done : done + ncyc * s].reshape(*batch, ncyc, s)
                cols.append(seg[..., :w])
                done += w
            heads = torch.cat(cols, dim=-1)
        frames = torch.cat([heads, blocks], dim=-1)  # [..., ncyc, F] = z[c*s : c*s + F]
        y = matmul(frames, self._matrix(x.device))
        return y.reshape(*batch, ncyc * self.n), z[..., -nh:]


@functools.lru_cache(maxsize=32)
def _resampler(fs_in: int, fs_out: int, hl: int) -> RationalResampler:
    return RationalResampler(fs_in, fs_out, hl)


def resample_signal(x: torch.Tensor, fs_in: int, fs_out: int, hl: int = 32) -> torch.Tensor:
    """Resample [..., T] from fs_in to fs_out on x's device.

    Pads the tail with zeros to a whole number of polyphase cycles; returns
    [..., ceil(T/s)*n] samples (the first T*fs_out/fs_in are the signal,
    offset by the resampler's h-sample group delay).  The resampler of a
    rate pair is designed once (a few ms on the host) and kept."""
    if fs_in == fs_out:
        return x
    rs = _resampler(int(fs_in), int(fs_out), int(hl))
    pad = (-x.shape[-1]) % rs.s
    if pad:
        x = torch.nn.functional.pad(x.to(torch.float32), (0, pad))
    y, _ = rs.apply(x, rs.init(x.shape[:-1], device=x.device))
    return y
