"""Fused STFT analyzer frames: framing, window, real DFT and the per-bin
display analysis of the phase wheel and the stereoscope in one pass.

Counterpart of ``meters_lv2_tpu/ops/pallas_stft.py::analyzer_frames``.  One
call covers one update block of every stereo stream, ext = [tail | block]
[..., 2, W + T], and frames f < F = T // hop, frame f being
ext[..., hop*(f+1) : hop*(f+1) + W] times the window.  Each channel gets
its own real DFT (bins 0..W/2-1) and, per mode, per stream, frame and bin:

  * ``phasewheel``: (dphi, level), dphi = phi_R - phi_L and level =
    max(P_L, P_R) where both powers reach ``thr``, else 0 and -100
    (gui/phasewheel.c:1307-1342);
  * ``stereoscope``: (pos, level), pos = 0.5 + 0.5 (sqrt P_R - sqrt P_L) /
    sqrt(max(level, 1e-30)) and level = max(P_L, P_R) (NaN propagates)
    where either power reaches ``thr``, else 0.5 and 0
    (gui/stereoscope.c:705-741);
  * ``raw``: (re, im), each [..., 2, F, W/2], no boundary-bin handling.

Power follows ft_analyze (fft.c:166-178): bin W/2-1 is 0, and the phase of
bins 0 and W/2-1 is 0.  Both channels are transformed apart, so a NaN or
Inf in one channel never reaches the other's bins.

``analyzer_frames`` launches the hand-written CUDA kernel
(csrc/stft_fused.cu: the Hopper body at W = 8192, the generic body below,
``body``) for CUDA tensors and uses the plain PyTorch version,
``plain_frames`` (frames by ``unfold``, the window, ``torch.fft.rfft``,
the same epilogue), only for tensors on the CPU.  On a CUDA tensor it
launches the kernel or raises; it never falls back.  Two float32 FFTs
differ by rounding (about 1e-7 of the frame's peak magnitude), so the two
agree to a stated tolerance, not bit for bit.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .fft import frames_of, ft_analyze, rfft_halves
from .lti import canonical_device, check_tensor

MODES = {"raw": 0, "phasewheel": 1, "stereoscope": 2}
MIN_W, MAX_W = 256, 8192  # window sizes the kernel is built for (powers of two)
HOPPER_W = 8192  # the analyzers' window: the Hopper body's; smaller ones run the generic body

# Kernel launches since import (or since a caller reset it): a run can
# show that its main path went through the kernel.  Only the CUDA branch
# of analyzer_frames counts.
launch_count = 0

_TWIDDLES: dict[tuple, torch.Tensor] = {}


def twiddles(W: int, device) -> torch.Tensor:
    """[W/2, 2] float32 table of e^{-i pi k / (W/2)}, k < W/2, built in
    float64 on the host and cached per (W, device): the stage twiddles of the
    kernel's W/2-point complex FFT and the real-DFT untangle's W_W^k."""
    device = canonical_device(device)
    key = (W, device)
    if key not in _TWIDDLES:
        n = W // 2
        a = math.pi * np.arange(n, dtype=np.float64) / n
        tw = np.stack([np.cos(a), -np.sin(a)], axis=-1).astype(np.float32)
        _TWIDDLES[key] = torch.as_tensor(tw, device=device)
    return _TWIDDLES[key]


def body(W: int) -> str:
    """The kernel body a window of W runs: "hopper" (W = 8192: per-pass
    twiddle tables, a named barrier a channel, paired bins, one atan2f a
    phase difference) or "generic" (W = 256 .. 4096, the first design)."""
    if W < MIN_W or W > MAX_W or W & (W - 1):
        raise ValueError(f"the kernel takes a power-of-two window of {MIN_W}..{MAX_W}, got {W}")
    return "hopper" if W == HOPPER_W else "generic"


_PASS_TWIDDLES: dict[tuple, torch.Tensor] = {}


def pass_twiddles(W: int, device) -> torch.Tensor:
    """[4080, 2] float32 table of the Hopper body's stage twiddles (W = 8192,
    a 4096-point complex FFT of three radix-16 passes): pass 2's
    e^{-2 pi i r m / 256} at row 16 (r - 1) + m (r = 1..15, m < 16), then
    pass 3's e^{-2 pi i r j / 4096} at row 240 + 256 (r - 1) + j (j < 256),
    so that a warp's load of twiddle r is one contiguous run.  Built in
    float64 on the host and cached per (W, device)."""
    if body(W) != "hopper":
        raise ValueError(f"pass_twiddles is the Hopper body's (W = {HOPPER_W}), got W = {W}")
    device = canonical_device(device)
    key = (W, device)
    if key not in _PASS_TWIDDLES:
        r = np.arange(1, 16, dtype=np.float64)[:, None]
        a2 = 2 * math.pi * r * np.arange(16) / 256
        a3 = 2 * math.pi * r * np.arange(256) / 4096
        a = np.concatenate([a2.ravel(), a3.ravel()])
        tw = np.stack([np.cos(a), -np.sin(a)], axis=-1).astype(np.float32)
        _PASS_TWIDDLES[key] = torch.as_tensor(tw, device=device)
    return _PASS_TWIDDLES[key]


def _check_mode(mode: str) -> None:
    if mode not in MODES:
        raise ValueError(f"mode must be one of {sorted(MODES)}, got {mode!r}")


def analysis(re: torch.Tensor, im: torch.Tensor, mode: str, thr: float):
    """The per-bin epilogue on (re, im) [..., 2, F, D] of both channels."""
    _check_mode(mode)
    if mode == "raw":
        return re, im
    thr = float(np.float32(thr))
    power, phase = ft_analyze(re, im, mode == "phasewheel")
    pl, pr = power[..., 0, :, :], power[..., 1, :, :]
    if mode == "phasewheel":
        ok = (pl >= thr) & (pr >= thr)
        dphi = torch.where(ok, phase[..., 1, :, :] - phase[..., 0, :, :], 0.0)
        return dphi, torch.where(ok, torch.maximum(pl, pr), -100.0)
    lv = torch.maximum(pl, pr)
    ok = (pl >= thr) | (pr >= thr)
    pos = 0.5 + 0.5 * (torch.sqrt(pr) - torch.sqrt(pl)) / torch.sqrt(torch.clamp_min(lv, 1e-30))
    return torch.where(ok, pos, 0.5), torch.where(ok, lv, 0.0)


def plain_frames(ext: torch.Tensor, win: torch.Tensor, hop: int, mode: str, thr: float):
    """Plain PyTorch version of the kernel, arguments and returns as
    ``analyzer_frames``."""
    if ext.ndim < 2 or ext.shape[-2] != 2:
        raise ValueError(f"ext must be [..., 2, W + T], got {tuple(ext.shape)}")
    W = win.shape[-1]
    frames = frames_of(ext, W, hop) * win  # [..., 2, F, W]
    return analysis(*rfft_halves(frames), mode, thr)


def _analyzer_frames_cuda(ext, win, hop, mode, thr):
    global launch_count
    from ..runtime import build

    device = canonical_device(ext.device)
    if ext.ndim < 2 or ext.shape[-2] != 2:
        raise ValueError(f"ext must be [..., 2, W + T], got {tuple(ext.shape)}")
    if not ext.is_contiguous():
        raise ValueError("ext must be contiguous")
    *batch, _, L = ext.shape
    W = win.shape[-1]
    hopper = body(W) == "hopper"
    if hop < 1:
        raise ValueError(f"hop must be positive, got {hop}")
    F = (L - W) // hop
    B = math.prod(batch)
    if F < 1 or B < 1:
        raise ValueError(f"ext {tuple(ext.shape)} holds no frame of {W} at hop {hop}")
    if 2 * B * L >= 2**31 or B * F >= 2**31:
        raise ValueError(f"ext {tuple(ext.shape)} is too large for one launch")
    ext3 = ext.reshape(B, 2, L)
    check_tensor("ext", ext3, (B, 2, L), device)
    check_tensor("win", win, (W,), device)
    if win.data_ptr() % 8:
        raise ValueError("win must be 8-byte aligned (the kernel reads float2)")
    tw = twiddles(W, device)
    ptw = pass_twiddles(W, device).data_ptr() if hopper else None
    D = W // 2
    oshape = (B, 2, F, D) if mode == "raw" else (B, F, D)
    out_a = torch.empty(oshape, dtype=torch.float32, device=device)
    out_b = torch.empty(oshape, dtype=torch.float32, device=device)
    lib = build.kernels()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = lib.stft_fused_launch(
            ext3.data_ptr(), win.data_ptr(), tw.data_ptr(), ptw, B, L, W, hop, F, MODES[mode],
            float(np.float32(thr)), out_a.data_ptr(), out_b.data_ptr(), stream,
        )
    build.check(lib, rc, "stft_fused_launch")
    launch_count += 1
    lead = (*batch, 2, F, D) if mode == "raw" else (*batch, F, D)
    return out_a.reshape(lead), out_b.reshape(lead)


def analyzer_frames(ext: torch.Tensor, win: torch.Tensor, hop: int, mode: str, thr: float):
    """Per-frame display quantities for one update block.

    Args:
      ext:  [..., 2, L] float32 sample stream (carried tail + new block);
            F = (L - W) // hop frames.
      win:  [W] float32 analysis window (fft.make_window) on ext's device;
            the kernel takes a power of two W from 256 to 8192.
      hop:  frame hop (any positive integer).
      mode: 'phasewheel', 'stereoscope' or 'raw' (see the module docstring).
      thr:  power threshold of the ok-test (used as float32).

    Returns two [..., F, W/2] tensors ([..., 2, F, W/2] in raw mode), in
    bin order.  A CUDA tensor goes to the CUDA kernel, which also needs
    contiguous float32 inputs on one card; a CPU tensor goes to the plain
    version.
    """
    _check_mode(mode)
    if ext.device.type == "cuda":
        return _analyzer_frames_cuda(ext, win, hop, mode, thr)
    if ext.device.type == "cpu":
        return plain_frames(ext, win, hop, mode, thr)
    raise ValueError(f"no analyzer_frames for device {ext.device}")
