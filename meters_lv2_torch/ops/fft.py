"""Streaming STFT analysis engine (the capability of gui/fft.c).

Counterpart of ``meters_lv2_tpu/ops/fft.py``.  The reference keeps a ring
buffer and runs one FFTW r2hc transform whenever ``hop = ceil(rate/fps)``
new samples have arrived (fft.c:209-237, 284-340).  Here a whole block of
frames is analysed at once: the frames are an ``unfold`` view of
[tail | block], the transform is ``torch.fft.rfft`` over [frames, window]
(the JAX package computes it outside any kernel with ``jnp.fft.rfft``),
and power and phase follow the reference's ft_analyze (fft.c:163-180):
power[0] = Re0^2, bins 1..W/2-2 get Re^2 + Im^2 and atan2(Im, Re); bin
W/2-1 stays 0.

The display analyzers (models/phasewheel.py) do not come through here:
their frames, transform and per-bin analysis are one kernel
(ops/stft_fused.py).  Window functions and their 2/sum normalisation
follow fft.c:84-161.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from .lti import canonical_device

WINDOW_TYPES = (
    "hann",
    "hamming",
    "nuttall",
    "blackman_nuttall",
    "blackman_harris",
    "flat_top",
)


def make_window(kind: str, n: int) -> np.ndarray:
    """Analysis window, normalised so sum(w) = 2 (fft.c:154-158); float64."""
    i = np.arange(n, dtype=np.float64)
    c = 2.0 * math.pi * i / (n - 1.0)
    if kind == "hann":
        w = 0.5 - 0.5 * np.cos(c)
    elif kind == "hamming":
        w = 0.54 - 0.46 * np.cos(c)
    elif kind == "nuttall":
        a = (0.355768, 0.487396, 0.144232, 0.012604)
        w = a[0] - a[1] * np.cos(c) + a[2] * np.cos(2 * c) - a[3] * np.cos(3 * c)
    elif kind == "blackman_nuttall":
        a = (0.3635819, 0.4891775, 0.1365995, 0.0106411)
        w = a[0] - a[1] * np.cos(c) + a[2] * np.cos(2 * c) - a[3] * np.cos(3 * c)
    elif kind == "blackman_harris":
        a = (0.35875, 0.48829, 0.14128, 0.01168)
        w = a[0] - a[1] * np.cos(c) + a[2] * np.cos(2 * c) - a[3] * np.cos(3 * c)
    elif kind == "flat_top":
        w = (
            1.0
            - 1.93 * np.cos(c)
            + 1.29 * np.cos(2 * c)
            - 0.388 * np.cos(3 * c)
            + 0.028 * np.cos(4 * c)
        )
    else:
        raise KeyError(kind)
    return (w * (2.0 / w.sum())).astype(np.float64)


@dataclasses.dataclass(frozen=True)
class STFTState:
    """Carried ring of the last window_size samples + analysis history."""

    tail: torch.Tensor  # [..., W] last W input samples (oldest first)
    phase_h: torch.Tensor  # [..., W//2] phase of the previous analysis


def frames_of(ext: torch.Tensor, W: int, hop: int) -> torch.Tensor:
    """Frame f = ext[..., hop*(f+1) : hop*(f+1) + W] for f < F = (L - W) // hop,
    as a [..., F, W] view of ext [..., L]."""
    F = (ext.shape[-1] - W) // hop
    if F < 1:
        raise ValueError(f"{ext.shape[-1]} samples hold no frame of {W} at hop {hop}")
    return ext.unfold(-1, W, hop)[..., 1 : F + 1, :]


def rfft_halves(frames: torch.Tensor):
    """(re, im) of the first W/2 rfft bins of [..., W] frames."""
    X = torch.fft.rfft(frames, dim=-1)[..., : frames.shape[-1] // 2]
    return X.real.contiguous(), X.imag.contiguous()


def ft_analyze(re: torch.Tensor, im: torch.Tensor, compute_phase: bool = True):
    """(power, phase | None) of (re, im) [..., D] with ft_analyze's edge
    rules (fft.c:166-178): the power of bin D-1 is 0, and the phase of bins
    0 and D-1 is 0."""
    D = re.shape[-1]
    power = re * re + im * im
    power[..., D - 1] = 0.0
    if not compute_phase:
        return power, None
    phase = torch.atan2(im, re)
    phase[..., 0] = 0.0
    phase[..., D - 1] = 0.0
    return power, phase


class STFT:
    """Fixed-hop streaming STFT.

    The reference hop is quantised to its process() call boundaries; here
    frames fall at exact multiples of ``hop``: the same analysis rate with
    regular placement.  update() blocks must be multiples of hop.
    """

    def __init__(
        self,
        rate: float,
        window_size: int = 8192,
        fps: float = 25.0,
        window: str = "hann",
    ):
        self.rate = float(rate)
        self.window_size = int(window_size)
        self.data_size = self.window_size // 2
        self.hop = int(math.ceil(rate / fps)) if fps > 0 else self.window_size
        self.window_np = make_window(window, self.window_size).astype(np.float32)
        self.freq_per_bin = self.rate / self.data_size / 2.0
        self.phasediff_step = math.pi / self.data_size
        self._win: dict[torch.device, torch.Tensor] = {}

    def win(self, device) -> torch.Tensor:
        """The float32 window [W] on ``device``, cached."""
        device = canonical_device(device)
        if device not in self._win:
            self._win[device] = torch.as_tensor(self.window_np, device=device)
        return self._win[device]

    def init(self, batch_shape=(), device="cuda") -> STFTState:
        batch_shape = tuple(batch_shape)
        return STFTState(
            tail=torch.zeros((*batch_shape, self.window_size), dtype=torch.float32, device=device),
            phase_h=torch.zeros((*batch_shape, self.data_size), dtype=torch.float32,
                                device=device),
        )

    def frames_in(self, T: int) -> int:
        if T % self.hop:
            raise ValueError(f"block of {T} samples is not a multiple of the hop {self.hop}")
        return T // self.hop

    def update(self, state: STFTState, x: torch.Tensor, compute_phase: bool = True):
        """x: [..., T], T % hop == 0.

        Returns (power [..., F, W/2], phase [..., F, W/2] | None, new_state)
        where F = T // hop; frame f covers the window ending at sample
        (f+1)*hop.  With compute_phase=False the phase is None and phase_h
        is carried unchanged.
        """
        self.frames_in(x.shape[-1])
        W = self.window_size
        ext = torch.cat([state.tail, x.to(torch.float32)], dim=-1)  # [..., W + T]
        frames = frames_of(ext, W, self.hop) * self.win(x.device)
        power, phase = ft_analyze(*rfft_halves(frames), compute_phase)  # [..., F, W/2]
        phase_h = phase[..., -1, :].clone() if compute_phase else state.phase_h
        return power, phase, STFTState(tail=ext[..., -W:].contiguous(), phase_h=phase_h)

    def update_stereo(self, state: STFTState, x: torch.Tensor):
        """update() for a stereo pair with ONE complex FFT for both channels
        (Z = fft(l + i r), L_k = (Z_k + conj(Z_{-k}))/2,
        R_k = -i (Z_k - conj(Z_{-k}))/2).

        state: STFTState with a trailing channel batch dim of 2 (as
        init((*batch, 2))); x: [..., 2, T].  Returns the same (power, phase,
        state) as update(), channel axis at -3 of the frame outputs.  A NaN
        or Inf in one channel reaches the other's bins through the shared
        transform.
        """
        if x.shape[-2] != 2:
            raise ValueError(f"x must be [..., 2, T], got {tuple(x.shape)}")
        self.frames_in(x.shape[-1])
        W, H = self.window_size, self.data_size
        ext = torch.cat([state.tail, x.to(torch.float32)], dim=-1)  # [..., 2, W + T]
        frames = frames_of(ext, W, self.hop) * self.win(x.device)  # [..., 2, F, W]
        Z = torch.fft.fft(torch.complex(frames[..., 0, :, :], frames[..., 1, :, :]), dim=-1)
        Zk = Z[..., : H + 1]
        # conj(Z_{-k}) for k = 0..W/2  (Z_{-0} = Z_0)
        Zr = torch.cat([Z[..., :1], torch.flip(Z[..., W - H :], dims=(-1,))], dim=-1).conj()
        L = 0.5 * (Zk + Zr)
        R = -0.5j * (Zk - Zr)
        X = torch.stack([L, R], dim=-3)  # [..., 2, F, W/2+1]
        power, phase = ft_analyze(X.real[..., :H], X.imag[..., :H])
        return power, phase, STFTState(tail=ext[..., -W:].contiguous(),
                                       phase_h=phase[..., -1, :].clone())

    def analyze_impulse(self, run_fn, prerun: int = 8192, device="cuda"):
        """Transfer-function self-analysis (fa_analyze_dsp, fft.c:363-387):
        pre-feed ``prerun`` zeros through run_fn (flushes filter state), then
        a unit impulse, and analyse the response, unwindowed.

        run_fn: callable(block [T]) -> processed block [T].  Returns
        (power [W/2], phase [W/2]).
        """
        W, D = self.window_size, self.data_size
        n = 0
        while n < prerun:
            step = min(prerun - n, W)
            run_fn(torch.zeros(step, dtype=torch.float32, device=device))
            n += step
        buf = torch.zeros(W, dtype=torch.float32, device=device)
        buf[0] = 1.0
        y = run_fn(buf)
        # no analysis window: fa_analyze_dsp fills fft_in directly and calls
        # ft_analyze, skipping the window multiply (fft.c:363-387)
        X = torch.fft.rfft(y, dim=-1)
        re, im = X.real, X.imag
        return (re * re + im * im)[:D], torch.atan2(im, re)[:D]

    def freq_at_bin(self, phase: torch.Tensor, phase_h: torch.Tensor, step: int) -> torch.Tensor:
        """Phase-derivative instantaneous-frequency estimate
        (fftx_freq_at_bin, fft.c:448-461), vectorised over bins [..., W/2]."""
        from .hist import float_to_int32

        b = torch.arange(phase.shape[-1], dtype=torch.float32, device=phase.device)
        dp = phase - phase_h - b * (self.phasediff_step * step)
        over = float_to_int32(dp / math.pi)
        over = over + torch.where(over >= 0, over & 1, -(over & 1))
        dp = dp - math.pi * over.to(torch.float32)
        dp = dp * (self.data_size / step) / math.pi
        return self.freq_per_bin * (b + dp)
