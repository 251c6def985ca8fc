"""Phase wheel and stereoscope: per-bin inter-channel phase or left/right
position against level at ~25 fps.

Counterpart of ``meters_lv2_tpu/models/phasewheel.py``.  Reference:
src/xfer.c (the plugin ships raw audio and runs a Stcorrdsp) and
gui/phasewheel.c:1307-1342 (process_audio): two synchronised STFTs
(8192-point Hann), per bin dphi = phi_R - phi_L and level = max(P_L, P_R)
where both powers reach the threshold; the display peak smoothed by
0.04 a frame; a stereo correlation strip from the Stcorrdsp.  The
stereoscope (gui/stereoscope.c:705-741) reads lr = .5 + .5 (sqrt P_R -
sqrt P_L) / sqrt max and the level, both smoothed 0.1 a frame.

Both meters take their frames, transform and per-bin analysis from
ops.stft_fused.analyzer_frames: the CUDA kernel (csrc/stft_fused.cu) on a
card, its plain PyTorch version on the CPU.  As on the JAX package's kernel
path, the carried ``STFTState.phase_h`` passes through unchanged (nothing
downstream of the analyzers reads it).  The frame-rate smoothing is glue:
a loop over the block's frames.
"""

from __future__ import annotations

import dataclasses

import torch

from ..ops import fft as fft_ops
from ..ops import stft_fused
from ..ops.lti import matmul
from .base import register
from .cor import CorrelationMeter, CorState

_F32 = torch.float32


@dataclasses.dataclass(frozen=True)
class PhaseWheelState:
    stft: fft_ops.STFTState  # batched over [..., 2] channels
    peak: torch.Tensor  # [...] smoothed display peak (power)
    cor: CorState


def _ext(stft: fft_ops.STFT, st: fft_ops.STFTState, lr: torch.Tensor):
    """(ext = [tail | block] [..., 2, W + T], the carried STFT state)."""
    if lr.ndim < 2 or lr.shape[-2] != 2:
        raise ValueError(f"lr must be [..., 2, T], got {tuple(lr.shape)}")
    stft.frames_in(lr.shape[-1])
    ext = torch.cat([st.tail, lr.to(_F32)], dim=-1)
    W = stft.window_size
    return ext, fft_ops.STFTState(tail=ext[..., -W:].contiguous(), phase_h=st.phase_h)


@register("phasewheel")
class PhaseWheel:
    def __init__(
        self,
        fs: float,
        bins: int = 4096,  # data_size; window = 2*bins (phasewheel.c:178-197)
        fps: float = 25.0,
        db_thresh_db: float = -60.0,
    ):
        self.fs = float(fs)
        self.stft = fft_ops.STFT(fs, 2 * bins, fps, "hann")
        self.bins = bins
        self.db_thresh = 10.0 ** (db_thresh_db / 10.0)  # power threshold
        self.cor = CorrelationMeter(fs)

    def init(self, batch_shape=(), device="cuda") -> PhaseWheelState:
        batch_shape = tuple(batch_shape)
        return PhaseWheelState(
            stft=self.stft.init((*batch_shape, 2), device),
            peak=torch.zeros(batch_shape, dtype=_F32, device=device),
            cor=self.cor.init(batch_shape, device),
        )

    def process(self, state: PhaseWheelState, lr: torch.Tensor):
        """lr: [..., 2, T], T % hop == 0.

        Returns ({'phase', 'level', 'peak', 'correlation'}, state):
        phase/level are [..., F, bins] per analysis frame (level in power,
        -100 below the threshold like phasewheel.c:1317-1323)."""
        ext, stft_st = _ext(self.stft, state.stft, lr)
        dphi, level = stft_fused.analyzer_frames(
            ext, self.stft.win(ext.device), self.stft.hop, "phasewheel", self.db_thresh)
        # frame-rate peak smoothing (phasewheel.c:1333-1338); level is
        # linear power (>= 0 where ok, the -100 marker elsewhere), so the
        # 0-floor max equals the ok-masked max
        fpk = torch.amax(torch.clamp_min(level, 0.0), dim=-1)  # [..., F]
        peak = state.peak
        for f in range(fpk.shape[-1]):
            peak = peak + 0.04 * (fpk[..., f] - peak) + 1e-15
            peak = torch.clamp_max(torch.where(torch.isnan(peak), 0.0, peak), 1000.0)
        cor_st = self.cor.update(state.cor, lr)
        corr, cor_st = self.cor.read(cor_st)
        new = PhaseWheelState(stft=stft_st, peak=peak, cor=cor_st)
        return {"phase": dphi, "level": level, "peak": peak, "correlation": corr}, new


def octave_bands(phase: torch.Tensor, level: torch.Tensor, freq_per_bin: float,
                 n_octaves: int = 12):
    """Octave-band aggregation by vector-averaged phase
    (gui/phasewheel.c:609-672): band phase = atan2(sum sin(phi) w,
    sum cos(phi) w) with level weights, log-frequency bands."""
    nbins = phase.shape[-1]
    dev = phase.device
    freqs = torch.arange(nbins, device=dev) * freq_per_bin
    edges = 20.0 * 2.0 ** torch.arange(n_octaves + 1, device=dev)
    band = torch.clamp(
        torch.searchsorted(edges, torch.clamp_min(freqs, 1e-3)) - 1, 0, n_octaves - 1)
    onehot = torch.nn.functional.one_hot(band, n_octaves).to(phase.dtype)
    w = torch.clamp_min(level, 0.0)
    s = matmul(w * torch.sin(phase), onehot)
    c = matmul(w * torch.cos(phase), onehot)
    lv = matmul(w, onehot)
    return torch.atan2(s, c), lv


# the stereoscope's state: a dict as the JAX package keeps it; each key with
# the class of its value (utils/interop carries it by this map)
STEREOSCOPE_STATE = {"stft": fft_ops.STFTState, "level": torch.Tensor, "lr": torch.Tensor}


@register("stereoscope")
class Stereoscope:
    """Stereoscope: per-bin left/right position against level.

    Reference: gui/stereoscope.c:705-741: lr = .5 + .5 (sqrt P_R -
    sqrt P_L) / sqrt max, smoothed 0.1 a frame; level smoothed 0.1 a
    frame (+1e-20); bins below the threshold snap to 0.5 and 0.
    """

    thresh = 1e-20

    def __init__(self, fs: float, bins: int = 4096, fps: float = 25.0):
        self.fs = float(fs)
        self.stft = fft_ops.STFT(fs, 2 * bins, fps, "hann")
        self.bins = bins

    def init(self, batch_shape=(), device="cuda"):
        batch_shape = tuple(batch_shape)
        return {
            "stft": self.stft.init((*batch_shape, 2), device),
            "level": torch.zeros((*batch_shape, self.bins), dtype=_F32, device=device),
            "lr": torch.full((*batch_shape, self.bins), 0.5, dtype=_F32, device=device),
        }

    def process(self, state, lr: torch.Tensor):
        """lr: [..., 2, T] -> ({'lr', 'level'} smoothed up to the block's
        last frame, state)."""
        ext, stft_st = _ext(self.stft, state["stft"], lr)
        pos, tgt_lv = stft_fused.analyzer_frames(
            ext, self.stft.win(ext.device), self.stft.hop, "stereoscope", self.thresh)
        # where either power reaches the threshold the target level is
        # max(P_L, P_R) >= 1e-20 or NaN, elsewhere exactly 0
        ok = tgt_lv != 0.0
        level, lrp = state["level"], state["lr"]
        for f in range(pos.shape[-2]):
            ok_f = ok[..., f, :]
            level = level + torch.where(ok_f, 0.1 * (tgt_lv[..., f, :] - level) + 1e-20, 0.0)
            lrp = lrp + torch.where(ok_f, 0.1 * (pos[..., f, :] - lrp) + 1e-10, 0.0)
            # below-threshold bins snap (stereoscope.c:716-719)
            level = torch.where(ok_f, level, 0.0)
            lrp = torch.where(ok_f, lrp, 0.5)
        new = {"stft": stft_st, "level": level, "lr": lrp}
        return {"lr": lrp, "level": level}, new
