"""Whole-file 30-band spectrum analysis over a ('dp', 'sp') mesh
(counterpart of ``meters_lv2_tpu/parallel/spectrum_sharded.py``).

The filter bank is a banked linear recurrence, so a file's timeline splits
over 'sp' ranks as the R128 K-weighting does (parallel.timepar): one
all_gather of [nsp, b, 30, 12] zero-state responses composes every
shard's entry state.  The display smoother is a per-band one-pole, also
linear: its value chains across shards through the scalar factor
(1 - w)^L, and the peak-hold combines with pmax.  This runs the banked
LTI and the runtime-omega one-pole of ops.lti, as the JAX module runs its
plain route: no kernel.  It holds four [b, 30, L] float32 intermediates
a rank.

The readout matches a serial SpectrumAnalyzer run over the whole file: the
same smoothed series, peak-hold and final state (the per-update 1e-20
denormal offset applied once, as one serial update() would).
"""

from __future__ import annotations

import torch

from ..models.spectrum import N_BANDS, SpectrumAnalyzer, SpectrumState
from ..ops import lti
from .timepar import banked_lti_apply_sp

_F32 = torch.float32


def _analyze_shard(meter: SpectrumAnalyzer, x: torch.Tensor, omega: torch.Tensor, sp):
    """Per-rank body; x: [b, L] (downmixed)."""
    B, Tl = x.shape
    v, zf = banked_lti_apply_sp(meter.bank, x, meter.bank.init((B,), x.device), sp)
    sq = torch.square(v)  # [B, 30, Tl]

    # smoother: a local zero-state pass, then the values chain across shards
    # by v_in[k] = sum_{i<k} b[i] (1-w)^(L (k-1-i)) (a fresh serial meter
    # starts from 0)
    vs, vloc = lti.one_pole_apply_traced(
        omega, sq, torch.zeros((B, N_BANDS, 1), dtype=_F32, device=x.device))
    l1 = torch.log1p(-omega)
    pw_l = torch.exp(Tl * l1)  # (1-w)^L, float32
    b_all = sp.all_gather(vloc[..., 0])  # [nsp, B, 30]
    v_in = torch.zeros_like(b_all[0])
    for i in range(sp.index):
        v_in = v_in * pw_l + b_all[i]
    # the exact local series from the true entry value: the zero-state
    # series plus the entry value's decaying tail
    t = torch.arange(Tl, dtype=_F32, device=x.device)
    vs = vs + v_in[..., None] * torch.exp((t + 1.0) * l1)

    peak = sp.pmax(vs.amax(-1))
    val = sp.all_gather(vs[..., -1].contiguous())[sp.size - 1]
    zf = torch.where(torch.isfinite(zf), zf, 0.0)
    val = torch.where(torch.isfinite(val), val, 0.0) + 1e-20
    peak = torch.where(torch.isfinite(peak), peak, 0.0)
    return SpectrumState(zf=zf, val=val, peak=peak, omega=omega)


def analyze_spectrum(meter: SpectrumAnalyzer, x: torch.Tensor, mesh, stereo: bool = True):
    """Sharded whole-file spectrum analysis, called by every rank.

    Args:
      meter: a SpectrumAnalyzer (supplies the bank and the smoother speed).
      x: this rank's block [b, 2, L] (stereo, averaged) or [b, L] (mono).
    Returns (read dict, SpectrumState), this rank's 'dp' block of what a
    serial whole-file run gives.
    """
    x = x.to(_F32)
    if stereo and x.ndim == 3:
        x = 0.5 * (x[..., 0, :] + x[..., 1, :])
    omega = torch.tensor(meter.omega, dtype=_F32, device=x.device)
    st = _analyze_shard(meter, x, omega, mesh.sp)
    return meter.read(st)[0], st
