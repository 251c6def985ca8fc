"""Whole-file EBU R128 + true-peak analysis over a ('dp', 'sp') mesh
(counterpart of ``meters_lv2_tpu/parallel/r128_sharded.py``).

A batch of files splits over 'dp' ranks and each file's timeline over 'sp'
ranks.  Per rank, on its block x [b, C, L]:

  * K-weighting and the 4x true peak: the entry state comes from the
    sequence-parallel composition (parallel.timepar, one all_gather of
    4-float states over 'sp'), the resampler history is the previous
    shard's last 47 samples (one shift); then the 128-aligned bulk runs
    ops.r128_fused.fused_core (the CUDA kernel on a card) and any
    remainder the meter's plain ops from the kernel's exit state, as
    ``EbuR128Meter.update`` does (a 44.1 kHz shard, fragm = 2205, is never
    128-aligned).  Peaks combine with pmax.
  * Fragment powers: local reshape-sums; the momentary and short-term
    windows need the previous shard's last 59 fragment powers (one shift).
    The window sums are exact float32 sums of ``unfold`` windows: a conv
    would run in TF32 under cuDNN's default.
  * Histograms and counts: an integer ``scatter_add_`` of the bins
    floor(10 v + 700.5) (``ops.hist``), psum over 'sp'; max M/S pmax.

Every collective moves O(d + 59 + 47) values a stream; the audio never
crosses ranks.  Each leaf of the result is this rank's block under
``OUT_SPECS`` (``parallel.mesh.gather_outputs`` rebuilds the whole).
"""

from __future__ import annotations

import types

import torch

from ..models.ebur128 import HIST_BINS, RADAR_POINTS, _MWIN, _SWIN, EbuR128Meter, _lufs
from ..ops import hist as hist_ops
from ..ops import r128_fused
from .timepar import lti_entry_state_sp

_F32 = torch.float32
_I32 = torch.int32

# the JAX out_specs of analyze_r128: curves are split over 'dp' and 'sp',
# the rest over 'dp' (the same block on every 'sp' rank)
OUT_SPECS = {"curve_M": ("dp", "sp"), "curve_S": ("dp", "sp"),
             "hist_m": ("dp", None), "hist_s": ("dp", None),
             "radar_m": ("dp", None), "radar_s": ("dp", None)}


def _hist(vals: torch.Tensor, mask: torch.Tensor):
    """([..., 751] int32 counts, [...] int32 count) of the points ``mask``
    selects, at bin floor(10 v + 700.5) clamped into range (ebu_r128_proc.cc:
    62-79); non-finite values and negative bins are not counted."""
    k = hist_ops.float_to_int32(torch.floor(10.0 * vals + 700.5))
    ok = mask & (k >= 0) & torch.isfinite(vals)
    k = torch.clamp(k, 0, HIST_BINS - 1)
    return (hist_ops.bincount(k, HIST_BINS, valid=ok, dtype=_I32),
            ok.sum(-1, dtype=_I32))


def _analyze_shard(meter: EbuR128Meter, x: torch.Tensor, sp) -> dict:
    """Per-rank body; x: [b, C, L] float32 on the rank's device."""
    B, C, Tl = x.shape
    fragm = meter.fragm
    if Tl % fragm:
        raise ValueError(f"the local time slice {Tl} is not a multiple of the fragment "
                         f"{fragm}; pad the stream")
    nfrag = Tl // fragm
    # the 59-fragment halo must cover the full short-term window, or
    # interior shards silently compute wrong S loudness / histogram points
    if nfrag < 59:
        raise ValueError(
            f"sequence-parallel shards need >= 59 fragments (~3 s) each, got {nfrag}; use "
            "fewer 'sp' shards or pad the stream")
    k, nsp = sp.index, sp.size
    dev = x.device

    # ---- K-weighting (entry state composed over 'sp') + true peak
    halo = sp.shift(x[..., -47:].contiguous())
    s_in = lti_entry_state_sp(meter.sys, x, torch.zeros((B, C, 4), dtype=_F32, device=dev), sp)
    Tm = (Tl // r128_fused.BLOCK) * r128_fused.BLOCK
    p, zr, hr, tpm = r128_fused.fused_core(
        x[..., :Tm].contiguous(), s_in.contiguous(), halo, meter.gains,
        meter.sys.op(r128_fused.BLOCK))
    if Tm < Tl:
        pt, tpm_t, _, _ = meter._plain_core(x[..., Tm:], zr, hr)
        p = torch.cat([p, pt], dim=-1)
        tpm = torch.maximum(tpm, tpm_t)
    dbtp = sp.pmax(tpm)

    # ---- fragment powers + windowed loudness with a 59-fragment halo
    fp = p.reshape(B, nfrag, fragm).sum(-1) / fragm + 1e-30 / fragm
    full = torch.cat([sp.shift(fp[..., -59:].contiguous()), fp], dim=-1)  # [B, 59 + nfrag]

    def wsum(w):  # sum of w fragments ending at each local fragment
        return full[..., (_SWIN - w):].unfold(-1, w, 1).sum(-1)

    lm = _lufs(wsum(_MWIN), _MWIN)  # [B, nfrag]
    ls = _lufs(wsum(_SWIN), _SWIN)
    max_m = sp.pmax(lm.amax(-1))
    max_s = sp.pmax(ls.amax(-1))
    # final M/S: the last shard's last fragment
    loud = sp.all_gather(torch.stack([lm[..., -1], ls[..., -1]]))[nsp - 1]

    # ---- histogram points at absolute fragment parity
    base = k * nfrag  # absolute index of local fragment 0
    ai = base + torch.arange(nfrag, dtype=torch.int64, device=dev)
    hist_m, cm = _hist(lm, ((ai % 2) == 1).expand(B, nfrag))
    hist_s, cs = _hist(ls, ((ai % 10) == 9).expand(B, nfrag))
    counts = sp.psum(torch.cat([hist_m, hist_s, cm[:, None], cs[:, None]], dim=-1))
    hist_m, hist_s = counts[:, :HIST_BINS], counts[:, HIST_BINS:2 * HIST_BINS]
    count_m, count_s = counts[:, -2], counts[:, -1]

    # ---- radar history: fragment-rate interval maxima at absolute sample
    # positions (the serial meter's radar from a fresh state).  An interval
    # may straddle shards, so per-shard partial maxima combine with pmax;
    # only the last <= 360 events survive in the ring (position = event %
    # 360, src/ebulv2.cc:160-176).
    spd = meter.radar_spd
    e_tot = max((Tl * nsp - 1) // spd, 0)  # events fired over the file
    e0 = max(0, e_tot - RADAR_POINTS)
    n_ev = e_tot - e0
    ninf = -float("inf")
    radar_m = torch.full((B, RADAR_POINTS), ninf, dtype=_F32, device=dev)
    radar_s = radar_m.clone()
    if n_ev > 0:
        contrib = torch.clamp_min((ai * fragm - 1) // spd, 0)  # the event each fragment feeds
        fed = (contrib >= e0) & (contrib < e_tot)
        idx = torch.where(fed, contrib - e0, n_ev).expand(B, nfrag)  # n_ev: a spare slot

        def ev_max(v):
            out = torch.full((B, n_ev + 1), ninf, dtype=_F32, device=dev)
            return out.scatter_reduce(-1, idx, v, "amax")[:, :n_ev]

        vm = sp.pmax(torch.stack([ev_max(lm), ev_max(ls)]))  # [2, B, n_ev]
        pos = (torch.arange(e0, e_tot, device=dev) % RADAR_POINTS)  # distinct positions
        radar_m[:, pos] = vm[0]
        radar_s[:, pos] = vm[1]
    radar_pos = torch.full((B,), e_tot % RADAR_POINTS, dtype=_I32, device=dev)

    return {
        # per-fragment loudness curves (LUFS-M/S at 20 Hz), split over 'sp'
        "curve_M": lm,
        "curve_S": ls,
        "loudness_M": loud[0],
        "loudness_S": loud[1],
        "max_M": max_m,
        "max_S": max_s,
        "hist_m": hist_m,
        "hist_s": hist_s,
        "count_m": count_m,
        "count_s": count_s,
        "dbtp": dbtp,
        "radar_m": radar_m,
        "radar_s": radar_s,
        "radar_pos": radar_pos,
    }


def analyze_r128(meter: EbuR128Meter, x: torch.Tensor, mesh) -> dict:
    """Sharded whole-file analysis, called by every rank of ``mesh``.

    Args:
      meter: an EbuR128Meter (supplies constants).  Only the default radar
        semantics: reference_radar (the reference's block-rate rings) and
        runtime_radar_speed (a radar interval in the state) are features
        of serial streaming that the sharded radar does not reproduce, so
        they are rejected rather than answered differently.
      x: this rank's block [b, C, L] (``mesh.shard_time`` of the global
        [B, C, T]): L a multiple of the fragment and at least 59 fragments.
    Returns this rank's block (``OUT_SPECS``) of the readout dict of
    ``EbuR128Meter.read``: integrated loudness and LRA from the psum'd
    histograms, the radar at the default fragment-rate semantics, no
    radar_spd / integ_time_s (a whole-file analysis has no running state
    for either), plus the loudness curves and the histograms.
    """
    if x.ndim != 3 or x.shape[1] != meter.nchan:
        raise ValueError(f"x must be [b, {meter.nchan}, L], got {tuple(x.shape)}")
    if meter.reference_radar or meter.runtime_radar_speed:
        raise NotImplementedError(
            "analyze_r128 supports only the default radar semantics; use serial streaming "
            "(meter.update) for reference_radar / runtime_radar_speed")
    out = _analyze_shard(meter, x.to(_F32), mesh.sp)
    # gated statistics from the combined histograms
    s = types.SimpleNamespace(hist_m=out["hist_m"], hist_s=out["hist_s"],
                              count_m=out["count_m"], count_s=out["count_s"])
    li, ith = meter.calc_integ(s)
    v0, v1, rth = meter.calc_range(s)
    out.update(integrated=li, integ_thr=ith, range_min=v0, range_max=v1, range_thr=rth,
               lra=v1 - v0)
    return out
