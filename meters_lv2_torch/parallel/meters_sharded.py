"""Whole-file sequence-parallel analysis for the counter and ballistics
meter families (counterpart of ``meters_lv2_tpu/parallel/meters_sharded.py``).

R128 and the 30-band spectrum shard in ``r128_sharded`` /
``spectrum_sharded``; this module covers the other long-file families:

  * ``analyze_truepeak``: dBTP.  The 4x polyphase oversampling runs on each
    shard with the previous shard's last 47 samples as its history
    (``ops.resample.upsample4``); the nonlinear display ballistics hand
    their state across shards through an exact sequential chain
    (``ballistics_chain_sp``).
  * ``analyze_dr14`` / ``analyze_tpnrms``: DR-14's 3 s windows tile the
    GLOBAL timeline (src/dr14.c:396-445), so each shard's partial window
    sums and peaks land in global slots and combine with psum/pmax; the
    gate, the 8000-bin histogram and the top-2 logic then run on every rank
    through the serial meter's own ``_dr_epilogue``.
  * ``analyze_sigdist``: histogram and counters psum; the running variance
    merges per-shard moments (Chan), or, under ``reference_oor_count``,
    composes the per-shard affine mean maps (sigdistlv2.c:313-318).
  * ``analyze_bitmeter``: ``BitMeter.update`` on each shard (the
    bitmeter_stats kernel on a card), then an exact integer merge.
  * ``analyze_needle``: VU (LTI state handoff, parallel.timepar) and the PPM
    family with BBC M-6 (the exact ballistics chain); one entry point for
    every needle meter (src/meters.cc:298-331).
  * ``analyze_kmeter`` / ``analyze_stcorr`` / ``analyze_surround``: the
    K-meter smoother and the correlator lowpasses hand LTI state across
    shards; the correlators' w2 averages are read only at the END of the
    file (stcorrdsp.cc:62-76), so each shard adds one closed-form weighted
    sum, scaled by its decay to the end of the file, into a psum.

Every collective moves O(state) values; the audio never crosses ranks.
Each analyze_* matches one serial ``meter.update(init, x_whole)`` +
``read()``, and returns this rank's 'dp' block of the readout (the same on
every 'sp' rank).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..models.bitmeter import BitMeter, BitMeterState
from ..models.cor import CorrelationMeter, CorState
from ..models.dr14 import DR14Meter
from ..models.kmeter import KMeter
from ..models.needle import _MV_6, _MV_14, BBCMidSideMeter, BBCMSState, VUMeter, VUState
from ..models.sigdist import _CAP, DIST_BIN, DIST_RANGE, DIST_ZERO, SigDistMeter, SigDistState
from ..models.surround import SurroundMeter, SurroundState
from ..models.truepeak import TruePeakMeter
from ..ops import ballistics as bal
from ..ops import hist as hist_ops
from ..ops import resample, segment
from ..ops.ballistics_core import f32
from ..ops.surround_fused import lowpass_eps, pair_products
from .timepar import lti_apply_sp, lti_entry_state_sp

_F32 = torch.float32
_I32 = torch.int32


def _check_len(L: int) -> None:
    if L % 4:
        raise ValueError(f"the local time slice {L} must be a multiple of 4 (T / sp % 4 == 0)")


def _halo47(x: torch.Tensor, sp) -> torch.Tensor:
    """The previous shard's last 47 samples (zeros on shard 0): the 4x
    polyphase resampler history (truepeakdsp.cc taps)."""
    return sp.shift(x[..., -47:].contiguous())


def ballistics_chain_sp(coeffs, t_abs: torch.Tensor, sp):
    """EXACT cross-shard PPM / true-peak ballistics over time shards.

    Each sample step z' = max(z, (1-w) z + w t) (iec2ppmdsp.cc:59-72) is a
    convex piecewise-linear map whose piece count grows with the segment,
    so no O(1) summary of a shard's map exists and a zero-state probe
    cannot be corrected for the true entry state (unlike the LTI handoff
    of parallel.timepar).  The chain visits the shards in order: at step i
    every rank runs ``ops.ballistics._run_ballistics`` (the ballistics
    kernel on a card, its envelope body up to ``ENVELOPE_MAX_ROWS`` rows)
    on its OWN series from shard i's true entry state, and ``select(i, .)``
    gives every rank shard i's exit.  So each rank launches it ``sp.size``
    times a chain, and the chain costs sp x the serial recurrence; what the
    mesh buys is the oversampling and the stream's memory.

    t_abs: [N, L4] local rectified series (L4 % 4 == 0).
    Returns (z1, z2, m, p): the whole stream's exit state, running display
    max and raw peak, on every rank."""
    z = torch.zeros(t_abs.shape[:-1], dtype=_F32, device=t_abs.device)
    carry = (z, z, z, z)
    for i in range(sp.size):
        out = bal._run_ballistics(coeffs, t_abs, *carry)
        carry = tuple(sp.select(i, torch.stack(out)).unbind(0))
    return carry


def _truepeak_core(meter: TruePeakMeter, x: torch.Tensor, sp):
    """Shared dBTP core: the halo'd 4x oversampling and the chained
    ballistics.  x: [..., L]; returns (m, the g-scaled display max, and p,
    the raw peak), each [...]."""
    up, _ = resample.upsample4(x, _halo47(x, sp))
    shape = up.shape
    z1, z2, m, p = ballistics_chain_sp(meter.coeffs, up.abs().reshape(-1, shape[-1]), sp)
    m = m * f32(meter.coeffs.g)
    return m.reshape(shape[:-1]), p.reshape(shape[:-1])


def _km_sp(km: KMeter, x: torch.Tensor, sp):
    """K-meter smoother over time shards: the LTI state handoff and the
    pmax block peak.  x: [..., L]; returns (z_final [..., 2], tmax [...])."""
    sq = torch.square(x)
    t = sp.pmax(torch.where(torch.isnan(sq), 0.0, sq).amax(-1))
    u = sq.reshape(*sq.shape[:-1], sq.shape[-1] // 4, 4)
    s0 = torch.zeros((*sq.shape[:-1], 2), dtype=_F32, device=x.device)
    s_in = lti_entry_state_sp(km.sys, u, s0, sp)
    _, z = km.sys.apply(u, s_in)
    return sp.all_gather(z)[sp.size - 1], t


# ---------------------------------------------------------------------------
# dBTP
# ---------------------------------------------------------------------------


def analyze_truepeak(meter: TruePeakMeter, x: torch.Tensor, mesh) -> dict:
    """Sharded whole-file dBTP.  x: this rank's block [b, L], L % 4 == 0.
    Returns {'level', 'peak'} of a serial single update + read."""
    _check_len(x.shape[-1])
    m, p = _truepeak_core(meter, x.to(_F32), mesh.sp)
    return {"level": m, "peak": p}


# ---------------------------------------------------------------------------
# DR-14 / TPnRMS
# ---------------------------------------------------------------------------


def _dr14_shard(meter: DR14Meter, x: torch.Tensor, sp):
    """Per-rank body; x: [B, C, L]."""
    B, C, L = x.shape
    k, nsp = sp.index, sp.size
    T = L * nsp
    dev = x.device

    # display meters (km RMS needle + tp dBTP needle, dr14.c:447-480)
    km_z, km_t = _km_sp(meter.km, x, sp)
    km = meter.km.finalize(meter.km.init((B, C), dev), km_z, km_t, T)
    tp_m, tp_p = _truepeak_core(meter.tp, x, sp)
    tp0 = meter.tp.init((B, C), dev)
    tp = dataclasses.replace(
        tp0, bal=dataclasses.replace(tp0.bal, m=tp_m, p=tp_p,
                                     res=torch.zeros_like(tp0.bal.res)))
    st = meter.init((B,), dev)
    if not meter.dr_mode:
        return dataclasses.replace(st, km=km, tp=tp)

    # global 3 s windows: the grid tiles the WHOLE timeline, so a shard's
    # local slots land at global slot (k L) // W, and windows split across
    # two shards combine by psum / pmax
    W = meter.win_len
    n_loc = L // W + 2
    n_glob = T // W + 2
    off = torch.full((B, C), (k * L) % W, dtype=_I32, device=dev)
    seg_sum = segment.shifted_segments(torch.square(x), off, W, n_loc, "sum")
    xpk = torch.where(torch.isnan(x), 0.0, x)
    seg_peak = segment.shifted_segments(xpk, off, W, n_loc, "max")
    base = (k * L) // W  # base + n_loc <= n_glob

    g = torch.zeros((2, B, C, n_glob), dtype=_F32, device=dev)
    g[0, ..., base:base + n_loc] = seg_sum
    g[1, ..., base:base + n_loc] = seg_peak
    gsum, gpeak = sp.psum(g[0]), sp.pmax(g[1])

    ncomp = torch.full((B,), T // W, dtype=_I32, device=dev)
    return meter._dr_epilogue(st, km, tp, gsum, gpeak, ncomp,
                              torch.full((B,), T % W, dtype=_I32, device=dev))


def analyze_dr14(meter: DR14Meter, x: torch.Tensor, mesh) -> dict:
    """Sharded whole-file DR-14 (or TPnRMS) analysis.

    x: this rank's block [b, C, L], L % 4 == 0.  Returns the read() dict of
    a serial single-update run (window sums at shard boundaries differ only
    by float32 addition order)."""
    if x.ndim != 3 or x.shape[1] != meter.nchan:
        raise ValueError(f"x must be [b, {meter.nchan}, L], got {tuple(x.shape)}")
    _check_len(x.shape[-1])
    return meter.read(_dr14_shard(meter, x.to(_F32), mesh.sp))[0]


def analyze_tpnrms(meter, x: torch.Tensor, mesh) -> dict:
    """TPnRMS flavour of analyze_dr14 (dr_mode=False display meters)."""
    return analyze_dr14(meter, x, mesh)


# ---------------------------------------------------------------------------
# SigDist
# ---------------------------------------------------------------------------


def _sigdist_shard(meter: SigDistMeter, x: torch.Tensor, T: int, sp) -> SigDistState:
    B, L = x.shape
    k, nsp = sp.index, sp.size
    dev = x.device

    bins = hist_ops.float_to_int32(torch.round(DIST_ZERO + x * DIST_RANGE))
    ok = (bins >= 0) & (bins < DIST_BIN)  # the run gate holds: T < 2^31
    counts = sp.psum(torch.cat([
        hist_ops.bincount(bins, DIST_BIN, valid=ok, dtype=_I32),
        ok.sum(-1, dtype=_I32)[:, None]], dim=-1))
    hist, n = counts[:, :DIST_BIN], counts[:, -1]
    total = sp.psum(torch.where(ok, x, 0.0).sum(-1))

    if meter.reference_oor_count:
        # the quirk chain: per-shard prefix maps with ABSOLUTE sample
        # indices; the entry mean is the fold of earlier shards' end maps
        time0 = torch.full((B,), k * L, dtype=_I32, device=dev)
        U, Bm = SigDistMeter._oor_maps(x, ok, time0)
        maps = sp.all_gather(torch.stack([U[..., -1], Bm[..., -1]], -1))  # [nsp, B, 2]
        m0 = torch.zeros((B,), dtype=_F32, device=dev)
        for i in range(k):
            m0 = m0 - maps[i, :, 0] * m0 + maps[i, :, 1]
        m = m0[..., None] - U * m0[..., None] + Bm
        m_prev = torch.cat([m0[..., None], m[..., :-1]], -1)
        m2 = sp.psum(torch.where(ok, (x - m) * (x - m_prev), 0.0).sum(-1))
        mean = sp.all_gather(m[..., -1].contiguous())[nsp - 1]
    else:
        nb, mb, m2b = hist_ops.welford_block(x, ok)
        nb_all = sp.all_gather(nb)
        mom = sp.all_gather(torch.stack([mb, m2b]))  # [nsp, 2, B]
        acc = (torch.zeros((B,), dtype=_I32, device=dev),
               torch.zeros((B,), dtype=_F32, device=dev),
               torch.zeros((B,), dtype=_F32, device=dev))
        for i in range(nsp):
            acc = hist_ops.welford_merge(acc, (nb_all[i], mom[i, 0], mom[i, 1]))
        _, mean, m2 = acc

    return SigDistState(
        hist=hist, n=n, mean=mean, m2=m2, total=total,
        time=torch.full((B,), T, dtype=_I32, device=dev),
        integrating=torch.ones((B,), dtype=torch.bool, device=dev),
    )


def analyze_sigdist(meter: SigDistMeter, x: torch.Tensor, mesh) -> dict:
    """Sharded whole-file signal-distribution analysis.  x: this rank's
    block [b, L]; the whole T = L * sp below 2^31 (the reference's
    acquisition cap, sigdistlv2.c:288-295).  Returns read() of a serial
    single-update run (histogram and counters exact; mean and variance
    within float32 merge-order noise)."""
    T = x.shape[-1] * mesh.sp.size
    if T >= _CAP:
        raise ValueError("whole-file analysis beyond the 2^31 cap")
    return meter.read(_sigdist_shard(meter, x.to(_F32), T, mesh.sp))[0]


# ---------------------------------------------------------------------------
# BitMeter
# ---------------------------------------------------------------------------


def _bitmeter_shard(meter: BitMeter, x: torch.Tensor, sp) -> BitMeterState:
    st = meter.update(meter.init((x.shape[0],), x.device), x)
    ints = (st.hit, st.one, st.dset, st.nan[:, None], st.inf[:, None], st.den[:, None],
            st.zero[:, None], st.pos[:, None], st.time[:, None])
    merged = sp.psum(torch.cat(ints, dim=-1)).split([v.shape[-1] for v in ints], dim=-1)
    hit, one, dset, nan, inf, den, zero, pos, time = (
        v if v.shape[-1] > 1 else v[:, 0] for v in merged)
    return BitMeterState(
        hit=hit, one=one, dset=dset, nan=nan, inf=inf, den=den, zero=zero, pos=pos,
        vmin=sp.pmin(st.vmin), vmax=sp.pmax(st.vmax), time=time,
        integrating=st.integrating,
    )


def analyze_bitmeter(meter: BitMeter, x: torch.Tensor, mesh) -> dict:
    """Sharded whole-file bit statistics, a bit-exact integer merge.
    x: this rank's block [b, L]; the whole T = L * sp below 2^31."""
    if x.shape[-1] * mesh.sp.size >= _CAP:
        raise ValueError("beyond the 2^31 acquisition cap")
    return meter.read(_bitmeter_shard(meter, x.to(_F32), mesh.sp))[0]


# ---------------------------------------------------------------------------
# Needle meters (VU / DIN / NOR / BBC / EBU / BBC M-6)
# ---------------------------------------------------------------------------


def _vu_shard(meter: VUMeter, x: torch.Tensor, sp) -> VUState:
    """VU over time shards: the 4-sample-cadence resonant lowpass is LTI,
    so the shards' entry states compose exactly (parallel.timepar); the
    needle max is a pmax of exact local maxima (vumeterdsp.cc:45-98)."""
    *batch, L = x.shape
    u = x.abs().reshape(*batch, L // 4, 4)
    s0 = torch.zeros((*batch, 2), dtype=_F32, device=x.device)
    y, z = lti_apply_sp(meter.sys, u, s0, sp)
    m = sp.pmax(y[..., 0].amax(-1))
    # the per-process()-call epilogue, once for the whole file
    # (vumeterdsp.cc:70-77)
    bad = ~torch.isfinite(z).all(-1)
    z = torch.where(bad[..., None], 0.0, z)
    z = torch.stack([z[..., 0], z[..., 1] + 1e-10], dim=-1)
    m = torch.where(bad, float("inf"), m)
    return VUState(z=z, m=m, res=torch.zeros(tuple(batch), dtype=torch.bool, device=x.device))


def _ppm_exit_state(coeffs, t_abs: torch.Tensor, sp) -> bal.PPMState:
    """The whole file's PPM state from local rectified series through the
    exact sequential chain; the per-process()-call denormal offset applies
    once (iec2ppmdsp.cc:76-77)."""
    z1, z2, m, _ = ballistics_chain_sp(coeffs, t_abs, sp)
    return bal.PPMState(z1=z1 + 1e-10, z2=z2 + 1e-10, m=m,
                        res=torch.zeros(t_abs.shape[:-1], dtype=torch.bool,
                                        device=t_abs.device))


def analyze_needle(meter, x: torch.Tensor, mesh, ref_level_db: float = -22.0,
                   s20: bool = False):
    """Sharded whole-file needle-meter reading.

    meter: VUMeter, any _PPMMeter subclass (DIN/NOR/BBC/EBU), or
    BBCMidSideMeter.  x: this rank's block [b, L] (BBC M-6: [b, 2, L]),
    L % 4 == 0.  Returns the value(s) of a serial single ``update(init, x)``
    + ``read(ref_level_db)``: exact for the PPM family (the same per-sample
    recurrence from exact entry states), within float32 product-order noise
    for VU.  BBC M-6 runs its mid and side chains apart: 2 sp launches."""
    _check_len(x.shape[-1])
    x = x.to(_F32)
    sp = mesh.sp
    if isinstance(meter, BBCMidSideMeter):
        l, r = x[..., 0, :], x[..., 1, :]
        st = BBCMSState(
            mid=_ppm_exit_state(meter.coeffs, _MV_6 * torch.abs(l + r), sp),
            side=_ppm_exit_state(meter.coeffs, (_MV_14 if s20 else _MV_6) * torch.abs(l - r),
                                 sp))
    elif isinstance(meter, VUMeter):
        st = _vu_shard(meter, x, sp)
    else:  # the _PPMMeter family
        st = _ppm_exit_state(meter.coeffs, x.abs(), sp)
    return meter.read(st, ref_level_db)[0]


# ---------------------------------------------------------------------------
# K-meter (K12/K14/K20)
# ---------------------------------------------------------------------------


def analyze_kmeter(meter: KMeter, x: torch.Tensor, mesh) -> dict:
    """Sharded whole-file K-meter: the LTI smoother handoff and the pmax
    digital peak, then the per-process()-call hold/fall epilogue once with
    the whole file's length (kmeterdsp.cc:101-139).  x: this rank's block
    [b, L] (channels are extra leading batch dims), L % 4 == 0."""
    _check_len(x.shape[-1])
    x = x.to(_F32)
    z, t = _km_sp(meter, x, mesh.sp)
    st = meter.finalize(meter.init(x.shape[:-1], x.device), z, t,
                        x.shape[-1] * mesh.sp.size)
    return meter.read(st)[0]


# ---------------------------------------------------------------------------
# Stereo correlation (COR) and surround
# ---------------------------------------------------------------------------


def _w2_shard_scales(w2: float, L: int, nsp: int) -> np.ndarray:
    """Float32 table of each shard's decay to the end of the file for the
    w2 product averages: shard k's local weighted sum (cor.ema_final from
    0) enters the whole file's value scaled by (1-w2)^(L (nsp-1-k)), the
    exact factorization of the serial weights w2 (1-w2)^(T-1-g) at
    g = k L + t.  Taken in float64 on the host (the float32 serial weights
    underflow first)."""
    e = L * np.arange(nsp - 1, -1, -1, dtype=np.float64)
    return ((1.0 - np.float64(w2)) ** e).astype(np.float32)


def _pair_products_sp(cor: CorrelationMeter, y: torch.Tensor, sel_a, sel_b, sp):
    """END-of-file value of the w2 running averages of the routed pair
    products: local closed-form sums, scaled into the whole timeline and
    psum-combined.  y: [..., C, L] filtered channels.  The pairs are
    selected by ``ops.surround_fused.pair_products`` (a broadcast and sum:
    no TF32 product, a non-finite channel reaches every pair as in the
    JAX package's one-hot product)."""
    prods = pair_products(sel_a, sel_b, y)  # [..., P, 3, L]
    acc = cor.ema_final(prods, torch.zeros(prods.shape[:-1], dtype=_F32, device=y.device))
    scale = float(_w2_shard_scales(cor.w2, y.shape[-1], sp.size)[sp.index])
    return sp.psum(scale * acc)


def analyze_stcorr(meter: CorrelationMeter, x: torch.Tensor, mesh):
    """Sharded whole-file phase correlation.  x: this rank's block
    [b, 2, L].  The 2 kHz lowpasses hand LTI state across shards; the w2
    product averages combine closed-form (``_w2_shard_scales``).  Matches a
    serial single update + read within float32 dot-order noise
    (stcorrdsp.cc:49-76)."""
    x = x.to(_F32)
    sp = mesh.sp
    l, r = x[..., 0, :], x[..., 1, :]
    eps = lowpass_eps(meter.w1)
    s0 = torch.zeros((*l.shape[:-1], 1), dtype=_F32, device=x.device)
    yl, zl = lti_apply_sp(meter.lp, l + eps, s0, sp)
    yr, zr = lti_apply_sp(meter.lp, r + eps, s0, sp)
    y = torch.stack([yl, yr], dim=-2)  # [b, 2, L]
    # one routed pair (L, R): [b, 1, 3] = (zlr, zll, zrr), CorState.zp's layout
    eye = torch.eye(2, dtype=_F32, device=x.device)
    zp = _pair_products_sp(meter, y, eye[0:1], eye[1:2], sp)[..., 0, :]
    # the per-process()-call epilogue once (stcorrdsp.cc:65-76)
    zl = torch.where(torch.isfinite(zl), zl, 0.0)
    zr = torch.where(torch.isfinite(zr), zr, 0.0)
    zp = torch.where(torch.isfinite(zp), zp, 0.0) + 1e-10
    return meter.read(CorState(zl=zl, zr=zr, zp=zp))[0]


def analyze_surround(meter: SurroundMeter, x: torch.Tensor, mesh) -> dict:
    """Sharded whole-file surround analysis (surround3..8).  x: this rank's
    block [b, C, L] with C == meter.nchan, L % 4 == 0.  Per-channel K-meters
    and correlator lowpasses hand LTI state across shards; the routed pair
    averages combine closed-form; the K hold/fall epilogue runs once with
    the whole file's length (surmeter.c:115-128)."""
    if x.ndim != 3 or x.shape[-2] != meter.nchan:
        raise ValueError(f"x must be [b, {meter.nchan}, L], got {tuple(x.shape)}")
    _check_len(x.shape[-1])
    x = x.to(_F32)
    sp = mesh.sp
    cor = meter.cor
    sel_a, sel_b = meter._sel(None, x.device)
    kmz, tmax = _km_sp(meter.km, x, sp)
    km = meter.km.finalize(meter.km.init(x.shape[:-1], x.device), kmz, tmax,
                           x.shape[-1] * sp.size)
    s0 = torch.zeros((*x.shape[:-1], 1), dtype=_F32, device=x.device)
    y, zl = lti_apply_sp(cor.lp, x + lowpass_eps(cor.w1), s0, sp)
    zp = _pair_products_sp(cor, y, sel_a, sel_b, sp)
    # the epilogue once (stcorrdsp.cc:65-76 through surround.update)
    zl = torch.where(torch.isfinite(zl), zl, 0.0)
    zp = torch.where(torch.isfinite(zp), zp, 0.0) + 1e-10
    return meter.read(SurroundState(km=km, zl=zl, zp=zp))[0]
