"""EBU R128 / ITU-R BS.1770 loudness meter with true peak, in PyTorch.

Counterpart of ``meters_lv2_tpu/models/ebur128.py`` with the same state
fields, layouts and readouts.  Reference: ebumeter/ebu_r128_proc.cc
(measurement core), src/ebulv2.cc (plugin semantics: dBTP via
TruePeakdsp::process_max, radar history, integration start/pause/reset).

  * K-weighting (ebu_r128_proc.cc:319-328) and the 4x true peak
    (truepeakdsp.cc:109-131): the 128-aligned bulk of a block goes through
    ops.r128_fused.fused_core (the CUDA kernel on a card); a non-aligned
    tail, or a block shorter than 128 samples, runs the plain lti/resample
    ops with chained state.
  * 1/20 s fragment powers (:207-248): shifted segment sums over the block,
    a 59-fragment history carried so momentary (8 frags / 400 ms) and
    short-term (60 frags / 3 s) windows are sliding sums over
    [history ++ new fragments].  A block of T >= 128 samples with
    T % 128 == 0, where a fragment (fs / 20) is longer than 128 samples,
    gets its fragment sums from fused_core's seg mode, so the full-rate
    power is never written; any other block sums the power with
    ops.segment.shifted_segments.  On the CPU both give the same bits.
  * Loudness histograms (751 bins, 0.1 LU, :62-79): integer scatter-add;
    M points every 2nd fragment, S points every 10th (:229-242), phase
    carried across blocks (div1/div2).
  * Gated integrated loudness and LRA (:105-150): computed in read() from
    the histograms.

Everything is vectorized over an arbitrary leading batch shape; update()
accepts any block length (partial fragments are carried).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..ops import design, lti, r128_fused, resample, segment
from ..ops.hist import float_to_int32
from ..utils import profiler
from .base import register

HIST_BINS = 751
RADAR_POINTS = 360
_MWIN = 8  # momentary window, fragments (400 ms)
_SWIN = 60  # short-term window, fragments (3 s)
_NRADIX = 1 << 30  # sample-counter split radix (two int32 words)
_BLOCK = r128_fused.BLOCK

_F32 = torch.float32
_I32 = torch.int32


@dataclasses.dataclass(frozen=True)
class EbuR128State:
    # filter + resampler
    z: torch.Tensor  # [..., C, 4] K-weighting filter state
    tp_hist: torch.Tensor  # [..., C, 47] true-peak resampler history
    # fragment assembly
    frpwr: torch.Tensor  # [...] partial fragment power (incl. 1e-30 seed)
    off: torch.Tensor  # [...] int32 samples already in current fragment
    fhist: torch.Tensor  # [..., 59] previous fragment powers (newest last)
    # loudness readouts
    loud_m: torch.Tensor  # [...]
    loud_s: torch.Tensor
    max_m: torch.Tensor
    max_s: torch.Tensor
    # gating histograms
    hist_m: torch.Tensor  # [..., 751] int32
    hist_s: torch.Tensor
    count_m: torch.Tensor  # [...] int32
    count_s: torch.Tensor
    div1: torch.Tensor  # [...] int32, M-point phase (mod 2)
    div2: torch.Tensor  # [...] int32, S-point phase (mod 10)
    # true peak + bookkeeping
    dbtp: torch.Tensor  # [...] running oversampled |peak|
    integrating: torch.Tensor  # [...] bool
    # integration sample count, only advanced while integrating
    # (src/ebulv2.cc:394-396), two int32 words at radix 2^30
    n_lo: torch.Tensor  # [...] int32 low word (< 2^30)
    n_hi: torch.Tensor  # [...] int32 high word
    # radar history (src/ebulv2.cc:160-176, 390-421): 360-point rings
    radar_m: torch.Tensor  # [..., 360]
    radar_s: torch.Tensor  # [..., 360]
    radar_pos: torch.Tensor  # [...] int32 ring write position
    radar_cur_m: torch.Tensor  # [...] running max since last radar point
    radar_cur_s: torch.Tensor  # [...]
    radar_spd_cur: torch.Tensor  # [...] int32 samples into current interval
    radar_spd: torch.Tensor  # [...] int32 samples per radar point
    # 500 ms-cadence snapshot of the M-histogram/count as of the most
    # recent S-point (ebu_r128_proc.cc:240-243); [..., 1] placeholder
    # unless the meter is built with track_cadence=True
    hist_m_snap: torch.Tensor  # [..., 751] int32
    count_m_snap: torch.Tensor  # [...] int32


STATE_FIELDS = tuple(f.name for f in dataclasses.fields(EbuR128State))


def _lufs(s: torch.Tensor, w: int) -> torch.Tensor:
    v = -0.6976 + 10.0 * torch.log10(s / w)
    return torch.where(torch.isfinite(v) & (v >= -200.0), v, -200.0)


@register("EBUr128")
class EbuR128Meter:
    """Full R128 meter; channels C in {1, 2, 5} (ebu_r128_proc.h:26)."""

    def __init__(
        self, fs: float, nchan: int = 2, radar_seconds: float = 120.0,
        runtime_radar_speed: bool = False, track_cadence: bool = False,
        reference_radar: bool = False,
    ):
        if not 1 <= nchan <= 5:
            raise ValueError(f"nchan must be 1..5, got {nchan}")
        self.fs = float(fs)
        self.nchan = nchan
        self.fragm = int(fs) // 20
        # radar interval (ebu_set_radarspeed, src/ebulv2.cc:75-78); the
        # extra fragm floor keeps the interval >= one loudness point
        self.radar_spd = max(
            int(round(radar_seconds * fs / RADAR_POINTS)), 4096, self.fragm
        )
        # runtime_radar_speed=True reads the interval from the state
        # (set_radar_speed mid-stream, CTL_RADARTIME)
        self.runtime_radar_speed = bool(runtime_radar_speed)
        # reference_radar=True reproduces src/ebulv2.cc:390-421 verbatim
        # (block-rate sampling, one ring point per update() call, the
        # radarSC carry gated on lm); False keeps fragment-rate semantics
        self.reference_radar = bool(reference_radar)
        # track_cadence=True carries the M-histogram snapshot that
        # read(cadence_500ms=True) needs
        self.track_cadence = bool(track_cadence)
        with profiler.span("r128.design"):
            self.sys = lti.LTISystem(*design.k_weighting_state_space(fs))
            gains = np.array([2.0]) if nchan == 1 else design.R128_CHAN_GAIN[:nchan]
            self.gains = r128_fused.gains_f32(gains)
        self._gains_on: dict[torch.device, torch.Tensor] = {}
        self._bin_power_on: dict[torch.device, torch.Tensor] = {}

    # -- lifecycle ----------------------------------------------------------

    def init(self, batch_shape=(), device="cuda") -> EbuR128State:
        batch_shape = tuple(batch_shape)

        def f(*s, value=0.0, dtype=_F32):
            return torch.full((*batch_shape, *s), value, dtype=dtype, device=device)

        def i():
            return f(value=0, dtype=_I32)

        neg = f(value=-200.0)
        return EbuR128State(
            z=f(self.nchan, 4),
            tp_hist=f(self.nchan, 47),
            frpwr=f(value=1e-30),
            off=i(),
            fhist=f(59),
            loud_m=neg,
            loud_s=neg.clone(),
            max_m=neg.clone(),
            max_s=neg.clone(),
            hist_m=f(HIST_BINS, value=0, dtype=_I32),
            hist_s=f(HIST_BINS, value=0, dtype=_I32),
            count_m=i(),
            count_s=i(),
            div1=i(),
            div2=i(),
            dbtp=f(),
            integrating=f(value=True, dtype=torch.bool),
            n_lo=i(),
            n_hi=i(),
            radar_m=f(RADAR_POINTS, value=-float("inf")),
            radar_s=f(RADAR_POINTS, value=-float("inf")),
            radar_pos=i(),
            radar_cur_m=f(value=-float("inf")),
            radar_cur_s=f(value=-float("inf")),
            radar_spd_cur=i(),
            radar_spd=f(value=self.radar_spd, dtype=_I32),
            hist_m_snap=f(HIST_BINS if self.track_cadence else 1, value=0, dtype=_I32),
            count_m_snap=i(),
        )

    def integr_start(self, state: EbuR128State) -> EbuR128State:
        return dataclasses.replace(state, integrating=torch.ones_like(state.integrating))

    def integr_pause(self, state: EbuR128State) -> EbuR128State:
        return dataclasses.replace(state, integrating=torch.zeros_like(state.integrating))

    def integr_reset(self, state: EbuR128State) -> EbuR128State:
        """The reference GUI RESET (ebu_reset, src/ebulv2.cc:45-60):
        Ebu_r128_proc::integr_reset plus integration time, tp_max and the
        radar ring cleared, but not the open radar interval and its running
        maxima, which carry across a reset as in the reference."""
        z = torch.zeros_like
        return dataclasses.replace(
            state,
            max_m=torch.full_like(state.max_m, -200.0),
            max_s=torch.full_like(state.max_s, -200.0),
            radar_m=torch.full_like(state.radar_m, -float("inf")),
            radar_s=torch.full_like(state.radar_s, -float("inf")),
            radar_pos=z(state.radar_pos),
            hist_m=z(state.hist_m),
            hist_s=z(state.hist_s),
            count_m=z(state.count_m),
            count_s=z(state.count_s),
            div1=z(state.div1),
            div2=z(state.div2),
            hist_m_snap=z(state.hist_m_snap),
            count_m_snap=z(state.count_m_snap),
            n_lo=z(state.n_lo),
            n_hi=z(state.n_hi),
            dbtp=z(state.dbtp),
        )

    # -- processing ----------------------------------------------------------

    def _gains(self, device) -> torch.Tensor:
        device = lti.canonical_device(device)
        if device not in self._gains_on:
            with profiler.counted("cache.fill"):
                self._gains_on[device] = torch.tensor(self.gains, dtype=_F32, device=device)
        return self._gains_on[device]

    def _plain_core(self, xt, z0, hist0):
        """K-weighted combined power (ebu_r128_proc.cc:302-337) and the
        oversampled |max| (TruePeakdsp::process_max) for any T, with the
        plain ops: the tail after the kernel's 128-aligned bulk."""
        yt, z1 = self.sys.apply(xt, z0)
        pt = torch.sum(torch.square(yt) * self._gains(xt.device)[:, None], dim=-2)
        upt, hist1 = resample.upsample4_absmax(xt, hist0)
        return pt, torch.amax(upt, dim=-1), z1, hist1

    def update(
        self, state: EbuR128State, x: torch.Tensor, flat: bool = False
    ) -> EbuR128State:
        """x: [..., C, T], any T >= 1.

        With flat=True, x is [..., C*T] in channel-major layout (the bits
        of reshape(..., C*T)); a T that is not a multiple of 128 is
        reshaped to [..., C, T] internally.
        """
        with profiler.span("r128.update"):
            return self._update(state, x, flat)

    def _update(self, state: EbuR128State, x: torch.Tensor, flat: bool) -> EbuR128State:
        C = self.nchan
        if x.dtype != _F32:
            x = x.to(_F32)
        if flat:
            *batch, CT = x.shape
            if CT % C:
                raise ValueError(f"flat width {CT} is not a multiple of nchan={C}")
            T = CT // C
            if T < _BLOCK or T % _BLOCK:
                x = x.reshape(*batch, C, T)
                flat = False
        else:
            *batch, Cx, T = x.shape
            if Cx != C:
                raise ValueError(f"x has {Cx} channels, meter has {C}")
        batch = tuple(batch)
        dev = x.device
        fragm = self.fragm

        off = state.off  # [...] samples already in the open fragment
        n_slots = T // fragm + 2
        seg = None

        # 1+2) K-weighting power and 4x-oversampled true peak: the kernel
        # covers the 128-aligned bulk, the plain ops any remainder, with
        # chained state.  A block that is all bulk takes the kernel's seg
        # mode, which returns the fragment sums of step 3 in place of the
        # full-rate power.  Non-finite filter state is flushed per block, as
        # the reference does per fragment (ebu_r128_proc.cc:331-334).
        if T >= _BLOCK:
            Tm = (T // _BLOCK) * _BLOCK
            with profiler.span("r128.kernel"):
                xin = x.reshape(-1, C * T) if flat else x[..., :Tm].reshape(-1, C, Tm)
                seg_kw = {}
                if T == Tm and fragm > _BLOCK:
                    profiler.count("r128.seg")
                    seg_kw = dict(off=off.reshape(-1).contiguous(), fragm=fragm,
                                  n_slots=n_slots)
                pr, zr, hr, tpm = r128_fused.fused_core(
                    xin.contiguous(),
                    state.z.reshape(-1, C, 4).contiguous(),
                    state.tp_hist.reshape(-1, C, 47).contiguous(),
                    self.gains,
                    self.sys.op(_BLOCK),
                    **seg_kw,
                )
                z = zr.reshape(*batch, C, 4)
                tp_hist = hr.reshape(*batch, C, 47)
                if seg_kw:
                    seg = pr.reshape(*batch, n_slots)
                else:
                    p = pr.reshape(*batch, Tm)
            dbtp = torch.maximum(state.dbtp, tpm.reshape(batch))
            if T > Tm:
                with profiler.span("r128.tail"):
                    pt, tpm_t, z, tp_hist = self._plain_core(x[..., Tm:], z, tp_hist)
                    p = torch.cat([p, pt], dim=-1)
                    dbtp = torch.maximum(dbtp, tpm_t)
        else:
            with profiler.span("r128.tail"):
                p, tpm, z, tp_hist = self._plain_core(x, state.z, state.tp_hist)
                dbtp = torch.maximum(state.dbtp, tpm)
        z = torch.where(torch.isfinite(z), z, 0.0)

        # 3) fragment segmentation with carried partial fragment, and the
        # fragment history: last 59 entries of [history ++ new]'s valid prefix
        with profiler.span("r128.fragments"):
            if seg is None:
                seg = segment.shifted_segments(p, off, fragm, n_slots, "sum")
            seg = torch.cat(
                [seg[..., :1] + (state.frpwr - 1e-30)[..., None], seg[..., 1:]], dim=-1
            )  # continue the open fragment
            seg = seg + 1e-30  # frpwr seed per fragment (ebu_r128_proc.cc:216)

            ncomp = (off + T) // fragm  # completed fragments this block
            slot = torch.arange(n_slots, dtype=_I32, device=dev)
            valid = slot < ncomp[..., None]  # [..., n_slots]

            fp = seg / fragm  # fragment mean powers (garbage where invalid)
            full = torch.cat([state.fhist, fp], dim=-1)  # [..., 59+n_slots]
            idx = (ncomp[..., None] + torch.arange(59, dtype=_I32, device=dev)).long()
            roll = torch.gather(full, -1, idx)

        # 4) sliding 8/60-fragment windows over [history ++ new] as short
        # exact fp32 window sums (no long cumsum: it cancels on long files;
        # no conv: cuDNN would run it in TF32)
        ninf = -float("inf")
        with profiler.span("r128.windows"):
            def wsum(w):  # sum of w fragments ending at each new slot
                return full[..., (_SWIN - w):].unfold(-1, w, 1).sum(-1)

            lm = _lufs(wsum(_MWIN), _MWIN)  # [..., n_slots]
            ls = _lufs(wsum(_SWIN), _SWIN)

            any_valid = valid.any(-1)
            last = torch.clamp_min(ncomp - 1, 0)[..., None].long()

            def pick(a):
                return torch.gather(a, -1, last)[..., 0]

            loud_m = torch.where(any_valid, pick(lm), state.loud_m)
            loud_s = torch.where(any_valid, pick(ls), state.loud_s)
            max_m = torch.maximum(state.max_m, torch.where(valid, lm, ninf).amax(-1))
            max_s = torch.maximum(state.max_s, torch.where(valid, ls, ninf).amax(-1))

        # 5) histogram points: M every 2nd, S every 10th completed fragment
        with profiler.span("r128.hist"):
            integ = state.integrating[..., None]
            m_pt = valid & integ & (((state.div1[..., None] + slot) % 2) == 1)
            s_pt = valid & integ & (((state.div2[..., None] + slot) % 10) == 9)

            def scatter(hist, vals, mask):
                # bin = floor(10 v + 700.5) in fp32 (ebu_r128_proc.cc:62-79);
                # integer scatter-add is exact in any order
                k = torch.floor(10.0 * vals + 700.5)
                ok = mask & (k >= 0) & torch.isfinite(vals)
                k = torch.where(ok, k, 0.0).clamp(0, HIST_BINS - 1).long()
                hist = hist.scatter_add(-1, k, ok.to(_I32))
                return hist, ok.sum(-1, dtype=_I32)

            hist_m, dcm = scatter(state.hist_m, lm, m_pt)
            hist_s, dcs = scatter(state.hist_s, ls, s_pt)

            # 5b) optional 500 ms-cadence snapshot: M-histogram as of the last
            # S-point in this block (ebu_r128_proc.cc:229-243)
            if self.track_cadence:
                any_s = s_pt.any(-1)
                ls_slot = torch.where(s_pt, slot, -1).amax(-1)
                snap_mask = m_pt & (slot <= ls_slot[..., None])
                hm_new, dcm_s = scatter(state.hist_m, lm, snap_mask)
                hist_m_snap = torch.where(any_s[..., None], hm_new, state.hist_m_snap)
                count_m_snap = torch.where(
                    any_s, state.count_m + dcm_s, state.count_m_snap
                )
            else:
                hist_m_snap = state.hist_m_snap
                count_m_snap = state.count_m_snap

        # 6) radar history, from the new points to the packed state
        with profiler.span("r128.radar"):
            pack = dict(
                state=state, z=z, tp_hist=tp_hist, seg=seg, ncomp=ncomp, off=off,
                T=T, fragm=fragm, roll=roll, loud_m=loud_m, loud_s=loud_s,
                max_m=max_m, max_s=max_s, hist_m=hist_m, hist_s=hist_s, dcm=dcm,
                dcs=dcs, dbtp=dbtp, hist_m_snap=hist_m_snap,
                count_m_snap=count_m_snap,
            )
            spd_flat = state.radar_spd if self.runtime_radar_speed else self.radar_spd

            if self.reference_radar:
                # src/ebulv2.cc:390-421 verbatim at the update()-call rate:
                # carries from this call's final lm/ls (incl. the radarSC lm
                # gate at :392), then at most one ring point per call
                rcm = torch.maximum(state.radar_cur_m, loud_m)
                rcs = torch.where(loud_m > state.radar_cur_s, loud_s, state.radar_cur_s)
                spd_cur = state.radar_spd_cur + T
                fire = spd_cur > spd_flat
                oh = (
                    torch.arange(RADAR_POINTS, dtype=_I32, device=dev)
                    == state.radar_pos[..., None]
                ) & fire[..., None]
                return self._pack_state(
                    **pack,
                    radar_m=torch.where(oh, rcm[..., None], state.radar_m),
                    radar_s=torch.where(oh, rcs[..., None], state.radar_s),
                    radar_pos=torch.where(
                        fire, (state.radar_pos + 1) % RADAR_POINTS, state.radar_pos
                    ),
                    rcm=torch.where(fire, ninf, rcm),
                    rcs=torch.where(fire, ninf, rcs),
                    rspd=torch.where(fire, spd_cur % spd_flat, spd_cur),
                )

            # default mode: per-interval max of fragment-rate loudness.  The
            # interval counter is recovered from the cumulative sample count:
            # fragment j fires iff floor((S_j - 1)/spd) increments, so fire
            # events, segmented maxima and ring writes are masked reductions.
            spd = state.radar_spd[..., None] if self.runtime_radar_speed else self.radar_spd
            adv = torch.where(slot == 0, fragm - off[..., None], fragm)
            advm = torch.where(valid, adv, 0)
            S = state.radar_spd_cur[..., None] + torch.cumsum(advm, -1, dtype=_I32)
            nf = torch.clamp_min((S - 1) // spd, 0)  # fires up to & incl fragment j
            contrib = torch.cat(
                [torch.zeros_like(nf[..., :1]), nf[..., :-1]], dim=-1
            )  # event id each fragment's loudness feeds
            total = nf[..., -1]  # fires this update

            ev = torch.arange(n_slots, dtype=_I32, device=dev)
            sel = valid[..., None, :] & (contrib[..., None, :] == ev[:, None])
            vml = torch.where(sel, lm[..., None, :], ninf).amax(-1)
            vms = torch.where(sel, ls[..., None, :], ninf).amax(-1)
            # the carried running max feeds event 0
            vml = torch.cat(
                [torch.maximum(vml[..., :1], state.radar_cur_m[..., None]), vml[..., 1:]], -1
            )
            vms = torch.cat(
                [torch.maximum(vms[..., :1], state.radar_cur_s[..., None]), vms[..., 1:]], -1
            )

            # only the last RADAR_POINTS fired events write: earlier ones would
            # be overwritten by the ring wrap, and masking them keeps ring
            # positions distinct
            ev_fired = (ev < total[..., None]) & (ev >= total[..., None] - RADAR_POINTS)
            ppos = (state.radar_pos[..., None] + ev) % RADAR_POINTS
            oh = (
                torch.arange(RADAR_POINTS, dtype=_I32, device=dev) == ppos[..., None]
            ) & ev_fired[..., None]  # [..., E, 360]; positions are distinct
            wrote = oh.any(-2)
            val_m = torch.where(oh, vml[..., None], ninf).amax(-2)
            val_s = torch.where(oh, vms[..., None], ninf).amax(-2)

            # open (unfired) group becomes the new running max
            open_sel = valid & (contrib == total[..., None])
            keep_carry = total == 0
            rcm = torch.maximum(
                torch.where(open_sel, lm, ninf).amax(-1),
                torch.where(keep_carry, state.radar_cur_m, ninf),
            )
            rcs = torch.maximum(
                torch.where(open_sel, ls, ninf).amax(-1),
                torch.where(keep_carry, state.radar_cur_s, ninf),
            )
            off_new = (off + T) % fragm
            rspd = S[..., -1] - spd_flat * total + torch.where(ncomp > 0, off_new, T)

            return self._pack_state(
                **pack,
                radar_m=torch.where(wrote, val_m, state.radar_m),
                radar_s=torch.where(wrote, val_s, state.radar_s),
                radar_pos=(state.radar_pos + total) % RADAR_POINTS,
                rcm=rcm, rcs=rcs, rspd=rspd,
            )

    def _pack_state(
        self, *, state, z, tp_hist, seg, ncomp, off, T, fragm, roll,
        loud_m, loud_s, max_m, max_s, hist_m, hist_s, dcm, dcs, dbtp,
        radar_m, radar_s, radar_pos, rcm, rcs, rspd, hist_m_snap,
        count_m_snap,
    ) -> EbuR128State:
        n_int = torch.where(state.integrating, ncomp, 0)
        n_lo = state.n_lo + state.integrating.to(_I32) * T
        return EbuR128State(
            z=z,
            tp_hist=tp_hist,
            frpwr=torch.gather(seg, -1, ncomp[..., None].long())[..., 0],
            off=(off + T) % fragm,
            fhist=roll,
            loud_m=loud_m,
            loud_s=loud_s,
            max_m=max_m,
            max_s=max_s,
            hist_m=hist_m,
            hist_s=hist_s,
            count_m=state.count_m + dcm,
            count_s=state.count_s + dcs,
            div1=(state.div1 + n_int) % 2,
            div2=(state.div2 + n_int) % 10,
            dbtp=dbtp,
            integrating=state.integrating,
            n_lo=n_lo % _NRADIX,
            n_hi=state.n_hi + n_lo // _NRADIX,
            radar_m=radar_m,
            radar_s=radar_s,
            radar_pos=radar_pos,
            radar_cur_m=rcm,
            radar_cur_s=rcs,
            radar_spd_cur=rspd,
            radar_spd=state.radar_spd,
            hist_m_snap=hist_m_snap,
            count_m_snap=count_m_snap,
        )

    # -- gated statistics (ebu_r128_proc.cc:82-150) ---------------------------

    def _bin_power(self, device) -> torch.Tensor:
        device = lti.canonical_device(device)
        if device not in self._bin_power_on:
            with profiler.counted("cache.fill"):
                k = torch.arange(HIST_BINS, dtype=_F32, device=device)
                self._bin_power_on[device] = torch.pow(10.0, (k - 700.0) / 100.0)
        return self._bin_power_on[device]

    def _integrate_from(self, hist, kstart):
        """integrate(i): mean linear power of bins >= kstart."""
        bp = self._bin_power(hist.device)
        bins = torch.arange(HIST_BINS, device=hist.device)
        h = torch.where(bins >= kstart[..., None], hist, 0).to(_F32)
        return (h * bp).sum(-1), h.sum(-1)

    def calc_integ(self, state: EbuR128State):
        """Gated integrated loudness + threshold (calc_integ, :105-125)."""
        s0, n0 = self._integrate_from(state.hist_m, torch.zeros_like(state.count_m))
        l0 = 10.0 * torch.log10(s0 / torch.clamp_min(n0, 1.0))
        th = l0 - 10.0
        k = float_to_int32(torch.floor(10.0 * l0 + 0.5)) + 600
        k = torch.clamp(k, 0, HIST_BINS - 1)
        s1, n1 = self._integrate_from(state.hist_m, k)
        li = 10.0 * torch.log10(s1 / torch.clamp_min(n1, 1.0))
        bad = (state.count_m < 50) | (n1 == 0)
        return (
            torch.where(bad, -200.0, li),
            torch.where(state.count_m < 50, -200.0, th),
        )

    def calc_range(self, state: EbuR128State):
        """Loudness range 10%..95% above the -20 dB gate (calc_range, :128-150)."""
        s0, n0 = self._integrate_from(state.hist_s, torch.zeros_like(state.count_s))
        l0 = 10.0 * torch.log10(s0 / torch.clamp_min(n0, 1.0))
        th = l0 - 20.0
        k = float_to_int32(torch.floor(10.0 * l0 + 0.5)) + 500
        k = torch.clamp(k, 0, HIST_BINS - 1)
        bins = torch.arange(HIST_BINS, device=state.hist_s.device)
        h = torch.where(bins >= k[..., None], state.hist_s, 0)
        c = torch.cumsum(h, -1).to(_F32)  # integer cumsum, then f32
        n = c[..., -1]
        a = 0.10 * n
        b = 0.95 * n
        # i = 1 + first bin where cumsum >= a ; j = last bin where cumsum <= b
        i = (c < a[..., None]).sum(-1) + 1
        j = (c <= b[..., None]).sum(-1) - 1
        v0 = (i.to(_F32) - 701.0) / 10.0
        v1 = (j.to(_F32) - 699.0) / 10.0
        bad = state.count_s < 20
        return (
            torch.where(bad, -200.0, v0),
            torch.where(bad, -200.0, v1),
            torch.where(bad, -200.0, th),
        )

    def read(self, state: EbuR128State, cadence_500ms: bool = False):
        """Full mtr_ebulevels readout (src/ebulv2.cc:466-482).

        cadence_500ms=True (requires track_cadence): I and LRA from the
        histograms as of the most recent S-point, the reference's cached
        values (ebu_r128_proc.cc:240-243).  Default False computes them from
        the live histograms."""
        with profiler.span("r128.read"):
            if cadence_500ms:
                if not self.track_cadence:
                    raise ValueError(
                        "construct EbuR128Meter(track_cadence=True) for 500 ms-"
                        "cadence readouts"
                    )
                snap = dataclasses.replace(
                    state, hist_m=state.hist_m_snap, count_m=state.count_m_snap
                )
                li, ith = self.calc_integ(snap)
                v0, v1, rth = self.calc_range(snap)
            else:
                li, ith = self.calc_integ(state)
                v0, v1, rth = self.calc_range(state)
            return {
                "loudness_M": state.loud_m,
                "loudness_S": state.loud_s,
                "max_M": state.max_m,
                "max_S": state.max_s,
                "integrated": li,
                "integ_thr": ith,
                "range_min": v0,
                "range_max": v1,
                "range_thr": rth,
                "lra": v1 - v0,
                "dbtp": state.dbtp,
                "integ_time_s": self.total_samples(state) / self.fs,
                "radar_m": state.radar_m,
                "radar_s": state.radar_s,
                "radar_pos": state.radar_pos,
                "radar_spd": state.radar_spd,
            }, state

    def total_samples(self, state: EbuR128State) -> torch.Tensor:
        """Integrated sample count as f32 (the counter itself is exact)."""
        return state.n_hi.to(_F32) * float(_NRADIX) + state.n_lo.to(_F32)

    def radar_reset(self, state: EbuR128State) -> EbuR128State:
        """CTL_RESETRADAR (src/ebulv2.cc:296-300)."""
        ninf = -float("inf")
        return dataclasses.replace(
            state,
            radar_m=torch.full_like(state.radar_m, ninf),
            radar_s=torch.full_like(state.radar_s, ninf),
            radar_pos=torch.zeros_like(state.radar_pos),
            radar_cur_m=torch.full_like(state.radar_cur_m, ninf),
            radar_cur_s=torch.full_like(state.radar_cur_s, ninf),
            radar_spd_cur=torch.zeros_like(state.radar_spd_cur),
        )

    def set_radar_speed(self, state: EbuR128State, seconds) -> EbuR128State:
        """CTL_RADARTIME (src/ebulv2.cc:75-78,312-318): change the radar
        interval at runtime, a pure state update.  The ring and the open
        interval counter carry over, as in the reference."""
        if not self.runtime_radar_speed:
            raise ValueError(
                "construct EbuR128Meter(runtime_radar_speed=True) for "
                "mid-stream radar speed changes"
            )
        # schema range 30 s .. 4 h; the reference clamps only the interval
        # at >= 4096 samples (ebu_set_radarspeed, src/ebulv2.cc:75-78)
        sec = torch.clamp(
            torch.as_tensor(seconds, dtype=_F32, device=state.radar_spd.device),
            30.0, 14400.0,
        )
        spd = torch.round(sec * self.fs / RADAR_POINTS).to(_I32)
        spd = torch.clamp_min(spd, max(4096, self.fragm))
        return dataclasses.replace(
            state, radar_spd=torch.broadcast_to(spd, state.radar_spd.shape).clone()
        )
