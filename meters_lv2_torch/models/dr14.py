"""DR-14 crest-factor meter and TP+RMS meter.

Counterpart of ``meters_lv2_tpu/models/dr14.py``.  Reference: src/dr14.c --
per channel a Kmeterdsp (display RMS) and a TruePeakdsp (display dBTP),
plus the DR measurement loop (:396-445): 3 s non-overlapping RMS windows,
a silence gate, an 8000-bin 0.01 dB histogram, a top-20% RMS score, the
2nd-highest window sample-peak, and DR = min(0, peak_db) - rms_db clamped
to 1..20.

The display meters are the port's KMeter and TruePeakMeter on a [..., C]
state batch (on a card the true peak runs the truepeak_fused kernel).
Window sums and peaks come from ops/segment.shifted_segments; the window
RMS bins cast through ops/hist.float_to_int32, so a NaN or an Inf bins on
the CPU and on a card as in the JAX package.  The top-20% score is a
reversed cumsum over the histogram at read(): the histogram changes only
at window boundaries, so read-time evaluation equals the reference's
event-time evaluation.
"""

from __future__ import annotations

import dataclasses

import torch

from ..ops import hist as hist_ops
from ..ops import segment
from ..utils import profiler
from .base import register
from .kmeter import KMeter, KMeterState
from .truepeak import TruePeakMeter, TruePeakMeterState

DR_HISTBINS = 8000  # -80..0 dB in 0.01 dB steps (src/dr14.c:46)


def coeff_to_db(c: torch.Tensor) -> torch.Tensor:
    """src/dr14.c:233-236."""
    return torch.where(c < 1e-4, -80.0, 20.0 * torch.log10(torch.clamp(c, min=1e-30)))


@dataclasses.dataclass(frozen=True)
class DR14State:
    km: KMeterState  # [..., C] display RMS meter
    tp: TruePeakMeterState  # [..., C] display true-peak meter
    m_dbtp: torch.Tensor  # [..., C] accumulated max dBTP (dr14.c:480)
    # DR measurement (dr14 mode only)
    rms_sum: torch.Tensor  # [..., C] open 3 s window sum of squares
    peak_cur: torch.Tensor  # [..., C] open window sample peak
    peak_top2: torch.Tensor  # [..., C, 2] two highest window peaks
    scnt: torch.Tensor  # [...] int32 samples into the open window
    num_windows: torch.Tensor  # [...] int32 non-silent windows counted
    hist: torch.Tensor  # [..., C, 8000] int32 counts (reference: uint32, dr14.c:89)


@register("dr14mono")
@register("dr14stereo")
class DR14Meter:
    """DR-14 meter; nchan channels ride a trailing state batch axis."""

    dr_mode = True

    def __init__(self, fs: float, nchan: int = 2):
        self.fs = float(fs)
        self.nchan = nchan
        self.win = int(round(fs * 3.0))  # n_sample_cnt (dr14.c:155)
        # the reference tests `if (++scnt > slmt)` after accumulating
        # (dr14.c:404-410), so each window spans n_sample_cnt + 1 samples
        # while the RMS normalizes by n_sample_cnt
        self.win_len = self.win + 1
        self.km = KMeter(fs)
        self.tp = TruePeakMeter(fs)

    def init(self, batch_shape=(), device="cuda") -> DR14State:
        batch_shape = tuple(batch_shape)
        C = self.nchan

        def f(*s):
            return torch.zeros((*batch_shape, *s), dtype=torch.float32, device=device)

        def zi(*s):
            return torch.zeros((*batch_shape, *s), dtype=torch.int32, device=device)

        return DR14State(
            km=self.km.init((*batch_shape, C), device),
            tp=self.tp.init((*batch_shape, C), device),
            m_dbtp=f(C), rms_sum=f(C), peak_cur=f(C), peak_top2=f(C, 2),
            scnt=zi(), num_windows=zi(), hist=zi(C, DR_HISTBINS),
        )

    def update(self, state: DR14State, x: torch.Tensor) -> DR14State:
        """x: [..., C, T] float32, T % 4 == 0."""
        *batch, C, T = x.shape
        if C != self.nchan:
            raise ValueError(f"expected {self.nchan} channels, got {C}")
        with profiler.span("dr14.update"):
            x = x.to(torch.float32)
            with profiler.span("dr14.km"):
                km = self.km.update(state.km, x)
            with profiler.span("dr14.tp"):
                tp = self.tp.update(state.tp, x)
            if not self.dr_mode:
                return dataclasses.replace(state, km=km, tp=tp)

            win_len = self.win_len
            with profiler.span("dr14.windows"):
                n_slots = T // win_len + 2
                off = state.scnt[..., None].expand(*batch, C)
                seg_sum = segment.shifted_segments(torch.square(x), off, win_len, n_slots, "sum")
                # the reference keeps peak_cur = MAX(peak_cur, v) of the signed
                # sample (dr14.c:404): positive peaks only, floor 0; the MAX
                # comparison skips NaN samples, so they map to the identity
                xpk = torch.where(torch.isnan(x), 0.0, x)
                seg_peak = segment.shifted_segments(xpk, off, win_len, n_slots, "max")
                seg_sum = torch.cat([seg_sum[..., :1] + state.rms_sum[..., None],
                                     seg_sum[..., 1:]], -1)
            with profiler.span("dr14.hist"):
                ncomp = torch.div(state.scnt + T, win_len, rounding_mode="floor")
                return self._dr_epilogue(
                    state, km, tp, seg_sum, seg_peak, ncomp, (state.scnt + T) % win_len
                )

    def _dr_epilogue(self, state, km, tp, seg_sum, seg_peak, ncomp, scnt_new) -> DR14State:
        """DR measurement from per-window sums and peaks (dr14.c:263-343).

        seg_sum/seg_peak: [..., C, n_slots] (slot 0 already carries the
        open window's continuation); ncomp: [...] completed windows.  A
        separate method so that a path assembling window sums across time
        shards can feed the same gate, histogram and top-2 logic."""
        *batch, C, n_slots = seg_sum.shape
        slot = torch.arange(n_slots, dtype=torch.int32, device=seg_sum.device)
        validb = slot < ncomp[..., None]  # [..., n_slots]

        # silence gate across channels (dr14.c:263-276)
        thr = 1e-9 * float(self.win)
        counted = validb & (seg_sum > thr).any(dim=-2)  # [..., n_slots]

        # window RMS -> histogram bin (dr14.c:286-295); rms_sum resets at
        # every completed window, so the window RMS is the slot's sum
        rms = torch.sqrt(2.0 * seg_sum / float(self.win))
        bins = hist_ops.float_to_int32(torch.round(100.0 * (80.0 + coeff_to_db(rms)))) - 1
        bins = torch.clamp(bins, max=DR_HISTBINS - 1)
        ok = counted[..., None, :] & (bins > 0)
        hist = state.hist + hist_ops.bincount(bins, DR_HISTBINS, valid=ok, dtype=torch.int32)

        # peak_cur persists through silent windows and resets only at
        # counted windows, where its value enters the top 2 (dr14.c:271-276,
        # 329-343); a loop over the few slots
        pk, top2 = state.peak_cur, state.peak_top2
        for s in range(n_slots):
            pk = torch.maximum(pk, seg_peak[..., s])
            new_top2 = torch.topk(torch.cat([top2, pk[..., None]], -1), 2, dim=-1).values
            cnt = counted[..., s, None]  # [..., 1]
            top2 = torch.where(cnt[..., None], new_top2, top2)
            pk = torch.where(cnt, 0.0, pk)

        idx = ncomp.to(torch.int64)[..., None, None].expand(*batch, C, 1)
        return DR14State(
            km=km, tp=tp,
            m_dbtp=state.m_dbtp,
            rms_sum=torch.gather(seg_sum, -1, idx)[..., 0],
            peak_cur=pk,
            peak_top2=top2,
            scnt=scnt_new.to(torch.int32),
            num_windows=state.num_windows + counted.sum(-1, dtype=torch.int32),
            hist=hist,
        )

    def _display(self, state: DR14State):
        km_out, km_st = self.km.read(state.km)
        tp_out, tp_st = self.tp.read(state.tp)
        m_dbtp = torch.maximum(state.m_dbtp, tp_out["peak"])
        out = {
            "v_rms": coeff_to_db(km_out["rms"]),
            "v_peak": coeff_to_db(tp_out["level"]),
            "m_peak": coeff_to_db(m_dbtp),
        }
        return out, km_out, dataclasses.replace(state, km=km_st, tp=tp_st, m_dbtp=m_dbtp)

    def read(self, state: DR14State):
        """Port readouts (dr14.c:447-516)."""
        with profiler.span("dr14.read"):
            out, _, state = self._display(state)
            nf = state.num_windows
            m_cut = torch.clamp(torch.floor(nf / 5.0), min=1.0).to(torch.int32)
            # whole bins from the top until the count reaches m_cut; bin 0 is
            # excluded (the b > 0 loop bound)
            rev = torch.flip(state.hist[..., 1:], [-1])
            csum = torch.cumsum(rev, -1)
            cum_above = torch.cat([torch.zeros_like(csum[..., :1]), csum[..., :-1]], -1)
            inc = cum_above < m_cut[..., None, None]
            b_idx = torch.arange(DR_HISTBINS - 1, 0, -1, dtype=torch.float32, device=rev.device)
            cd = torch.pow(10.0, 0.05 * (b_idx - DR_HISTBINS + 1) / 100.0)
            revf = rev.to(torch.float32)
            score = torch.where(inc, revf * cd * cd, 0.0).sum(-1)
            n_cut = torch.where(inc, revf, 0.0).sum(-1)
            enough = nf[..., None] > 2
            rms_db = torch.where(
                (n_cut > 0) & enough,
                coeff_to_db(torch.sqrt(score / torch.clamp(n_cut, min=1.0))),
                -81.0,
            )
            peak_db = torch.where(enough, coeff_to_db(state.peak_top2[..., 1]), -81.0)
            both = (rms_db > -80.0) & (peak_db > -80.0)
            dr_raw = torch.clamp(peak_db, max=0.0) - rms_db
            dr = torch.where(both, torch.clamp(dr_raw, 1.0, 20.0), 21.0)
            nvalid = both.sum(-1)
            dr_total = torch.where(
                nvalid > 0,
                torch.clamp(torch.where(both, dr_raw, 0.0).sum(-1) / torch.clamp(nvalid, min=1),
                            1.0, 20.0),
                21.0,
            )
            out.update(
                m_rms=rms_db, dr=dr, dr_total=dr_total,
                block_count=3.0 * state.num_windows.to(torch.float32),
            )
            return out, state

    def reset(self, state: DR14State) -> DR14State:
        return self.init(state.scnt.shape, state.scnt.device)


@register("TPnRMSmono")
@register("TPnRMSstereo")
class TPnRMSMeter(DR14Meter):
    """dBTP + RMS only (dr14.c dr_operation_mode=false)."""

    dr_mode = False

    def read(self, state: DR14State):
        out, km_out, state = self._display(state)
        out["m_rms"] = coeff_to_db(km_out["peak"])
        return out, state
