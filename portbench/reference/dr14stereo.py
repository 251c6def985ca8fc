"""Plain DR-14 meter (x42 ``dr14stereo``, src/dr14.c).

Per channel, over each stream's whole history from silence, read once at
the programme's end (dr14.c:447-516):

  * the display RMS, a K-meter (jmeters/kmeterdsp.cc:77-139): per sample
    z1 += w (x^2 - z1), per group of 4 samples z2 += 4 w (z1 - z2), w =
    9.72 / fs rounded to float32; the readout is the largest sqrt(2 z2)
    at the end of an update since the programme's start.  Both one-pole
    stages are evaluated exactly by lti.Blocked;
  * the display and accumulated true peak: dBTPstereo.py's ballistic level
    and raw 4x peak (truepeakdsp.cc), the accumulated max dBTP being the
    raw peak at the first read (dr14.c:480);
  * the DR measurement (dr14.c:263-343, 396-445): windows of 3 fs + 1
    samples from the first sample (the C code counts ``++scnt > slmt``
    after accumulating), each window's sum of squares and positive sample
    peak (floor 0); a window counts when any channel's sum exceeds 1e-9 *
    3 fs; a counted window puts its RMS sqrt(2 sum / 3 fs) into bin
    round(100 (80 + dB)) - 1 of 8,000 (dB = -80 below 1e-4, the bin at
    most 7,999, only bins above 0), and its channel's peak, held since the
    last counted window, into the two highest; the RMS score is the top
    20 % of the histogram by whole bins (at least one window), DR = min(0,
    2nd peak dB) - score dB, clamped to 1..20 (21 where either is -80 or
    below, and -81 for both with fewer than 3 windows);
  * every readout converted by coeff_to_db (dr14.c:233-236): 20 log10,
    -80 below 1e-4.

Departures: the K-meter's 1e-20 added to z1 and z2 on exit of each update
(kmeterdsp.cc:101-107) is left out: it moves a readout above -80 dB by
less than 1e-10 relative.  The entry clamps of the K-meter ([0, 50]) and
of the true peak never act on samples within [-1, 1].  The C code's
uint32 histogram is int64 here.

How it is judged (``judge``).  The display RMS (v_rms, dB) is a plain dB
difference of its own, ``rms_db``: the K-meter is the one readout here
whose reference runs through matrix products large enough for the TF32
control to show, so its limit sits between the program's float32 noise
and that control.  The display and accumulated true peak (v_peak, m_peak,
dB) are plain dB differences, compare.py's "lufs" kind, in ``level_db``.
The histogram is judged as EBUr128.py judges R128's: a
float32 meter puts a window whose RMS lies within its rounding of a bin
edge (AMBIGUOUS_BINS of a bin, 5e-5 dB) in either bin, and a window whose
largest channel sum lies within GATE_REL of the gate on either side of
it; ``dr_moves`` counts the points moved beyond those, the windows
counted beyond the gate-ambiguous ones, and the two highest peaks (exact
sample values) that differ in a stream with no gate-ambiguous window.  The
score, DR, the average DR and the block count are the C code's read over
the program's own histogram, window count and peaks in float64, in
``level_db``.
"""

from __future__ import annotations

import numpy as np
import torch

from .dBTPstereo import expected as true_peak
from .dBTPstereo import f32
from .lti import Blocked, Prec

KIND = "dr14stereo"
READOUTS = {
    "v_rms": "rms_db", "v_peak": "lufs", "m_peak": "lufs",
    "m_rms": "dr", "dr": "dr", "dr_total": "dr", "block_count": "dr",
}
STATE = {"hist": "dr_hist", "peak_top2": "dr_peak", "num_windows": "dr_count"}
BINS = 8000
AMBIGUOUS_BINS = 5e-3  # of a 0.01 dB bin: float32's rounding of sum, log10 and 100 (80 + dB)
GATE_REL = 1e-5  # float32's relative rounding of a window's sum of squares, with room


def coeff_db(c):
    """dr14.c:233-236 on a float64 tensor."""
    return torch.where(c < 1e-4, torch.full_like(c, -80.0),
                       20.0 * torch.log10(torch.clamp(c, min=1e-30)))


def _kmeter_rms(x: torch.Tensor, fs: int, block: int, prec: Prec) -> torch.Tensor:
    """x [R, n] -> [R] the largest sqrt(2 z2) at an update's end."""
    w = f32(9.72 / fs)
    a = 1.0 - w
    b = 1.0 - 4.0 * w
    z1 = Blocked([(np.array([[a]]), np.array([[w]]), np.array([[a]]), np.array([[w]]))],
                 prec, x.device)(x.to(prec.dtype) ** 2)  # after each sample
    z1g = z1[..., 3::4]  # after each group of 4
    del z1
    z2 = Blocked([(np.array([[b]]), np.array([[4 * w]]), np.array([[b]]), np.array([[4 * w]]))],
                 prec, x.device)(z1g)  # after each group
    ends = z2[..., block // 4 - 1::block // 4]
    return torch.sqrt(2.0 * ends).amax(-1)


def _bins(rms: torch.Tensor):
    """Window RMS [..] -> (value 100 (80 + dB), bin) as the C code's lround."""
    v = 100.0 * (80.0 + coeff_db(rms))
    return v, torch.clamp(torch.floor(v + 0.5) - 1, max=BINS - 1).long()


def _count(idx: torch.Tensor, use: torch.Tensor) -> torch.Tensor:
    """idx [S, C, W] bins, use [S, C, W] bool -> [S, C, BINS] counts."""
    h = torch.zeros((*idx.shape[:-1], BINS), dtype=torch.int64, device=idx.device)
    return h.scatter_add_(-1, idx.clamp(0, BINS - 1), use.long())


def _edges(bins: torch.Tensor, use: torch.Tensor) -> torch.Tensor:
    """A point of bin b may leave the histogram or enter it: it crosses every
    edge 1..b (edge e lies between bin e - 1 and bin e, bin 0 never counted).
    -> [S, C, BINS] how many such points reach past each edge."""
    e = torch.arange(BINS, device=bins.device)
    reach = (e >= 1) & (e <= bins[..., None])  # [S, C, W, BINS]
    return (reach & use[..., None]).sum(-2)


def expected(x: torch.Tensor, fs: int, reads: list[int], prec: Prec, block: int) -> dict:
    """x [S, C, n], one read at the end -> {key: [S, 1, ...]}, with the
    ambiguous points ("amb": [S, 1, C, 2, BINS], up then down, by edge) and
    the gate-ambiguous windows of each stream ("gate_amb": [S, 1])."""
    S, C, n = x.shape
    if reads != [n] or n % block or block % 4:
        raise ValueError("the DR-14 reference reads once, after whole updates")
    dev = x.device
    with prec.active():
        v_rms = coeff_db(_kmeter_rms(x.reshape(S * C, n), fs, block, prec).reshape(S, C))
        tp = true_peak(x, fs, reads, prec, block)
        v_peak = coeff_db(tp["level"][:, 0].to(prec.dtype))
        m_peak = coeff_db(tp["peak"][:, 0].to(prec.dtype))

        win = int(round(3.0 * fs))
        L = win + 1
        W = n // L
        xw = x[..., :W * L].reshape(S, C, W, L).to(prec.dtype)
        sums = (xw * xw).sum(-1)  # [S, C, W]
        peaks = torch.where(torch.isnan(xw), 0.0, xw).clamp(min=0.0).amax(-1)
        del xw
    thr = 1e-9 * win
    counted = (sums > thr).any(1)  # [S, W], the gate across channels
    clear = (sums > thr * (1 + GATE_REL)).any(1)
    near = ((sums - thr).abs() <= thr * GATE_REL).any(1)
    gate_amb = near & ~clear
    sure = counted & ~gate_amb
    v, bins = _bins(torch.sqrt(2.0 * sums.to(torch.float64) / win))
    cnt = counted[:, None, :].expand(S, C, W)
    hist = _count(bins, cnt & (bins > 0))
    frac = v + 0.5 - torch.floor(v + 0.5)  # in [0, 1): 0 at the bin's lower edge
    keep = sure[:, None, :].expand(S, C, W)
    e = torch.arange(BINS, device=dev)
    up_edge = torch.where(keep & (frac > 1.0 - AMBIGUOUS_BINS) & (bins + 1 <= BINS - 1)
                          & (bins + 1 >= 1), bins + 1, -1)
    down_edge = torch.where(keep & (frac < AMBIGUOUS_BINS) & (bins >= 1), bins, -1)
    up = (up_edge[..., None] == e).sum(-2)
    down = (down_edge[..., None] == e).sum(-2)
    # a gate-ambiguous window may be absent (it counts here) or present
    g = gate_amb[:, None, :].expand(S, C, W)
    down = down + _edges(bins, g & counted[:, None, :])
    up = up + _edges(bins, g & ~counted[:, None, :])

    pk = torch.zeros((S, C), dtype=torch.float64, device=dev)
    top2 = torch.zeros((S, C, 2), dtype=torch.float64, device=dev)
    for j in range(W):
        pk = torch.maximum(pk, peaks[..., j].to(torch.float64))
        new = torch.topk(torch.cat([top2, pk[..., None]], -1), 2, dim=-1).values
        c = counted[:, j, None]
        top2 = torch.where(c[..., None], new, top2)
        pk = torch.where(c, torch.zeros_like(pk), pk)
    nf = counted.sum(-1)
    m_rms, dr, dr_total = read_dr(hist, nf, top2)
    one = lambda t: t[:, None]  # noqa: E731  (the one read)
    return {
        "v_rms": one(v_rms), "v_peak": one(v_peak), "m_peak": one(m_peak),
        "m_rms": one(m_rms), "dr": one(dr), "dr_total": one(dr_total),
        "block_count": one(3.0 * nf.to(torch.float64)),
        "hist": one(hist), "peak_top2": one(top2), "num_windows": one(nf),
        "amb": one(torch.stack([up, down], dim=-2)), "gate_amb": one(gate_amb.sum(-1)),
    }


def read_dr(hist: torch.Tensor, nf: torch.Tensor, top2: torch.Tensor):
    """The C code's read (dr14.c:447-516) in float64: hist [..., C, BINS],
    nf [...], top2 [..., C, 2] -> (score dB [..., C], DR [..., C], the
    average DR [...])."""
    hist = hist.to(torch.float64)
    nf = nf.to(torch.float64)
    m_cut = torch.clamp(torch.floor(nf / 5.0), min=1.0)
    rev = torch.flip(hist[..., 1:], [-1])  # bins 7999 .. 1
    above = torch.cumsum(rev, -1) - rev  # windows in the bins above each
    inc = above < m_cut[..., None, None]
    b = torch.arange(BINS - 1, 0, -1, dtype=torch.float64, device=hist.device)
    cd = 10.0 ** (0.05 * (b - (BINS - 1)) / 100.0)
    score = torch.where(inc, rev * cd * cd, 0.0).sum(-1)
    n_cut = torch.where(inc, rev, 0.0).sum(-1)
    enough = nf[..., None] > 2
    rms_db = torch.where((n_cut > 0) & enough,
                         coeff_db(torch.sqrt(score / torch.clamp(n_cut, min=1.0))),
                         torch.full_like(score, -81.0))
    peak_db = torch.where(enough, coeff_db(top2[..., 1].to(torch.float64)),
                          torch.full_like(score, -81.0))
    both = (rms_db > -80.0) & (peak_db > -80.0)
    raw = torch.clamp(peak_db, max=0.0) - rms_db
    dr = torch.where(both, torch.clamp(raw, 1.0, 20.0), torch.full_like(raw, 21.0))
    nvalid = both.sum(-1)
    total = torch.where(both, raw, torch.zeros_like(raw)).sum(-1) / torch.clamp(nvalid, min=1)
    dr_total = torch.where(nvalid > 0, torch.clamp(total, 1.0, 20.0), torch.full_like(total, 21.0))
    return rms_db, dr, dr_total


def judge(name: str, port: dict, at: dict, ref: dict) -> dict:
    """{"dr_moves": [S], "level_db": [S], "rms_db": [S]} for the meter
    ``name``."""
    def k(key):
        return f"{name}.{key}"

    hat = at.get(k("hist"), np.zeros(0, np.int64))
    if port.get(k("hist")) is None or not len(hat):
        inf = np.full(ref[k("hist")].shape[0], np.inf)
        return {"dr_moves": inf, "level_db": inf, "rms_db": inf}
    ph = np.asarray(port[k("hist")], np.int64)  # [S, R', C, BINS]
    S, R, C, _ = ph.shape
    rh = np.broadcast_to(ref[k("hist")][:, hat], ph.shape)
    amb = np.broadcast_to(ref[k("amb")][:, hat], (S, R, C, 2, BINS))
    moves = _moves_each(ph, rh, amb)
    gate = ref[k("gate_amb")][:, hat]  # [S, R']
    pnf = np.asarray(port[k("num_windows")], np.int64)
    rnf = ref[k("num_windows")][:, hat]
    moves = moves + np.maximum(np.abs(pnf - rnf) - gate, 0).sum(-1)
    ptop = np.asarray(port[k("peak_top2")], np.float64)
    rtop = ref[k("peak_top2")][:, hat]
    moves = moves + np.where(gate[..., None, None] > 0, 0, ptop != rtop).reshape(S, -1).sum(-1)
    # the program's read against the C code's read of its own state
    pos = at[k("state_pos")]
    m_rms, dr, dr_total = (t.numpy() for t in read_dr(
        torch.as_tensor(ph), torch.as_tensor(pnf), torch.as_tensor(ptop)))
    g = np.zeros(S)
    for key, want in (("m_rms", m_rms), ("dr", dr), ("dr_total", dr_total),
                      ("block_count", 3.0 * pnf)):
        got = np.asarray(port[k(key)], np.float64)[:, pos]
        d = np.abs(got - want)
        g = np.maximum(g, np.where(np.isnan(d), np.inf, d).reshape(S, -1).max(-1))
    rms = np.abs(np.asarray(port[k("v_rms")], np.float64) - ref[k("v_rms")][:, at[k("v_rms")]])
    rms = np.where(np.isnan(rms), np.inf, rms).reshape(S, -1).max(-1)
    return {"dr_moves": moves.astype(np.float64), "level_db": g, "rms_db": rms}


def _moves_each(port: np.ndarray, ref: np.ndarray, amb: np.ndarray) -> np.ndarray:
    """[S, R', C, BINS] histograms, amb [S, R', C, 2, BINS] -> [S] the
    crossings of bin edges that ambiguity does not explain, summed over the
    channels and the reads (EBUr128.py's count).  Bin 0 is never counted,
    so edges 1..7,999 are the histogram's: the points at or above edge e,
    less the reference's, must be covered by the ambiguous points there."""
    d = (port - ref)[..., 1:]
    above = np.cumsum(d[..., ::-1], axis=-1)[..., ::-1]
    un = (np.maximum(above - amb[..., 0, 1:], 0)
          + np.maximum(-above - amb[..., 1, 1:], 0))
    return un.reshape(port.shape[0], -1).sum(-1)
