"""Plain EBU R128 / BS.1770 loudness with true peak (x42 ``EBUr128``).

Straight from the published description and the C reference
(ebumeter/ebu_r128_proc.cc, src/ebulv2.cc), over each stream's whole
history from silence:

  * K-weighting: the 4-state recurrence of ebu_r128_proc.cc:319-328
    (coefficients from the frozen design), power = sum of channel gain
    times y^2;
  * 1/20 s fragments: power sums plus the 1e-30 seed (:207-248); M over 8
    and S over 60 fragments, zeros before the first, -0.6976 + 10 log10,
    -200 where not finite or below;
  * histograms of 0.1 LU bins, floor(10 L + 700.5) in 0..750: M points at
    every 2nd fragment, S points at every 10th (:62-79, :229-242);
  * gated integrated loudness and LRA from the histograms (:105-150), with
    the C reference's float32 percentile thresholds 0.1f n and 0.95f n;
  * the 4x true peak: |x| of the zita polyphase FIR (48 taps a phase,
    truepeakdsp.cc), max over channels, phases and samples.

No block structure: a read after e samples sees exactly the samples
before e, which is what a meter updated in any blocks must show.

How the gating is judged (``judge``).  A float32 meter puts a point whose
loudness lies within its rounding of a bin edge in either bin, so its
histograms may differ from these by such points, and each moved point
moves I by up to ~1e-2 LU when it crosses the relative gate.  So:

  * ``hist_moves``: the program's histograms must be these with only
    ambiguous points moved, those within AMBIGUOUS_LU of an edge (6x the
    largest float32 error of the program's M and S seen on the card), each
    across its own edge.  The points a histogram has at or above an edge, less these
    histograms', must be covered by the ambiguous points at that edge;
    what is not covered is counted.  An exact comparison.
  * the program's I and LRA against this reference's gating of the
    program's own histograms (whose points ``hist_moves`` judged), in
    float64, go into ``level_db``: a lower precision than float32 shows on
    M, S and the true peak, not in this integer-weighted sum (a TF32
    control computes it as the program does).
"""

from __future__ import annotations

import numpy as np
import torch

from . import design
from .lti import REFERENCE, Blocked, Prec
from .truepeak import peak_per_sample

KIND = "EBUr128"
READOUTS = {
    "loudness_M": "lufs", "loudness_S": "lufs", "max_M": "lufs", "max_S": "lufs",
    "dbtp": "lin", "integrated": "gated", "lra": "gated",
}
STATE = {"hist_m": "hist", "hist_s": "hist"}
BINS = 751
AMBIGUOUS_LU = 5e-5


def _lufs(s: torch.Tensor, w: int) -> torch.Tensor:
    v = -0.6976 + 10.0 * torch.log10(s / w)
    return torch.where(torch.isfinite(v) & (v >= -200.0), v, torch.full_like(v, -200.0))


def _windows(fp: torch.Tensor, w: int) -> torch.Tensor:
    """sum of the w fragments ending at each fragment, zeros before."""
    p = torch.nn.functional.pad(fp, (w - 1, 0))
    return p.unfold(-1, w, 1).sum(-1)


def _points(values: torch.Tensor, use: torch.Tensor):
    """values [S, F] loudness a fragment, use [F] which fragments are
    points -> (bin [S, F] or -1, up edge [S, F] or -1, down edge [S, F] or
    -1): the edge (0..750) an ambiguous point could cross upward (it lies
    just below it) or downward (just above it); edge b lies between bin
    b - 1 (or below the histogram, for b = 0) and bin b."""
    z = 10.0 * values.to(torch.float64) + 700.5
    k = torch.floor(z)
    eps = 10.0 * AMBIGUOUS_LU
    used = use[None, :].expand_as(k)
    none = torch.full_like(k, -1)
    binned = torch.where(used & (k >= 0), k.clamp(max=BINS - 1), none)
    up = torch.where(used & (z - k > 1.0 - eps) & (k >= -1) & (k < BINS - 1), k + 1, none)
    down = torch.where(used & (z - k < eps) & (k >= 0) & (k <= BINS - 1), k, none)
    return binned.long(), up.long(), down.long()


def _cum_counts(idx: torch.Tensor, frag_at: list[int]) -> torch.Tensor:
    """idx [S, F] bin or -1 -> [S, R, BINS] int32 counts among the first
    frag_at[r] fragments."""
    S, F = idx.shape
    inc = torch.zeros((S, F, BINS), dtype=torch.int32, device=idx.device)
    inc.scatter_(2, idx.clamp(min=0)[..., None], (idx >= 0).to(torch.int32)[..., None])
    cum = torch.cumsum(inc, dim=1, dtype=torch.int32)
    del inc
    pick = torch.as_tensor([max(f, 1) - 1 for f in frag_at], device=idx.device)
    h = cum.index_select(1, pick)
    zero = torch.as_tensor([f == 0 for f in frag_at], device=idx.device)
    return torch.where(zero[None, :, None], torch.zeros_like(h), h)


def _f32mul(c: float, n: torch.Tensor) -> torch.Tensor:
    """float32 c * n rounded to float32, as the C reference's float code."""
    return (torch.tensor(c, dtype=torch.float32) * n.to(torch.float32)).to(torch.float64)


def gated(hist_m, hist_s, prec: Prec):
    """(integrated, lra) from histograms [..., BINS] (calc_integ,
    calc_range); the counts are the histograms' sums."""
    dev = hist_m.device
    dt = prec.dtype
    hist_m = hist_m.long()
    hist_s = hist_s.long()
    count_m, count_s = hist_m.sum(-1), hist_s.sum(-1)
    bins = torch.arange(BINS, device=dev)
    bp = torch.pow(torch.tensor(10.0, dtype=torch.float64, device=dev),
                   (bins.to(torch.float64) - 700.0) / 100.0).to(dt)

    def integ(h, kmin):
        hm = torch.where(bins >= kmin[..., None], h, torch.zeros_like(h)).to(dt)
        s = prec.mm(hm[..., None, :], bp[:, None])[..., 0, 0]
        return s, hm.sum(-1)

    def level(h):
        s0, n0 = integ(h, torch.zeros(h.shape[:-1], dtype=torch.long, device=dev))
        l0 = 10.0 * torch.log10(s0 / torch.clamp_min(n0, 1.0))
        k = torch.floor(10.0 * l0 + 0.5)
        return torch.where(torch.isfinite(k), k, torch.zeros_like(k)).long()

    k = level(hist_m)
    s1, n1 = integ(hist_m, (k + 600).clamp(0, BINS - 1))
    li = 10.0 * torch.log10(s1 / torch.clamp_min(n1, 1.0))
    bad = (count_m < 50) | (n1 == 0)
    integrated = torch.where(bad, torch.full_like(li, -200.0), li)

    kmin = (level(hist_s) + 500).clamp(0, BINS - 1)
    h = torch.where(bins >= kmin[..., None], hist_s, torch.zeros_like(hist_s))
    c = torch.cumsum(h, -1).to(torch.float64)
    n = c[..., -1]
    a = _f32mul(0.10, n)
    b = _f32mul(0.95, n)
    i = (c < a[..., None]).sum(-1) + 1
    j = (c <= b[..., None]).sum(-1) - 1
    v0 = (i.to(torch.float64) - 701.0) / 10.0
    v1 = (j.to(torch.float64) - 699.0) / 10.0
    lra = torch.where(count_s < 20, torch.zeros_like(v0), v1 - v0)
    return integrated, lra


def expected(x: torch.Tensor, fs: int, reads: list[int], prec: Prec, block: int) -> dict:
    """x [S, C, n] audio; reads: sample counts after which the program read
    (ascending) -> {key: [S, R, ...]}, with the ambiguous points a
    histogram may move ("amb_m", "amb_s": [S, R, 2, BINS], up then down,
    by edge)."""
    S, C, n = x.shape
    dev = x.device
    dt = prec.dtype
    fragm = int(fs) // 20
    gains = np.array([2.0]) if C == 1 else design.R128_CHAN_GAIN[:C]
    with prec.active():
        kw = Blocked([design.k_weighting_state_space(fs)], prec, dev)
        y = kw(x)  # [S, C, n]
        p = (y * y * prec.t(gains, dev)[None, :, None]).sum(1)
        del y
        F = n // fragm
        fp = (p[:, :F * fragm].reshape(S, F, fragm).sum(-1) + 1e-30) / fragm
        del p
        lm = _lufs(_windows(fp, 8), 8)  # [S, F]
        ls = _lufs(_windows(fp, 60), 60)
        frag_at = [e // fragm for e in reads]
        last = torch.as_tensor([max(f, 1) - 1 for f in frag_at], device=dev)
        none = torch.as_tensor([f == 0 for f in frag_at], device=dev)[None, :]
        neg = torch.full((S, len(reads)), -200.0, dtype=dt, device=dev)
        out = {
            "loudness_M": torch.where(none, neg, lm.index_select(1, last)),
            "loudness_S": torch.where(none, neg, ls.index_select(1, last)),
            "max_M": torch.where(none, neg, torch.clamp_min(torch.cummax(lm, 1)[0], -200.0)
                                 .index_select(1, last)),
            "max_S": torch.where(none, neg, torch.clamp_min(torch.cummax(ls, 1)[0], -200.0)
                                 .index_select(1, last)),
        }
        j = torch.arange(F, device=dev)
        for key, vals, use in (("m", lm, j % 2 == 1), ("s", ls, j % 10 == 9)):
            binned, up, down = _points(vals, use)
            out["hist_" + key] = _cum_counts(binned, frag_at)
            out["amb_" + key] = torch.stack([_cum_counts(up, frag_at),
                                             _cum_counts(down, frag_at)], dim=2)
        out["integrated"], out["lra"] = gated(out["hist_m"], out["hist_s"], prec)
        peak = torch.cummax(peak_per_sample(x, prec), dim=1)[0]  # [S, n]
        out["dbtp"] = peak.index_select(1, torch.as_tensor([e - 1 for e in reads], device=dev))
    return out


def _moves(port: np.ndarray, ref: np.ndarray, amb: np.ndarray) -> np.ndarray:
    """[S, R, BINS] histograms, amb [S, R, 2, BINS] -> [S] the most points
    at a read that ambiguity does not explain."""
    d = port.astype(np.int64) - ref.astype(np.int64)
    above = np.cumsum(d[..., ::-1], axis=-1)[..., ::-1]  # points at or above edge b
    un = np.maximum(above - amb[..., 0, :], 0) + np.maximum(-above - amb[..., 1, :], 0)
    return un.sum(-1).max(-1).astype(np.float64)


def judge(name: str, port: dict, at: dict, ref: dict) -> dict:
    """{"hist_moves": [S], "level_db": [S]} for the meter ``name``."""
    def k(key):
        return f"{name}.{key}"

    hat = at.get(k("hist_m"), np.zeros(0, np.int64))
    if port.get(k("hist_m")) is None or not len(hat):
        inf = np.full(ref[k("hist_m")].shape[0], np.inf)
        return {"hist_moves": inf, "level_db": inf}
    moves = sum(_moves(port[k("hist_" + s)], ref[k("hist_" + s)][:, hat],
                       ref[k("amb_" + s)][:, hat]) for s in "ms")
    gi, gl = gated(torch.as_tensor(port[k("hist_m")]), torch.as_tensor(port[k("hist_s")]),
                   REFERENCE)
    # the program's I and LRA read where its histograms were taken
    pos = at[k("state_pos")]
    pi = np.asarray(port[k("integrated")], np.float64)[:, pos]
    pl = np.asarray(port[k("lra")], np.float64)[:, pos]
    g = np.maximum(np.abs(pi - gi.numpy()), np.abs(pl - gl.numpy()))
    return {"hist_moves": moves, "level_db": np.where(np.isnan(g), np.inf, g).max(-1)}
