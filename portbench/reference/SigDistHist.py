"""Plain signal-distribution histogram (x42 ``SigDistHist``, src/sigdistlv2.c).

A mono meter: the configuration's pipeline feeds it channel 0 of the
stereo stream.  Over the stream's whole history from the start of
integration, read once at the programme's end (sigdistlv2.c:287-355):

  * each sample v goes to bin rint(180 + 150 v) of 361; a sample outside
    0..360 is skipped for everything below (``if (bin < 0) continue``);
  * ``hist_max`` and ``hist_peak_bin``: the largest count and the first bin
    that holds it;
  * ``hist_avg``: the running sum of the accepted samples, which the C
    code transmits under that name; ``mean`` and ``hist_var``: their mean
    and their sum of squared deviations (Welford's var_s); ``variance``:
    var_s / (count - 1), at least over 1; ``integration_time``: every
    sample integrated.

Departures: the C code's Welford recurrence divides by the global sample
index, skipped samples included (sigdistlv2.c:313-318); the configured
meter (``reference_oor_count`` off, its default) and this reference divide
by the accepted samples.  The two differ only when a sample lies outside
-1.2033..1.2033; the generator clamps every sample to [-1, 1].  The
2^31-sample integration cap is never reached in a programme.

How it is judged (``judge``).  A float32 meter rounds 150 v and 180 + 150
v, so a sample within AMBIGUOUS of a half-integer may land in either bin
(2^-15, one float32 step at 256..512, covers both roundings); the
histogram is judged as EBUr128.py judges R128's (``sigdist_moves``: the
crossings of bin edges no ambiguous sample explains), with the program's
``hist_max`` and ``hist_peak_bin`` held to its own histogram and its
``integration_time`` to the samples, exactly.  The sums are judged
against the scale of what was summed, not against a value that may lie
near zero (``sigdist_rel``): the running sum and the mean against the sum
and the mean of |v|, var_s and the variance against the sum and the mean
of v^2.
"""

from __future__ import annotations

import numpy as np
import torch

from .lti import Prec

KIND = "SigDistHist"
READOUTS = {
    "hist": "sd_hist", "hist_max": "sd_count", "hist_peak_bin": "sd_count",
    "hist_avg": "sd_sum", "hist_var": "sd_sum", "mean": "sd_sum", "variance": "sd_sum",
    "integration_time": "sd_count",
}
STATE = {}
BINS = 361
AMBIGUOUS = 2.0 ** -15


def expected(x: torch.Tensor, fs: int, reads: list[int], prec: Prec, block: int) -> dict:
    """x [S, C, n], one read at the end -> {key: [S, 1, ...]}, with the
    ambiguous samples ("amb": [S, 1, 2, BINS], up then down, by edge) and the
    scales of the sums ("abs_sum", "sq_sum": [S, 1])."""
    S, C, n = x.shape
    if reads != [n]:
        raise ValueError("the sigdist reference reads once, at the programme's end")
    v = x[:, 0].to(torch.float64)
    u = 180.0 + 150.0 * v  # exact in float64
    k = torch.floor(u + 0.5)
    ok = (k >= 0) & (k < BINS)
    idx = torch.where(ok, k, torch.zeros_like(k)).long()
    hist = torch.zeros((S, BINS), dtype=torch.int64, device=x.device)
    hist.scatter_add_(1, idx, ok.long())
    frac = u + 0.5 - k  # in [0, 1): 0 at the bin's lower edge
    up = torch.zeros_like(hist).scatter_add_(
        1, (idx + 1).clamp(max=BINS - 1), (ok & (frac > 1.0 - AMBIGUOUS) & (k + 1 < BINS)).long())
    down = torch.zeros_like(hist).scatter_add_(1, idx, (ok & (frac < AMBIGUOUS)).long())
    cnt = ok.sum(-1)
    with prec.active():
        vv = torch.where(ok, v, torch.zeros_like(v)).to(prec.dtype)
        total = vv.sum(-1)
        mean = total / torch.clamp(cnt, min=1)
        d = torch.where(ok, vv - mean[:, None], torch.zeros_like(vv))
        m2 = (d * d).sum(-1)
    peak = hist.amax(-1)
    one = lambda t: t[:, None]  # noqa: E731  (the one read)
    vok = torch.where(ok, v, torch.zeros_like(v))
    return {
        "hist": one(hist), "hist_max": one(peak), "hist_peak_bin": one(hist.argmax(-1)),
        "hist_avg": one(total), "hist_var": one(m2), "mean": one(mean),
        "variance": one(m2 / torch.clamp(cnt - 1, min=1)),
        "integration_time": one(torch.full((S,), n, dtype=torch.int64, device=x.device)),
        "amb": one(torch.stack([up, down], dim=1)),
        "abs_sum": one(vok.abs().sum(-1)), "sq_sum": one((vok * vok).sum(-1)),
        "count": one(cnt),
    }


def _rel(got, want, scale) -> np.ndarray:
    d = np.abs(np.asarray(got, np.float64) - want)
    r = np.where(d == 0, 0.0, d / np.maximum(scale, 1e-300))
    return np.where(np.isnan(r), np.inf, r)


def judge(name: str, port: dict, at: dict, ref: dict) -> dict:
    """{"sigdist_moves": [S], "sigdist_rel": [S]} for the meter ``name``."""
    def k(key):
        return f"{name}.{key}"

    hat = at.get(k("hist"), np.zeros(0, np.int64))
    if port.get(k("hist")) is None or not len(hat):
        inf = np.full(ref[k("hist")].shape[0], np.inf)
        return {"sigdist_moves": inf, "sigdist_rel": inf}
    ph = np.asarray(port[k("hist")], np.int64)  # [S, R', BINS]
    S = ph.shape[0]
    rh = ref[k("hist")][:, hat]
    amb = ref[k("amb")][:, hat]
    d = ph - rh
    above = np.cumsum(d[..., ::-1], axis=-1)[..., ::-1]
    un = np.maximum(above - amb[..., 0, :], 0) + np.maximum(-above - amb[..., 1, :], 0)
    moves = un.reshape(S, -1).sum(-1)
    # the peak readouts against the program's own histogram, the time exactly
    moves = moves + (np.asarray(port[k("hist_max")]) != ph.max(-1)).sum(-1)
    moves = moves + (np.asarray(port[k("hist_peak_bin")]) != ph.argmax(-1)).sum(-1)
    moves = moves + (np.asarray(port[k("integration_time")])
                     != ref[k("integration_time")][:, hat]).sum(-1)
    n = ref[k("count")][:, hat].astype(np.float64)
    a, q = ref[k("abs_sum")][:, hat], ref[k("sq_sum")][:, hat]
    rel = np.maximum.reduce([
        _rel(port[k("hist_avg")], ref[k("hist_avg")][:, hat], a),
        _rel(port[k("mean")], ref[k("mean")][:, hat], a / np.maximum(n, 1)),
        _rel(port[k("hist_var")], ref[k("hist_var")][:, hat], q),
        _rel(port[k("variance")], ref[k("variance")][:, hat], q / np.maximum(n - 1, 1)),
    ])
    return {"sigdist_moves": moves.astype(np.float64), "sigdist_rel": rel.max(-1)}
