"""The PPM attack/release recurrence, evaluated exactly over long series.

Per 4-sample group (iec2ppmdsp.cc:47-80, truepeakdsp.cc:58-107)::

    z *= w3                              # release
    for each of the 4 samples t:
        if t > z: z += w * (t - z)       # attack

For z and t of one sign the attack is z' = max(z, a z + w t) with
a = 1 - w, a monotone map, so any stretch of groups maps z to
max_k (W a^k z + b_k): k counts the attacks taken and b_k is the best
intercept over all ways of taking k attacks, W the stretch's release.
Composing a stretch with one more group is a max-plus convolution over k.
That gives an exact evaluation in O(n) work with few sequential steps:

  1. each group's intercepts e_0..e_4, for all groups at once;
  2. the composite intercepts of segments of G groups, the G groups
     composed in turn for all segments at once;
  3. z at every segment start, one step a segment;
  4. z1 and z2 at every group end, all segments at once, and the readout
     max(z1 + z2) over the groups.

``update`` counts groups a ``process()`` call (the meter's update): z is
clamped to [0, 20] on entry and ``offset`` added on exit, as the plugins
do.  A segment never straddles two updates.  Plain float64 throughout; no
product here is a matrix product, so the control's TF32 does not reach it.
"""

from __future__ import annotations

import torch


def _group_intercepts(tg: torch.Tensor, w: float) -> torch.Tensor:
    """tg [..., 4] one group's samples -> [..., 5] intercepts b_k."""
    a = 1.0 - w
    ninf = torch.full_like(tg[..., 0], -float("inf"))
    b = [torch.zeros_like(ninf)] + [ninf] * 4
    for i in range(4):
        t = w * tg[..., i]
        b = [b[0]] + [torch.maximum(b[k], a * b[k - 1] + t) for k in range(1, 5)]
    return torch.stack(b, dim=-1)


def _segments(e: torch.Tensor, w3: float, a: float) -> torch.Tensor:
    """e [..., S, G, 5] -> [..., S, 4G + 1] composite intercepts."""
    G = e.shape[-2]
    K = 4 * G + 1
    out = torch.full((*e.shape[:-2], K), -float("inf"), dtype=e.dtype, device=e.device)
    out[..., :5] = e[..., 0, :]
    aj = [w3 * a ** j for j in range(5)]
    for g in range(1, G):
        top = 4 * g + 1  # entries that can be finite before this group
        prev = out[..., :top].clone()
        for j in range(5):
            view = out[..., j:j + top]
            cand = torch.add(e[..., g, j:j + 1], prev, alpha=aj[j])
            if j:
                torch.maximum(view, cand, out=view)
            else:
                view.copy_(cand)
    return out


def _segment_size(groups: int, update: int, target: int = 120) -> int:
    """The divisor of ``update`` (and of ``groups``) nearest ``target``."""
    best = 1
    for g in range(1, min(update, groups) + 1):
        if update % g == 0 and groups % g == 0 and abs(g - target) < abs(best - target):
            best = g
    return best


def peak_meter(t: torch.Tensor, w1: float, w2: float, w3: float, update: int,
               offset: float) -> torch.Tensor:
    """t [R, n] rectified float64 samples (n % 4 == 0), states from zero ->
    [R]: max over every group end of z1 + z2."""
    R, n = t.shape
    groups = n // 4
    if groups * 4 != n or groups % update:
        raise ValueError(f"{n} samples are not whole updates of {update} groups")
    G = _segment_size(groups, update)
    S = groups // G
    per_update = update // G
    tg = t.reshape(R, S, G, 4)
    z_start = []
    es = []
    for w in (w1, w2):
        a = 1.0 - w
        e = _group_intercepts(tg, w)  # [R, S, G, 5]
        es.append(e)
        B = _segments(e, w3, a)  # [R, S, K]
        slope = torch.tensor([w3 ** G * a ** k for k in range(B.shape[-1])],
                             dtype=t.dtype, device=t.device)
        z = torch.zeros(R, dtype=t.dtype, device=t.device)
        starts = []
        for s in range(S):
            if s % per_update == 0:
                z = torch.clamp(z + (offset if s else 0.0), 0.0, 20.0)
            starts.append(z)
            z = torch.amax(torch.addcmul(B[:, s], slope, z[:, None]), dim=-1)
        z_start.append(torch.stack(starts, dim=1))  # [R, S]
        del B
    z1, z2 = z_start
    m = torch.full((R, S), -float("inf"), dtype=t.dtype, device=t.device)
    for g in range(G):
        for i, w in enumerate((w1, w2)):
            a = 1.0 - w
            e = es[i][:, :, g]  # [R, S, 5]
            z = z1 if i == 0 else z2
            cand = torch.stack([w3 * a ** k * z for k in range(5)], dim=-1) + e
            if i == 0:
                z1 = cand.amax(-1)
            else:
                z2 = cand.amax(-1)
        m = torch.maximum(m, z1 + z2)
    return m.amax(-1)
