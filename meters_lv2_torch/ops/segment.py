"""Shifted segment reduction, the fragment/window assembly primitive.
Counterpart of ``meters_lv2_tpu/ops/segment.py``.

Streaming meters accumulate fixed-length windows (R128's fs/20 fragments)
that are not aligned to the caller's block boundaries: the block is placed
at a per-stream sample offset before an aligned reshape-reduce.  Shifted
segment f spans the tail (`off` samples) of unshifted row f-1 plus the head
of row f, so two masked reductions and a one-row shift give the result
without moving data.

The R128 meter calls it itself only for a block that is not a whole
number of 128-sample blocks; on the others ops.r128_fused's seg mode
returns the fragment sums (its plain CPU version through this function).
"""

from __future__ import annotations

import torch


def shifted_segments(
    p: torch.Tensor,
    off: torch.Tensor,
    seg_len: int,
    n_slots: int,
    reduce: str = "sum",
) -> torch.Tensor:
    """Segment-reduce p placed at sample offset `off` on a seg_len grid.

    Args:
      p: [..., T] values (T <= n_slots*seg_len - off, guaranteed by callers
         choosing n_slots = T // seg_len + 2).
      off: [...] int32 offset in [0, seg_len).
      reduce: 'sum' or 'max' (max uses identity 0; callers floor at 0).

    Returns [..., n_slots] per-segment reductions of the shifted stream
    (positions [0, off) and beyond off+T contribute the identity).
    """
    if reduce not in ("sum", "max"):
        raise ValueError(f"reduce must be 'sum' or 'max', not {reduce!r}")
    *batch, T = p.shape
    # n_slots == 1 cannot represent a boundary crossing (callers use
    # T // seg_len + 2 >= 2)
    assert n_slots >= 2, n_slots

    def red(v, dim):
        return v.sum(dim) if reduce == "sum" else v.amax(dim)

    if seg_len >= T:
        # long-window fast path: at most one boundary falls inside the
        # block, so two masked reductions over the unpadded [..., T] suffice
        t = torch.arange(T, dtype=torch.int32, device=p.device)
        in0 = t < (seg_len - off[..., None])  # [..., T]
        r0 = red(torch.where(in0, p, 0.0), -1)
        r1 = red(torch.where(in0, 0.0, p), -1)
        rest = torch.zeros((*batch, n_slots - 2), dtype=p.dtype, device=p.device)
        return torch.cat([r0[..., None], r1[..., None], rest], dim=-1)
    L = n_slots * seg_len
    pad = torch.zeros((*batch, L - T), dtype=p.dtype, device=p.device)
    rows = torch.cat([p, pad], dim=-1).reshape(*batch, n_slots, seg_len)
    w = torch.arange(seg_len, dtype=torch.int32, device=p.device)
    head = w < (seg_len - off[..., None, None])  # [..., 1, seg_len]
    a = red(torch.where(head, rows, 0.0), -1)
    b = red(torch.where(head, 0.0, rows), -1)
    b = torch.cat([torch.zeros_like(b[..., :1]), b[..., :-1]], dim=-1)
    return a + b if reduce == "sum" else torch.maximum(a, b)
