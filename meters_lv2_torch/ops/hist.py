"""Histograms, streaming moments and the float -> int32 bin cast.

Counterpart of ``meters_lv2_tpu/ops/hist.py`` (``bincount``,
``welford_block``, ``welford_merge``).  The TPU builds one-hot matrices and
lets the matrix unit count; here ``scatter_add_`` counts directly: on
int32 it is exact and independent of order (integer atomics on a card),
the weighted float path keeps float32.

``float_to_int32`` is the one cast every binning of the port goes through
(sigdist, DR-14).  A plain ``.to(torch.int32)`` of NaN, +-Inf or an
out-of-range value is not defined the same way on the CPU and on CUDA, and
differs from the JAX package's cast; this helper gives the JAX result on
both.
"""

from __future__ import annotations

import torch

_I32_MIN = -2147483648
_I32_MAX = 2147483647
_TWO31 = 2147483648.0  # 2^31, exact in float32


def float_to_int32(v: torch.Tensor) -> torch.Tensor:
    """``v.astype(int32)`` as the JAX package casts on the CPU: truncation
    toward zero, NaN -> 0, values >= 2^31 (+inf included) -> INT32_MAX,
    values <= -2^31 (-inf included) -> INT32_MIN.  Identical on the CPU and
    on CUDA: NaN is mapped and the range clamped before the cast."""
    big = v >= _TWO31
    safe = torch.where(torch.isnan(v) | big, 0.0, v).clamp(min=-_TWO31)
    return torch.where(big, _I32_MAX, safe.to(torch.int32))


def bincount(
    ids: torch.Tensor,
    nbins: int,
    weights: torch.Tensor | None = None,
    valid: torch.Tensor | None = None,
    dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """Histogram of integer ids along the last axis.

    Args:
      ids: [..., T] integer bin indices; out-of-range ids are dropped.
      nbins: bin count.
      weights: optional [..., T] per-sample weights (default 1).
      valid: optional [..., T] bool mask.
      dtype: accumulator dtype; integer dtypes count exactly.

    Returns counts [..., nbins] in ``dtype``.
    """
    *batch, T = ids.shape
    ok = (ids >= 0) & (ids < nbins)
    if valid is not None:
        ok = ok & valid
    # dropped samples land in a spare bin past the end, cut off below
    idx = torch.where(ok, ids, nbins).to(torch.int64)
    if weights is None:
        src = ok.to(dtype)
    else:
        src = torch.where(ok, weights, 0).to(dtype)
    out = torch.zeros((*batch, nbins + 1), dtype=dtype, device=ids.device)
    out.scatter_add_(-1, idx, src)
    return out[..., :nbins]


def welford_block(x: torch.Tensor, valid: torch.Tensor | None = None):
    """Per-block (count, mean, M2) along the last axis for variance merging.

    The count is int32 (exact past 2^24, where a float count would stop
    incrementing); mean and M2 stay in x's dtype."""
    if valid is None:
        n = torch.full(x.shape[:-1], x.shape[-1], dtype=torch.int32, device=x.device)
        mean = x.mean(-1)
        m2 = torch.square(x - mean[..., None]).sum(-1)
    else:
        n = valid.sum(-1, dtype=torch.int32)
        nsafe = torch.clamp(n.to(x.dtype), min=1.0)
        mean = torch.where(valid, x, 0.0).sum(-1) / nsafe
        m2 = torch.where(valid, torch.square(x - mean[..., None]), 0.0).sum(-1)
    return n, mean, m2


def welford_merge(a, b):
    """Chan et al. parallel variance merge of (n, mean, M2) triples."""
    na, ma, m2a = a
    nb, mb, m2b = b
    n = na + nb  # int32, exact
    naf = na.to(ma.dtype)
    nbf = nb.to(ma.dtype)
    nsafe = torch.clamp(naf + nbf, min=1.0)
    d = mb - ma
    mean = ma + d * (nbf / nsafe)
    m2 = m2a + m2b + torch.square(d) * naf * nbf / nsafe
    return n, mean, m2
