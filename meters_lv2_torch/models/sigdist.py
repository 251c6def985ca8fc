"""Signal-distribution histogram (SigDistHist).

Counterpart of ``meters_lv2_tpu/models/sigdist.py``.  Reference:
src/sigdistlv2.c -- 361-bin histogram of raw sample values (bin =
rint(180 + v*150), out-of-range dropped), histogram peak bin/count, running
sum and variance, integration gated by transport/UI with a 2^31-sample cap
(:287-326).

Binning casts through ``ops.hist.float_to_int32``, so a NaN sample lands in
bin 0 and flows into the running sum and variance exactly as in the JAX
package, on the CPU and on a card alike.  The running variance is the
parallel (Chan) merge of per-block moments; ``reference_oor_count=True``
reproduces the reference's global-index Welford count instead (see
``_oor_maps``).

On a CUDA tensor in the default mode one launch of csrc/sigdist_fused.cu
(``ops/sigdist_fused.py``) does the whole update, with the same histogram,
count and time and the same merge; ``_plain_update`` runs everywhere else.
"""

from __future__ import annotations

import dataclasses

import torch

from ..ops import hist as hist_ops
from ..ops import sigdist_fused
from ..utils import profiler
from .base import register

DIST_BIN = 361
DIST_RANGE = 150.0
DIST_ZERO = 180.0
_CAP = 2147483647


@dataclasses.dataclass(frozen=True)
class SigDistState:
    hist: torch.Tensor  # [..., 361] int32 counts (reference: int, :298)
    n: torch.Tensor  # [...] int32 count of integrated in-range samples
    mean: torch.Tensor  # [...] f32 running mean
    m2: torch.Tensor  # [...] f32 running M2
    total: torch.Tensor  # [...] f32 running sum (reference reports avg as sum)
    time: torch.Tensor  # [...] int32 integration time in samples
    integrating: torch.Tensor  # [...] bool


def prefix_compose(u: torch.Tensor, b: torch.Tensor):
    """Inclusive prefix composition along the last axis of the affine maps
    m -> (1 - u) m + b, earlier maps applied first.

    A log-depth (Hillis-Steele) scan with the JAX package's combine
    ``comp(p, q) = (u1 + u2 - u1 u2, b1 - u2 b1 + b2)``: the multiplier is
    carried in complement form u, because 1 - 1/cnt rounds to exactly 1.0
    in float32 past cnt ~ 2^24 and would freeze the mean."""
    T = u.shape[-1]
    d = 1
    while d < T:
        u1, b1 = u[..., :-d], b[..., :-d]  # the earlier operand
        u2, b2 = u[..., d:], b[..., d:]
        u = torch.cat([u[..., :d], u1 + u2 - u1 * u2], dim=-1)
        b = torch.cat([b[..., :d], b1 - u2 * b1 + b2], dim=-1)
        d *= 2
    return u, b


@register("SigDistHist")
class SigDistMeter:
    def __init__(self, fs: float, reference_oor_count: bool = False):
        self.fs = float(fs)
        # the reference's out-of-range Welford count (sigdistlv2.c:316-318)
        self.reference_oor_count = bool(reference_oor_count)

    def init(self, batch_shape=(), device="cuda") -> SigDistState:
        batch_shape = tuple(batch_shape)

        def z(dtype=torch.float32):
            return torch.zeros(batch_shape, dtype=dtype, device=device)

        return SigDistState(
            hist=torch.zeros((*batch_shape, DIST_BIN), dtype=torch.int32, device=device),
            n=z(torch.int32), mean=z(), m2=z(), total=z(),
            time=z(torch.int32),
            integrating=torch.ones(batch_shape, dtype=torch.bool, device=device),
        )

    def takes_kernel(self, x: torch.Tensor) -> bool:
        """Whether update() runs csrc/sigdist_fused.cu for the block x: a
        CUDA tensor in the default mode.  The reference's out-of-range
        Welford count keeps its prefix composition on every device."""
        return x.device.type == "cuda" and not self.reference_oor_count

    def update(self, state: SigDistState, x: torch.Tensor) -> SigDistState:
        """x: [..., T] with the state's batch shape."""
        with profiler.span("sigdist.update"):
            x = x.to(torch.float32)
            if not self.takes_kernel(x):
                return self._plain_update(state, x)
            with profiler.span("sigdist.kernel"):
                profiler.count("sigdist.kernel")
                batch, N = state.n.shape, state.n.numel()
                hist, *rest = sigdist_fused.sigdist_fused(
                    state.hist.reshape(N, DIST_BIN),
                    *(v.reshape(N) for v in (state.n, state.mean, state.m2, state.total,
                                             state.time, state.integrating)),
                    x.reshape(N, x.shape[-1]))
                n, mean, m2, total, time = (v.reshape(batch) for v in rest)
                return SigDistState(
                    hist=hist.reshape(*batch, DIST_BIN), n=n, mean=mean, m2=m2, total=total,
                    time=time, integrating=state.integrating,
                )

    def _plain_update(self, state: SigDistState, x: torch.Tensor) -> SigDistState:
        """update() in plain PyTorch ops (any device): the CPU's path, the
        reference's out-of-range count, and the kernel's test oracle."""
        T = x.shape[-1]
        run = state.integrating & (state.time < _CAP - T)
        with profiler.span("sigdist.hist"):
            bins = hist_ops.float_to_int32(torch.round(DIST_ZERO + x * DIST_RANGE))
            ok = (bins >= 0) & (bins < DIST_BIN) & run[..., None]
            hist = state.hist + hist_ops.bincount(bins, DIST_BIN, valid=ok, dtype=torch.int32)
        # out-of-range samples are skipped for avg/var too (`if (bin < 0)
        # continue;`, sigdistlv2.c:303-318)
        with profiler.span("sigdist.moments"):
            if self.reference_oor_count:
                mean, m2 = self._oor_welford(state, x, ok)
                n = state.n + ok.sum(-1, dtype=torch.int32)
            else:
                n, mean, m2 = hist_ops.welford_merge(
                    (state.n, state.mean, state.m2), hist_ops.welford_block(x, ok)
                )
            total = state.total + torch.where(ok, x, 0.0).sum(-1)
            time = state.time + torch.where(run, T, 0).to(torch.int32)
        return SigDistState(
            hist=hist, n=n, mean=mean, m2=m2, total=total, time=time,
            integrating=state.integrating,
        )

    def _oor_welford(self, state: SigDistState, x: torch.Tensor, ok: torch.Tensor):
        """Reference-exact Welford chain (sigdistlv2.c:313-318): the count
        is the global sample index including skipped samples, which leave
        the running mean and var_s untouched."""
        U, B = self._oor_maps(x, ok, state.time)
        m0 = state.mean[..., None]
        m = m0 - U * m0 + B  # the running mean after each sample
        m_prev = torch.cat([m0, m[..., :-1]], dim=-1)
        var_s_inc = torch.where(ok, (x - m) * (x - m_prev), 0.0).sum(-1)
        return m[..., -1], state.m2 + var_s_inc

    @staticmethod
    def _oor_maps(x: torch.Tensor, ok: torch.Tensor, time0: torch.Tensor):
        """Prefix composition (U, B) of the per-sample maps m -> (1 - u) m
        + b, u = 1/cnt and b = x/cnt for an accepted sample, the identity
        for a skipped one; cnt is the 1-based global index counting every
        sample (time0: [...] int32 samples before this block)."""
        T = x.shape[-1]
        cnt = (time0[..., None]
               + torch.arange(1, T + 1, dtype=torch.int32, device=x.device)).to(x.dtype)
        u = torch.where(ok, 1.0 / cnt, 0.0)
        b = torch.where(ok, x / cnt, 0.0)
        return prefix_compose(u, b)

    def read(self, state: SigDistState):
        """sdh_histogram atom contents (sigdistlv2.c:332-355)."""
        peak_cnt = state.hist.amax(-1)
        peak_bin = state.hist.argmax(-1)  # the first maximal bin, as jnp.argmax
        denom = (state.time if self.reference_oor_count else state.n).to(state.m2.dtype)
        return {
            "hist": state.hist,
            "hist_max": peak_cnt,
            "hist_peak_bin": peak_bin,
            "hist_avg": state.total,  # the reference transmits the running sum
            "hist_var": state.m2,  # and var_s (sum of squared deviations)
            "integration_time": state.time,
            "mean": state.mean,
            # the reference UI divides var_s by (integration_spl - 1), all
            # samples (gui/sdhmeter.c:316); the default mode divides by the
            # accepted-sample count
            "variance": state.m2 / torch.clamp(denom - 1.0, min=1.0),
        }, state

    def reset(self, state: SigDistState) -> SigDistState:
        return self.init(state.n.shape, state.n.device)

    def integrate(self, state: SigDistState, on: bool) -> SigDistState:
        return dataclasses.replace(
            state, integrating=torch.full_like(state.integrating, bool(on))
        )
