"""Multi-meter pipeline: any set of meters over one block stream
(counterpart of ``meters_lv2_tpu/parallel/pipeline.py``).

The reference runs one plugin instance per track; a session (e.g. a
mastering QA pass) wants several meters on the same audio.  MeterPipeline
routes one [..., C, T] input to each meter in the form it takes:

    pipe = MeterPipeline({"r128": EbuR128Meter(fs), "k20": K20Meter(fs)})
    state = pipe.init(batch_shape)            # audio is [..., C, T]
    state = pipe.update(state, x)
    outs, state = pipe.read(state)            # {"r128": {...}, "k20": {...}}

``run_stream_ragged`` measures each stream of a right-padded batch over
exactly its own length.  PyTorch runs eagerly, so each update launches the
meters' kernels as it comes; the JAX package's jit cache has no counterpart.
"""

from __future__ import annotations

import inspect
from typing import Any, Mapping

import numpy as np
import torch

from ..utils import profiler
from ..utils.interop import tree_map

# how each meter family consumes the [..., C, T] pipeline input, by class
# name (the port's classes carry the JAX package's names)
_MODES = {
    # per-channel scalar meters: channel axis becomes a state batch axis
    "VUMeter": "per_channel",
    "DINMeter": "per_channel",
    "NordicMeter": "per_channel",
    "BBCMeter": "per_channel",
    "EBUMeter": "per_channel",
    "KMeter": "per_channel",
    "K12Meter": "per_channel",
    "K14Meter": "per_channel",
    "K20Meter": "per_channel",
    "TruePeakMeter": "per_channel",
    # whole-signal multichannel meters
    "EbuR128Meter": "multi",
    "BBCMidSideMeter": "multi",
    "CorrelationMeter": "multi",
    "DR14Meter": "multi",
    "TPnRMSMeter": "multi",
    "Goniometer": "multi",
    "PhaseWheel": "multi",
    "Stereoscope": "multi",
    # mono meters: fed channel 0 (reference plugins are mono taps)
    "SigDistMeter": "mono",
    "BitMeter": "mono",
    # spectrum averages stereo inputs
    "SpectrumAnalyzer": "stereo_mix",
}


def _mode(meter) -> str:
    for klass in type(meter).__mro__:
        if klass.__name__ in _MODES:
            return _MODES[klass.__name__]
    return "multi"  # the surround meters, Surround3..8Meter


def freeze(old, new, alive: torch.Tensor):
    """Per-stream select over a state tree: ``new`` where ``alive`` [B]
    holds, else ``old``.  A tree is a frozen dataclass, a dict (the
    stereoscope's state) or a tensor; a tensor with fewer dims than
    ``alive`` is a stream-shared config leaf (spectrum's omega) and passes
    through from ``new``.  Trailing dims of a leaf (a per_channel state's
    channel axis, a meter's own) broadcast against ``alive``."""

    def pick(o, n):
        if o.ndim < alive.ndim:
            return n
        return torch.where(alive.reshape(alive.shape + (1,) * (o.ndim - alive.ndim)), n, o)

    return tree_map(pick, old, new)


def _update_one(m, st, x: torch.Tensor, kw: dict):
    """One meter's update on the pipeline's [..., C, T] block, in the form
    its family takes (``_MODES``)."""
    mode = _mode(m)
    if mode == "per_channel":
        return m.update(st, x, **kw)
    if mode == "mono":
        return m.update(st, x[..., 0, :], **kw)
    if mode == "stereo_mix":
        C = x.shape[-2]
        if C == 2:
            return m.update(st, x, stereo=True, **kw)
        if C == 1:
            return m.update(st, x[..., 0, :], **kw)
        # >2 channels: equal-weight downmix (generalizes the reference's
        # stereo (l+r)/2, spectrumlv2.c:195-201)
        return m.update(st, x.mean(dim=-2), **kw)
    if hasattr(m, "update"):
        return m.update(st, x, **kw)
    return m.process(st, x)[1]  # display processors expose process()


class MeterPipeline:
    def __init__(self, meters: Mapping[str, Any], nchan: int = 2):
        self.meters = dict(meters)
        self.nchan = nchan

    def init(self, batch_shape=(), device="cuda"):
        batch_shape = tuple(batch_shape)
        out = {}
        for name, m in self.meters.items():
            if _mode(m) == "per_channel":
                out[name] = m.init((*batch_shape, self.nchan), device=device)
            else:
                out[name] = m.init(batch_shape, device=device)
        return out

    def update(self, state, x: torch.Tensor, controls=None):
        """x: [..., C, T].

        ``controls`` optionally maps meter name -> extra update() keyword
        ports whose values may be tensors (e.g. the BBC M-6 s20 toggle):
        the reference re-reads such ports every run()
        (src/meters.cc:562-563), so they may change from one call to the
        next."""
        new = {}
        with profiler.span("pipe.update"):
            for name, m in self.meters.items():
                with profiler.span(f"pipe.{name}"):
                    new[name] = _update_one(m, state[name], x,
                                            dict((controls or {}).get(name, {})))
        return new

    def read(self, state, ref_level_db=None):
        """Read every meter; ref_level_db (the needle meters' reference
        level port, lv2ttl default -22) is forwarded to readers that take
        it; None keeps each meter's own default.  A dict maps meter name ->
        per-instance level (one ref-level dial per plugin, as in
        src/meters.cc:303-306); absent names keep their default."""
        outs = {}
        new = {}
        for name, m in self.meters.items():
            if hasattr(m, "read"):
                kw = {}
                rl = (ref_level_db.get(name)
                      if isinstance(ref_level_db, dict) else ref_level_db)
                if rl is not None and "ref_level_db" in inspect.signature(m.read).parameters:
                    kw["ref_level_db"] = rl
                o, s = m.read(state[name], **kw)
            else:
                o, s = {}, state[name]
            outs[name] = o
            new[name] = s
        return outs, new

    def run_stream(self, state, x: torch.Tensor, chunk: int):
        """Stream x [..., C, T] through update in chunk-sized steps."""
        T = x.shape[-1]
        if T % chunk:
            raise ValueError(f"T={T} is not a multiple of chunk={chunk}")
        for i in range(0, T, chunk):
            state = self.update(state, x[..., i : i + chunk])
        return state

    def run_stream_ragged(self, state, x: torch.Tensor, lengths, chunk: int):
        """Length-exact streaming over a right-padded ragged batch.

        Each stream i is measured over exactly lengths[i] samples: padding
        past a file's end is never processed, so per-file readouts equal a
        serial per-file run (the reference's one-run()-stream-per-track
        semantics, src/meters.cc:298-331).

          1. chunk-sized steps over the batch; a stream's state is frozen
             once its full chunks are used up;
          2. the (4-aligned) sub-chunk tails by their binary decomposition:
             one update for each level from 4 samples up to chunk/2,
             largest first, each stream frozen through the levels its tail
             lacks.  Each stream's block is taken at its own cursor by one
             batched gather.

        lengths (host integers) must be multiples of 4, the meters' grain;
        x: [B, C, T] with T % chunk == 0 and T >= max(lengths).  The
        lengths are on the host, so a step or level that no stream takes
        is not run: it would leave every stream's state as it is.
        """
        lengths = np.asarray(lengths, np.int64)
        B, C, T = x.shape
        if chunk <= 0 or chunk % 4 or T % chunk:
            raise ValueError(f"chunk={chunk} must be a positive multiple of 4 dividing T={T}")
        if lengths.shape != (B,) or (lengths % 4).any() or (lengths < 0).any() or lengths.max() > T:
            raise ValueError(f"lengths must be [B={B}] multiples of 4 in 0..{T}, got {lengths}")
        dev = x.device
        full = lengths // chunk
        full_dev = torch.as_tensor(full, device=dev)
        for j in range(int(full.max())):
            new = self.update(state, x[..., j * chunk:(j + 1) * chunk])
            state = new if (full > j).all() else freeze(state, new, full_dev > j)

        q = (lengths % chunk) // 4
        pos = full * chunk
        n_levels = max(chunk // 4 - 1, 1).bit_length()
        for k in reversed(range(n_levels)):
            s = 4 << k
            take = (q >> k) & 1 == 1
            if not take.any():
                continue
            # a stream that does not take the level reads any in-bounds
            # block; a stream that does has pos + s <= its length <= T
            at = torch.as_tensor(np.minimum(pos, T - s), device=dev)
            idx = at[:, None] + torch.arange(s, device=dev)
            xt = torch.gather(x, 2, idx[:, None, :].expand(B, C, s))
            new = self.update(state, xt)
            state = new if take.all() else freeze(state, new, torch.as_tensor(take, device=dev))
            pos = pos + np.where(take, s, 0)
        return state
