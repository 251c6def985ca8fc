"""The comparison that decides ``correct``.

Each readout a reference module declares has a kind.  The kinds below
feed one number each, the widest gap over the sampled answers:

  level_db     |difference| in dB of every level readout but the
               spectrum's: R128's M, S and their maxima (LUFS), every true
               peak and the PPM (linear readouts through 20 log10)
  spectrum_db  |difference| in dB of the 1/3-octave bands
  spectrum_peak_db  |difference| in dB of the bands' peak-hold
  cor          |difference| of the phase correlation

A module with other kinds judges them itself (``judge``): R128's
histograms (EBUr128.py) give ``hist_moves``, and its gated I and LRA
join ``level_db``.  A NaN where the reference has a number, or an answer that
never came, is an infinite gap.  Each number is held to the cell's limit
for it.
"""

from __future__ import annotations

import math

import numpy as np

GROUP = {"lufs": "level_db", "lin": "level_db", "db": "spectrum_db",
         "db_peak": "spectrum_peak_db", "cor": "cor"}


def _gap(kind: str, port: np.ndarray, ref: np.ndarray) -> np.ndarray:
    """[S, ...] gaps, reduced to one a stream."""
    port = np.asarray(port, np.float64)
    ref = np.asarray(ref, np.float64)
    if kind == "lin":
        port = 20.0 * np.log10(np.maximum(port, 1e-30))
        ref = 20.0 * np.log10(np.maximum(ref, 1e-30))
    g = np.abs(port - ref)
    g = np.where(np.isnan(g), np.inf, g)
    return g.reshape(g.shape[0], -1).max(-1) if g.size else np.full(g.shape[0], np.inf)


def gaps(port: dict, at: dict, ref: dict, kinds: dict) -> dict:
    """{key: [S]} each generic readout's widest gap a sampled stream;
    port[key] [S, R', ...] answers the reference's reads at[key]."""
    out = {}
    for key, kind in kinds.items():
        if kind not in GROUP:
            continue
        if key in port and len(at.get(key, ())):
            out[key] = _gap(kind, port[key], ref[key][:, at[key]])
        else:
            out[key] = np.full(ref[key].shape[0], np.inf)
    return out


def numbers(port: dict, at: dict, ref: dict, kinds: dict, modules: dict) -> dict:
    """{number: [S]}, each sampled stream's widest gap: the generic kinds
    by GROUP, then each module's own ``judge``."""
    per_stream: dict = {}

    def add(name, g):
        per_stream[name] = np.maximum(per_stream[name], g) if name in per_stream else g

    for key, g in gaps(port, at, ref, kinds).items():
        add(GROUP[kinds[key]], g)
    for meter, mod in modules.items():
        if hasattr(mod, "judge"):
            for name, g in mod.judge(meter, port, at, ref).items():
                add(name, g)
    return per_stream


def judge(per_stream: dict, limits: dict) -> tuple[bool, dict, int]:
    """(correct, {number: {"value", "limit"}}, streams failed): every
    number finite and at or under its limit, and no number without a
    limit."""
    checks = {}
    ok = bool(per_stream)
    bad = None
    for name, g in sorted(per_stream.items()):
        lim = limits.get(name)
        v = float(g.max())
        checks[name] = {"value": v, "limit": lim}
        over = ~(g <= lim) if lim is not None else np.ones(g.shape, bool)
        bad = over if bad is None else bad | over
        ok = ok and lim is not None and math.isfinite(v) and v <= lim
    return ok, checks, int(bad.sum()) if bad is not None else 0
