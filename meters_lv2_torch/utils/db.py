"""dB conversions and display transfer (deflection) curves.

The reference renders needles/bars with meter-type-specific transfer
curves; these are the capability-parity equivalents (vectorized).
Implemented in numpy on purpose: every consumer is the host-side
renderer (utils/render.py), and device scalar math here would launch
dozens of tiny device ops per PNG frame.  A copy of
``meters_lv2_tpu/utils/db.py``, kept in the port so that it imports
nothing of the JAX package:

- meter_deflect: needle curves (src/dpy_needle.c:26-47)
- iec268_deflect: IEC 268-18 piecewise digital-bar curve (gui/dpm.c:149-178)
- kmeter_deflect: K-system bar curve (src/dpy_bargraph.c:14-27)
"""

from __future__ import annotations

import numpy as np

MT_VU, MT_BBC, MT_EBU, MT_DIN, MT_NOR, MT_COR, MT_BM6 = range(7)


def db_to_coeff(db):
    return np.power(10.0, 0.05 * db)


def coeff_to_db(v, floor=1e-12):
    return 20.0 * np.log10(np.maximum(np.abs(v), floor))


def meter_deflect(meter_type: int, v):
    """Needle deflection in [0, 1] from the linear meter value."""
    if meter_type == MT_VU:
        return 5.6234149 * v
    if meter_type in (MT_BBC, MT_BM6, MT_EBU):
        u = v * 3.17
        return np.where(u < 0.1, u * 0.855, 0.3 * np.log(np.maximum(u, 1e-20)) + 0.77633)
    if meter_type == MT_DIN:
        u = np.sqrt(np.sqrt(2.002353 * v)) - 0.1885
        return np.maximum(u, 0.0)
    if meter_type == MT_NOR:
        return np.where(
            v < 1e-5, 0.0, 0.4166666 * np.log10(np.maximum(v, 1e-20)) + 1.125
        )
    if meter_type == MT_COR:
        return 0.5 * (1.0 + v)
    raise KeyError(meter_type)


def iec268_deflect(db):
    """IEC 268-18 style piecewise bar deflection in [0, 1] (gui/dpm.c)."""
    db = np.asarray(db)
    segs = [
        (-70.0, -60.0, 0.25, 0.0, 70.0),
        (-60.0, -50.0, 0.5, 2.5, 60.0),
        (-50.0, -40.0, 0.75, 7.5, 50.0),
        (-40.0, -30.0, 1.5, 15.0, 40.0),
        (-30.0, -20.0, 2.0, 30.0, 30.0),
        (-20.0, 6.0, 2.5, 50.0, 20.0),
    ]
    out = np.zeros_like(db)
    for lo, hi, slope, base, off in segs:
        out = np.where((db >= lo) & (db < hi), (db + off) * slope + base, out)
    out = np.where(db >= 6.0, 115.0, out)
    return out / 115.0


def kmeter_deflect(db, krange):
    """K-system bar deflection in [0, 1] (src/dpy_bargraph.c:14-27)."""
    d = db + krange
    low = (np.where(d > -90.0, np.power(10.0, d * 0.05), 0.0)
           * 500.0 / (krange + 45.0))
    high = np.minimum((d + 45.0) / (krange + 45.0), 1.0)
    return np.where(d < -40.0, low, high)


def lufs_to_lu(lufs, target_lufs: float = -23.0):
    """Absolute LUFS → relative LU against a target (the EBU GUI displays
    LU with a +23 offset by default, gui/ebur.c:336)."""
    return np.asarray(lufs) - target_lufs
