"""Host-transport following (counterpart of
``meters_lv2_tpu/utils/transport.py``).

The reference plugins react to LV2 time:Position atoms: when the host
transport starts rolling they can auto-start integration and optionally
reset the measurement (src/ebulv2.cc:84-111 update_position,
src/sigdistlv2.c:80-100, src/dr14.c:263-282 parse_time_position).

Here the host calls `follow(meter, state, rolling, was_rolling, mode)`
between update() calls with the transport flag; the same mode bits as the
reference's follow_transport_mode apply:

  bit 0 (FOLLOW_START_STOP): integrate while rolling, pause when stopped
  bit 1 (FOLLOW_AUTO_RESET): reset measurement on each roll start
"""

from __future__ import annotations

import numpy as np
import torch

FOLLOW_OFF = 0
FOLLOW_START_STOP = 1
FOLLOW_AUTO_RESET = 2


def _integrating(state) -> bool:
    """Whether every stream of ``state`` integrates: one host read of the
    flag (a tensor on the card is copied with one ``.item()``)."""
    flag = getattr(state, "integrating", False)
    if isinstance(flag, torch.Tensor):
        return bool(flag.all().item())
    return bool(np.all(np.asarray(flag)))


def follow(meter, state, rolling: bool, was_rolling: bool, mode: int):
    """Apply a transport edge to a meter state; returns the new state.

    Works with any meter exposing integr_start/integr_pause (+ optional
    integr_reset / reset), e.g. EbuR128Meter, SigDistMeter, DR14Meter.

    Mirrors the reference's ebu_integrate guard (src/ebulv2.cc:63-73):
    it early-returns when integration is already in the requested state,
    so a measurement the user started MANUALLY is NOT auto-reset when
    the transport later starts rolling — the reset fires only on an
    actual off->on integration transition.  The flag is read from the
    state only on that path (a roll start with FOLLOW_AUTO_RESET).
    """
    if mode & FOLLOW_START_STOP:
        if rolling and not was_rolling:
            if (mode & FOLLOW_AUTO_RESET) and not _integrating(state):
                if hasattr(meter, "integr_reset"):
                    state = meter.integr_reset(state)
                elif hasattr(meter, "reset"):
                    state = meter.reset(state)
            if hasattr(meter, "integr_start"):
                state = meter.integr_start(state)
            elif hasattr(meter, "integrate"):
                state = meter.integrate(state, True)
        elif not rolling and was_rolling:
            if hasattr(meter, "integr_pause"):
                state = meter.integr_pause(state)
            elif hasattr(meter, "integrate"):
                state = meter.integrate(state, False)
    return state
