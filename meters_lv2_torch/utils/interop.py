"""Carry meter state and block operators between the JAX package and the port.

The meter has no learned weights: what a run carries is its state and the
host-built operator matrices.  These helpers move both as numpy arrays, so
a state taken from ``meters_lv2_tpu`` (``np.asarray`` of each leaf) can seed
the port mid-stream and the two can be compared leaf by leaf.  Nothing here
imports jax.
"""

from __future__ import annotations

import numpy as np
import torch

from ..models.ebur128 import STATE_FIELDS, EbuR128State
from ..ops.lti import block_op_tensors as block_op_to_torch  # noqa: F401


def state_from_numpy(arrays: dict, device="cpu") -> EbuR128State:
    """EbuR128State from a dict holding every field as an array.

    Dtypes follow the arrays (float32 / int32 / bool, as both packages
    keep them); a missing or unknown field raises KeyError."""
    missing = set(STATE_FIELDS) - set(arrays)
    extra = set(arrays) - set(STATE_FIELDS)
    if missing or extra:
        raise KeyError(f"state fields missing {sorted(missing)}, unknown {sorted(extra)}")
    return EbuR128State(
        **{
            k: torch.as_tensor(np.array(arrays[k], copy=True), device=device)
            for k in STATE_FIELDS
        }
    )


def state_to_numpy(state: EbuR128State) -> dict[str, np.ndarray]:
    """Every EbuR128State field as a host numpy array."""
    return {k: getattr(state, k).detach().cpu().numpy() for k in STATE_FIELDS}
