"""Carry meter state and block operators between the JAX package and the port.

The meter has no learned weights: what a run carries is its state and the
host-built operator matrices.  These helpers move both as numpy arrays, so
a state taken from ``meters_lv2_tpu`` (``np.asarray`` of each leaf) can seed
the port mid-stream and the two can be compared leaf by leaf.  A state is a
dict of its fields; a field that is itself a state (``BBCMSState.mid``,
``TruePeakMeterState.bal``) is a nested dict.  Nothing here imports jax.
"""

from __future__ import annotations

import dataclasses
import typing

import numpy as np
import torch

from ..models.ebur128 import EbuR128State
from ..ops.lti import block_op_tensors as block_op_to_torch  # noqa: F401


def state_from_numpy(arrays: dict, device="cpu", cls: type = EbuR128State):
    """A state of class ``cls`` (EbuR128State unless given) from a dict
    holding every field as an array, or as a nested dict for a field that
    is a state class itself.

    Dtypes follow the arrays (float32 / int32 / bool, as both packages
    keep them); a missing or unknown field raises KeyError."""
    names = [f.name for f in dataclasses.fields(cls)]
    missing = set(names) - set(arrays)
    extra = set(arrays) - set(names)
    if missing or extra:
        raise KeyError(f"{cls.__name__} fields missing {sorted(missing)}, unknown {sorted(extra)}")
    hints = typing.get_type_hints(cls)
    kw = {}
    for k in names:
        if dataclasses.is_dataclass(hints[k]):
            kw[k] = state_from_numpy(arrays[k], device, hints[k])
        else:
            kw[k] = torch.as_tensor(np.array(arrays[k], copy=True), device=device)
    return cls(**kw)


def state_to_numpy(state) -> dict:
    """Every field of a state as a host numpy array (a nested dict for a
    field that is a state itself)."""
    return {
        f.name: (state_to_numpy(v) if dataclasses.is_dataclass(v)
                 else v.detach().cpu().numpy())
        for f in dataclasses.fields(state)
        for v in (getattr(state, f.name),)
    }
