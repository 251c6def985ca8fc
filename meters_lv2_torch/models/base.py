"""Meter protocol and registry (vendored from ``meters_lv2_tpu/models/base.py``).

Each meter mirrors the reference plugin lifecycle (src/meters.cc:192-331):

    meter = SomeMeter(fs=48000, ...)            # instantiate(): bake constants
    state = meter.init(batch_shape, device)     # per-stream state tensors
    state = meter.update(state, block)          # run(): block [..., T] / [..., C, T]
    out, state = meter.read(state)              # control-port readout

State is a frozen dataclass of tensors with arbitrary leading batch dims;
config lives on the meter object.
"""

from __future__ import annotations

from typing import Any, Callable

import torch

_REGISTRY: dict[str, Callable[..., Any]] = {}

# Meters of the JAX package (meters_lv2_tpu.models) that the port does not
# have yet; create() names them in a NotImplementedError.  Every meter is
# ported, so it is empty.
NOT_YET_PORTED: frozenset[str] = frozenset()


def register(name: str):
    """Register a meter class under its reference URI suffix (e.g. 'EBUr128')."""

    def deco(cls):
        _REGISTRY[name] = cls
        cls.uri_suffix = name
        return cls

    return deco


def create(name: str, fs: float, **kwargs):
    """Instantiate a meter by reference URI suffix, e.g. create('EBUr128', 48000)."""
    if name not in _REGISTRY:
        if name in NOT_YET_PORTED:
            raise NotImplementedError(
                f"meter {name!r} is not ported to meters_lv2_torch yet; "
                f"available: {sorted(_REGISTRY)}"
            )
        raise KeyError(
            f"unknown meter {name!r}; available: {sorted(_REGISTRY)}"
        )
    return _REGISTRY[name](fs=fs, **kwargs)


def available() -> list[str]:
    return sorted(_REGISTRY)


def ref_level_gain(ref_level_db: float) -> torch.Tensor:
    """Needle-meter reference-level gain: 10^(0.05*(refl+18))
    (src/meters.cc:303-306)."""
    ref = torch.tensor(ref_level_db, dtype=torch.float32)
    return torch.pow(torch.tensor(10.0, dtype=torch.float32), 0.05 * (ref + 18.0))
