"""Carry meter state and block operators between the JAX package and the port.

The meter has no learned weights: what a run carries is its state and the
host-built operator matrices.  These helpers move both as numpy arrays, so
a state taken from ``meters_lv2_tpu`` (``np.asarray`` of each leaf) can seed
the port mid-stream and the two can be compared leaf by leaf.  A state is a
dict of its fields; a field that is itself a state (``BBCMSState.mid``,
``TruePeakMeterState.bal``, ``DR14State.km`` and ``.tp``,
``SurroundState.km``, ``PhaseWheelState.stft`` and ``.cor``) is a nested
dict.  The stereoscope keeps its state as a dict, as the JAX package does;
``cls`` is then a dict of each key's class
(``models.phasewheel.STEREOSCOPE_STATE``).

``tree_flatten`` / ``tree_unflatten`` / ``tree_map`` walk such trees (and
the live shell's session trees) in the JAX package's leaf order: dataclass
fields in order, dict keys sorted, ``None`` holding no leaf.  A list of
leaves from one package therefore lines up with the other's, which is what
``utils/state.py`` relies on to exchange checkpoints.  Nothing here imports
jax.
"""

from __future__ import annotations

import dataclasses
import typing

import numpy as np
import torch

from ..models.ebur128 import EbuR128State
from ..ops.lti import block_op_tensors as block_op_to_torch  # noqa: F401


def _node(tree):
    """(kind, keys, children) of an inner node of a tree, or None for a
    leaf.  kind is the dataclass's type, ``dict``, or NoneType (no leaf)."""
    if tree is None:
        return type(None), (), ()
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        names = tuple(f.name for f in dataclasses.fields(tree))
        return type(tree), names, tuple(getattr(tree, k) for k in names)
    if isinstance(tree, dict):
        keys = tuple(sorted(tree))
        return dict, keys, tuple(tree[k] for k in keys)
    return None


def _build(kind, keys, children):
    if kind is type(None):
        return None
    fields = dict(zip(keys, children))
    return fields if kind is dict else kind(**fields)


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of ``tree`` and the matching leaves of the
    trees in ``rest`` (of the same structure), rebuilt in ``tree``'s
    structure.  Matching goes by field name and dict key, so the walk
    needs no leaf order: a dict keeps its own key order and nothing is
    sorted (the ragged pipeline maps each state once a step)."""
    if tree is None:
        return None
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return type(tree)(**{
            f.name: tree_map(fn, getattr(tree, f.name), *(getattr(r, f.name) for r in rest))
            for f in dataclasses.fields(tree)})
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    return fn(tree, *rest)


def tree_flatten(tree):
    """(leaves, treedef): the leaves in the JAX package's order and the
    structure that ``tree_unflatten`` rebuilds from them."""
    leaves = []

    def walk(t):
        node = _node(t)
        if node is None:
            leaves.append(t)
            return None
        kind, keys, children = node
        return kind, keys, tuple(walk(c) for c in children)

    return leaves, walk(tree)


def tree_unflatten(treedef, leaves):
    """The tree of ``treedef`` (from ``tree_flatten``) holding ``leaves``."""
    it = iter(leaves)

    def build(d):
        if d is None:
            return next(it)
        kind, keys, children = d
        return _build(kind, keys, tuple(build(c) for c in children))

    return build(treedef)


def state_from_numpy(arrays: dict, device="cuda", cls: type = EbuR128State):
    """A state of class ``cls`` (EbuR128State unless given) from a dict
    holding every field as an array, or as a nested dict for a field that
    is a state class itself.  A dict ``cls`` ({key: class}) gives a dict
    state.

    Dtypes follow the arrays (float32 / int32 / bool, as both packages
    keep them); a missing or unknown field raises KeyError."""
    is_dict = isinstance(cls, dict)
    hints = dict(cls) if is_dict else typing.get_type_hints(cls)
    names = list(hints) if is_dict else [f.name for f in dataclasses.fields(cls)]
    missing = set(names) - set(arrays)
    extra = set(arrays) - set(names)
    if missing or extra:
        what = "dict state" if is_dict else cls.__name__
        raise KeyError(f"{what} fields missing {sorted(missing)}, unknown {sorted(extra)}")
    kw = {}
    for k in names:
        if dataclasses.is_dataclass(hints[k]):
            kw[k] = state_from_numpy(arrays[k], device, hints[k])
        else:
            kw[k] = torch.as_tensor(np.array(arrays[k], copy=True), device=device)
    return kw if is_dict else cls(**kw)


def state_to_numpy(state) -> dict:
    """Every field of a state (a dataclass, or a dict of tensors and
    states) as a host numpy array (a nested dict for a field that is a
    state itself)."""
    if isinstance(state, dict):
        return {k: (state_to_numpy(v) if dataclasses.is_dataclass(v)
                    else v.detach().cpu().numpy()) for k, v in state.items()}
    return {
        f.name: (state_to_numpy(v) if dataclasses.is_dataclass(v)
                 else v.detach().cpu().numpy())
        for f in dataclasses.fields(state)
        for v in (getattr(state, f.name),)
    }
