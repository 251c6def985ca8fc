"""Checkpoint / save-restore of meter state (counterpart of
``meters_lv2_tpu/utils/state.py``).

The reference persists small UI/config words through the LV2 State
interface (src/ebulv2.cc:514-553 packs ui_settings | transport_mode<<8 |
radar_speed<<16 into one uint32; src/goniometerlv2.c:210-293 stores float
vectors of display prefs).  Measurement state is not persisted there:
resume restarts measurement.

Here any meter state is a tree of tensors (frozen dataclasses and dicts,
nested), so a full measurement checkpoint is a tree serialisation:

- pack_settings / unpack_settings: the reference's bit-packed config word
- save_state / load_state: full measurement checkpoint (npz), enabling
  resume of long-running jobs mid-stream
- save_state_sharded / load_state_sharded: the same for a state split over
  a ('dp', 'sp') mesh of ranks (parallel.mesh): each rank writes and reads
  only its own block, in the save_state layout, beside a manifest

The npz layout is the JAX package's: the leaves in its order (dataclass
fields in order, dict keys sorted) as ``leaf_{i}``, plus a
``__treedef__`` byte string that describes the tree and is not read back.
A checkpoint written by either package therefore loads into the other.
Leaves are tensors or host numpy values; the live shell's session tree
holds both.

Compatibility: checkpoints capture internal state representations (e.g.
a filter's state-space realization), which may change between versions
while keeping identical shapes; load_state validates count/shape/dtype,
so restore checkpoints with the version that wrote them (the same caveat
applies to the reference's LV2 State across plugin versions).
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch

from .interop import tree_flatten, tree_unflatten


def pack_settings(ui_settings: int = 0, transport_mode: int = 0, radar_speed: int = 0) -> int:
    """EBU plugin state word (src/ebulv2.cc:519-524)."""
    return (ui_settings & 0xFF) | ((transport_mode & 0xFF) << 8) | ((radar_speed & 0xFFFF) << 16)


def unpack_settings(word: int) -> dict:
    return {
        "ui_settings": word & 0xFF,
        "transport_mode": (word >> 8) & 0xFF,
        "radar_speed": (word >> 16) & 0xFFFF,
    }


def _host(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def save_state(state, path_or_file):
    """Serialize a meter-state tree to .npz (host roundtrip).

    A string/Path target is written at exactly that path (np.savez alone
    would append '.npz' when the suffix is missing, making save/load
    asymmetric for extensionless paths)."""
    leaves, treedef = tree_flatten(state)
    arrays = {f"leaf_{i}": _host(x) for i, x in enumerate(leaves)}
    arrays["__treedef__"] = np.frombuffer(repr(treedef).encode(), dtype=np.uint8)
    if isinstance(path_or_file, (str, os.PathLike)):
        with open(path_or_file, "wb") as f:
            np.savez(f, **arrays)
    else:
        np.savez(path_or_file, **arrays)


def _spec(like):
    """(shape, numpy dtype or None) that a saved leaf must have to stand in
    for ``like``."""
    if isinstance(like, torch.Tensor):
        return tuple(like.shape), torch.empty((), dtype=like.dtype).numpy().dtype
    return np.shape(like), getattr(like, "dtype", None)


def _restore(arr: np.ndarray, like):
    """A saved leaf in the form of ``like``: a tensor on ``like``'s device,
    a numpy scalar of ``like``'s type, or a numpy array."""
    if isinstance(like, torch.Tensor):
        return torch.as_tensor(np.array(arr, order="C"), device=like.device)
    if isinstance(like, np.generic):
        return arr[()]
    return arr


def load_state(like_state, path_or_file):
    """Restore a tree saved by save_state; ``like_state`` supplies the
    structure and the placement: each tensor leaf lands on the device of
    the matching leaf of ``like_state``, a numpy leaf stays numpy.

    Leaves map positionally, so a checkpoint from a different tree would
    silently land in the wrong slots; guard by validating leaf count and
    per-leaf shape/dtype against ``like_state`` before building anything."""
    leaves, treedef = tree_flatten(like_state)
    n = len(leaves)
    with np.load(path_or_file) as data:  # close the npz fd promptly
        saved_n = sum(1 for k in data.files if k.startswith("leaf_"))
        if saved_n != n:
            raise ValueError(
                f"checkpoint has {saved_n} leaves, expected {n} — saved "
                "from a different meter configuration"
            )
        arrays = []
        for i, like in enumerate(leaves):
            arr = data[f"leaf_{i}"]
            want_shape, want_dtype = _spec(like)
            if arr.shape != want_shape or (want_dtype is not None and arr.dtype != want_dtype):
                raise ValueError(
                    f"checkpoint leaf {i} is {arr.shape}/{arr.dtype}, "
                    f"expected {want_shape}/{want_dtype} — saved from a "
                    "different meter configuration"
                )
            arrays.append(arr)
    return tree_unflatten(treedef, [_restore(a, like) for a, like in zip(arrays, leaves)])


_MANIFEST = "manifest.json"


def _rank_file(rank: int) -> str:
    return f"rank{rank}.npz"


def save_state_sharded(state, path, mesh) -> None:
    """Checkpoint this rank's block of a mesh-sharded meter state; called
    by every rank of ``mesh`` (parallel.mesh.Mesh).

    Each rank writes only its own block to ``path/rank{r}.npz`` in the
    ``save_state`` layout, and rank 0 the manifest ``path/manifest.json``
    (dp, sp, world size, each rank's mesh position and file): no rank
    touches another rank's file, nothing is gathered to one host.  Returns
    when every rank has written (a barrier)."""
    os.makedirs(path, exist_ok=True)
    save_state(state, os.path.join(path, _rank_file(mesh.rank)))
    if mesh.rank == 0:
        dp, sp = mesh.shape
        manifest = {
            "dp": dp, "sp": sp, "world_size": mesh.world_size,
            "blocks": [{"rank": r, "dp_index": r // sp, "sp_index": r % sp,
                        "file": _rank_file(r)} for r in range(mesh.world_size)],
        }
        tmp = os.path.join(path, _MANIFEST + ".tmp")
        with open(tmp, "w") as f:
            json.dump(manifest, f)
        os.replace(tmp, os.path.join(path, _MANIFEST))
    mesh.barrier()


def load_state_sharded(like_state, path, mesh):
    """Restore this rank's block of a ``save_state_sharded`` checkpoint;
    called by every rank.  The manifest must name this mesh's layout (dp,
    sp, world size and this rank's position), else ValueError; the block
    is checked leaf by leaf against ``like_state`` as ``load_state``
    checks, and each tensor lands on its like leaf's device."""
    with open(os.path.join(path, _MANIFEST)) as f:
        manifest = json.load(f)
    dp, sp = mesh.shape
    saved = (manifest["dp"], manifest["sp"], manifest["world_size"])
    if saved != (dp, sp, mesh.world_size):
        raise ValueError(
            f"checkpoint saved under dp={saved[0]} x sp={saved[1]} ({saved[2]} ranks), this "
            f"mesh is dp={dp} x sp={sp} ({mesh.world_size} ranks)")
    block = manifest["blocks"][mesh.rank]
    if (block["rank"], block["dp_index"], block["sp_index"]) != (mesh.rank, *divmod(mesh.rank, sp)):
        raise ValueError(f"manifest block {block} does not belong to rank {mesh.rank}")
    return load_state(like_state, os.path.join(path, block["file"]))
