"""Sequence parallelism for linear recurrences (counterpart of
``meters_lv2_tpu/parallel/timepar.py``).

Splitting an IIR across ranks looks impossible (per-sample dependence),
but the blocked state-space form (ops.lti) makes the cross-rank dependency
a d-dimensional affine map: rank k's incoming state is

    s_in[k] = (A^L)^k s0 + sum_{i<k} (A^L)^{k-1-i} b[i]

where b[i] is rank i's zero-state response (computed locally in one
pass).  An all_gather of the small b vectors and a local compose give
every rank its true incoming state; a second local pass gives exact
outputs.  A^L is taken in float64 on the host (``np.linalg.matrix_power``;
a shard is millions of samples long) and rounded to float32 once; the
compose products are IEEE float32 (``ops.lti.matmul``) whatever the caller
set, since entry-state errors would compound across shards.

The zero-state pass needs only the exit state, not the outputs: it is
the system's ``exit_state`` (``ops.lti.lti_scan_exit``, a pairwise tree
over the blocks in place of ``apply``'s launch a block).

``axis`` is a mesh axis (``parallel.mesh.Axis``, the mesh's ``sp``).
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops import lti
from ..ops.lti import BankedLTISystem, LTISystem


def _compose(s0: torch.Tensor, b_all: torch.Tensor, aL: torch.Tensor, k: int) -> torch.Tensor:
    """s := s @ aL + b[i] for i < k, from s0 broadcast to b's shape; a
    banked aL [NB, d, d] multiplies each bank's state by its own matrix."""
    s = s0 + torch.zeros_like(b_all[0])
    for i in range(k):
        if aL.ndim == 2:
            s = lti.matmul(s, aL) + b_all[i]
        else:
            s = lti.matmul(s.unsqueeze(-2), aL).squeeze(-2) + b_all[i]
    return s


def lti_entry_state_sp(sys: LTISystem, u: torch.Tensor, s0: torch.Tensor, axis,
                       prefer_block: int = 128) -> torch.Tensor:
    """This rank's exact incoming state for its time shard (pass 1 of
    ``lti_apply_sp``).  Exposed so that shard bodies which evaluate the
    local recurrence by other means (the fused R128 kernel) can still
    compose the cross-rank state exactly.

    u: local segment [..., L(, m)] (rank k holds samples [k L, (k+1) L));
    s0: stream-start state [..., d] (only index 0's enters)."""
    # [nsp, ..., d]
    b_all = axis.all_gather(sys.exit_state(u, torch.zeros_like(s0), prefer_block))
    T = u.shape[-2] if u.ndim > s0.ndim else u.shape[-1]
    aL = np.linalg.matrix_power(sys.A, T).T.astype(np.float32)  # right-multiply form
    return _compose(s0, b_all, torch.as_tensor(aL, device=u.device), axis.index)


def lti_apply_sp(sys: LTISystem, u: torch.Tensor, s0: torch.Tensor, axis,
                 prefer_block: int = 128):
    """Run ``sys`` over a time-sharded input.

    Returns (y_local, s_final): this rank's exact outputs, and the
    stream-end state (the last index's exit state) on every rank."""
    s_in = lti_entry_state_sp(sys, u, s0, axis, prefer_block)
    y, s_out = sys.apply(u, s_in, prefer_block)
    return y, axis.all_gather(s_out)[axis.size - 1]


def banked_lti_apply_sp(bank: BankedLTISystem, u: torch.Tensor, s0: torch.Tensor, axis,
                        prefer_block: int = 128):
    """``lti_apply_sp`` for a bank of NB independent systems (the 30-band
    filter bank): one all_gather of [nsp, ..., NB, d] zero-state responses;
    per-band A^L compose the entry states.

    u: local segment [..., L], shared by the banks; s0: [..., NB, d].
    Returns (y_local [..., NB, L], s_final [..., NB, d])."""
    b_all = axis.all_gather(bank.exit_state(u, torch.zeros_like(s0), prefer_block))
    T = u.shape[-1]
    aL = np.stack([np.linalg.matrix_power(m[0], T).T for m in bank.mats]).astype(np.float32)
    s_in = _compose(s0, b_all, torch.as_tensor(aL, device=u.device), axis.index)
    y, s_out = bank.apply(u, s_in, prefer_block)
    return y, axis.all_gather(s_out)[axis.size - 1]
