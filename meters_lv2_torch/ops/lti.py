"""Blocked linear-time-invariant (LTI) recurrence evaluation in PyTorch.

Counterpart of ``meters_lv2_tpu/ops/lti.py``.  A recurrence

    s[t+1] = A s[t] + B u[t]        (state s: R^d, input u: R^m)
    y[t]   = C s[t] + D u[t]

is evaluated in blocks of T samples: within a block the output is an exact
affine function of the incoming state and the block's inputs,

    y_blk = U_blk @ K^T + s_in @ Sy^T
    s_out = s_in @ (A^T)^T + vec(U_blk) @ G

where K is the lower-triangular block Toeplitz matrix of the truncated
impulse response.  The block matrices are built on the host in float64 and
kept as float32 numpy leaves; ``LTIBlockOp.tensors(device)`` caches their
torch copies per device.

Every product here is IEEE float32: on a CUDA device ``torch.matmul`` runs
full fp32 as long as ``torch.backends.cuda.matmul.allow_tf32`` stays False
(PyTorch's default).  The state chain compounds its rounding across blocks
(see the JAX module's precision note), so it must never run in TF32.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch


class BlockOpTensors(NamedTuple):
    """The float32 leaves of an ``LTIBlockOp`` on one device."""

    kmat: torch.Tensor  # [T*m, T*p]
    sy: torch.Tensor  # [d, T*p]
    at: torch.Tensor  # [d, d]
    g: torch.Tensor  # [T*m, d]


def canonical_device(device) -> torch.device:
    """``torch.device`` with the index filled in for CUDA, so cache keys
    for "cuda" and "cuda:0" agree."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device


def check_tensor(name: str, t: torch.Tensor, shape, device) -> None:
    """Raise unless t is a contiguous float32 tensor of ``shape`` on
    ``device``: what every kernel wrapper checks before it passes a
    pointer."""
    if t.dtype != torch.float32:
        raise TypeError(f"{name} must be float32, got {t.dtype}")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


@dataclasses.dataclass(frozen=True, eq=False)
class LTIBlockOp:
    """Precomputed block-recurrence operator (host numpy leaves).

    Attributes:
      kmat:  [T*m, T*p]  lower block-triangular input->output map, stored
                         transposed so that y = u @ kmat
      sy:    [d, T*p]    state->output map (rows of C A^j), transposed
      at:    [d, d]      A^T_block (state propagation over one block)
      g:     [T*m, d]    input->state map (A^{T-1-j} B columns)
      block: samples (input steps) per block
      d, m, p: state/input/output dims
    """

    kmat: np.ndarray
    sy: np.ndarray
    at: np.ndarray
    g: np.ndarray
    block: int
    d: int
    m: int
    p: int
    _on_device: dict = dataclasses.field(
        default_factory=dict, repr=False, compare=False
    )

    def tensors(self, device) -> BlockOpTensors:
        """The leaves as float32 tensors on ``device`` (cached per device)."""
        device = canonical_device(device)
        if device not in self._on_device:
            self._on_device[device] = block_op_tensors(self, device)
        return self._on_device[device]


def block_op_tensors(op, device="cpu") -> BlockOpTensors:
    """The kmat/sy/at/g leaves of a block operator of either package (any
    object with those numpy attributes) as float32 tensors on ``device``."""
    return BlockOpTensors(
        *(
            torch.as_tensor(
                np.ascontiguousarray(getattr(op, k), np.float32), device=device
            )
            for k in BlockOpTensors._fields
        )
    )


def build_lti_block_op(
    A: np.ndarray,
    B: np.ndarray,
    C: np.ndarray,
    D: np.ndarray,
    block: int,
    dtype=np.float32,
) -> LTIBlockOp:
    """Precompute block matrices in float64 on the host."""
    A = np.asarray(A, np.float64)
    B = np.asarray(B, np.float64)
    C = np.asarray(C, np.float64)
    D = np.asarray(D, np.float64)
    d = A.shape[0]
    m = B.shape[1]
    p = C.shape[0]
    T = int(block)

    # powers of A: apow[j] = A^j, j = 0..T
    apow = np.empty((T + 1, d, d))
    apow[0] = np.eye(d)
    for j in range(1, T + 1):
        apow[j] = A @ apow[j - 1]

    # impulse response h[0] = D, h[i] = C A^{i-1} B  (shape [T, p, m])
    h = np.empty((T, p, m))
    h[0] = D
    for i in range(1, T):
        h[i] = C @ apow[i - 1] @ B

    # K[(i,p),(j,m)] = h[i-j] for i >= j  -> y_i = sum_j h[i-j] u_j
    kmat = np.zeros((T * p, T * m))
    for i in range(T):
        for j in range(i + 1):
            kmat[i * p : (i + 1) * p, j * m : (j + 1) * m] = h[i - j]

    # Sy[(i,p), d] = C A^i
    sy = np.empty((T * p, d))
    for i in range(T):
        sy[i * p : (i + 1) * p] = C @ apow[i]

    # G[(j,m), d]: s_out = A^T s_in + sum_j A^{T-1-j} B u_j  -> columns
    g = np.empty((T * m, d))
    for j in range(T):
        g[j * m : (j + 1) * m] = (apow[T - 1 - j] @ B).T

    npdt = np.dtype(dtype)
    return LTIBlockOp(
        kmat=np.asarray(kmat.T, npdt),  # stored transposed: u @ kmat.T
        sy=np.asarray(sy.T, npdt),
        at=np.asarray(apow[T].T, npdt),
        g=np.asarray(g, npdt),
        block=T,
        d=d,
        m=m,
        p=p,
    )


def lti_scan(
    op: LTIBlockOp, u: torch.Tensor, s0: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """Run the blocked recurrence.

    The input->output convolution within each block is state-independent,
    so it runs for all blocks as one batched matmul; only the d-dimensional
    state recurrence is sequential, as a plain loop over blocks:

        conv_y[k] = u[k] @ K
        gin[k]    = u[k] @ G
        s[k+1]    = s[k] @ A^T + gin[k]
        y[k]      = conv_y[k] + s[k] @ Sy

    Args:
      op: precomputed block operator.
      u:  inputs [..., T_total, m] (T_total divisible by op.block), or
          [..., T_total] when m == 1.
      s0: initial state [..., d].

    Returns:
      (y, s_final): y [..., T_total, p] (or [..., T_total] if the input
      was rank-reduced and p == 1); s_final [..., d].
    """
    squeeze = False
    if u.ndim == s0.ndim:  # missing input-channel dim
        u = u[..., None]
        squeeze = op.p == 1
    *batch, T_total, m = u.shape
    assert m == op.m, (m, op.m)
    assert T_total % op.block == 0, (T_total, op.block)
    nblk = T_total // op.block
    w = op.tensors(u.device)

    uf = u.reshape(*batch, nblk, op.block * op.m)
    conv_y = torch.matmul(uf, w.kmat)  # [..., nblk, T*p]
    gin = torch.matmul(uf, w.g)  # [..., nblk, d]

    s = torch.broadcast_to(s0, gin.shape[:-2] + (op.d,))
    entry = []
    for k in range(nblk):
        entry.append(s)
        s = torch.matmul(s, w.at) + gin[..., k, :]
    s_all = torch.stack(entry, dim=-2)  # [..., nblk, d] entry states

    y = conv_y + torch.matmul(s_all, w.sy)
    y = y.reshape(*batch, T_total, op.p)
    if squeeze:
        y = y[..., 0]
    return y, s


class LTISystem:
    """An (A, B, C, D) system plus a cache of block operators.

    ``apply`` handles arbitrary step counts by splitting into a main run of
    ``prefer_block``-sized blocks plus one remainder block, so callers can
    feed any block length without rebuilding constants per call.
    """

    def __init__(self, A, B, C, D):
        self.A = np.asarray(A, np.float64)
        self.B = np.asarray(B, np.float64)
        self.C = np.asarray(C, np.float64)
        self.D = np.asarray(D, np.float64)
        self.d = self.A.shape[0]
        self.m = self.B.shape[1]
        self.p = self.C.shape[0]
        self._ops: dict[int, LTIBlockOp] = {}

    def op(self, block: int) -> LTIBlockOp:
        if block not in self._ops:
            self._ops[block] = build_lti_block_op(
                self.A, self.B, self.C, self.D, block
            )
        return self._ops[block]

    def init(self, batch_shape=(), device="cpu") -> torch.Tensor:
        return torch.zeros(
            (*batch_shape, self.d), dtype=torch.float32, device=device
        )

    def apply(
        self, u: torch.Tensor, s0: torch.Tensor, prefer_block: int = 128
    ) -> tuple[torch.Tensor, torch.Tensor]:
        """Run the recurrence over u [..., T(, m)] from state s0 [..., d]."""
        squeeze = u.ndim == s0.ndim
        if squeeze:
            u = u[..., None]
        T = u.shape[-2]
        main = (T // prefer_block) * prefer_block
        ys = []
        s = s0
        if main:
            y, s = lti_scan(self.op(prefer_block), u[..., :main, :], s)
            ys.append(y)
        if T - main:
            y, s = lti_scan(self.op(T - main), u[..., main:, :], s)
            ys.append(y)
        y = ys[0] if len(ys) == 1 else torch.cat(ys, dim=-2)
        if squeeze and self.p == 1:
            y = y[..., 0]
        return y, s


def one_pole_system(w: float) -> LTISystem:
    """z' = (1-w) z + w x ; y = z' (post-update value, as the meters read)."""
    A = np.array([[1.0 - w]])
    B = np.array([[w]])
    # y[t] must be the *updated* state: y = (1-w) z + w x
    C = np.array([[1.0 - w]])
    D = np.array([[w]])
    return LTISystem(A, B, C, D)


def grouped4_smoother_system(w: float) -> LTISystem:
    """The shared VU/K-meter two-stage smoother at 4-sample cadence.

    Semantics (vumeterdsp.cc:56-68 / kmeterdsp.cc:77-107): per group of 4
    inputs u0..u3 (x^2 for the K-meter)::

        z1 += w*(u_i - z1)      (4x)
        z2 += 4w*(z1 - z2)      (once per group)

    LTI with 4 inputs per step (m = 4).  Output = z2 after the update.
    State order: (z1, z2).
    """
    wq = float(w)
    a = 1.0 - wq
    A1 = a**4
    # z1_out = (1-w)^4 z1 + sum_i w (1-w)^{3-i} u_i
    Bu = np.array([wq * a**3, wq * a**2, wq * a, wq])
    # z2_out = (1-4w) z2 + 4w z1_out
    A = np.array([[A1, 0.0], [4 * wq * A1, 1.0 - 4 * wq]])
    B = np.vstack([Bu, 4 * wq * Bu])  # [2, 4]
    C = np.array([[4 * wq * A1, 1.0 - 4 * wq]])  # z2 after update
    D = (4 * wq * Bu)[None, :]
    return LTISystem(A, B, C, D)


def vu_grouped4_system(w: float) -> LTISystem:
    """VU meter exact 4-sample-cadence recurrence (vumeterdsp.cc:56-68).

    Per group with t2 = z2/2 frozen at group start::

        z1 += w*(|x_i| - z2/2 - z1)   (4x)
        z2 += 4w*(z1 - z2)

    Inputs are |x_i| (4 per group, m = 4); output = z2 after the group
    update.  The -z2/2 feed makes z2 enter the z1 path: fold into A.
    """
    wq = float(w)
    a = 1.0 - wq
    # z1_out = a^4 z1 + (sum_i w a^{3-i}) * (-z2/2) + sum_i w a^{3-i} |x_i|
    Bu = np.array([wq * a**3, wq * a**2, wq * a, wq])
    s_b = Bu.sum()
    A = np.array(
        [
            [a**4, -0.5 * s_b],
            [4 * wq * a**4, 1.0 - 4 * wq - 4 * wq * 0.5 * s_b],
        ]
    )
    B = np.vstack([Bu, 4 * wq * Bu])
    C = A[1:2, :]
    D = B[1:2, :]
    return LTISystem(A, B, C, D)
