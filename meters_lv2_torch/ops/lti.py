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

Every product here is IEEE float32, whatever the caller set: the state
chain compounds its rounding across blocks (see the JAX module's precision
note), so it must never run in TF32.  ``ieee_fp32`` pins that for the
products of the port's glue (``matmul`` here; the LTI scan, the
resampler, the surround and correlator averages and the phase wheel's
band sums call it).
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from ..utils import profiler


# the per-backend float32 matmul settings (PyTorch 2.9 on); older versions
# have the global one only
_FP32_BACKENDS = tuple(
    b for b in (getattr(torch.backends.cuda, "matmul", None),
                getattr(getattr(torch.backends, "mkldnn", None), "matmul", None))
    if b is not None and hasattr(b, "fp32_precision"))


def _ieee_already() -> bool:
    try:
        return torch.get_float32_matmul_precision() == "highest"
    except RuntimeError:  # per-backend settings that the global one cannot name
        return False


@contextlib.contextmanager
def ieee_fp32():
    """Run the body's float32 matrix products in IEEE float32, with TF32 and
    bf16 off, whatever ``torch.set_float32_matmul_precision`` or the
    per-backend ``fp32_precision`` settings say; the caller's settings come
    back on exit, exception or not."""
    if _ieee_already():
        yield
        return
    if _FP32_BACKENDS:
        saved = [b.fp32_precision for b in _FP32_BACKENDS]
        try:
            for b in _FP32_BACKENDS:
                b.fp32_precision = "ieee"
            yield
        finally:
            for b, v in zip(_FP32_BACKENDS, saved):
                b.fp32_precision = v
    else:
        saved = torch.get_float32_matmul_precision()
        try:
            torch.set_float32_matmul_precision("highest")
            yield
        finally:
            torch.set_float32_matmul_precision(saved)


def matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``torch.matmul`` in IEEE float32 (``ieee_fp32``)."""
    with ieee_fp32():
        return torch.matmul(a, b)


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
      at64:  A^T_block in float64, the source of ``at_powers`` (None where
             the operator was built elsewhere)
    """

    kmat: np.ndarray
    sy: np.ndarray
    at: np.ndarray
    g: np.ndarray
    block: int
    d: int
    m: int
    p: int
    at64: np.ndarray | None = dataclasses.field(default=None, repr=False, compare=False)
    _on_device: dict = dataclasses.field(
        default_factory=dict, repr=False, compare=False
    )
    _powers: dict = dataclasses.field(default_factory=dict, repr=False, compare=False)

    def tensors(self, device) -> BlockOpTensors:
        """The leaves as float32 tensors on ``device`` (cached per device)."""
        device = canonical_device(device)
        if device not in self._on_device:
            with profiler.counted("cache.fill"):
                self._on_device[device] = block_op_tensors(self, device)
        return self._on_device[device]

    def at_powers(self, levels: int, device) -> list[torch.Tensor]:
        """[(A^T_block)^(2^l) for l < levels] as float32 tensors on
        ``device``: squared in float64 on the host and rounded once, cached
        per device."""
        if self.at64 is None:
            raise ValueError("this block operator carries no float64 A^T_block")
        device = canonical_device(device)
        have = self._powers.get(device, [])
        if len(have) < levels:
            p64 = [self.at64]
            while len(p64) < levels:
                p64.append(p64[-1] @ p64[-1])  # a stacked [NB, d, d] squares by bank
            have = [torch.as_tensor(p.astype(np.float32), device=device) for p in p64]
            self._powers[device] = have
        return have[:levels]


def block_op_tensors(op, device="cuda") -> BlockOpTensors:
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
        at64=apow[T].T.copy(),
    )


@dataclasses.dataclass(frozen=True, eq=False)
class TensorBlockOp:
    """A block operator whose leaves are already tensors on one device
    (built there from a runtime coefficient, ``one_pole_block_op_traced``)."""

    kmat: torch.Tensor
    sy: torch.Tensor
    at: torch.Tensor
    g: torch.Tensor
    block: int
    d: int
    m: int
    p: int

    def tensors(self, device) -> BlockOpTensors:
        if canonical_device(device) != canonical_device(self.kmat.device):
            raise ValueError(f"operator is on {self.kmat.device}, input on {device}")
        return BlockOpTensors(self.kmat, self.sy, self.at, self.g)


def _mm_state(s: torch.Tensor, at: torch.Tensor) -> torch.Tensor:
    """State s [..., (NB,) i] @ at [(NB,) i, j].  A banked ``at`` holds one
    matrix per bank, contracted with the bank axis of s ("...bi,bij->...bj"):
    a plain matmul would take s's last two axes as one [NB, i] matrix.
    Called inside ``lti_scan``'s ``ieee_fp32`` block."""
    if at.ndim == 2:
        return torch.matmul(s, at)
    return torch.matmul(s.unsqueeze(-2), at).squeeze(-2)


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

    A banked operator (leaves with a leading bank axis NB, from
    ``BankedLTISystem``) takes u [..., NB, T_total, m] and s0 [..., NB, d];
    the per-block products batch over the bank axis.

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
    with ieee_fp32():  # one block for the scan: the loop pays for it once
        conv_y = torch.matmul(uf, w.kmat)  # [..., nblk, T*p]
        gin = torch.matmul(uf, w.g)  # [..., nblk, d]

        s = torch.broadcast_to(s0, gin.shape[:-2] + (op.d,))
        entry = []
        for k in range(nblk):
            entry.append(s)
            s = _mm_state(s, w.at) + gin[..., k, :]
        s_all = torch.stack(entry, dim=-2)  # [..., nblk, d] entry states

        y = conv_y + torch.matmul(s_all, w.sy)
    y = y.reshape(*batch, T_total, op.p)
    if squeeze:
        y = y[..., 0]
    return y, s


def _scan_split(op_of, u: torch.Tensor, s: torch.Tensor, prefer_block: int):
    """lti_scan over u [..., T, m] as a run of ``prefer_block``-sized blocks
    plus one remainder block, state chained; ``op_of(n)`` gives the block
    operator for n samples.  Returns (y [..., T, p], s)."""
    T = u.shape[-2]
    main = (T // prefer_block) * prefer_block
    ys = []
    if main:
        y, s = lti_scan(op_of(prefer_block), u[..., :main, :], s)
        ys.append(y)
    if T - main:
        y, s = lti_scan(op_of(T - main), u[..., main:, :], s)
        ys.append(y)
    return (ys[0] if len(ys) == 1 else torch.cat(ys, dim=-2)), s


def lti_scan_exit(op: LTIBlockOp, u: torch.Tensor, s0: torch.Tensor) -> torch.Tensor:
    """The final state of ``lti_scan(op, u, s0)`` without the outputs.

    The blocks' input terms gin[k] = u[k] @ G come from one product, as in
    ``lti_scan``; s0 P^n + sum_k gin[k] P^(n-1-k), P = A^T_block, then comes
    from a pairwise tree of ceil(log2(n + 1)) levels, each with its power
    of P (``LTIBlockOp.at_powers``), where ``lti_scan`` walks the n blocks
    one launch after another (112,500 of them for 14.4 M samples at 128).
    The sums run in another order than the loop's, so the state differs
    from ``lti_scan``'s by float32 rounding.  Arguments as ``lti_scan``;
    returns s_final [..., d]."""
    if u.ndim == s0.ndim:  # missing input-channel dim
        u = u[..., None]
    *batch, T_total, m = u.shape
    assert m == op.m, (m, op.m)
    assert T_total % op.block == 0, (T_total, op.block)
    nblk = T_total // op.block
    w = op.tensors(u.device)
    with ieee_fp32():
        gin = torch.matmul(u.reshape(*batch, nblk, op.block * op.m), w.g)  # [..., nblk, d]
        s = torch.broadcast_to(s0, gin.shape[:-2] + (op.d,))
        g = torch.cat([s.unsqueeze(-2), gin], dim=-2)  # term j takes P^(nblk - j)
        for pw in op.at_powers(nblk.bit_length(), u.device):
            if g.shape[-2] % 2:  # a zero term in front changes no sum
                g = torch.cat([torch.zeros_like(g[..., :1, :]), g], dim=-2)
            # a banked pw [NB, d, d] batches with g's bank axis [..., NB, k, d]
            g = torch.matmul(g[..., 0::2, :], pw) + g[..., 1::2, :]
    return g[..., 0, :]


def _exit_split(op_of, u: torch.Tensor, s: torch.Tensor, prefer_block: int) -> torch.Tensor:
    """``_scan_split``'s final state by ``lti_scan_exit``."""
    T = u.shape[-2]
    main = (T // prefer_block) * prefer_block
    if main:
        s = lti_scan_exit(op_of(prefer_block), u[..., :main, :], s)
    if T - main:
        s = lti_scan_exit(op_of(T - main), u[..., main:, :], s)
    return s


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
            with profiler.counted("cache.fill"):
                self._ops[block] = build_lti_block_op(
                    self.A, self.B, self.C, self.D, block
                )
        return self._ops[block]

    def init(self, batch_shape=(), device="cuda") -> torch.Tensor:
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
        y, s = _scan_split(self.op, u, s0, prefer_block)
        if squeeze and self.p == 1:
            y = y[..., 0]
        return y, s

    def exit_state(
        self, u: torch.Tensor, s0: torch.Tensor, prefer_block: int = 128
    ) -> torch.Tensor:
        """``apply(u, s0, prefer_block)[1]`` without the outputs
        (``lti_scan_exit``)."""
        if u.ndim == s0.ndim:
            u = u[..., None]
        return _exit_split(self.op, u, s0, prefer_block)


class BankedLTISystem:
    """A bank of NB independent same-dimension LTI systems (e.g. the 30
    IEC 61260 band filters) evaluated together: block operators are stacked
    along a leading bank axis and the per-block products batch over it.

    apply() semantics match LTISystem.apply with an extra bank axis: input
    u [..., T] is broadcast to every bank; output y is [..., NB, T];
    state s is [..., NB, d].
    """

    def __init__(self, systems: list[tuple]):
        self.mats = [tuple(np.asarray(m, np.float64) for m in s) for s in systems]
        d0 = self.mats[0][0].shape[0]
        assert all(m[0].shape[0] == d0 for m in self.mats)
        self.nb = len(systems)
        self.d = d0
        self.m = self.mats[0][1].shape[1]
        self.p = self.mats[0][2].shape[0]
        self._ops: dict[int, LTIBlockOp] = {}

    def op(self, block: int) -> LTIBlockOp:
        if block not in self._ops:
            ops = [build_lti_block_op(*m, block) for m in self.mats]
            self._ops[block] = LTIBlockOp(
                *(np.stack([getattr(o, k) for o in ops]) for k in BlockOpTensors._fields),
                block=block, d=self.d, m=self.m, p=self.p,
                at64=np.stack([o.at64 for o in ops]),
            )
        return self._ops[block]

    def init(self, batch_shape=(), device="cuda") -> torch.Tensor:
        return torch.zeros(
            (*batch_shape, self.nb, self.d), dtype=torch.float32, device=device
        )

    def apply(
        self, u: torch.Tensor, s0: torch.Tensor, prefer_block: int = 128
    ) -> tuple[torch.Tensor, torch.Tensor]:
        """u: [..., T] (shared across banks); s0: [..., NB, d].
        Returns (y [..., NB, T], s [..., NB, d])."""
        y, s = _scan_split(self.op, self._banked(u), s0, prefer_block)
        return y[..., 0], s

    def exit_state(
        self, u: torch.Tensor, s0: torch.Tensor, prefer_block: int = 128
    ) -> torch.Tensor:
        """``apply(u, s0, prefer_block)[1]`` without the outputs
        (``lti_scan_exit``)."""
        return _exit_split(self.op, self._banked(u), s0, prefer_block)

    def _banked(self, u: torch.Tensor) -> torch.Tensor:
        """u [..., T] shared by the banks as [..., NB, T, 1]."""
        return u.unsqueeze(-2).expand(*u.shape[:-1], self.nb, u.shape[-1]).unsqueeze(-1)


def one_pole_block_op_traced(omega: torch.Tensor, block: int) -> TensorBlockOp:
    """Block operator for z' = (1-w) z + w x, y = z', from a runtime omega.

    ``omega`` is a 0-d float32 tensor; the operator is built on its device
    from it, so a speed change costs neither a rebuild of host constants
    nor a host sync (the reference changes its display speed through a
    control port, src/spectrumlv2.c:161-177).  Powers go through
    exp(k*log1p(-w)) so tiny omegas (slow speeds) don't lose precision to
    the f32 representation of 1-w.
    """
    om = omega.to(torch.float32)
    dev = om.device
    l1 = torch.log1p(-om)  # log(1 - w)
    kk = torch.arange(block + 1, dtype=torch.float32, device=dev)
    pw = torch.exp(kk * l1)  # (1-w)^k, k = 0..block
    ar = torch.arange(block, device=dev)
    idx = ar[:, None] - ar[None, :]
    kmat = torch.where(
        idx >= 0, om * torch.exp(idx.to(torch.float32) * l1), torch.zeros((), device=dev)
    )  # K[i, j] = w (1-w)^{i-j}
    return TensorBlockOp(
        kmat=kmat.T.contiguous(),  # stored transposed, as build_lti_block_op does
        sy=pw[1 : block + 1][None, :],  # C A^i = (1-w)^{i+1}
        at=pw[block : block + 1][None, :],  # A^block
        g=(om * torch.flip(pw[:block], [0]))[:, None],  # A^{c-1-j} B
        block=block, d=1, m=1, p=1,
    )


def one_pole_apply_traced(
    omega: torch.Tensor, u: torch.Tensor, s0: torch.Tensor, prefer_block: int = 128
) -> tuple[torch.Tensor, torch.Tensor]:
    """LTISystem.apply equivalent for the runtime-omega one-pole.

    u: [..., T]; s0: [..., 1]; omega: 0-d tensor on u's device.
    Returns (y [..., T], s [..., 1])."""
    y, s = _scan_split(
        lambda n: one_pole_block_op_traced(omega, n), u[..., None], s0, prefer_block)
    return y[..., 0], s


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
