"""Linear recurrences for the plain reference, evaluated in blocks.

A recurrence s[t+1] = A s[t] + B u[t], y[t] = C s[t] + D u[t] is exact in
blocks of L samples: y_blk = u_blk T^T + s_in O^T and s_out = s_in (A^L)^T
+ u_blk R^T, with T the L x L lower-triangular Toeplitz matrix of the
impulse response (h_0 = D, h_k = C A^(k-1) B), O the rows C A^i and R the
columns A^(L-1-j) B.  The matrices are built on the host in float64 from
(A, B, C, D) and cast to the precision the caller asks for, so that the
same code is the reference (float64) and the control (float32 with TF32
products, the nearest precision below the configuration's float32).

``Prec`` carries that choice: every product of the reference goes through
``Prec.mm``.  On a card the control turns TF32 on for its products; on the
CPU, where no TF32 exists, it rounds the operands of each product to TF32's
10-bit mantissa and multiplies in float32, which is what a TF32 tensor-core
product does.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass

import numpy as np
import torch

BLOCK = 1024


def _tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 x rounded to TF32's 10 explicit mantissa bits (nearest,
    ties away from zero)."""
    i = x.contiguous().view(torch.int32)
    return ((i + 0x1000) & ~0x1FFF).view(torch.float32)


@dataclass(frozen=True)
class Prec:
    """The arithmetic of one evaluation: float64, or float32 with TF32
    products (``tf32``)."""

    dtype: torch.dtype = torch.float64
    tf32: bool = False

    def t(self, a, device) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a, np.float64), device=device).to(self.dtype)

    def mm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        if self.tf32 and a.device.type == "cpu":
            return torch.matmul(_tf32(a.to(torch.float32)), _tf32(b.to(torch.float32)))
        return torch.matmul(a, b)

    @contextlib.contextmanager
    def active(self):
        """TF32 on for the card's float32 products while the control runs;
        the caller's settings come back on exit."""
        if not self.tf32:
            yield
            return
        be = torch.backends
        old = (be.cuda.matmul.allow_tf32, be.cudnn.allow_tf32)
        be.cuda.matmul.allow_tf32 = be.cudnn.allow_tf32 = True
        try:
            yield
        finally:
            be.cuda.matmul.allow_tf32, be.cudnn.allow_tf32 = old


REFERENCE = Prec()
CONTROL = Prec(torch.float32, tf32=True)


def block_matrices(A, B, C, D, L: int = BLOCK):
    """(T [L, L], O [L, d], R [d, L], AL [d, d]) in float64 for a
    single-input single-output system."""
    A = np.asarray(A, np.float64)
    B = np.asarray(B, np.float64).reshape(-1)
    C = np.asarray(C, np.float64).reshape(-1)
    D = float(np.asarray(D, np.float64).reshape(()))
    d = A.shape[0]
    O = np.zeros((L, d))
    R = np.zeros((d, L))
    h = np.zeros(L)
    h[0] = D
    row = C.copy()  # C A^i
    col = B.copy()  # A^i B
    for i in range(L):
        O[i] = row
        R[:, L - 1 - i] = col
        if i + 1 < L:
            h[i + 1] = row @ B
        row = row @ A
        col = A @ col
    idx = np.arange(L)
    T = np.where(idx[:, None] >= idx[None, :], h[np.clip(idx[:, None] - idx[None, :], 0, L - 1)], 0.0)
    AL = np.linalg.matrix_power(A, L)
    return T, O, R, AL


class Blocked:
    """A bank of systems [nsys] evaluated on inputs [..., n]; every system
    sees the same input (the spectrum's bands) or, with ``nsys == 1``, one
    system per row."""

    def __init__(self, systems, prec: Prec, device, L: int = BLOCK):
        mats = [block_matrices(*s, L=L) for s in systems]
        self.L = L
        self.prec = prec
        self.T = prec.t(np.stack([m[0] for m in mats]), device)  # [ns, L, L]
        self.O = prec.t(np.stack([m[1] for m in mats]), device)  # [ns, L, d]
        self.R = prec.t(np.stack([m[2] for m in mats]), device)  # [ns, d, L]
        self.AL = prec.t(np.stack([m[3] for m in mats]), device)  # [ns, d, d]

    def __call__(self, u: torch.Tensor) -> torch.Tensor:
        """u [..., n] from zero state -> y [..., ns, n] (ns squeezed when 1)."""
        mm = self.prec.mm
        L = self.L
        *lead, n = u.shape
        nb = -(-n // L)
        u = u.to(self.prec.dtype)
        if nb * L != n:
            u = torch.nn.functional.pad(u, (0, nb * L - n))
        ub = u.reshape(*lead, 1, nb, L)
        y = mm(ub, self.T.transpose(-1, -2))  # [..., ns, nb, L]
        g = mm(ub, self.R.transpose(-1, -2))  # [..., ns, nb, d]
        ns, d = self.AL.shape[0], self.AL.shape[-1]
        s = torch.zeros((*lead, ns, 1, d), dtype=self.prec.dtype, device=u.device)
        alt = self.AL.transpose(-1, -2)  # [ns, d, d]
        entry = []
        for k in range(nb):
            entry.append(s)
            s = mm(s, alt) + g[..., k:k + 1, :]
        sin = torch.cat(entry, dim=-2)  # [..., ns, nb, d]
        y = y + mm(sin, self.O.transpose(-1, -2))
        y = y.reshape(*lead, ns, nb * L)[..., :n]
        return y[..., 0, :] if ns == 1 else y

