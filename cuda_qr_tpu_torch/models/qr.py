"""High-level QR API (counterpart of ``cuda_qr_tpu/models/qr.py``).

``qr(A)`` returns explicit (Q, R) in numpy.linalg.qr-style modes;
``qr_factor(A)`` returns the packed factorization for later orgqr/ormqr use.
The reduced mode is differentiable through ``thin_qr_vjp``, an
``autograd.Function`` that needs only the primal outputs.
"""

from __future__ import annotations

import torch

from ..ops.blocked import (PackedQR, _require_real, as_tensor, extract_r, orgqr,
                           ormqr, qr_blocked)
from ..utils.config import DEFAULT_CONFIG, QRConfig
from ..utils.errors import QRShapeError


class QRResult:
    """Factorization handle: lazy Q/R extraction over packed factors."""

    def __init__(self, factors: PackedQR, m: int, n: int, config: QRConfig):
        self.factors = factors
        self.m, self.n = m, n
        self.config = config

    @property
    def Q(self) -> torch.Tensor:
        return orgqr(self.factors, self.m, self.n, self.config)

    @property
    def R(self) -> torch.Tensor:
        return extract_r(self.factors, self.n)

    def apply_qt(self, B) -> torch.Tensor:
        return ormqr(self.factors, B, transpose=True, config=self.config)

    def apply_q(self, B) -> torch.Tensor:
        return ormqr(self.factors, B, transpose=False, config=self.config)


def qr_factor(A, config: QRConfig = DEFAULT_CONFIG) -> QRResult:
    A = as_tensor(A, config)
    m, n = A.shape
    return QRResult(qr_blocked(A, config), m, n, config)


def thin_qr_vjp(Q, R, dQ, dR):
    """Reverse rule for any thin QR, m >= n (the copyltu formula):
        M = R dR^T - dQ^T Q
        dA = (dQ + Q (tril(M,-1) + tril(M,-1)^T + diag(M))) R^{-T}
    """
    M = R @ dR.T - dQ.T @ Q
    tri = torch.tril(M, -1)
    copyltu = tri + tri.T + torch.diag(torch.diagonal(M))
    rhs = dQ + Q @ copyltu
    return torch.linalg.solve_triangular(R, rhs.T, upper=True).T


class _ThinQR(torch.autograd.Function):
    """Reduced-mode QR with the reference's custom VJP: the factorization's
    loops are not differentiated through."""

    @staticmethod
    def forward(ctx, A, config):
        res = qr_factor(A, config)
        Q, R = res.Q, res.R
        ctx.save_for_backward(Q, R)
        return Q, R

    @staticmethod
    def backward(ctx, dQ, dR):
        Q, R = ctx.saved_tensors
        dQ = torch.zeros_like(Q) if dQ is None else dQ
        dR = torch.zeros_like(R) if dR is None else dR
        return thin_qr_vjp(Q, R, dQ, dR), None


def qr(A, config: QRConfig = DEFAULT_CONFIG, mode: str = "reduced"):
    """QR factorization with numpy.linalg.qr-style modes.

    mode='reduced': (Q (m x k), R (k x n)), k = min(m, n); wide matrices
      (m < n) factor the left m x m block and apply Q^T to the rest.
    mode='complete': (Q (m x m), R (m x n)).
    mode='r': R only.
    mode='raw': (h (n x m), tau (k,)), LAPACK geqrf packed storage
      transposed like numpy's raw mode; Householder-convention panels are
      forced (the basis-kernel default stores a non-LAPACK V block).  2-D
      m >= n input only.
    Leading batch dimensions are factored one matrix at a time.
    """
    A = as_tensor(A, config)
    _require_real(A)
    if mode == "raw":
        if A.dim() != 2 or A.shape[0] < A.shape[1]:
            raise QRShapeError(
                f"mode='raw' needs a single m >= n matrix, got {tuple(A.shape)}")
        m, n = A.shape
        cfg = (config if config.panel_method != "cholqr2_bk"
               else config.replace(panel_method="cholqr2_hr"))
        fac = qr_blocked(A, cfg)
        return fac.packed[:m, :n].T, fac.taus.reshape(-1)[:n]
    if mode not in ("reduced", "complete", "r"):
        raise ValueError(f"unknown mode {mode!r}")
    if A.dim() > 2:
        batch = A.shape[:-2]
        outs = [qr(a, config, mode) for a in A.reshape((-1,) + A.shape[-2:])]
        if mode == "r":
            return torch.stack(outs).reshape(batch + outs[0].shape)
        Qs = torch.stack([o[0] for o in outs])
        Rs = torch.stack([o[1] for o in outs])
        return (Qs.reshape(batch + Qs.shape[-2:]), Rs.reshape(batch + Rs.shape[-2:]))
    m, n = A.shape
    if m >= n:
        if mode == "reduced":
            return _ThinQR.apply(A, config)
        res = qr_factor(A, config)
        if mode == "r":
            return res.R
        Q = orgqr(res.factors, m, m, config)
        R = torch.nn.functional.pad(res.R, (0, 0, 0, m - n))
        return Q, R
    # wide: A = [A1 | A2], A1 = Q R11, R12 = Q^T A2
    res = qr_factor(A[:, :m], config)
    R12 = res.apply_qt(A[:, m:])[:m]
    R = torch.cat([res.R, R12], 1)
    if mode == "r":
        return R
    if mode == "complete":
        return orgqr(res.factors, m, m, config), R
    return res.Q, R
