"""Least squares via QR, min ||Ax - b||_2 (BASELINE config 4), the
counterpart of ``cuda_qr_tpu/models/lstsq.py``.

Pipeline: ``qr_blocked`` -> Q^T b without forming Q (``ormqr``) ->
back-substitution R x = (Q^T b)[:n].

Differentiation (real input): an ``autograd.Function`` with the reference's
implicit-function VJP (the adjoint of the normal equations), two n x n
triangular solves and three GEMMs instead of differentiating through the
factorization.  With z solving A^T A z = xbar and rhat the unit residual:
  bbar = A z + rhat diag(rhobar)
  Abar = r z^T - (A z) x^T - rhat diag(rhobar) x^T
(the A dx term of d||r|| vanishes because A^T r = 0 at the solution).
Complex input takes the plain path, as the reference's complex branch does
(``cuda_qr_tpu/models/lstsq.py:120-123``).

``lstsq_dist`` is the distributed counterpart over the row mesh (BASELINE
config 4 at mesh scale), through the R-only CAQR of [A | b].
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from torch.distributed.tensor import DTensor

from ..ops.blocked import as_tensor, extract_r, ormqr, qr_blocked
from ..ops.gemm import gemm
from ..parallel.mesh import as_row_sharded, shard_rows
from ..utils.config import DEFAULT_CONFIG, QRConfig
from ..utils.errors import QRShapeError
from .caqr import caqr_r


class LstsqResult(NamedTuple):
    x: torch.Tensor              # (n,) or (n, k) solution
    residual_norm: torch.Tensor  # ||Ax - b||_2 per right-hand side


def _lstsq_math(A: torch.Tensor, B: torch.Tensor, config: QRConfig):
    """(x, resid, R) for 2-D B: the forward computation."""
    m, n = A.shape
    fac = qr_blocked(A, config)
    QtB = ormqr(fac, B.to(fac.packed.dtype), transpose=True, config=config)
    R = extract_r(fac, n)
    x = torch.linalg.solve_triangular(R, QtB[:n], upper=True)
    return x, torch.linalg.norm(QtB[n:m], dim=0), R


class _Lstsq(torch.autograd.Function):
    """(x, resid) with the implicit-function VJP of the module docstring."""

    @staticmethod
    def forward(ctx, A, B, config):
        x, resid, R = _lstsq_math(A, B, config)
        A = A.to(x.dtype)
        r = B.to(x.dtype) - gemm(A, x, config.precision)
        ctx.precision = config.precision
        ctx.save_for_backward(A, x, R, r, resid)
        return x, resid

    @staticmethod
    def backward(ctx, xbar, rhobar):
        A, x, R, r, resid = ctx.saved_tensors
        xbar = torch.zeros_like(x) if xbar is None else xbar
        rhobar = torch.zeros_like(resid) if rhobar is None else rhobar
        prec = ctx.precision
        # z solves A^T A z = xbar through R: z = R^-1 R^-T xbar.
        w = torch.linalg.solve_triangular(R.T, xbar, upper=False)
        z = torch.linalg.solve_triangular(R, w, upper=True)
        safe = resid > 0
        rhat = r / torch.where(safe, resid, torch.ones_like(resid))[None, :]
        scaled = rhat * torch.where(safe, rhobar, torch.zeros_like(rhobar))[None, :]
        Az = gemm(A, z, prec)
        Abar = gemm(r, z.T, prec) - gemm(Az, x.T, prec) - gemm(scaled, x.T, prec)
        return Abar, Az + scaled, None


def lstsq(A, b, config: QRConfig = DEFAULT_CONFIG, damp: float = 0.0) -> LstsqResult:
    """Solve min_x ||A x - b|| for full-rank A (m >= n); b is (m,) or (m, k).

    damp > 0 solves the ridge problem min ||A x - b||^2 + damp^2 ||x||^2 by
    factoring the stacked [A; damp I] system (no A^T A); residual_norm is
    then the augmented norm, which includes the damp ||x|| term.  The
    residual norm comes from ||(Q^H b)[n:]||, with no extra GEMM.
    Differentiable in (A, b) for real input; complex input is solved on
    the plain path.
    """
    A = as_tensor(A, config)
    b = as_tensor(b, config).to(A.device)
    m, n = A.shape
    if damp:
        A = torch.cat([A, damp * torch.eye(n, dtype=A.dtype, device=A.device)], 0)
        b = torch.cat([b, b.new_zeros((n,) + tuple(b.shape[1:]))], 0)
        m += n
    if m < n:
        raise QRShapeError(f"lstsq requires m >= n, got {m}x{n}")
    vec = b.dim() == 1
    B = b[:, None] if vec else b
    if A.is_complex() or B.is_complex():
        x, resid, _ = _lstsq_math(A, B, config)
    else:
        x, resid = _Lstsq.apply(A, B, config)
    if vec:
        x, resid = x[:, 0], resid[0]
    return LstsqResult(x=x, residual_norm=resid)


def solve(A, b, config: QRConfig = DEFAULT_CONFIG) -> torch.Tensor:
    """Solve the square system A x = b via QR (a backward-stable alternative
    to LU for moderately sized dense systems)."""
    A = as_tensor(A, config)
    m, n = A.shape
    if m != n:
        raise QRShapeError(f"solve requires square A, got {m}x{n}")
    return lstsq(A, b, config).x


def lstsq_dist(A, b, mesh, config: QRConfig = DEFAULT_CONFIG,
               combine: str = "bk") -> LstsqResult:
    """Distributed least squares over the row mesh, min ||A x - b||, called
    by every rank; x and the residual norms come back replicated.

    Augmented-matrix CAQR: one R-only factorization of [A | b] gives
    R_aug = [[R, Q^H b], [0, rho]], so x = R^{-1} R_aug[:n, n:] and the
    residual norm of each right-hand side is a column norm of the rho
    block; b never moves between ranks.  (Both are invariant to R's
    row-phase ambiguity.)  A (m x n, m >= n, full rank) and b ((m,) or
    (m, k)) are full arrays on every rank, or row-sharded DTensors; b is
    cast to A's dtype.  Complex A takes the "allgather" combine with no
    kernel (``caqr_r``).
    """
    m, n = A.shape
    vec = len(b.shape) == 1
    if b.shape[0] != m:
        raise QRShapeError(f"b rows {b.shape[0]} != A rows {m}")
    if isinstance(A, DTensor) or isinstance(b, DTensor):
        a, _ = shard_rows(A, mesh)
        bl, _ = shard_rows(b, mesh)
        aug = as_row_sharded(torch.cat([a, (bl[:, None] if vec else bl).to(a.dtype)], 1),
                             mesh, m)
    elif isinstance(A, torch.Tensor):
        B = torch.as_tensor(b, device=A.device)
        aug = torch.cat([A, (B[:, None] if vec else B).to(A.dtype)], 1)
    else:
        A, B = np.asarray(A), np.asarray(b)
        aug = np.concatenate([A, (B[:, None] if vec else B).astype(A.dtype)], 1)
    Raug = caqr_r(aug, mesh, config, combine=combine)
    R, Z = Raug[:n, :n], Raug[:n, n:]
    x = torch.linalg.solve_triangular(R, Z, upper=True)
    resid = torch.linalg.norm(Raug[n:, n:], dim=0)
    if vec:
        return LstsqResult(x[:, 0], resid[0])
    return LstsqResult(x, resid)
