"""Batched small-matrix QR: thin Q/R for stacks of (m, n) problems.

Counterpart of ``cuda_qr_tpu/models/batched.py``: shifted CholeskyQR3
(Fukaya, Kannan, Nakatsukasa, Yamamoto, Yanagisawa, SIAM J. Sci. Comput.
2020) across the whole stack at once.  Every step is a batched GEMM or one
Cholesky + inverse of the whole stack of n x n Gram matrices, on the
chol_inv kernel's batch grid where it is eligible.

Numerical envelope: the shift keeps round 1's Cholesky finite for
numerically full-rank elements with cond(X) <~ 1/(8 sqrt(eps)); two
refinement rounds (the third only when the batch needs it: one host
decision) restore O(eps) orthogonality.  R has a positive diagonal, the
CholeskyQR convention, which differs from the Householder paths' by a
column sign flip.  Exactly rank-deficient elements give NaN (detectable),
not silently wrong factors; use ``qr`` for those.
"""

from __future__ import annotations

import torch

from ..ops.blocked import as_tensor
from ..ops.gemm import gemm
from ..ops.chol_kernel import chol_with_inv_auto
from ..ops.smalllinalg import host_decision
from ..utils.config import DEFAULT_CONFIG, QRConfig
from ..utils.errors import QRShapeError
from .qr import ThinQRFunction


def _chol_round(X: torch.Tensor, config: QRConfig):
    """(Q, R, emax): one CholeskyQR round of a (B, m, n) stack; emax =
    max over the batch of |X^T X - I|, the gate for another round.  GEMMs
    at ``config.precision``."""
    n = X.shape[-1]
    prec = config.precision
    G = gemm(X.mT, X, prec)
    emax = (G - torch.eye(n, dtype=X.dtype, device=X.device)).abs().max()
    L, Li = chol_with_inv_auto(G, config)
    return gemm(X, Li.mT, prec), L.mT, emax             # X L^-T


def qr_batched(A, config: QRConfig = DEFAULT_CONFIG, mode: str = "reduced"):
    """Thin QR of a stack: A (..., m, n) with m >= n -> Q (..., m, n),
    R (..., n, n) upper triangular with positive diagonal.

    mode='reduced' returns (Q, R); mode='r' returns R only (same work).
    Differentiable through the shared thin-QR VJP, batched.
    """
    A = as_tensor(A, config)
    if A.dim() < 2:
        raise QRShapeError(f"qr_batched needs at least 2 dims, got {A.dim()}")
    if A.is_complex():
        raise QRShapeError("qr_batched is real-only (CholeskyQR rounds); use qr() "
                           "for complex batches")
    if mode not in ("reduced", "r"):
        raise QRShapeError(f"mode must be 'reduced' or 'r', got {mode!r}")
    *batch, m, n = A.shape
    if m < n:
        raise QRShapeError(f"qr_batched requires m >= n, got {m}x{n}")
    dtype = A.dtype if A.dtype in (torch.float32, torch.float64) else config.dtype
    X = A.reshape(-1, m, n).to(dtype)
    Q, R = ThinQRFunction.apply(X, config, _qr_batched_math)
    R = R.reshape(tuple(batch) + (n, n))
    if mode == "r":
        return R
    return Q.reshape(tuple(batch) + (m, n)), R


def _qr_batched_math(X: torch.Tensor, config: QRConfig):
    """sCholQR3 of a flattened (B, m, n) stack -> (Q, R)."""
    _, m, n = X.shape
    dtype = X.dtype
    eps = torch.finfo(dtype).eps
    eye = torch.eye(n, dtype=dtype, device=X.device)
    prec = config.precision
    # Shifted round 1: the shift keeps G + sI positive definite through
    # rounding for cond(X) up to ~1/(8 sqrt(eps)); ||X||_2^2 is bounded
    # by the Frobenius norm squared.
    fro2 = (X ** 2).sum((-2, -1))
    shift = 11.0 * (m * n + n * (n + 1)) * eps * fro2 + torch.finfo(dtype).tiny
    G = gemm(X.mT, X, prec) + shift[:, None, None] * eye
    L1, L1i = chol_with_inv_auto(G, config)
    Q1, R1 = gemm(X, L1i.mT, prec), L1.mT
    # Round 2 always (CholeskyQR2); emax2 ~ eps cond(X)^2 + shift error.
    Q, R2, emax2 = _chol_round(Q1, config)
    R = gemm(R2, R1, prec)
    # Round 3 only when rounds 1+2 cannot have reached O(eps)
    # orthogonality: one decision for the whole batch.
    tol = 3e-4 if dtype == torch.float32 else 3e-8
    if host_decision(emax2 > tol):
        Q, R3, _ = _chol_round(Q, config)
        R = gemm(R3, R, prec)
    return Q, torch.triu(R)   # exact zeros below the diagonal
