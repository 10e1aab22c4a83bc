"""Residual / orthogonality verification (``cuda_qr_tpu/utils/verify.py``).

Same gates as the reference: ||A - QR||_F / ||A||_F < n*eps and
||Q^T Q - I||_F < 4*n*eps, with eps of the factorization's dtype.
``check_qr`` computes in float64 on the host; ``check_qr_device`` computes
in float64 on the tensors' own device, so a large check on the card does not
run a host product of O(m n^2).  Complex factors are widened to complex128
and Q^T reads Q^H; eps is that of the real part.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class QRCheck:
    residual: float          # ||A - QR||_F / ||A||_F
    orthogonality: float     # ||Q^T Q - I||_F
    r_triangular: float      # max |strict lower triangle of R|
    n: int
    eps: float

    @property
    def residual_ok(self) -> bool:
        return self.residual < self.n * self.eps

    @property
    def orthogonality_ok(self) -> bool:
        return self.orthogonality < self.n * self.eps * 4

    @property
    def ok(self) -> bool:
        return bool(self.residual_ok and self.orthogonality_ok
                    and self.r_triangular == 0.0)


def _eps(Q) -> float:
    """eps of the factor dtype (Q's), not of A's: callers often keep a
    float64 copy of A while factoring in float32."""
    if isinstance(Q, torch.Tensor):
        return float(torch.finfo(Q.dtype).eps)
    return float(np.finfo(np.asarray(Q).dtype).eps)


def _wide(x: torch.Tensor) -> torch.dtype:
    return torch.complex128 if x.is_complex() else torch.float64


def _to_numpy64(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.detach().to("cpu", _wide(x)).numpy()
    x = np.asarray(x)
    return x.astype(np.complex128 if np.iscomplexobj(x) else np.float64)


def check_qr(A, Q, R) -> QRCheck:
    """Verify a thin factorization A (m x n) = Q (m x n) R (n x n) on the
    host in float64."""
    eps = _eps(Q)
    A, Q, R = _to_numpy64(A), _to_numpy64(Q), _to_numpy64(R)
    n = A.shape[1]
    anorm = float(np.linalg.norm(A))
    resid = float(np.linalg.norm(A - Q @ R)) / (anorm if anorm > 0 else 1.0)
    orth = float(np.linalg.norm(Q.conj().T @ Q - np.eye(Q.shape[1])))
    tri = float(np.max(np.abs(np.tril(R, k=-1)))) if R.shape[0] > 1 else 0.0
    return QRCheck(residual=resid, orthogonality=orth, r_triangular=tri,
                   n=n, eps=eps)


def check_qr_device(A: torch.Tensor, Q: torch.Tensor, R: torch.Tensor) -> QRCheck:
    """``check_qr`` in float64 on Q's device (A and R are moved there)."""
    eps = _eps(Q)
    dev = Q.device
    A = A.to(dev, _wide(A))
    Q64 = Q.to(_wide(Q))
    R = R.to(dev, _wide(R))
    n = A.shape[1]
    anorm = float(torch.linalg.norm(A))
    resid = float(torch.linalg.norm(A - Q64 @ R)) / (anorm if anorm > 0 else 1.0)
    G = Q64.mH @ Q64
    G.diagonal().sub_(1.0)
    orth = float(torch.linalg.norm(G))
    tri = float(torch.tril(R, -1).abs().max()) if R.shape[0] > 1 else 0.0
    return QRCheck(residual=resid, orthogonality=orth, r_triangular=tri,
                   n=n, eps=eps)
