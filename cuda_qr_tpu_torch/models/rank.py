"""Rank-revealing solvers on column-pivoted QR (LAPACK gelsy class), the
counterpart of ``cuda_qr_tpu/models/rank.py``: numerical rank,
minimum-norm least squares through a complete orthogonal decomposition
(COD), pseudoinverse, null-space basis, and slogdet.

The rank is decided on the host, as in the reference: factor with QRCP,
bring the R diagonal over (one transfer), count the diagonal entries above
rcond * |R_00|, then run the algebra for that rank.

COD: A P = Q [R1; 0] with R1 (r x n); the LQ step R1 = T Z (from the QR of
R1^H) gives A P = Q1 T Z with T (r x r) lower-triangular and Z (r x n)
with orthonormal rows, and the minimum-norm solution of min ||Ax - b|| is
x = P Z^H T^{-1} Q1^H b.  Complex A runs at ``complex_config`` throughout
(the reference's ``_complexify``).  The back-transforms by Z^H are
default-precision products in the reference
(``cuda_qr_tpu/models/rank.py:104,127``), whose TPU default is one bf16
pass; here they run at "highest" at any ``config.precision``.
"""

from __future__ import annotations

import torch

from ..ops.blocked import as_tensor, complex_config, extract_r, orgqr, ormqr, qr_blocked
from ..ops.gemm import gemm
from ..ops.qrcp import qrcp_blocked
from ..utils.config import DEFAULT_CONFIG, QRConfig
from ..utils.errors import QRShapeError
from .qr import qr_factor


def _qrcp_with_rank(A: torch.Tensor, config: QRConfig, rcond):
    """QRCP factors and the host-side rank decision:
    (factors, piv (n_pad,), R (kb x n_pad), r, the configuration A runs at)."""
    config = complex_config(A, config)
    m, n = A.shape
    factors, jpvt, R12 = qrcp_blocked(A, config)
    kb = factors.packed.shape[1]
    R = torch.cat([extract_r(factors, kb), R12], 1)
    # float64 on the host whatever R's dtype: a float32 copy would flush a
    # float64 diagonal outside float32's range to 0 or inf (rank 0)
    d = torch.diagonal(R)[:n].abs().double().cpu().numpy()
    if rcond is None:
        rcond = max(m, n) * float(torch.finfo(R.dtype).eps)
    r = int((d > rcond * (d[0] if d.size else 0.0)).sum())
    return factors, jpvt, R, r, config


def _unpermute(Y: torch.Tensor, piv: torch.Tensor) -> torch.Tensor:
    """X with X[piv] = Y (rows of Y in factorization order)."""
    return torch.zeros_like(Y).index_copy_(0, piv, Y)


def _lq(R1: torch.Tensor, config: QRConfig):
    """LQ of R1 (r x n) through the QR of R1^H: (QR handle, Z^H (n x r),
    T (r x r) lower)."""
    lq = qr_factor(R1.mH, config)
    return lq, lq.Q, lq.R.mH


def matrix_rank(A, rcond: float | None = None,
                config: QRConfig = DEFAULT_CONFIG) -> int:
    """Numerical rank of A (m >= n) from the QRCP R diagonal.

    rcond defaults to max(m, n) * eps(dtype) relative to |R_00|, the
    numpy.linalg.matrix_rank convention, with an O(mn^2) QR for the SVD.
    """
    return _qrcp_with_rank(as_tensor(A, config), config, rcond)[3]


def lstsq_rr(A, b, rcond: float | None = None,
             config: QRConfig = DEFAULT_CONFIG):
    """Minimum-norm least squares for possibly rank-deficient A (m >= n).

    Returns (x, residual_norm, rank, piv).  Full-rank systems should prefer
    ``models.lstsq.lstsq`` (no COD step).
    """
    A = as_tensor(A, config)
    m, n = A.shape
    factors, jpvt, R, r, config = _qrcp_with_rank(A, config, rcond)
    b = as_tensor(b, config).to(A.device)
    vec = b.dim() == 1
    B = (b[:, None] if vec else b).to(factors.packed.dtype)
    QtB = ormqr(factors, B, transpose=True, config=config)
    piv = jpvt[:n]
    if r == 0:
        x = torch.zeros((n, B.shape[1]), dtype=B.dtype, device=B.device)
        resid = torch.linalg.norm(B, dim=0)
    else:
        _, Zt, T_low = _lq(R[:r, :n], config)
        y = torch.linalg.solve_triangular(T_low, QtB[:r], upper=False)
        x = _unpermute(gemm(Zt, y, "highest"), piv)
        resid = torch.linalg.norm(QtB[r:m], dim=0)
    if vec:
        x, resid = x[:, 0], resid[0]
    return x, resid, r, piv


def pinv(A, rcond: float | None = None,
         config: QRConfig = DEFAULT_CONFIG) -> torch.Tensor:
    """Moore-Penrose pseudoinverse of A (m >= n) through the COD:
    A^+ = P Z^H T^{-1} Q1^H, O(mn^2), no SVD."""
    A = as_tensor(A, config)
    m, n = A.shape
    factors, jpvt, R, r, config = _qrcp_with_rank(A, config, rcond)
    if r == 0:
        return torch.zeros((n, m), dtype=factors.packed.dtype, device=A.device)
    _, Zt, T_low = _lq(R[:r, :n], config)
    Q1 = orgqr(factors, m, factors.packed.shape[1], config)[:, :r]
    W = torch.linalg.solve_triangular(T_low, Q1.mH, upper=False)     # (r, m)
    return _unpermute(gemm(Zt, W, "highest"), jpvt[:n])


def null_space(A, rcond: float | None = None,
               config: QRConfig = DEFAULT_CONFIG) -> torch.Tensor:
    """Orthonormal basis (n, n - rank) of the null space of A (m >= n): the
    trailing complete-Q columns of the COD's LQ step, unpermuted."""
    A = as_tensor(A, config)
    m, n = A.shape
    factors, jpvt, R, r, config = _qrcp_with_rank(A, config, rcond)
    dtype = factors.packed.dtype
    if r >= n:
        return torch.zeros((n, 0), dtype=dtype, device=A.device)
    if r == 0:
        return torch.eye(n, dtype=dtype, device=A.device)
    lq, _, _ = _lq(R[:r, :n], config)
    N = orgqr(lq.factors, n, n, config)[:, r:]
    return _unpermute(N, jpvt[:n])


def slogdet(A, config: QRConfig = DEFAULT_CONFIG):
    """(sign, logabsdet) of a square real matrix via QR.

    |det A| = prod |diag R|; sign(det A) = sign(prod diag R) * det Q, and
    det Q = prod_j det H_j = prod_j (1 - tau_j ||v_j||^2) for the reflectors
    H_j = I - tau_j v_j v_j^T, with ||v_j||^2 = 1 + the squares of the packed
    factor's column j below the diagonal (float64, on the factor's device).
    Each factor is +1 (tau = 0, the identity) or -1 (tau ||v||^2 = 2, a
    reflection) up to rounding, so its sign is exact.  The reference counts
    the reflectors with tau != 0 instead (``cuda_qr_tpu/models/rank.py:172``),
    which is wrong on this panel path: when the last panel is square (n a
    multiple of the panel width), its last reflector acts on one row, and the
    Householder reconstruction's tau = diag(T) of an LU comes out as rounding
    noise (~1e-7) where the identity's is 0.  The basis-kernel default is
    swapped for Householder reconstruction, as in the reference (genuine
    (v, tau) pairs; ``logabsdet`` is the reference's).  A zero diagonal gives
    sign 0, as numpy.linalg.slogdet.
    """
    A = as_tensor(A, config)
    m, n = A.shape
    if m != n or A.is_complex():
        raise QRShapeError(f"slogdet needs a square real matrix, got {tuple(A.shape)}")
    cfg = (config if config.panel_method != "cholqr2_bk"
           else config.replace(panel_method="cholqr2_hr"))
    fac = qr_blocked(A, cfg)
    d = torch.diagonal(fac.packed)[:n]
    v2 = fac.packed[:n, :n].to(torch.float64, copy=True).tril_(-1).square_().sum(0) + 1.0
    det_h = 1.0 - fac.taus.reshape(-1)[:n].to(torch.float64) * v2
    sign_q = torch.prod(torch.sign(det_h)).to(d.dtype)
    sign = torch.where((d == 0).any(), torch.zeros_like(sign_q),
                       torch.prod(torch.sign(d)) * sign_q)
    return sign, torch.log(d.abs()).sum()
