"""Fast panel factorization: CholeskyQR2 + basis-kernel or Householder
reconstruction (counterpart of ``cuda_qr_tpu/ops/fast_panel.py``).

  1. CholeskyQR2: Q R = X by two rounds of Gram + Cholesky + inverse; the
     nb x nb Cholesky + inverse runs on the chol_inv kernel (B1) where the
     reference's gate allows it;
  2a. basis kernel (Yamamoto et al.): V := Q - E_J S, T := (I - S Q_J)^{-T}
      by Newton-Schulz, certified a posteriori; on the card a float32
      "highest" panel runs both in one launch of kernel B4
      (``ops/newton_kernel.py``);
  2b. Householder reconstruction (Ballard et al., IPDPS 2014): unit-lower V,
      tau, T from an LU of E_J - Q_J S;
  3. Householder fallback (geqr2 + larft) on Cholesky breakdown or a
     round-1 Gram error above ``_EMAX_GATE``.

Every product runs at ``config.precision`` (the reference's ``prec``), the
Householder fallback's included; the chol_inv kernel computes in float32
at any precision.

The panel's live rows are rows >= off; the functions slice them instead of
masking a full-height panel, and return full-height packed panels whose
rows above ``off`` are the input's.  The reference's device-side branches
are host decisions here (``smalllinalg.host_decision``), with the same
thresholds.
"""

from __future__ import annotations

import torch

from ..utils.profiling import span
from .gemm import gemm
from .householder import geqr2, larft, unpack_v
from .newton_kernel import newton_certified_kernel
from .newton_kernel import supported as newton_kernel_supported
from .smalllinalg import chol_with_inv_auto, host_decision, lu_with_inv, newton_certified

# Above this round-1 Gram error, round 2 cannot restore O(eps)
# orthogonality (needs eps*cond(X)^2 << 1).  Dimensionless: f32 and f64.
_EMAX_GATE = 0.05


def _eye(n: int, like: torch.Tensor) -> torch.Tensor:
    return torch.eye(n, dtype=like.dtype, device=like.device)


def _cholqr2(X: torch.Tensor, config=None):
    """CholeskyQR2 of the live panel X: (Q, Rpos, emax).

    emax = max|Q1^T Q1 - I| after round 1 ~= eps cond(X)^2.  Round 2's
    Cholesky is replaced by a first-order Taylor step when emax < tol.
    """
    nb = X.shape[1]
    dtype = X.dtype
    prec = config.precision
    eye = _eye(nb, X)
    L1, L1i = chol_with_inv_auto(gemm(X.T, X, prec), config)
    Q1 = gemm(X, L1i.T, prec)
    E = gemm(Q1.T, Q1, prec) - eye
    emax = E.abs().max()
    tol = 3e-4 if dtype == torch.float32 else 3e-8
    if host_decision(emax < tol):
        C = torch.tril(E, -1) + 0.5 * torch.diag(torch.diagonal(E))
        L2, L2i = eye + C, eye - C
    else:
        L2, L2i = chol_with_inv_auto(E + eye, config)
    Q = gemm(Q1, L2i.T, prec)
    Rpos = gemm(L2.T, L1.T, prec)
    return Q, Rpos, emax


def _hr_construct(Q: torch.Tensor, Rpos: torch.Tensor, precision: str):
    """Householder reconstruction from CholeskyQR2's live Q (m' x nb) and
    positive-diagonal R: (packed_live, tau, T, VJ) with unit-lower VJ."""
    nb = Q.shape[1]
    eye = _eye(nb, Q)
    QJ = Q[:nb]
    s = torch.where(torch.diagonal(QJ) >= 0, -1.0, 1.0).to(Q.dtype)
    YJ = eye - QJ * s[None, :]
    VJl, W, VJi, Wi = lu_with_inv(YJ, precision)
    # V = (E_J - Q S) Wi = place(Wi at rows J) - Q (S Wi)
    Z = gemm(Q, s[:, None] * Wi, precision)
    V = -Z
    V[:nb] = Wi - Z[:nb]
    T = gemm(W, VJi.T, precision)
    tau = torch.diagonal(T).clone()
    R_house = s[:, None] * Rpos
    packed = V
    packed[:nb] = torch.triu(R_house) + torch.tril(V[:nb], -1)
    VJ = torch.tril(VJl, -1) + eye
    return packed, tau, T, VJ


def _householder_fallback(panel: torch.Tensor, off: int, precision: str):
    """geqr2 + larft on the live rows (packed_live, tau, T, VJ)."""
    nb = panel.shape[1]
    lo, tau = geqr2(panel[off:], precision=precision)
    T = larft(unpack_v(lo), tau, precision)
    VJ = torch.tril(lo[:nb], -1) + _eye(nb, lo)
    return lo, tau, T, VJ


def _bad(packed: torch.Tensor, T: torch.Tensor, emax: torch.Tensor) -> bool:
    return host_decision(~torch.isfinite(packed.sum() + T.sum()) | (emax > _EMAX_GATE))


def _newton_on_kernel(M: torch.Tensor, config) -> bool:
    """Whether the basis-kernel panel's Newton-Schulz inverse and its
    certificate run on kernel B4: a float32 M on the card at "highest" (the
    kernel computes in float32 FFMA), of a side the kernel takes.  float64,
    the "tf32"/"high" panels, wider panels and the CPU keep the plain chain."""
    return (config.use_kernels and config.precision == "highest" and M.is_cuda
            and newton_kernel_supported(M.shape, M.dtype))


def panel_factor_cholqr2hr(panel: torch.Tensor, off: int, config):
    """Factor rows >= off of an m x nb panel (m - off >= nb): (packed, tau, T)
    in LAPACK storage, unit-lower V under R."""
    cast_back = panel.dtype if panel.dtype == torch.bfloat16 else None
    if cast_back is not None:
        panel = panel.float()
    Q, Rpos, emax = _cholqr2(panel[off:], config)
    live, tau, T, _ = _hr_construct(Q, Rpos, config.precision)
    if _bad(live, T, emax):
        with span("panel.retry_geqr2"):
            live, tau, T, _ = _householder_fallback(panel, off, config.precision)
    packed = torch.cat([panel[:off], live], 0)
    if cast_back is not None:
        packed = packed.to(cast_back)
    return packed, tau, T


def panel_factor_cholqr2bk(panel: torch.Tensor, off: int, config):
    """Basis-kernel panel factorization: CholeskyQR2 + Yamamoto's N.

    Y = Q - E_J S, N = (I - S Q_J)^{-1}, H = I - Y N Y^T with
    S = diag(-sign(diag Q_J)); H A = E_J (S Rpos).  Returns
    (packed, tau, T, VJ): R in rows [off, off+nb), Y's dense tail (Q's tail)
    below, VJ = Q_J - S the dense diagonal block, T = N^T, tau = diag(T).
    If Newton-Schulz's a-posteriori certificate fails, the panel is rebuilt
    by Householder reconstruction from the same Q/Rpos; on Cholesky
    breakdown it falls back to geqr2.
    """
    nb = panel.shape[1]
    cast_back = panel.dtype if panel.dtype == torch.bfloat16 else None
    if cast_back is not None:
        panel = panel.float()
    dtype = panel.dtype
    prec = config.precision
    Q, Rpos, emax = _cholqr2(panel[off:], config)
    eye = _eye(nb, Q)
    QJ = Q[:nb]
    s = torch.where(torch.diagonal(QJ) >= 0, -1.0, 1.0).to(dtype)
    M = eye - s[:, None] * QJ
    if _newton_on_kernel(M, config):
        N, _, cert, _ = newton_certified_kernel(M)
    else:
        N, _, cert = newton_certified(M, prec)
    # H deviates from orthogonality by <= 16 ||N||^2 ||I - M N|| to first
    # order, and cond(M) is unbounded for near-square live panels.
    if host_decision(~(cert <= 100 * torch.finfo(dtype).eps)):   # NaN -> HR
        with span("panel.retry_hr"):
            live, tau, T, VJ = _hr_construct(Q, Rpos, prec)
    else:
        T = N.T
        tau = torch.diagonal(T).clone()
        VJ = QJ - torch.diag(s)
        live = torch.cat([torch.triu(s[:, None] * Rpos), Q[nb:]], 0)
    if _bad(live, T, emax):
        with span("panel.retry_geqr2"):
            live, tau, T, VJ = _householder_fallback(panel, off, prec)
    packed = torch.cat([panel[:off], live], 0)
    if cast_back is not None:
        packed = packed.to(cast_back)
    return packed, tau, T, VJ
