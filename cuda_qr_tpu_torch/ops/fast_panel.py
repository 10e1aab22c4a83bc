"""Fast panel factorization: CholeskyQR2 + basis-kernel or Householder
reconstruction (counterpart of ``cuda_qr_tpu/ops/fast_panel.py``).  One
skeleton, ``_cholqr2_panel``, runs both methods:

  1. CholeskyQR2: Q R = X by two rounds of Gram + Cholesky + inverse
     (``chol_kernel.chol_with_inv_auto``: kernel B1 where eligible);
  2. an assembler: the basis kernel (Yamamoto et al.), V := Q - E_J S,
     T := (I - S Q_J)^{-T} by Newton-Schulz, certified a posteriori
     (``newton_kernel.newton_certified_auto``: kernel B4 where eligible) and
     rebuilt by Householder reconstruction when the certificate fails; or
     Householder reconstruction (Ballard et al., IPDPS 2014) itself:
     unit-lower V, tau, T from an LU of E_J - Q_J S;
  3. a Householder retry (geqr2 + larft) on Cholesky breakdown or a
     round-1 Gram error above ``_EMAX_GATE``.

Every product runs at ``config.precision``; the kernels compute in float32
at any precision.  The panel arrives in its compute dtype
(``blocked._panel_factor`` owns the storage dtype).  Its live rows are rows
>= off, sliced rather than masked; the packed panel is full-height with the
input's rows above ``off``.  The reference's device-side branches are host
decisions here (``smalllinalg.host_decision``), with the same thresholds.
"""

from __future__ import annotations

import torch

from ..utils.profiling import span
from .chol_kernel import chol_with_inv_auto
from .gemm import gemm
from .householder import geqr2, larft, unit_vj, unpack_v
from .newton_kernel import newton_certified_auto
from .smalllinalg import eye_like, host_decision, lu_with_inv

# Above this round-1 Gram error, round 2 cannot restore O(eps)
# orthogonality (needs eps*cond(X)^2 << 1).  Dimensionless: f32 and f64.
_EMAX_GATE = 0.05


def _cholqr2(X: torch.Tensor, config):
    """CholeskyQR2 of the live panel X: (Q, Rpos, emax).

    emax = max|Q1^T Q1 - I| after round 1 ~= eps cond(X)^2.  Round 2's
    Cholesky is replaced by a first-order Taylor step when emax < tol.
    """
    nb = X.shape[1]
    dtype = X.dtype
    prec = config.precision
    eye = eye_like(nb, X)
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


def _hr_construct(Q: torch.Tensor, Rpos: torch.Tensor, config):
    """Householder reconstruction from CholeskyQR2's live Q (m' x nb) and
    positive-diagonal R: (packed_live, tau, T, VJ) with unit-lower VJ."""
    nb = Q.shape[1]
    precision = config.precision
    eye = eye_like(nb, Q)
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
    V[:nb] = torch.triu(s[:, None] * Rpos) + torch.tril(V[:nb], -1)   # R_house over VJ
    return V, tau, T, torch.tril(VJl, -1) + eye


def _basis_kernel(Q: torch.Tensor, Rpos: torch.Tensor, config):
    """Yamamoto's basis-kernel panel from CholeskyQR2's live Q and Rpos:
    (packed_live, tau, T, VJ) with the dense VJ = Q_J - S, or
    ``_hr_construct``'s when the certificate fails (NaN included)."""
    nb = Q.shape[1]
    QJ = Q[:nb]
    s = torch.where(torch.diagonal(QJ) >= 0, -1.0, 1.0).to(Q.dtype)
    M = eye_like(nb, Q) - s[:, None] * QJ
    N, _, cert, _ = newton_certified_auto(M, config)
    # H deviates from orthogonality by <= 16 ||N||^2 ||I - M N|| to first
    # order, and cond(M) is unbounded for near-square live panels.
    if host_decision(~(cert <= 100 * torch.finfo(Q.dtype).eps)):   # NaN -> HR
        with span("panel.retry_hr"):
            return _hr_construct(Q, Rpos, config)
    T = N.T
    live = torch.cat([torch.triu(s[:, None] * Rpos), Q[nb:]], 0)
    return live, torch.diagonal(T).clone(), T, QJ - torch.diag(s)


def _householder_fallback(X: torch.Tensor, precision: str):
    """geqr2 + larft of the live rows X: (packed_live, tau, T, VJ).  T is
    ``larft``'s, the reference's float32 Gram (not ``panel_larft``'s)."""
    lo, tau = geqr2(X, precision=precision)
    return lo, tau, larft(unpack_v(lo), tau, precision), unit_vj(lo, 0, X.shape[1])


def _bad(packed: torch.Tensor, T: torch.Tensor, emax: torch.Tensor) -> bool:
    return host_decision(~torch.isfinite(packed.sum() + T.sum()) | (emax > _EMAX_GATE))


def _cholqr2_panel(panel: torch.Tensor, off: int, config, assemble):
    """The skeleton: ``_cholqr2`` of rows >= off, ``assemble(Q, Rpos,
    config)``, one guard and one geqr2 retry.  Returns (packed, tau, T, VJ),
    packed full-height with the input's rows above ``off``."""
    X = panel[off:]
    Q, Rpos, emax = _cholqr2(X, config)
    live, tau, T, VJ = assemble(Q, Rpos, config)
    if _bad(live, T, emax):
        with span("panel.retry_geqr2"):
            live, tau, T, VJ = _householder_fallback(X, config.precision)
    return torch.cat([panel[:off], live], 0), tau, T, VJ


def panel_factor_cholqr2hr(panel: torch.Tensor, off: int, config):
    """Factor rows >= off of an m x nb panel (m - off >= nb): (packed, tau, T)
    in LAPACK storage, unit-lower V under R."""
    return _cholqr2_panel(panel, off, config, _hr_construct)[:3]


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
    return _cholqr2_panel(panel, off, config, _basis_kernel)
