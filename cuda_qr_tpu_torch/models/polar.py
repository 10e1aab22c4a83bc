"""Polar decomposition A = U H by QR-based dynamically weighted Halley (QDWH),
and the SVD built on it.

Counterpart of ``cuda_qr_tpu/models/polar.py``.  QDWH (Nakatsukasa, Bai &
Gygi 2010; Nakatsukasa & Higham 2013) computes the orthogonal polar factor
with a cubically convergent Halley iteration whose building blocks are this
package's own paths: a tall stacked QR per early iteration, and a few n x n
GEMMs plus one Cholesky (the chol_inv kernel where it is eligible) per late
iteration.  There is no SVD anywhere.

The Halley weights (a_k, b_k, c_k) depend only on the scalar lower bound l_k
of sigma_min(X_k), and l_0 is chosen from the dtype (a floor just below
machine eps, valid for any numerically nonsingular input).  So the whole
weight schedule -- the QR-step vs Cholesky-step switch (c_k > 100) and the
iteration count included -- is computed on the host before the first GEMM,
and the iteration itself takes no host sync.

Iteration (X_0 = A/alpha, alpha >= ||A||_2):
    QR step:    [Q1; Q2] R = qr([sqrt(c) X; I]);
                X <- (b/c) X + (1/sqrt(c)) (a - b/c) Q1 Q2^H
    Chol step:  Z = I + c X^H X;  W = chol(Z);
                X <- (b/c) X + (a - b/c) (X W^{-H}) W^{-1}
Both are algebraically X (aI + b X^H X)(I + c X^H X)^{-1}; the QR form is
inverse-free and stable for the huge early c_k, the Cholesky form costs
about half once c_k is O(1).

Complex input takes QR steps throughout (no Cholesky step, so no chol_inv
kernel), on the blocked Householder QR (never TSQR), at
``complex_config``: the reference's route.  ``polar_dist`` and ``svd_dist``
run the same iteration on a row-sharded matrix over the row mesh
(``parallel/``).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..ops.blocked import as_matrix, complex_config
from ..ops.chol_kernel import chol_with_inv_auto, on_kernel
from ..ops.gemm import gemm
from ..ops.smalllinalg import cholesky_with_inv, eye_like, library_eigh
from ..parallel.collectives import pmax, psum
from ..parallel.mesh import as_row_sharded, shard_rows
from ..parallel.tsqr_dist import _check as _check_tsqr, _tsqr_dist_local
from ..utils.config import DEFAULT_CONFIG, QRConfig
from ..utils.errors import QRShapeError
from ..utils.geometry import round_up
from .qr import qr
from .tsqr import _householder_small, tsqr

_CHOL_C_MAX = 100.0  # Nakatsukasa-Higham switch: Chol step is stable below
EIGH_IMPLS = ("torch", "qdwh")


def _qdwh_schedule(l0: float, eps: float, max_iter: int = 24):
    """Static (a, b, c, use_qr) weight schedule from the scalar recurrence.

    l0 is a lower bound for sigma_min(X0) in (0, 1]; the recurrence
    l <- l (a + b l^2)/(1 + c l^2) converges to 1 cubically, so ~6 steps
    cover l0 = 1e-17.  Stops once |1 - l| <= 5 eps (the iteration is then a
    no-op to working precision).
    """
    steps = []
    l = min(max(l0, 1e-17), 1.0)
    for _ in range(max_iter):
        if 1.0 - l <= 5.0 * eps:
            break
        l2 = l * l
        d = (4.0 * (1.0 - l2) / (l2 * l2)) ** (1.0 / 3.0)
        sq = math.sqrt(1.0 + d)
        a = sq + 0.5 * math.sqrt(8.0 - 4.0 * d + 8.0 * (2.0 - l2) / (l2 * sq))
        b = (a - 1.0) ** 2 / 4.0
        c = a + b - 1.0
        steps.append((a, b, c, c > _CHOL_C_MAX))
        l = l * (a + b * l2) / (1.0 + c * l2)
    return steps


def _real_dtype(dt: torch.dtype) -> torch.dtype:
    """The working real dtype of the scalar recurrences and tolerances."""
    return torch.float64 if dt in (torch.float64, torch.complex128) else torch.float32


def _thin_q2(Y: torch.Tensor, config: QRConfig) -> torch.Tensor:
    """Thin Q of the stacked (m+n) x n QDWH matrix; complex Y never takes
    TSQR (``cuda_qr_tpu/models/polar.py:80``)."""
    m, n = Y.shape
    if n <= config.panel_width and m >= 2 * n and not Y.is_complex():
        return tsqr(Y, config)[0]
    return qr(Y, config, mode="reduced")[0]


def _chol_inv_padded(Z: torch.Tensor, config: QRConfig):
    """The Cholesky step's (L, L^{-1}): chol_with_inv_auto of diag(Z, I), Z
    grown to the next multiple of 16, cut back to Z's size (diag(L, I) is
    the factor of diag(Z, I)).  Every QDWH Cholesky step takes this one
    route, so a side that is no multiple of 16 (the exact-size blocks of
    ``models/eigh.py``; the reference pads its bucketed blocks with +I too)
    passes the chol_inv kernel's gate instead of taking the plain recursion.
    Sides that are multiples of 16, sides above 512 and float64 go to
    chol_with_inv_auto unchanged, the reference's routing."""
    n = Z.shape[0]
    npad = round_up(n, 16)
    if npad == n or not on_kernel((npad, npad), Z.dtype, config):
        return chol_with_inv_auto(Z, config)
    Zp = eye_like(npad, Z)
    Zp[:n, :n] = Z
    L, Li = chol_with_inv_auto(Zp, config)
    return L[:n, :n], Li[:n, :n]


def _qdwh_core(X: torch.Tensor, schedule, config: QRConfig) -> torch.Tensor:
    """Run a (a, b, c, use_qr) weight schedule on X (m x n, spectrum in
    [l0, 1]); complex X takes the QR step at every weight.  GEMMs at
    config.precision; no host sync of its own."""
    m, n = X.shape
    dt = X.dtype
    cplx = X.is_complex()
    prec = config.precision
    eye = eye_like(n, X)
    for a, b, c, use_qr in schedule:
        a, b, c = float(a), float(b), float(c)
        bc = b / c
        if use_qr or cplx:
            sc = math.sqrt(c)
            Q = _thin_q2(torch.cat([sc * X, eye], 0), config).to(dt)
            X = bc * X + ((a - bc) / sc) * gemm(Q[:m], Q[m:].mH, prec)
        else:
            Z = eye + c * gemm(X.T, X, prec)
            _, Li = _chol_inv_padded(Z, config)
            # X Z^{-1} = (X L^{-T}) L^{-1}  with  Z = L L^T
            X = bc * X + (a - bc) * gemm(gemm(X, Li.T, prec), Li, prec)
    return X


def _halley_weights(l, rdt):
    """Dynamic Halley weights (a, b, c) from the scalar bound l, in numpy
    scalars of type ``rdt``.

    Factored so every intermediate stays in float32 range for l >= ~1e-12:
    the textbook form computes l^4 (underflows float32 below l ~ 1e-9), so
    d = cbrt(4(1-l^2)) * exp(-4/3 log l) instead.
    """
    f = rdt
    l = min(max(f(l), f(1e-12)), f(1.0))
    l2 = f(l * l)
    d = f(np.cbrt(f(f(4.0) * f(f(1.0) - l2))) * np.exp(f(f(-4.0 / 3.0) * np.log(l))))
    sq = f(np.sqrt(f(f(1.0) + d)))
    inner = f(f(8.0) - f(f(4.0) * d) + f(f(8.0) * f(f(2.0) - l2)) / f(l2 * sq))
    a = f(sq + f(f(0.5) * np.sqrt(max(inner, f(0.0)))))
    b = f(f(f(a - f(1.0)) ** 2) / f(4.0))
    c = f(f(a + b) - f(1.0))
    return a, b, c


def _qdwh_dyn_schedule(l0: float, rdt, max_iter: int = 24):
    """The weight sequence of the reference's dynamic-weight iteration: a
    QR phase while c > 100, then a Cholesky phase, each ending once
    1 - l <= 5 eps or after max_iter steps in all.  The recurrence runs in
    numpy scalars of the working real dtype ``rdt`` (np.float32 or
    np.float64), as the reference carries l on the device in that dtype, so
    the step count is the one it takes at run time."""
    f = rdt
    eps = f(np.finfo(rdt).eps)
    l = f(l0)
    steps = []

    def converged():
        return f(f(1.0) - l) <= f(f(5.0) * eps)

    def advance(a, b, c):
        l2 = f(l * l)
        nxt = f(f(l * f(a + f(b * l2))) / f(f(1.0) + f(c * l2)))
        return min(max(nxt, f(0.0)), f(1.0))

    with np.errstate(all="ignore"):
        for phase_qr in (True, False):
            while len(steps) < max_iter and not converged():
                a, b, c = _halley_weights(l, rdt)
                if phase_qr and not c > f(_CHOL_C_MAX):
                    break
                steps.append((a, b, c, phase_qr))
                l = advance(a, b, c)
    return steps


def _qdwh_dyn_core(X: torch.Tensor, l0: float, config: QRConfig) -> torch.Tensor:
    """Dynamic-weight QDWH polar iteration for callers that start from their
    own bound l0 (the divide steps of ``models/eigh.py``).

    X: (m, n) scaled so its singular values lie in (l_true, 1]; l0: lower
    bound for sigma_min(X) (pessimistic is fine: extra iterations are no-ops
    once l reaches 1).  The reference carries l as a device scalar under two
    while-loops; l0 is a host number here, so the weights are all computed
    on the host first and the iteration takes no host sync.  Complex X runs
    the same weights as QR steps throughout (``_qdwh_core``), as the
    reference's complex iteration stays in its QR phase until it converges."""
    rdt = np.float64 if _real_dtype(X.dtype) == torch.float64 else np.float32
    return _qdwh_core(X, _qdwh_dyn_schedule(l0, rdt), config)


def polar(A, side: str = "right", l0: float | None = None,
          config: QRConfig = DEFAULT_CONFIG, max_iter: int = 24):
    """Polar decomposition (scipy.linalg.polar analog, QDWH, SVD-free).

    side='right': A = U H with U (m x n) having orthonormal columns
    (m >= n) or orthonormal rows (m < n) and H (n x n) Hermitian PSD.
    side='left':  A = H U with H (m x m) Hermitian PSD.

    l0: optional lower bound for sigma_min(A)/||A||_2 in (0, 1].  Tighter
    values shorten the schedule; the default (just below machine eps of the
    working dtype) is valid for any numerically nonsingular A.  For singular
    A the iteration still returns an orthogonal U (the polar factor of a
    nearby full-rank matrix; the polar factor itself is non-unique there).
    """
    A = as_matrix(A, config, "polar")
    if side not in ("right", "left"):
        raise ValueError(f"side must be 'right' or 'left', got {side!r}")
    m, n = A.shape
    if m < n:
        # A = U H  <=>  A^H = H U^H: the transposed problem on the other side
        Ut, Ht = polar(A.mH, side="left" if side == "right" else "right", l0=l0,
                       config=config, max_iter=max_iter)
        return Ut.mH.resolve_conj(), Ht.mH.resolve_conj()
    dt = A.dtype
    if config.dtype != dt:
        # float64 / bfloat16 / complex input: run the QR core in the input dtype
        config = config.replace(dtype=dt)
    config = complex_config(A, config)
    eps = float(torch.finfo(_real_dtype(dt)).eps)
    if l0 is None:
        l0 = eps / 10.0
    # X0 = A/alpha with alpha = sqrt(||A||_1 ||A||_inf), which overestimates
    # ||A||_2 by at most (mn)^(1/4); l0 bounds sigma_min(A)/||A||_2, so the
    # schedule must start from the deflated sigma_min(X0) bound.
    schedule = _qdwh_schedule(l0 / (m * n) ** 0.25, eps, max_iter)
    U = _qdwh_core(_prep(A), schedule, config)
    return U, _form_h(U, A, side, config)


def svd(A, full_matrices: bool = False, l0: float | None = None,
        config: QRConfig = DEFAULT_CONFIG, eigh_impl: str = "torch"):
    """Singular value decomposition via QDWH-SVD (Nakatsukasa-Higham 2013).

    A = U diag(s) V^H with s descending (real).  The polar factor comes from
    the QDWH iteration above (all GEMM/QR work), then one Hermitian
    eigendecomposition of the n x n factor H = V S V^H gives the right
    singular vectors, and U = U_polar V is one GEMM.  No bidiagonalization.

    full_matrices=True extends the thin factor on the long side to a full
    orthonormal basis: the complement columns come from qr(U, 'complete'),
    orthogonal to range(U) = range(A); any such complement is a valid
    full-SVD basis since the extra rows of diag(s) are zero.

    eigh_impl: "torch" (default) diagonalizes H with torch.linalg.eigh
    (``smalllinalg.library_eigh``);
    "qdwh" uses this package's QDWH-eig divide and conquer
    (``models/eigh.py``), so that no stage of the SVD is a library
    factorization.
    """
    A = as_matrix(A, config, "svd")
    config = complex_config(A, config)
    if eigh_impl not in EIGH_IMPLS:
        raise ValueError(f"eigh_impl must be one of {EIGH_IMPLS}, got {eigh_impl!r}")
    m, n = A.shape
    if m < n:
        U, s, Vh = svd(A.mH, full_matrices=full_matrices, l0=l0, config=config,
                       eigh_impl=eigh_impl)
        return Vh.mH.resolve_conj(), s, U.mH.resolve_conj()
    Up, H = polar(A, side="right", l0=l0, config=config)
    if eigh_impl == "qdwh":
        from .eigh import eigh
        w, V = eigh(H, config)
    else:
        w, V = library_eigh(H)                      # ascending
    U, s, Vh = _svd_finish(Up, w, V, config)
    if full_matrices and m > n:
        Qc = qr(U, config.replace(dtype=U.dtype), mode="complete")[0]  # keep float64 bases
        U = torch.cat([U, Qc[:, n:]], 1)
    return U, s, Vh


def _svd_finish(Up, w, V, config: QRConfig):
    """(U, s, V^H) from the polar factor and H's ascending eigenpairs; s in
    the real dtype."""
    w = w.flip(0).clamp_min(0.0)                    # descending, clipped PSD
    V = V.flip(1)
    U = gemm(Up, V.to(Up.dtype), config.precision)
    return U, w.to(Up.real.dtype), V.mH.to(Up.dtype).resolve_conj()


def _prep(A: torch.Tensor) -> torch.Tensor:
    """Scale A so its spectrum lies in (0, 1]:
    alpha = sqrt(||A||_1 ||A||_inf) >= sigma_max(A), a cheap, exact bound."""
    absA = A.abs()
    alpha = torch.sqrt(absA.sum(0).max() * absA.sum(1).max())
    alpha = torch.where(alpha > 0, alpha, torch.ones_like(alpha))
    return A / alpha


def _form_h(U, A, side: str, config: QRConfig) -> torch.Tensor:
    Hm = (gemm(U.mH, A, config.precision) if side == "right"
          else gemm(A, U.mH, config.precision))
    return (Hm + Hm.mH) * 0.5


def _prep_dist(a: torch.Tensor, mesh) -> torch.Tensor:
    """``_prep`` of a row-sharded A (a: this rank's rows): alpha from the
    all-reduced column sums and the largest row sum over the ranks."""
    absA = a.abs()
    alpha = torch.sqrt(psum(absA.sum(0), mesh).max() * pmax(absA.sum(1).max(), mesh))
    alpha = torch.where(alpha > 0, alpha, torch.ones_like(alpha))
    return a / alpha


def _qdwh_dist(X: torch.Tensor, schedule, mesh, config: QRConfig, strategy: str):
    """The QDWH schedule on a row-sharded X (this rank's rows).  QR step:
    X = Q_d R_d by ``tsqr_dist``, then the small replicated stack
    [sqrt(c) R_d; I] = [Q1; Q2] R2, so the Halley update is one rank-local
    GEMM Q_d (Q1 Q2^H).  Cholesky step: one all_reduce of X^T X and the
    plain ``cholesky_with_inv``, as the reference's distributed iteration.
    Complex X takes the QR step at every weight."""
    n = X.shape[1]
    cplx = X.is_complex()
    prec = config.precision
    eye = eye_like(n, X)
    for a, b, c, use_qr in schedule:
        a, b, c = float(a), float(b), float(c)
        bc = b / c
        if use_qr or cplx:
            sc = math.sqrt(c)
            Qd, Rd = _tsqr_dist_local(X, mesh, config, strategy)
            Qs, _ = _householder_small(torch.cat([sc * Rd, eye], 0), config)
            X = bc * X + ((a - bc) / sc) * gemm(Qd, gemm(Qs[:n], Qs[n:].mH, prec), prec)
        else:
            Z = eye + c * psum(gemm(X.T, X, prec), mesh)
            _, Li = cholesky_with_inv(Z, prec)
            X = bc * X + (a - bc) * gemm(gemm(X, Li.T, prec), Li, prec)
    return X


def polar_dist(A, mesh, l0: float | None = None, config: QRConfig = DEFAULT_CONFIG,
               strategy: str | None = None, max_iter: int = 24):
    """Distributed QDWH polar decomposition of a row-sharded tall matrix,
    called by every rank: A = U H with U (m x n, orthonormal columns) a
    row-sharded DTensor and H (n x n Hermitian PSD) replicated.

    The QR steps factor X with ``tsqr_dist`` (``strategy``, default
    "allgather": the unconditionally stable combine, since early iterates
    have cond up to 1/l0) and the replicated (2n x n) stack; the Cholesky
    steps all-reduce the Gram; H = U^H A is one all-reduced GEMM.  A: the
    full matrix on every rank or a row-sharded DTensor; m >= n, m % P == 0.
    Complex A takes QR steps throughout on Householder leaves
    (``cuda_qr_tpu/models/polar.py:305-345``).
    """
    if len(A.shape) != 2:
        raise QRShapeError(f"polar_dist needs a 2-D matrix, got {tuple(A.shape)}")
    m, n = A.shape
    P = mesh.size(0)
    if m < n:
        raise QRShapeError(f"polar_dist needs a tall matrix (m >= n), got {m}x{n}; "
                           "transpose on the host for the wide case")
    if m % P:
        raise QRShapeError(f"polar_dist needs m % P == 0, got m={m} P={P}")
    strategy = strategy or "allgather"
    _check_tsqr(strategy, m, P)              # before any collective, as tsqr_dist
    a, _ = shard_rows(A, mesh)
    dt = a.dtype
    if config.dtype != dt:
        config = config.replace(dtype=dt)
    config = complex_config(a, config)
    eps = float(torch.finfo(_real_dtype(dt)).eps)
    if l0 is None:
        l0 = eps / 10.0
    schedule = _qdwh_schedule(l0 / (m * n) ** 0.25, eps, max_iter)
    U = _qdwh_dist(_prep_dist(a, mesh), schedule, mesh, config, strategy)
    Hm = psum(gemm(U.mH, a, config.precision), mesh)
    return as_row_sharded(U, mesh, m), (Hm + Hm.mH) * 0.5


def svd_dist(A, mesh, l0: float | None = None, config: QRConfig = DEFAULT_CONFIG,
             strategy: str | None = None, eigh_impl: str = "torch", max_iter: int = 24):
    """Distributed SVD of a row-sharded tall matrix via QDWH, called by
    every rank: A = U diag(s) V^H with U (m x n) a row-sharded DTensor, s
    descending and V^H (n x n) replicated.

    The polar factor comes from ``polar_dist`` (its only collectives), the
    replicated n x n factor H is diagonalized on every rank (``eigh_impl``
    as in ``svd``), and U = U_polar V is one rank-local GEMM.  No
    ``full_matrices``: a distributed complement of range(A) is all
    communication.
    """
    if len(A.shape) != 2:
        raise QRShapeError(f"svd_dist needs a 2-D matrix, got {tuple(A.shape)}")
    if eigh_impl not in EIGH_IMPLS:
        raise ValueError(f"eigh_impl must be one of {EIGH_IMPLS}, got {eigh_impl!r}")
    config = complex_config(A, config)
    Up, H = polar_dist(A, mesh, l0=l0, config=config, strategy=strategy, max_iter=max_iter)
    if eigh_impl == "qdwh":
        from .eigh import eigh
        w, V = eigh(H, config.replace(dtype=H.dtype))
    else:
        w, V = library_eigh(H)                      # ascending
    U, s, Vh = _svd_finish(Up.to_local(), w, V, config)
    return as_row_sharded(U, mesh, A.shape[0]), s, Vh
