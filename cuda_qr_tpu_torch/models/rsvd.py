"""QR-powered spectral tools: orth / randomized SVD / randomized
eigendecomposition / norm and condition estimates.

Counterpart of ``cuda_qr_tpu/models/rsvd.py``.  The randomized range finder
(Halko, Martinsson & Tropp 2011) is two tall GEMMs plus thin QRs, the
shapes the TSQR and blocked-QR paths factor; the only dense SVD or
eigendecomposition is of a small (k+p) core and goes to ``torch.linalg``,
as the reference hands it to its library.

  orth(A)          orthonormal basis of range(A) (thin Q; rank-revealing
                   truncation via QRCP when rcond is given)
  rsvd(A, k)       rank-k randomized SVD: A ~= U @ diag(s) @ Vt
  eigh_rand(A, k)  rank-k randomized eigendecomposition of a symmetric A
  norm2_est(A)     randomized spectral-norm estimate (block power iteration)
  cond_est(A)      2-norm condition estimate through one QR

The sketches.  The reference draws them from ``jax.random`` (key 12), whose
numbers torch cannot reproduce; here ``generator`` (default: seeded 12 on
the input's device) takes the key's place, and ``omega`` hands the sketch in
directly, which is how the two packages are compared on one input.

Complex A (the reference's route): the sketch is a real Gaussian in A's
dtype, every transpose is the conjugate one, s, w and the estimates are
real, and every GEMM runs at ``complex_config`` ("highest").

``rsvd_dist`` and ``eigh_rand_dist`` run the same range finders over the
row mesh (``parallel/``), their sketches shared from rank 0.
"""

from __future__ import annotations

import torch

from ..ops.blocked import as_matrix, complex_config, orgqr
from ..ops.gemm import gemm
from ..ops.smalllinalg import library_eigh
from ..parallel.collectives import broadcast, coord, psum
from ..parallel.mesh import as_row_sharded, shard_rows
from ..parallel.tsqr_dist import _tsqr_dist_local
from ..utils.config import DEFAULT_CONFIG, QRConfig
from ..utils.errors import QRShapeError
from .qr import qr
from .tsqr import tsqr

SKETCH_SEED = 12   # the reference's PRNGKey(12)


def _mm(X: torch.Tensor, Y: torch.Tensor, config: QRConfig) -> torch.Tensor:
    """X @ Y at config.precision; mixed dtypes promote, as jnp.einsum does."""
    dt = torch.promote_types(X.dtype, Y.dtype)
    return gemm(X.to(dt), Y.to(dt), config.precision)


def _thin_qr(Y: torch.Tensor, config: QRConfig) -> torch.Tensor:
    """Thin Q of a tall block: TSQR when it fits the tall-skinny path,
    blocked Householder otherwise."""
    m, n = Y.shape
    if n <= config.panel_width and m >= 2 * n:
        return tsqr(Y, config)[0]
    return qr(Y, config, mode="reduced")[0]


def _sketch(shape, like: torch.Tensor, generator, omega) -> torch.Tensor:
    """Standard normal sketch of ``shape`` in ``like``'s dtype on its device:
    ``omega`` if given, else drawn from ``generator`` (default seeded 12) in
    the real dtype, as the reference draws it for complex A too."""
    if omega is not None:
        omega = torch.as_tensor(omega, device=like.device).to(like.dtype)
        if tuple(omega.shape) != tuple(shape):
            raise QRShapeError(f"omega must be {tuple(shape)}, got {tuple(omega.shape)}")
        return omega
    if generator is None:
        generator = torch.Generator(device=like.device).manual_seed(SKETCH_SEED)
    rdt = like.real.dtype if like.is_complex() else like.dtype
    return torch.randn(shape, generator=generator, dtype=rdt, device=like.device).to(like.dtype)


def _prepare(A, config: QRConfig, name: str):
    """(A as a matrix, the configuration it runs at)."""
    A = as_matrix(A, config, name)
    return A, complex_config(A, config)


def orth(A, rcond: float | None = None, config: QRConfig = DEFAULT_CONFIG):
    """Orthonormal basis of range(A) (scipy.linalg.orth analog, QR-based).

    rcond=None: thin Q of A (full column count, requires m >= n).
    rcond given: rank-revealing basis -- QRCP runs, the rank is the count of
    R's diagonal entries above rcond * |R[0,0]|, and only those columns of Q
    return (at least one: a zero matrix keeps a trivial 1-column slot).
    """
    A, config = _prepare(A, config, "orth")
    if rcond is None:
        return _thin_qr(A, config)
    from .rank import _qrcp_with_rank
    factors, _, _, r, config = _qrcp_with_rank(A, config, rcond)
    r = max(r, 1)
    kb = factors.packed.shape[1]
    return orgqr(factors, A.shape[0], kb, config)[:, :r]


def rsvd(A, k: int, p: int = 8, n_iter: int = 2,
         generator: torch.Generator | None = None,
         config: QRConfig = DEFAULT_CONFIG, omega=None):
    """Randomized rank-k SVD (HMT 2011, Alg. 4.4 + 5.1): returns (U, s, Vt)
    with U (m x k), s (k,), Vt (k x n) and A ~= U @ diag(s) @ Vt.

    Sketch width ell = min(k + p, m, n); n_iter power iterations with QR
    re-orthonormalization between applications.  All large operations are
    (m x n)(n x ell) GEMMs and thin QRs; the dense SVD is of the (ell x n)
    projection only.  Works for m >= n and m < n alike.  ``omega``: the
    (n x ell) sketch, in place of a draw from ``generator``.
    """
    A, config = _prepare(A, config, "rsvd")
    m, n = A.shape
    ell = min(k + p, min(m, n))
    if not 1 <= k <= min(m, n):
        raise QRShapeError(f"rank k must be in [1, {min(m, n)}], got {k}")
    Om = _sketch((n, ell), A, generator, omega)
    Q = _thin_qr(_mm(A, Om, config), config)
    for _ in range(n_iter):
        Q = _thin_qr(_mm(A.mH, Q, config), config)
        Q = _thin_qr(_mm(A, Q, config), config)
    B = _mm(Q.mH, A, config)                      # (ell x n) projection
    Ub, s, Vt = torch.linalg.svd(B, full_matrices=False)
    U = _mm(Q, Ub, config)
    return U[:, :k], s[:k], Vt[:k]


def eigh_rand(A, k: int, p: int = 8, n_iter: int = 2,
              generator: torch.Generator | None = None,
              config: QRConfig = DEFAULT_CONFIG, omega=None):
    """Randomized rank-k eigendecomposition of a symmetric (Hermitian) A.

    Returns (w (k,), V (m x k)) with A ~= V @ diag(w) @ V^H, eigenpairs
    ordered by descending |w| (the dominant pairs the sketch captures; works
    for indefinite A).  Range finder as in ``rsvd`` -- for symmetric A each
    power step is one GEMM + thin QR -- then Rayleigh-Ritz on the
    (ell x ell) compression T = Q^H A Q.  n_iter counts single applications
    of A (n_iter + 1 in all).  ``omega``: the (m x ell) sketch.
    """
    A, config = _prepare(A, config, "eigh_rand")
    m, n = A.shape
    if m != n:
        raise QRShapeError(f"eigh_rand needs a square matrix, got {tuple(A.shape)}")
    ell = min(k + p, m)
    if not 1 <= k <= m:
        raise QRShapeError(f"rank k must be in [1, {m}], got {k}")
    Om = _sketch((m, ell), A, generator, omega)
    Q = _thin_qr(_mm(A, Om, config), config)
    for _ in range(n_iter):
        Q = _thin_qr(_mm(A, Q, config), config)
    T = _mm(Q.mH, _mm(A, Q, config), config)      # (ell x ell) Rayleigh quotient
    T = 0.5 * (T + T.mH)
    w, S = library_eigh(T)                        # ascending
    order = torch.argsort(-w.abs(), stable=True)[:k]
    return w[order], _mm(Q, S[:, order], config)


def _gram_orthonormalize(Z: torch.Tensor, config: QRConfig) -> torch.Tensor:
    """Z L^{-H} with L L^H = Z^H Z + tiny I: the b-column re-orthonormalization
    of the block power iterations (Q^T = solve(conj(L), Z^T), the
    reference's form)."""
    b = Z.shape[1]
    tiny = torch.finfo(Z.dtype).tiny
    G = _mm(Z.mH, Z, config)
    L = torch.linalg.cholesky_ex(
        G + tiny * torch.eye(b, dtype=G.dtype, device=G.device)).L
    return torch.linalg.solve_triangular(L.conj(), Z.T, upper=False).T


def _growth(Y: torch.Tensor, X: torch.Tensor) -> torch.Tensor:
    """max over columns of ||Y_j|| / ||X_j|| (a 0-d tensor)."""
    tiny = torch.finfo(X.dtype).tiny
    return (torch.linalg.norm(Y, dim=0)
            / torch.linalg.norm(X, dim=0).clamp_min(tiny)).max()


def norm2_est(A, n_iter: int = 8, generator: torch.Generator | None = None,
              config: QRConfig = DEFAULT_CONFIG, omega=None) -> torch.Tensor:
    """Randomized spectral-norm estimate via block power iteration (block
    size min(4, n)) with Gram-Cholesky re-orthonormalization; a lower bound
    converging at rate (s2/s1)^(2*n_iter).  Returns a 0-d tensor; the loop
    takes no host sync.  ``omega``: the (n x b) start block."""
    A, config = _prepare(A, config, "norm2_est")
    n = A.shape[1]
    X = _sketch((n, min(4, n)), A, generator, omega)
    for _ in range(n_iter):
        X = _gram_orthonormalize(_mm(A.mH, _mm(A, X, config), config), config)
    return _growth(_mm(A, X, config), X)


def cond_est(A, n_iter: int = 12, generator: torch.Generator | None = None,
             config: QRConfig = DEFAULT_CONFIG, omega=None, omega_inv=None) -> torch.Tensor:
    """2-norm condition number estimate of A (m >= n, full rank) via QR.

    cond2(A) = cond2(R): one factorization, then block power iteration on
    R^H R for sigma_max (``norm2_est``) and on R^{-1} R^{-H} (two triangular
    solves per step; R is never inverted) for sigma_min.  Both iterates are
    lower bounds of their targets, so the estimate approaches cond2(A) from
    below.  ``omega`` is ``norm2_est``'s (n x b) start block, ``omega_inv``
    the inverse iteration's; without them both are drawn, one after the
    other, from ``generator``.
    """
    A, config = _prepare(A, config, "cond_est")
    m, n = A.shape
    if m < n:
        raise QRShapeError(f"cond_est needs m >= n, got {tuple(A.shape)}")
    R = qr(A, config, mode="r")
    if generator is None:
        generator = torch.Generator(device=R.device).manual_seed(SKETCH_SEED)
    smax = norm2_est(R, n_iter=n_iter, generator=generator, config=config, omega=omega)

    def apply_inv(X):                             # R^{-1} R^{-H} X
        Y = torch.linalg.solve_triangular(R.mH, X, upper=False)
        return torch.linalg.solve_triangular(R, Y, upper=True)

    # sigma_min(R) = 1 / ||R^{-1}||_2: power-iterate z -> R^{-1} R^{-H} z
    X = _sketch((n, min(4, n)), R, generator, omega_inv)
    for _ in range(n_iter):
        X = _gram_orthonormalize(apply_inv(X), config)
    # one (R^-1 R^-H) application grows vectors by sigma_min^{-2}
    smin = 1.0 / torch.sqrt(_growth(apply_inv(X), X))
    return smax / smin


def _dist_setup(A, k: int, name: str, mesh, config: QRConfig, square: bool):
    """(this rank's rows of A in the working dtype, m, config, the tsqr_dist
    combine) for the distributed range finders: complex A takes Householder
    leaves and the "allgather" combine, real A the "cholesky" one."""
    m, n = A.shape
    if square and m != n:
        raise QRShapeError(f"{name} needs a square matrix, got {tuple(A.shape)}")
    if not 1 <= k <= min(m, n):
        raise QRShapeError(f"rank k must be in [1, {min(m, n)}], got {k}")
    if m % mesh.size(0):
        raise QRShapeError(f"{name} needs m % P == 0; got {m} rows on {mesh.size(0)} shards")
    a, _ = shard_rows(A, mesh)
    if a.is_complex():
        return a, m, complex_config(a, config), "allgather"
    if a.dtype == torch.float64:
        # float64 keeps its precision, as the single-device functions do
        config = config.replace(dtype=torch.float64)
    return a.to(config.dtype), m, config, "cholesky"


def _shared_sketch(shape, a, generator, omega, mesh) -> torch.Tensor:
    """The sketch, the same on every rank: rank 0's draw (or ``omega``)
    broadcast to all."""
    return broadcast(_sketch(shape, a, generator, omega), mesh)


def rsvd_dist(A, k: int, mesh, p: int = 8, n_iter: int = 2,
              generator: torch.Generator | None = None,
              config: QRConfig = DEFAULT_CONFIG, omega=None):
    """Distributed randomized rank-k SVD of a row-sharded tall matrix,
    called by every rank.  Returns (U (m x k) row-sharded DTensor, s (k,),
    Vt (k x n)), the last two replicated.

    ``rsvd``'s algorithm with the tall factors on the mesh: the sketch and
    projection GEMMs are rank-local, the thin QRs of tall blocks go through
    ``tsqr_dist`` (CholeskyQR2 combine; "allgather" for complex A), and the
    small n x ell intermediates (A^H Q) are all-reduced; no row of A
    crosses between ranks.
    Needs m % P == 0.  The (n x ell) sketch is rank 0's (``generator`` or
    ``omega``), broadcast.
    """
    m, n = A.shape
    ell = min(k + p, min(m, n))
    a, m, config, strategy = _dist_setup(A, k, "rsvd_dist", mesh, config, square=False)
    Om = _shared_sketch((n, ell), a, generator, omega, mesh)
    Q = _tsqr_dist_local(_mm(a, Om, config), mesh, config, strategy)[0]
    for _ in range(n_iter):
        Z = qr(psum(_mm(a.mH, Q, config), mesh), config, mode="reduced")[0]  # replicated
        Q = _tsqr_dist_local(_mm(a, Z, config), mesh, config, strategy)[0]
    B = psum(_mm(a.mH, Q, config), mesh).mH             # (ell x n) = Q^H A
    Ub, s, Vt = torch.linalg.svd(B, full_matrices=False)
    U = _mm(Q, Ub, config)
    return as_row_sharded(U[:, :k], mesh, m), s[:k], Vt[:k]


def eigh_rand_dist(A, k: int, mesh, p: int = 8, n_iter: int = 2,
                   generator: torch.Generator | None = None,
                   config: QRConfig = DEFAULT_CONFIG, omega=None):
    """Distributed randomized rank-k eigendecomposition of a row-sharded
    symmetric A (m x m, m % P == 0), called by every rank.  Returns
    (w (k,) replicated, V (m x k) row-sharded DTensor), by descending |w|.

    The communication of ``rsvd_dist``: rank-local sketch GEMMs, thin QRs
    through ``tsqr_dist``, and all-reduced (m x ell) and (ell x ell)
    intermediates.  Symmetry makes the all-reduced A^H Q the next
    application of A.  The (m x ell) sketch is rank 0's, broadcast.
    """
    m = A.shape[0]
    ell = min(k + p, m)
    a, m, config, strategy = _dist_setup(A, k, "eigh_rand_dist", mesh, config, square=True)
    mloc, i = a.shape[0], coord(mesh)

    def mine(W):                                        # this rank's rows
        return W[i * mloc:(i + 1) * mloc]

    Om = _shared_sketch((m, ell), a, generator, omega, mesh)
    Q = _tsqr_dist_local(_mm(a, Om, config), mesh, config, strategy)[0]
    for _ in range(n_iter):
        W = psum(_mm(a.mH, Q, config), mesh)            # = A Q (A Hermitian)
        Q = _tsqr_dist_local(mine(W), mesh, config, strategy)[0]
    AQ = mine(psum(_mm(a.mH, Q, config), mesh))         # (m x ell), my rows
    T = psum(_mm(Q.mH, AQ, config), mesh)               # (ell x ell) Rayleigh quotient
    T = 0.5 * (T + T.mH)
    w, S = library_eigh(T)                              # ascending
    order = torch.argsort(-w.abs(), stable=True)[:k]
    return w[order], as_row_sharded(_mm(Q, S[:, order], config), mesh, m)
