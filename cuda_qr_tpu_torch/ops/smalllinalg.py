"""Small-matrix primitives of the fast panel path (plain PyTorch).

Counterpart of ``cuda_qr_tpu/ops/smalllinalg.py``: triangular inversion by
block doubling, Cholesky and unpivoted LU by 2-way recursion (each fused with
the inverses the recursion needs anyway), and a Newton-Schulz inverse with
its a-posteriori certificate.
Every product runs at the ``precision`` its function takes ("highest" by
default), as the reference's recursions take ``precision=``.
``cholesky_with_inv`` is the plain version of the chol_inv kernel
(``ops/chol_kernel.py``), ``newton_certified`` that of the Newton-Schulz
kernel (``ops/newton_kernel.py``).  Every routine takes leading batch dimensions
(the reference's ``jax.vmap``); a 2-D input runs the same ops as before.  A non-PD input gives NaN/Inf, no raise: callers
branch on finiteness.

Data-dependent branches.  The reference decides them on the device
(``lax.cond`` / ``lax.while_loop``); eager PyTorch decides them on the host,
and every such decision is one device->host sync.  ``host_decision`` (a
boolean) and ``host_values`` (numbers, such as a split size) are the only
places that take one, and ``host_syncs`` counts them; the blocking read
itself is the span ``driver.host_sync`` (``utils/profiling.span``), so its
seconds are the host's wait at the sync.
"""

from __future__ import annotations

import torch

from ..utils.profiling import span
from .gemm import gemm
from .householder import vecmat

_BASE = 16

# Host syncs taken by data-dependent branches since the last reset; read and
# reset by callers that report syncs per factorization.
host_syncs = 0


def host_decision(flag: torch.Tensor) -> bool:
    """Bring a 0-d boolean tensor to the host (one sync on a device)."""
    global host_syncs
    host_syncs += 1
    with span("driver.host_sync"):
        return bool(flag)


def host_values(values: torch.Tensor):
    """Bring a small tensor to the host as Python numbers (one sync on a
    device, however many numbers it holds)."""
    global host_syncs
    host_syncs += 1
    with span("driver.host_sync"):
        return values.tolist()


def eye_like(n: int, like: torch.Tensor) -> torch.Tensor:
    """The n x n identity in ``like``'s dtype, on its device."""
    return torch.eye(n, dtype=like.dtype, device=like.device)


def _zeros(like: torch.Tensor, rows: int, cols: int) -> torch.Tensor:
    """Zeros of ``like``'s leading batch shape, dtype and device."""
    return torch.zeros(like.shape[:-2] + (rows, cols), dtype=like.dtype,
                       device=like.device)


def _block(A, B, C, D) -> torch.Tensor:
    """[[A, B], [C, D]] over the last two dimensions."""
    return torch.cat([torch.cat([A, B], -1), torch.cat([C, D], -1)], -2)


def _inv_upper_base(U: torch.Tensor) -> torch.Tensor:
    """Back-substitution inverse of a small upper-triangular block.  Its
    products are the reference's default-precision ones
    (``cuda_qr_tpu/ops/smalllinalg.py:33``): "highest" here."""
    n = U.shape[-1]
    X = torch.zeros_like(U)
    eye = eye_like(n, U)
    for j in range(n - 1, -1, -1):
        X[..., j, :] = ((eye[j] - vecmat(U[..., j, j + 1:], X[..., j + 1:, :], "highest"))
                        / U[..., j, j, None])
    return X


def inv_upper(U: torch.Tensor, precision: str = "highest") -> torch.Tensor:
    """Inverse of upper-triangular U (..., n, n).

    Power-of-two sizes: batched block doubling, level s inverting all n/2s
    diagonal 2s-blocks at once, inv([[A, B], [0, C]]) = [[Ai, -Ai B Ci],
    [0, Ci]].  Other sizes: 2-way recursion with a back-substitution base.
    """
    n = U.shape[-1]
    if n & (n - 1):
        return _inv_upper_rec(U, precision)
    lead = U.shape[:-2]
    M = (1.0 / torch.diagonal(U, 0, -2, -1)).reshape(lead + (n, 1, 1))
    s = 1
    while s < n:
        nblk = n // (2 * s)
        view = U.reshape(lead + (nblk, 2 * s, nblk, 2 * s))
        dblk = torch.diagonal(view, 0, -4, -2).movedim(-1, -3)   # (..., nblk, 2s, 2s)
        B = dblk[..., :s, s:]
        Ai, Ci = M[..., 0::2, :, :], M[..., 1::2, :, :]
        top = -gemm(gemm(Ai, B, precision), Ci, precision)
        M = _block(Ai, top, torch.zeros_like(Ai), Ci)
        s *= 2
    return M[..., 0, :, :]


def _inv_upper_rec(U: torch.Tensor, precision: str) -> torch.Tensor:
    n = U.shape[-1]
    if n <= _BASE:
        return _inv_upper_base(U)
    h = n // 2
    Ai = _inv_upper_rec(U[..., :h, :h], precision)
    Ci = _inv_upper_rec(U[..., h:, h:], precision)
    top = -gemm(gemm(Ai, U[..., :h, h:], precision), Ci, precision)
    return _block(Ai, top, _zeros(U, n - h, h), Ci)


def inv_lower(L: torch.Tensor, precision: str = "highest") -> torch.Tensor:
    """Inverse of lower-triangular L via the upper routine on L^T."""
    return inv_upper(L.mT.contiguous(), precision).mT


def _chol_base(G: torch.Tensor) -> torch.Tensor:
    """Column-by-column base Cholesky (n <= _BASE)."""
    n = G.shape[-1]
    G = G.clone()
    L = torch.zeros_like(G)
    for j in range(n):
        col = G[..., j:, j] / torch.sqrt(G[..., j, j, None])
        L[..., j:, j] = col
        G[..., j:, j:] -= col[..., :, None] * col[..., None, :]
    return L


def cholesky_with_inv(G: torch.Tensor, precision: str = "highest"):
    """(L, L^{-1}) of SPD G (..., n, n) in one 2-way recursion:
        inv([[L1, 0], [L21, L2]]) = [[L1i, 0], [-L2i L21 L1i, L2i]].
    Leading dimensions are a batch (the reference vmaps the 2-D recursion)."""
    n = G.shape[-1]
    if n <= _BASE:
        L = _chol_base(G)
        return L, inv_lower(L, precision)
    h = n // 2
    L1, L1i = cholesky_with_inv(G[..., :h, :h], precision)
    L21 = gemm(G[..., h:, :h], L1i.mT, precision)
    S = G[..., h:, h:] - gemm(L21, L21.mT, precision)
    L2, L2i = cholesky_with_inv(S, precision)
    bot = -gemm(gemm(L2i, L21, precision), L1i, precision)
    z = _zeros(G, h, n - h)
    return _block(L1, z, L21, L2), _block(L1i, z, bot, L2i)


def newton_inverse(M: torch.Tensor, precision: str = "highest", tol: float | None = None,
                   max_iters: int = 48):
    """Dense inverse of a well-conditioned square M by Newton-Schulz.

    X_{k+1} = X_k (2I - M X_k), starting from 2I - M when M is near I, else
    from M^T / (||M||_1 ||M||_inf).  Returns (X, err) with
    err = ||I - M X_prev||_max of the last accepted iterate: err <= tol
    certifies convergence; err > tol (or NaN) means M was too
    ill-conditioned.  One host sync per iteration decides whether to go on.
    """
    X, err, _, _ = newton_certified(M, precision, tol, max_iters)
    return X, err


def newton_certified(M: torch.Tensor, precision: str = "highest", tol: float | None = None,
                     max_iters: int = 48):
    """(N, err, cert, iters): ``newton_inverse``'s iteration on M, then the
    certificate cert = max|N|^2 max|I - M N| (the basis-kernel panel's block
    reflector deviates from orthogonality by at most 16 cert, to first order
    in N's error); iters is the iterations run, a 0-d int32 tensor.  The
    plain version of the Newton-Schulz kernel (``ops/newton_kernel.py``):
    one host sync an iteration, none for the certificate."""
    n = M.shape[0]
    if tol is None:
        tol = 2e-4 if M.dtype == torch.float32 else 3e-8
    eye = eye_like(n, M)
    a = M.abs().sum(0).max()
    b = M.abs().sum(1).max()
    denom = torch.clamp(a * b, min=torch.finfo(M.dtype).tiny)
    E = eye - M
    e2 = torch.sqrt(E.abs().sum(0).max() * E.abs().sum(1).max())
    X = torch.where(e2 < 0.5, eye + E, (M / denom).T)
    err = torch.full((), float("inf"), dtype=M.dtype, device=M.device)
    iters = 0
    for _ in range(max_iters):
        if not host_decision(err > tol):
            break
        P = gemm(M, X, precision)
        err = (eye - P).abs().max()
        X = gemm(X, 2 * eye - P, precision)
        iters += 1
    cert = X.abs().max() ** 2 * (eye - gemm(M, X, precision)).abs().max()
    return X, err, cert, torch.tensor(iters, dtype=torch.int32)


def _lu_base(Y: torch.Tensor):
    """Base unpivoted LU (n <= _BASE): L unit-lower, U upper."""
    n = Y.shape[0]
    Y = Y.clone()
    for j in range(n - 1):
        Y[j + 1:, j] /= Y[j, j]
        Y[j + 1:, j + 1:] -= torch.outer(Y[j + 1:, j], Y[j, j + 1:])
    L = torch.tril(Y, -1) + eye_like(n, Y)
    U = torch.triu(Y)
    return L, U


def lu_with_inv(Y: torch.Tensor, precision: str = "highest"):
    """(L, U, L^{-1}, U^{-1}) of an unpivoted-LU-safe Y in one recursion."""
    n = Y.shape[0]
    if n <= _BASE:
        L, U = _lu_base(Y)
        return L, U, inv_lower(L, precision), inv_upper(U, precision)
    h = n // 2
    L11, U11, L11i, U11i = lu_with_inv(Y[:h, :h], precision)
    U12 = gemm(L11i, Y[:h, h:], precision)
    L21 = gemm(Y[h:, :h], U11i, precision)
    S = Y[h:, h:] - gemm(L21, U12, precision)
    L22, U22, L22i, U22i = lu_with_inv(S, precision)
    zl, zu = _zeros(Y, h, n - h), _zeros(Y, n - h, h)
    Lbot = -gemm(gemm(L22i, L21, precision), L11i, precision)
    Utop = -gemm(gemm(U11i, U12, precision), U22i, precision)
    return (_block(L11, zl, L21, L22), _block(U11, U12, zu, U22),
            _block(L11i, zl, Lbot, L22i), _block(U11i, Utop, zu, U22i))


# Largest float32 side that library_eigh solves in float64 on a card.  The
# value is PyTorch's own switch (torch 2.11, CUDA 12.8: float32 matrices of
# at most 512 rows go to cuSOLVER's Jacobi solver, larger ones and float64
# to the QR-based one).  tests/test_torch_cuda.py holds both sides of it
# (384, 512, 528 rows) to n eps; re-read it there when torch changes.
LIBRARY_EIGH_F64_MAX_N = 512


def library_eigh(H: torch.Tensor):
    """torch.linalg.eigh of a symmetric H, the small dense core that the
    reference hands to its library too.  On a card, a float32 H of at most
    LIBRARY_EIGH_F64_MAX_N rows is solved in float64 and rounded back: the
    Jacobi solver PyTorch picks there gave the eigenvalues of a 384 x 384 H
    1.5e-4 ||H|| off (H100), where the QR-based solver comes out at n eps.
    A complex64 H stays complex64: PyTorch's solver is at n eps there (a
    384 x 384 Gram's eigenvalues 2.2e-7 ||H|| from complex128's, H100).
    A CPU tensor goes to torch.linalg.eigh as it is."""
    if H.is_cuda and H.dtype == torch.float32 and H.shape[-1] <= LIBRARY_EIGH_F64_MAX_N:
        w, V = torch.linalg.eigh(H.double())
        return w.float(), V.float()
    return torch.linalg.eigh(H)
