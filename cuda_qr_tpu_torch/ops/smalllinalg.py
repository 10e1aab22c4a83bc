"""Small-matrix primitives of the fast panel path (plain PyTorch).

Counterpart of ``cuda_qr_tpu/ops/smalllinalg.py``: triangular inversion by
block doubling, Cholesky and unpivoted LU by 2-way recursion (each fused with
the inverses the recursion needs anyway), and a Newton-Schulz inverse.
``cholesky_with_inv`` is the plain version of the chol_inv kernel
(``ops/chol_kernel.py``).  A non-PD input gives NaN/Inf, no raise: callers
branch on finiteness.

Data-dependent branches.  The reference decides them on the device
(``lax.cond`` / ``lax.while_loop``); eager PyTorch decides them on the host,
and every such decision is one device->host sync.  ``host_decision`` is the
single place that takes one, and ``host_syncs`` counts them.
"""

from __future__ import annotations

import torch

_BASE = 16

# Host syncs taken by data-dependent branches since the last reset; read and
# reset by callers that report syncs per factorization.
host_syncs = 0


def host_decision(flag: torch.Tensor) -> bool:
    """Bring a 0-d boolean tensor to the host (one sync on a device)."""
    global host_syncs
    host_syncs += 1
    return bool(flag)


def _eye(n: int, like: torch.Tensor) -> torch.Tensor:
    return torch.eye(n, dtype=like.dtype, device=like.device)


def _inv_upper_base(U: torch.Tensor) -> torch.Tensor:
    """Back-substitution inverse of a small upper-triangular block."""
    n = U.shape[0]
    X = torch.zeros_like(U)
    eye = _eye(n, U)
    for j in range(n - 1, -1, -1):
        X[j] = (eye[j] - U[j, j + 1:] @ X[j + 1:]) / U[j, j]
    return X


def inv_upper(U: torch.Tensor) -> torch.Tensor:
    """Inverse of upper-triangular U.

    Power-of-two sizes: batched block doubling, level s inverting all n/2s
    diagonal 2s-blocks at once, inv([[A, B], [0, C]]) = [[Ai, -Ai B Ci],
    [0, Ci]].  Other sizes: 2-way recursion with a back-substitution base.
    """
    n = U.shape[0]
    if n & (n - 1):
        return _inv_upper_rec(U)
    M = (1.0 / torch.diagonal(U)).reshape(n, 1, 1)
    s = 1
    while s < n:
        nblk = n // (2 * s)
        view = U.reshape(nblk, 2 * s, nblk, 2 * s)
        idx = torch.arange(nblk, device=U.device)
        dblk = view[idx, :, idx, :]                    # (nblk, 2s, 2s)
        B = dblk[:, :s, s:]
        Ai, Ci = M[0::2], M[1::2]
        top = -(Ai @ B @ Ci)
        z = torch.zeros((nblk, s, s), dtype=U.dtype, device=U.device)
        M = torch.cat([torch.cat([Ai, top], 2), torch.cat([z, Ci], 2)], 1)
        s *= 2
    return M[0]


def _inv_upper_rec(U: torch.Tensor) -> torch.Tensor:
    n = U.shape[0]
    if n <= _BASE:
        return _inv_upper_base(U)
    h = n // 2
    Ai = _inv_upper_rec(U[:h, :h])
    Ci = _inv_upper_rec(U[h:, h:])
    top = -(Ai @ U[:h, h:] @ Ci)
    z = torch.zeros((n - h, h), dtype=U.dtype, device=U.device)
    return torch.cat([torch.cat([Ai, top], 1), torch.cat([z, Ci], 1)], 0)


def inv_lower(L: torch.Tensor) -> torch.Tensor:
    """Inverse of lower-triangular L via the upper routine on L^T."""
    return inv_upper(L.T.contiguous()).T


def _chol_base(G: torch.Tensor) -> torch.Tensor:
    """Column-by-column base Cholesky (n <= _BASE)."""
    n = G.shape[0]
    G = G.clone()
    L = torch.zeros_like(G)
    for j in range(n):
        col = G[j:, j] / torch.sqrt(G[j, j])
        L[j:, j] = col
        G[j:, j:] -= torch.outer(col, col)
    return L


def cholesky_with_inv(G: torch.Tensor):
    """(L, L^{-1}) of SPD G in one 2-way recursion:
        inv([[L1, 0], [L21, L2]]) = [[L1i, 0], [-L2i L21 L1i, L2i]]."""
    n = G.shape[0]
    if n <= _BASE:
        L = _chol_base(G)
        return L, inv_lower(L)
    h = n // 2
    L1, L1i = cholesky_with_inv(G[:h, :h])
    L21 = G[h:, :h] @ L1i.T
    S = G[h:, h:] - L21 @ L21.T
    L2, L2i = cholesky_with_inv(S)
    bot = -(L2i @ L21 @ L1i)
    z = torch.zeros((h, n - h), dtype=G.dtype, device=G.device)
    L = torch.cat([torch.cat([L1, z], 1), torch.cat([L21, L2], 1)], 0)
    Li = torch.cat([torch.cat([L1i, z], 1), torch.cat([bot, L2i], 1)], 0)
    return L, Li


def newton_inverse(M: torch.Tensor, tol: float | None = None, max_iters: int = 48):
    """Dense inverse of a well-conditioned square M by Newton-Schulz.

    X_{k+1} = X_k (2I - M X_k), starting from 2I - M when M is near I, else
    from M^T / (||M||_1 ||M||_inf).  Returns (X, err) with
    err = ||I - M X_prev||_max of the last accepted iterate: err <= tol
    certifies convergence; err > tol (or NaN) means M was too
    ill-conditioned.  One host sync per iteration decides whether to go on.
    """
    n = M.shape[0]
    if tol is None:
        tol = 2e-4 if M.dtype == torch.float32 else 3e-8
    eye = _eye(n, M)
    a = M.abs().sum(0).max()
    b = M.abs().sum(1).max()
    denom = torch.clamp(a * b, min=torch.finfo(M.dtype).tiny)
    E = eye - M
    e2 = torch.sqrt(E.abs().sum(0).max() * E.abs().sum(1).max())
    X = torch.where(e2 < 0.5, eye + E, (M / denom).T)
    err = torch.full((), float("inf"), dtype=M.dtype, device=M.device)
    for _ in range(max_iters):
        if not host_decision(err > tol):
            break
        P = M @ X
        err = (eye - P).abs().max()
        X = X @ (2 * eye - P)
    return X, err


def _lu_base(Y: torch.Tensor):
    """Base unpivoted LU (n <= _BASE): L unit-lower, U upper."""
    n = Y.shape[0]
    Y = Y.clone()
    for j in range(n - 1):
        Y[j + 1:, j] /= Y[j, j]
        Y[j + 1:, j + 1:] -= torch.outer(Y[j + 1:, j], Y[j, j + 1:])
    L = torch.tril(Y, -1) + _eye(n, Y)
    U = torch.triu(Y)
    return L, U


def lu_with_inv(Y: torch.Tensor):
    """(L, U, L^{-1}, U^{-1}) of an unpivoted-LU-safe Y in one recursion."""
    n = Y.shape[0]
    if n <= _BASE:
        L, U = _lu_base(Y)
        return L, U, inv_lower(L), inv_upper(U)
    h = n // 2
    L11, U11, L11i, U11i = lu_with_inv(Y[:h, :h])
    U12 = L11i @ Y[:h, h:]
    L21 = Y[h:, :h] @ U11i
    S = Y[h:, h:] - L21 @ U12
    L22, U22, L22i, U22i = lu_with_inv(S)
    zl = torch.zeros((h, n - h), dtype=Y.dtype, device=Y.device)
    zu = torch.zeros((n - h, h), dtype=Y.dtype, device=Y.device)
    Lbot = -(L22i @ L21 @ L11i)
    Utop = -(U11i @ U12 @ U22i)
    return (torch.cat([torch.cat([L11, zl], 1), torch.cat([L21, L22], 1)], 0),
            torch.cat([torch.cat([U11, U12], 1), torch.cat([zu, U22], 1)], 0),
            torch.cat([torch.cat([L11i, zl], 1), torch.cat([Lbot, L22i], 1)], 0),
            torch.cat([torch.cat([U11i, Utop], 1), torch.cat([zu, U22i], 1)], 0))


def chol_with_inv_auto(G: torch.Tensor, config=None):
    """cholesky_with_inv, on the chol_inv kernel when the config allows it
    and G is eligible (the reference's routing, ``smalllinalg.py:148-162``)."""
    from .chol_kernel import chol_with_inv_kernel, supported
    if (config is not None and config.use_kernels and config.use_chol_kernel
            and supported(G.shape, G.dtype)):
        return chol_with_inv_kernel(G)
    return cholesky_with_inv(G)
