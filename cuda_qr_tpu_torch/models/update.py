"""QR factorization updating: rank-1 update, row/column insert and delete.

Counterpart of ``cuda_qr_tpu/models/update.py``: given a thin
factorization A = Q R (Q m x n orthonormal columns, R n x n upper
triangular), produce the factorization of a modified A in O(mn + n^2) work
instead of the O(mn^2) refactor, by Givens-rotation chains (Golub & Van
Loan 12.5; Bjorck 3.2).

Each chain is a Python loop over int indices; the rotation coefficients
stay 0-d tensors on the factors' device, so a chain takes no host sync
(entries are set with ``fill_``/``zero_``: assigning a Python number to an
element of a CUDA tensor synchronizes).  It
is launch-bound on a GPU (a few launches per rotation), so updating beats
refactoring only while the chain is shorter than the refactor: callers
choose by measurement.  Every function returns new tensors and leaves its
inputs unchanged.  Complex factors follow LAPACK's clartg convention, as
the reference's: G = [[c, -s], [conj(s), c]] with real c, applied as
M <- G M and Q <- Q G^H; ``qr_rank1_update`` computes A + u v^H
(scipy.linalg.qr_update's convention; v^H = v^T for real v).

GEMM precision: the projections onto span(Q) run at the ``precision`` the
function takes, as the reference's; the rotations are exact float32 products
in the reference (elementwise), so their 2 x 2 GEMMs run at "highest"
whatever the caller's TF32 state.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..ops.gemm import gemm


def _givens(a: torch.Tensor, b: torch.Tensor):
    """(c, s, r) with G @ [a, b] = [r, 0] for G = [[c, -s], [conj(s), c]],
    c real.  Safe at a = b = 0 (the identity, r = a).

    Real: c = a/r, s = -b/r, r = hypot(a, b) >= 0.  Complex (clartg):
    c = |a|/h, s = -(a/|a|) conj(b)/h, r = (a/|a|) h with
    h = sqrt(|a|^2 + |b|^2), so r carries a's phase.
    """
    if not (a.is_complex() or b.is_complex()):
        r = torch.hypot(a, b)
        safe = r > 0
        rs = torch.where(safe, r, 1.0)
        c = torch.where(safe, a / rs, 1.0)
        s = torch.where(safe, -b / rs, 0.0)
        return c, s, torch.where(safe, r, a)
    absa = a.abs()
    h = torch.sqrt(absa * absa + b.abs() ** 2)
    safe = h > 0
    hs = torch.where(safe, h, 1.0)
    siga = torch.where(absa > 0, a / torch.where(absa > 0, absa, 1.0), 1.0)
    c = torch.where(safe, absa / hs, 1.0)                          # real
    s = torch.where(safe, -siga * b.conj() / hs, 0.0)
    return c, s, torch.where(safe, siga * h, a)


def _rotate(M: torch.Tensor, Q: torch.Tensor, i: int, j: int, c, s) -> None:
    """In place: rows (i, j) of M <- G [M_i; M_j] and columns (i, j) of Q
    <- [Q_i, Q_j] G^H, for G = [[c, -s], [conj(s), c]]."""
    G = torch.stack([c.to(s.dtype), -s, s.conj(), c.to(s.dtype)]).reshape(2, 2)
    rows = gemm(G, torch.stack([M[i], M[j]]), "highest")
    M[i], M[j] = rows[0], rows[1]
    cols = gemm(torch.stack([Q[:, i], Q[:, j]], 1), G.mH, "highest")
    Q[:, i], Q[:, j] = cols[:, 0], cols[:, 1]


def _orthogonal_complement(Q: torch.Tensor, u: torch.Tensor, precision: str):
    """(q, Q^H u, rho): q is the unit residual of u against span(Q) (zero
    when u already lies in the span -- the chains then never mix the dead
    column in, because its Givens weight is zero), rho its norm (real); the
    two products at ``precision``."""
    w = gemm(Q.mH, u, precision)
    r = u - gemm(Q, w, precision)
    rho = torch.linalg.norm(r)
    safe = rho > 0
    q = torch.where(safe, r / torch.where(safe, rho, 1.0), 0.0)
    return q, w, torch.where(safe, rho, 0.0)


def qr_rank1_update(Q: torch.Tensor, R: torch.Tensor, u: torch.Tensor,
                    v: torch.Tensor, precision: str = "highest"):
    """Thin QR of A + u v^H from the thin QR of A (m x n, m >= n).

    With w = Q^H u, q the unit residual and rho its norm,
    A + u v^H = [Q q] ([[R], [0]] + [w; rho] v^H).  A bottom-up Givens
    chain maps [w; rho] to tau e_0 and [[R], [0]] to upper Hessenberg;
    adding (tau e_0) v^H touches row 0 only; a top-down chain restores
    triangularity.  2n rotations.
    """
    m, n = Q.shape
    q, w, rho = _orthogonal_complement(Q, u.to(Q.dtype), precision)
    Q1 = torch.cat([Q, q[:, None]], 1)
    M = torch.cat([R, R.new_zeros(1, n)], 0)
    we = torch.cat([w, rho.to(w.dtype)[None]])
    for i in range(n - 1, -1, -1):
        c, s, r = _givens(we[i], we[i + 1])
        we[i] = r
        we[i + 1].zero_()
        _rotate(M, Q1, i, i + 1, c, s)
    M[0] += we[0] * v.to(M.dtype).conj()
    for i in range(n):
        c, s, _ = _givens(M[i, i], M[i + 1, i])
        _rotate(M, Q1, i, i + 1, c, s)
    return Q1[:, :n], torch.triu(M[:n])


def qr_update(Q: torch.Tensor, R: torch.Tensor, u: torch.Tensor,
              v: torch.Tensor, precision: str = "highest"):
    """Thin QR of A + u v^H (rank 1) or A + U V^H (rank k, U (m, k),
    V (n, k)), as k sequential rank-1 chains."""
    if u.dim() == 1:
        return qr_rank1_update(Q, R, u, v, precision)
    if u.dim() != 2 or v.dim() != 2 or u.shape[1] != v.shape[1]:
        raise ValueError(f"rank-k update needs U (m, k), V (n, k); got "
                         f"{tuple(u.shape)} {tuple(v.shape)}")
    for i in range(u.shape[1]):
        Q, R = qr_rank1_update(Q, R, u[:, i], v[:, i], precision)
    return Q, R


def qr_row_insert(Q: torch.Tensor, R: torch.Tensor, a: torch.Tensor,
                  k: int | None = None):
    """Thin QR of A with row ``a`` inserted before row k (default: appended).

    Append first -- [[A], [a]] = diag(Q, 1) @ [[R], [a]] -- then one
    left-to-right chain folds the bottom row into R (n rotations); the
    insertion position only permutes rows of Q afterwards.
    """
    m, n = Q.shape
    if k is None:
        k = m
    Q1 = F.pad(Q, (0, 1, 0, 1))
    Q1[m, n].fill_(1)
    M = torch.cat([R, a.to(R.dtype)[None]], 0)
    for i in range(n):
        c, s, _ = _givens(M[i, i], M[n, i])
        _rotate(M, Q1, i, n, c, s)
    Qn = Q1[:, :n]
    return torch.cat([Qn[:k], Qn[m:], Qn[k:m]]), torch.triu(M[:n])


def qr_row_delete(Q: torch.Tensor, R: torch.Tensor, k: int,
                  precision: str = "highest"):
    """Thin QR of A with row k removed (downdating); requires m > n.

    Bjorck 3.2.4: extend Q with the unit residual of e_k (so the extended
    row k is [q, gamma] with unit norm); a right-to-left chain rotates that
    row onto e_n, after which column n of the rotated basis is exactly e_k,
    row k of the shrunken Q is zero, and dropping both leaves the
    orthonormal factor of the deleted-row matrix.
    """
    m, n = Q.shape
    if m <= n:
        raise ValueError(f"row_delete needs m > n (thin QR after deletion), got {m}x{n}")
    ek = Q.new_zeros(m)
    ek[k].fill_(1)
    w, q, _ = _orthogonal_complement(Q, ek, precision)
    Qe = torch.cat([Q, w[:, None]], 1)
    M = torch.cat([R, R.new_zeros(1, n)], 0)
    # gamma^2 = 1 - ||q||^2, real also for complex Q (Bjorck)
    gamma = torch.sqrt(torch.clamp(1 - torch.sum((q * q.conj()).real), min=0))
    qe = torch.cat([q, gamma.to(q.dtype)[None]])
    for i in range(n - 1, -1, -1):
        c, s, r = _givens(qe[n], qe[i])
        qe[n] = r
        qe[i].zero_()
        _rotate(M, Qe, n, i, c, s)
    return torch.cat([Qe[:k, :n], Qe[k + 1:, :n]]), torch.triu(M[:n])


def qr_col_insert(Q: torch.Tensor, R: torch.Tensor, a: torch.Tensor, k: int,
                  precision: str = "highest"):
    """Thin QR of A with column ``a`` inserted before column k; needs m > n.

    The new column contributes [Q^H a; rho] in the extended basis; columns
    right of k are upper Hessenberg after the shift, and one bottom-up chain
    of n - k rotations on column k restores triangularity for all of them.
    """
    m, n = Q.shape
    if m <= n:
        raise ValueError(f"col_insert needs m > n to extend the basis, got {m}x{n}")
    q, w, rho = _orthogonal_complement(Q, a.to(Q.dtype), precision)
    Q1 = torch.cat([Q, q[:, None]], 1)
    Rp = F.pad(R, (0, 0, 0, 1))
    newcol = torch.cat([w, rho.to(w.dtype)[None]])[:, None]
    M = torch.cat([Rp[:, :k], newcol, Rp[:, k:]], 1)
    for i in range(n - 1, k - 1, -1):
        c, s, _ = _givens(M[i, k], M[i + 1, k])
        _rotate(M, Q1, i, i + 1, c, s)
    return Q1, torch.triu(M)


def qr_col_delete(Q: torch.Tensor, R: torch.Tensor, k: int):
    """Thin QR of A with column k removed.

    Dropping column k of R leaves an upper Hessenberg matrix in columns
    k..n-2; one left-to-right chain of n - 1 - k rotations
    re-triangularizes, and the last column/row pair of the factors falls
    away.
    """
    n = Q.shape[1]
    M = torch.cat([R[:, :k], R[:, k + 1:]], 1)
    Q = Q.clone()
    for j in range(k, n - 1):
        c, s, _ = _givens(M[j, j], M[j + 1, j])
        _rotate(M, Q, j, j + 1, c, s)
    return Q[:, :n - 1], torch.triu(M[:n - 1])
