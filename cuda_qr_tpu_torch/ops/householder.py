"""Householder reflectors and compact-WY accumulation (plain PyTorch).

Counterpart of ``cuda_qr_tpu/ops/householder.py``, real dtypes only, with
the same conventions so factors compare one to one:
    sign  = -1 if x0 < 0 else +1
    u     = x0 + sign * ||x||
    tau   = sign * u / ||x||
    beta  = -sign * ||x||          (stored R diagonal entry)
    tail  = x_tail / u             (stored below the diagonal; v0 == 1 implicit)
    H     = I - tau v v^T
The norm is scaled by max|x| (overflow guard) and a zero column gives
tau = 0, H = I.  T is the LAPACK-forward factor: H_0 ... H_{k-1} = I - V T V^T.

GEMM precision is not an argument here: callers set it around the calls
(``utils.config.matmul_precision``).
"""

from __future__ import annotations

import torch


def make_reflector(col: torch.Tensor, d: int):
    """Householder reflector for rows >= d of ``col`` (m,).

    Returns (v, tau, beta): full-length v with v[d] == 1 and zeros above d,
    0-d tensors tau and beta (the new diagonal entry)."""
    x0 = col[d]
    tail = col[d + 1:]
    scale = col[d:].abs().max()
    s = torch.where(scale > 0, scale, torch.ones_like(scale))
    ts = tail / s
    x0s = x0 / s
    norm = torch.sqrt(x0s * x0s + torch.sum(ts * ts)) * s
    one = torch.ones_like(x0)
    sign = torch.where(x0 < 0, -one, one)
    u = x0 + sign * norm
    degenerate = norm <= 0                     # zero column => H = I
    safe_norm = torch.where(degenerate, one, norm)
    safe_u = torch.where(degenerate, one, u)
    tau = torch.where(degenerate, torch.zeros_like(x0), sign * u / safe_norm)
    beta = torch.where(degenerate, x0, -sign * norm)
    v = torch.zeros_like(col)
    v[d] = 1
    v[d + 1:] = torch.where(degenerate, torch.zeros_like(tail), tail / safe_u)
    return v, tau, beta


def geqr2(A: torch.Tensor, row_offset: int = 0):
    """Unblocked Householder QR of rows >= row_offset of A (m x n).

    Column j is reduced over rows >= row_offset + j; rows above row_offset
    are untouched.  Returns (packed, tau): R on/above the shifted diagonal,
    reflector tails below, one tau per column.  A is not modified.
    """
    A = A.clone()
    m, n = A.shape
    tau = torch.zeros(n, dtype=A.dtype, device=A.device)
    for j in range(n):
        d = row_offset + j
        if d >= m:
            break   # dead column: tau = 0 / H = I, as the zero-norm guard gives
        v, tj, beta = make_reflector(A[:, j], d)
        vl = v[d:]
        if j + 1 < n:
            w = tj * (vl @ A[d:, j + 1:])
            A[d:, j + 1:] -= torch.outer(vl, w)
        A[d, j] = beta
        A[d + 1:, j] = vl[1:]
        tau[j] = tj
    return A, tau


def unpack_v(packed: torch.Tensor, row_offset: int = 0) -> torch.Tensor:
    """Full V (unit diagonal at row c + row_offset, zeros above) from packed
    storage."""
    m, n = packed.shape
    r = torch.arange(m, device=packed.device)[:, None]
    d = torch.arange(n, device=packed.device)[None, :] + row_offset
    return torch.where(r > d, packed, (r == d).to(packed.dtype))


def unpack_r(packed: torch.Tensor, row_offset: int = 0) -> torch.Tensor:
    m, n = packed.shape
    r = torch.arange(m, device=packed.device)[:, None]
    c = torch.arange(n, device=packed.device)[None, :]
    return torch.where(r <= c + row_offset, packed, torch.zeros_like(packed))


def larft(V: torch.Tensor, tau: torch.Tensor) -> torch.Tensor:
    """Forward compact-WY T: Q = I - V T V^T, T upper triangular.

    T[:j, j] = -tau_j T[:j, :j] (V[:, :j]^T v_j), T[j, j] = tau_j, with the
    Gram matrix V^T V formed once."""
    n = V.shape[1]
    G = V.T @ V
    T = torch.zeros((n, n), dtype=V.dtype, device=V.device)
    for j in range(n):
        if j:
            T[:j, j] = -tau[j] * (T[:j, :j] @ G[:j, j])
        T[j, j] = tau[j]
    return T


def larfb(B: torch.Tensor, V: torch.Tensor, T: torch.Tensor,
          transpose: bool = True) -> torch.Tensor:
    """Q^T B (transpose=True) or Q B for Q = I - V T V^T."""
    W = V.T @ B
    W = (T.T if transpose else T) @ W
    return B - V @ W


def merge_wy(V1: torch.Tensor, T1: torch.Tensor, V2: torch.Tensor,
             T2: torch.Tensor) -> torch.Tensor:
    """T of (I - V1 T1 V1^T)(I - V2 T2 V2^T) = I - [V1 V2] T [V1 V2]^T:
        T = [[T1, -T1 (V1^T V2) T2], [0, T2]]."""
    T12 = -(T1 @ ((V1.T @ V2) @ T2))
    z = torch.zeros((T2.shape[0], T1.shape[0]), dtype=T1.dtype, device=T1.device)
    return torch.cat([torch.cat([T1, T12], 1), torch.cat([z, T2], 1)], 0)


def panel_v(packed: torch.Tensor, off: int, VJ: torch.Tensor) -> torch.Tensor:
    """Full V (m x nb) of one panel: zero above ``off``, the panel's diagonal
    block ``VJ`` at rows [off, off+nb), packed storage below.  Requires
    off + nb <= m."""
    nb = packed.shape[1]
    V = torch.zeros_like(packed)
    V[off:off + nb] = VJ.to(packed.dtype)
    V[off + nb:] = packed[off + nb:]
    return V


def unit_vj(packed: torch.Tensor, off: int, nb: int) -> torch.Tensor:
    """Unit-lower diagonal V block of a LAPACK-packed panel."""
    blockJ = packed[off:off + nb, :nb]
    return torch.tril(blockJ, -1) + torch.eye(nb, dtype=packed.dtype,
                                              device=packed.device)
