"""Householder reflectors and compact-WY accumulation (plain PyTorch).

Counterpart of ``cuda_qr_tpu/ops/householder.py``, with the same
conventions so factors compare one to one.  Real dtypes:
    sign  = -1 if x0 < 0 else +1
    u     = x0 + sign * ||x||
    tau   = sign * u / ||x||
    beta  = -sign * ||x||          (stored R diagonal entry)
    tail  = x_tail / u             (stored below the diagonal; v0 == 1 implicit)
    H     = I - tau v v^T
The norm is scaled by max|x| (overflow guard) and a zero column gives
tau = 0, H = I.  T is the LAPACK-forward factor: H_0 ... H_{k-1} = I - V T V^H.

Complex dtypes follow LAPACK clarfg/cgeqr2: beta real, tau complex,
H = I - tau v v^H, and the factorization applies H^H.  Every transpose that
complex input can reach is the conjugate one (``.mH``, ``.conj()``), which
for a real tensor is the plain transpose (the same view), so real results
are unchanged bit for bit.

GEMM precision is not an argument here: callers set it around the calls
(``utils.config.matmul_precision``).
"""

from __future__ import annotations

import torch


def vecmat(v: torch.Tensor, M: torch.Tensor) -> torch.Tensor:
    """v^T M (no conjugation) over leading batch dims: v (..., k), M (..., k, n) -> (..., n).

    The unbatched case stays a 1-D product, so its rounding is that of the
    2-D code."""
    if v.dim() == 1 and M.dim() == 2:
        return v @ M
    return (v.unsqueeze(-2) @ M).squeeze(-2)


def matvec(M: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """M v over leading batch dims: M (..., m, k), v (..., k) -> (..., m)."""
    if v.dim() == 1 and M.dim() == 2:
        return M @ v
    return (M @ v.unsqueeze(-1)).squeeze(-1)


def make_reflector(col: torch.Tensor, d: int):
    """Householder reflector for rows >= d of ``col`` (..., m).

    Returns (v, tau, beta): full-length v with v[d] == 1 and zeros above d,
    tau and beta (the new diagonal entry) of the leading shape (0-d for one
    column).  Complex input takes the clarfg convention
    (``_make_reflector_complex``)."""
    if col.is_complex():
        return _make_reflector_complex(col, d)
    x0 = col[..., d]
    tail = col[..., d + 1:]
    scale = col[..., d:].abs().amax(-1)
    s = torch.where(scale > 0, scale, torch.ones_like(scale))
    ts = tail / s[..., None]
    x0s = x0 / s
    norm = torch.sqrt(x0s * x0s + torch.sum(ts * ts, -1)) * s
    one = torch.ones_like(x0)
    sign = torch.where(x0 < 0, -one, one)
    u = x0 + sign * norm
    degenerate = norm <= 0                     # zero column => H = I
    safe_norm = torch.where(degenerate, one, norm)
    safe_u = torch.where(degenerate, one, u)
    tau = torch.where(degenerate, torch.zeros_like(x0), sign * u / safe_norm)
    beta = torch.where(degenerate, x0, -sign * norm)
    v = torch.zeros_like(col)
    v[..., d] = 1
    v[..., d + 1:] = torch.where(degenerate[..., None], torch.zeros_like(tail),
                                 tail / safe_u[..., None])
    return v, tau, beta


def _make_reflector_complex(col: torch.Tensor, d: int):
    """clarfg-convention reflector (``cuda_qr_tpu/ops/householder.py:117-136``):
    beta = -sign(Re x0) ||x|| is real, tau = (beta - x0) / beta,
    v = tail / (x0 - beta), and H = I - tau v v^H satisfies H^H x = beta e_d.
    A zero tail with a real x0 is degenerate: tau = 0, H = I, beta = x0."""
    x0 = col[..., d]
    tail = col[..., d + 1:]
    scale = col[..., d:].abs().amax(-1)
    s = torch.where(scale > 0, scale, torch.ones_like(scale))
    ts = tail / s[..., None]
    x0s = x0 / s
    norm = torch.sqrt(x0s.abs() ** 2 + torch.sum((ts * ts.conj()).real, -1)) * s
    one = torch.ones_like(norm)
    sign = torch.where(x0.real < 0, -one, one)
    beta = -sign * norm
    degenerate = (norm <= 0) | ((ts.abs().sum(-1) <= 0) & (x0.imag == 0))
    safe_beta = torch.where(degenerate, one, beta).to(col.dtype)
    tau = torch.where(degenerate, torch.zeros_like(x0), (safe_beta - x0) / safe_beta)
    denom = torch.where(degenerate, torch.ones_like(x0), x0 - safe_beta)
    v = torch.zeros_like(col)
    v[..., d] = 1
    v[..., d + 1:] = torch.where(degenerate[..., None], torch.zeros_like(tail),
                                 tail / denom[..., None])
    return v, tau, torch.where(degenerate, x0, beta.to(col.dtype))


def geqr2(A: torch.Tensor, row_offset: int = 0):
    """Unblocked Householder QR of rows >= row_offset of A (..., m, n).

    Column j is reduced over rows >= row_offset + j; rows above row_offset
    are untouched.  Returns (packed, tau): R on/above the shifted diagonal,
    reflector tails below, one tau per column.  A is not modified.  Leading
    dimensions are a batch, reduced column by column all at once.  Each
    column applies H^H = I - conj(tau) v v^H (H itself for real input).
    """
    A = A.clone()
    m, n = A.shape[-2:]
    tau = torch.zeros(A.shape[:-2] + (n,), dtype=A.dtype, device=A.device)
    for j in range(n):
        d = row_offset + j
        if d >= m:
            break   # dead column: tau = 0 / H = I, as the zero-norm guard gives
        v, tj, beta = make_reflector(A[..., :, j], d)
        vl = v[..., d:]
        if j + 1 < n:
            w = tj.conj()[..., None] * vecmat(vl.conj(), A[..., d:, j + 1:])
            A[..., d:, j + 1:] -= vl[..., :, None] * w[..., None, :]
        A[..., d, j] = beta
        A[..., d + 1:, j] = vl[..., 1:]
        tau[..., j] = tj
    return A, tau


def unpack_v(packed: torch.Tensor, row_offset: int = 0) -> torch.Tensor:
    """Full V (unit diagonal at row c + row_offset, zeros above) from packed
    storage (..., m, n)."""
    m, n = packed.shape[-2:]
    r = torch.arange(m, device=packed.device)[:, None]
    d = torch.arange(n, device=packed.device)[None, :] + row_offset
    return torch.where(r > d, packed, (r == d).to(packed.dtype))


def unpack_r(packed: torch.Tensor, row_offset: int = 0) -> torch.Tensor:
    m, n = packed.shape[-2:]
    r = torch.arange(m, device=packed.device)[:, None]
    c = torch.arange(n, device=packed.device)[None, :]
    return torch.where(r <= c + row_offset, packed, torch.zeros_like(packed))


def larft(V: torch.Tensor, tau: torch.Tensor) -> torch.Tensor:
    """Forward compact-WY T: Q = I - V T V^H, T upper triangular.

    T[:j, j] = -tau_j T[:j, :j] (V[:, :j]^H v_j), T[j, j] = tau_j, with the
    Gram matrix V^H V formed once.  V (..., m, n), tau (..., n)."""
    n = V.shape[-1]
    G = V.mH @ V
    T = torch.zeros(V.shape[:-2] + (n, n), dtype=V.dtype, device=V.device)
    for j in range(n):
        if j:
            T[..., :j, j] = -tau[..., j, None] * matvec(T[..., :j, :j], G[..., :j, j])
        T[..., j, j] = tau[..., j]
    return T


def larfb(B: torch.Tensor, V: torch.Tensor, T: torch.Tensor,
          transpose: bool = True) -> torch.Tensor:
    """Q^H B (transpose=True) or Q B for Q = I - V T V^H (batch-aware):
    B - V T^H (V^H B) or B - V T (V^H B)."""
    W = V.mH @ B
    W = (T.mH if transpose else T) @ W
    return B - V @ W


def merge_wy(V1: torch.Tensor, T1: torch.Tensor, V2: torch.Tensor,
             T2: torch.Tensor) -> torch.Tensor:
    """T of (I - V1 T1 V1^H)(I - V2 T2 V2^H) = I - [V1 V2] T [V1 V2]^H:
        T = [[T1, -T1 (V1^H V2) T2], [0, T2]]."""
    T12 = -(T1 @ ((V1.mH @ V2) @ T2))
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
