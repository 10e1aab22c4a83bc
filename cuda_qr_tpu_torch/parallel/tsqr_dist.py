"""Distributed TSQR over the row mesh (``cuda_qr_tpu/parallel/tsqr_dist.py``).

Each rank runs this package's TSQR (``models/tsqr.py``) on its row block:
Householder leaves and tree nodes on the geqrt kernel's batch grid, or
batched CholeskyQR2 leaves on the chol_inv kernel with
``tsqr_leaf="cholqr2"``.  The n x n R factors are then combined across the
ranks, and the thin Q is recovered by one n x n GEMM per rank:

  "allgather": every rank gathers all P R factors and factors the P*n x n
               stack redundantly (one round, unconditionally stable);
  "butterfly": log2(P) rounds of pairwise R exchange (ppermute), each rank
               factoring a 2n x n stack per round (power-of-two P only);
  "cholesky":  CholeskyQR2 on the all-reduced Gram of the R factors (two
               n x n all_reduces), falling back to "allgather" when it
               breaks down; the fallback is one rank-uniform decision.

Only n x n triangles cross between ranks; every GEMM is rank-local.
Complex input runs "allgather" and "butterfly" on Householder leaves and
nodes at its own dtype; "cholesky" is real-only, as in the reference.
"""

from __future__ import annotations

import torch
from torch.distributed.device_mesh import DeviceMesh

from ..models.tsqr import _complex_config, _geqrt, tsqr as tsqr_local
from ..ops.blocked import is_complex
from ..ops.householder import larfb, unpack_r, unpack_v
from ..ops.smalllinalg import _eye, cholesky_with_inv
from ..utils.config import DEFAULT_CONFIG, QRConfig, matmul_precision
from .collectives import agree, all_gather, coord, ppermute, psum
from .mesh import as_row_sharded, shard_rows

STRATEGIES = ("allgather", "butterfly", "cholesky")


def _small_qr_q(stacked: torch.Tensor, config: QRConfig):
    """Explicit (rows x n) Q and (n x n) R of a small stacked matrix: one
    geqrt (the geqrt kernel where it is eligible) and a larfb of I."""
    rows, n = stacked.shape
    packed, _, T = _geqrt(stacked, config)
    Q = larfb(_eye(rows, stacked)[:, :n], unpack_v(packed), T, transpose=False)
    return Q, unpack_r(packed)[:n]


def _cholesky_combine(R_l: torch.Tensor, mesh: DeviceMesh):
    """(mine, R, bad): CholeskyQR2 of the all-reduced Gram of the local R
    factors.  Two n x n all_reduces; each rank's n x n map ``mine``
    satisfies R_l = mine @ R with the stacked ``mine`` orthonormal.  ``bad``
    is a 0-d bool tensor of this rank's view."""
    n = R_l.shape[1]
    eye = _eye(n, R_l)
    G = psum(R_l.T @ R_l, mesh)
    L1, L1i = cholesky_with_inv(G)
    M0 = R_l @ L1i.T
    G2 = psum(M0.T @ M0, mesh)
    E = G2 - eye
    emax = E.abs().max()
    tol = 3e-4 if R_l.dtype == torch.float32 else 3e-8
    if agree(emax < tol, mesh):
        C = torch.tril(E, -1) + 0.5 * torch.diag(torch.diagonal(E))
        L2, L2i = eye + C, eye - C
    else:
        L2, L2i = cholesky_with_inv(E + eye)
    mine = M0 @ L2i.T
    R = L2.T @ L1.T
    bad = ~torch.isfinite(mine.sum()) | (emax > 0.3)
    return mine, torch.triu(R), bad


def _gathered_combine(R_l: torch.Tensor, mesh: DeviceMesh, config: QRConfig):
    """(mine, R) of the "allgather" strategy."""
    n, P = R_l.shape[1], mesh.size(0)
    Rs = all_gather(R_l, mesh)                          # (P, n, n)
    Qhat, R = _small_qr_q(Rs.reshape(P * n, n), config)
    i = coord(mesh)
    return Qhat[i * n:(i + 1) * n], R


def _butterfly_combine(R_l: torch.Tensor, mesh: DeviceMesh, config: QRConfig):
    """(mine, R) of the "butterfly" strategy."""
    n, P, i = R_l.shape[1], mesh.size(0), coord(mesh)
    mine, R = _eye(n, R_l), R_l
    step = 1
    while step < P:
        other = ppermute(R, mesh, [(s, s ^ step) for s in range(P)])
        first = (i & step) == 0          # do I supply the top block?
        top, bot = (R, other) if first else (other, R)
        Qp, R = _small_qr_q(torch.cat([top, bot]), config)
        mine = mine @ (Qp[:n] if first else Qp[n:])
        step *= 2
    return mine, R


def _tsqr_dist_local(a: torch.Tensor, mesh: DeviceMesh, config: QRConfig,
                     strategy: str):
    """(this rank's rows of Q, R replicated) for this rank's rows ``a``."""
    Q_l, R_l = tsqr_local(a, config)
    with matmul_precision(config.precision):
        if strategy == "cholesky":
            mine, R, bad = _cholesky_combine(R_l, mesh)
            if agree(bad, mesh):
                mine, R = _gathered_combine(R_l, mesh, config)
        elif strategy == "allgather":
            mine, R = _gathered_combine(R_l, mesh, config)
        else:
            mine, R = _butterfly_combine(R_l, mesh, config)
        return Q_l @ mine, R


def _check(strategy: str, m: int, P: int, complex_input: bool = False) -> None:
    if strategy not in STRATEGIES:
        raise ValueError(f"unknown strategy {strategy!r}")
    if m % P:
        raise ValueError(f"m={m} must divide the mesh ({P} shards)")
    if strategy == "cholesky" and complex_input:
        # _cholesky_combine's Grams are real-only; the Householder combines
        # are conjugation-correct throughout.
        raise ValueError("strategy='cholesky' is real-only; use 'allgather' or "
                         "'butterfly' for complex input")
    if strategy == "butterfly" and (P & (P - 1)) != 0:
        # s ^ step would address partners >= P: a wrong factorization.
        raise ValueError(f"butterfly strategy needs a power-of-two shard count, got {P};"
                         " use strategy='allgather'")


def tsqr_dist(A, mesh: DeviceMesh, config: QRConfig = DEFAULT_CONFIG,
              strategy: str = "allgather"):
    """Thin QR of a row-sharded tall-skinny A, called by every rank.
    Returns (Q, a row-sharded DTensor like A; R, replicated).

    A: a row-sharded DTensor, or the full matrix on every rank (tensor or
    numpy).  Strategies as in the module docstring; complex input takes
    "allgather" or "butterfly".
    """
    _check(strategy, A.shape[0], mesh.size(0), is_complex(A))
    a, m = shard_rows(A, mesh)
    config = _complex_config(a, config)
    Q, R = _tsqr_dist_local(a.to(config.dtype), mesh, config, strategy)
    return as_row_sharded(Q, mesh, m), R
