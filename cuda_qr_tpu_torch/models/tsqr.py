"""TSQR: tall-skinny QR by binary tree reduction of R factors.

Counterpart of ``cuda_qr_tpu/models/tsqr.py``.  Structure:

  leaves:  split the m axis into L row blocks and factor them all at once
           (Householder on the geqrt kernel's batch grid, or batched
           CholeskyQR2 on the chol_inv kernel's batch grid);
  tree:    pairwise stack [R_i; R_j] (2n x n), factor the stack the same
           way, log2(L) levels;
  Q:       root explicit Q, then push down the tree -- each child's Q is its
           local Q times its n x n slice of the parent's Q.

With ``tsqr_leaf="cholqr2"`` there is no tree at all unless it is needed:
``_cholqr2_direct`` factors the whole matrix in two passes over A and falls
back to the Householder tree when its certificates fail.

Each ``lax.cond`` of the reference is one ``smalllinalg.host_decision``
here (counted in ``host_syncs``): the direct path's Taylor bypass and its
fallback, and the cholqr2 leaf fallback of a tree.

Spans (``utils/profiling.span``): ``entry.tsqr`` around ``tsqr``;
``driver.tsqr_direct`` around each direct attempt (``_cholqr2_direct`` and
the host decision on its certificate, so both of its ``driver.host_sync``
spans nest inside it), in ``tsqr`` and ``tsqr_r``; ``driver.tsqr_leaves``,
``driver.tsqr_level`` and ``driver.tsqr_q`` around the tree's parts.
``direct_fallbacks`` counts the direct attempts whose certificate sent the
call to the Householder tree.

Every GEMM runs at ``config.precision`` through ``ops.gemm.gemm``, but the
direct path's two full-height ones, at the trailing precision.

Complex input keeps its dtype and takes Householder leaves and tree nodes
on the plain geqr2 + larft, whatever ``tsqr_leaf`` says
(``_complex_config``, the reference's routing).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..ops.blocked import as_tensor, complex_config, is_complex
from ..ops.gemm import gemm
from ..ops.chol_kernel import chol_with_inv_auto
from ..ops.geqrt import geqrt_auto
from ..ops.householder import larfb, unpack_r, unpack_v
from ..ops.smalllinalg import eye_like, host_decision
from ..utils.config import DEFAULT_CONFIG, QRConfig
from ..utils.errors import QRShapeError
from ..utils.geometry import ceildiv
from ..utils.profiling import span
from .qr import ThinQRFunction

direct_fallbacks = 0


def _batched_qr(blocks: torch.Tensor, config: QRConfig, pair: bool = False):
    """Householder QR of a batch of (b, n) blocks -> (packed, T, R), tau
    freed before the caller's Q (``pair``: each block is a tree node
    [R_i; R_j] of two upper triangles)."""
    n = blocks.shape[-1]
    packed, _, T = geqrt_auto(blocks, config, pair=pair)
    return packed, T, unpack_r(packed)[..., :n, :]


def _batched_orgqr(packed: torch.Tensor, T: torch.Tensor,
                   precision: str = "highest") -> torch.Tensor:
    """Explicit thin Q (L, b, n) from batched packed factors: larfb of
    I (b x n), whose V^H I is the top n x n block of V^H."""
    n = packed.shape[-1]
    V = unpack_v(packed)
    Q = -gemm(V, gemm(T, V[..., :n, :].mH, precision), precision)
    Q[..., :n, :] += eye_like(n, Q)
    return Q


def _batched_cholqr2(blocks: torch.Tensor, config: QRConfig):
    """CholeskyQR2 of a batch of (b, n) blocks -> (Q (L,b,n), R (L,n,n), emax).

    Two rounds of R = chol(A^T A), Q = A R^{-1}, the triangular solve a GEMM
    against the fused L^-1.  emax is the round-2 Gram defect |Q1^T Q1 - I|:
    above ~0.05 the second round cannot restore O(eps) orthogonality, and
    the Cholesky may stay finite anyway, so callers gate on it.
    """
    prec = config.precision

    def one_round(A):
        G = gemm(A.mT, A, prec)
        Lc, Li = chol_with_inv_auto(G, config)
        return gemm(A, Li.mT, prec), Lc.mT, G          # A L^-T, R upper

    Q1, R1, _ = one_round(blocks)
    Q, R2, G2 = one_round(Q1)
    emax = (G2 - eye_like(blocks.shape[-1], G2)).abs().max()
    return Q, gemm(R2, R1, prec), emax


def _leaf_qr(blocks: torch.Tensor, config: QRConfig, with_q: bool = True,
             pair: bool = False):
    """Leaf (or tree-node) factorization -> (Q (L,b,n), R (L,n,n)) by
    config.tsqr_leaf, falling back to Householder for the whole batch when
    CholeskyQR2 broke down (non-finite output) or silently lost
    orthogonality (round-2 Gram defect above 0.05): one host decision.
    ``with_q=False`` skips the Householder leaves' explicit Q (Q is None).
    ``pair``: the blocks are a tree level's [R_i; R_j] (``_tree_level``)."""
    if config.tsqr_leaf == "cholqr2":
        Q, R, emax = _batched_cholqr2(blocks, config)
        bad = ~torch.isfinite(Q.sum() + R.sum()) | (emax > 0.05)
        if not host_decision(bad):
            return Q, R
    packed, T, R = _batched_qr(blocks, config, pair)
    return (_batched_orgqr(packed, T, config.precision) if with_q else None), R


def _cholqr2_direct(A: torch.Tensor, config: QRConfig, with_q: bool = True):
    """Whole-matrix CholeskyQR2 in two passes over A -> (Q, R, bad).

    Round 1's Gram G = A^T A is the first read; round 2's Gram comes from G
    (G2 = L1i G L1i^T, n x n work), and both triangular solves fuse into one
    GEMM Q = A (L1i^T L2i^T), the second read and only write (skipped for
    ``with_q=False``).  Round 2 takes chol(I + E) ~ I + tril(E, -1) +
    diag(E)/2 when ||E||_max is tiny.  The two full-height GEMMs run at
    ``resolved_trailing_precision()`` (through ``ops.gemm.gemm``: "high"
    is 3xTF32), all n x n math at ``precision``.
    ``bad`` (a 0-d bool tensor) is set on Cholesky breakdown, a large
    round-1 defect, or a cond(A) proxy near cond^2 * eps ~ 1.
    """
    n = A.shape[1]
    gprec, prec = config.resolved_trailing_precision(), config.precision
    eye = eye_like(n, A)
    G = gemm(A.T, A, gprec)                                  # pass 1
    L1, L1i = chol_with_inv_auto(G, config)
    G2 = gemm(gemm(L1i, G, prec), L1i.T, prec)
    E = G2 - eye
    emax = E.abs().max()
    tol = 3e-4 if A.dtype == torch.float32 else 3e-8
    if host_decision(emax < tol):
        C = torch.tril(E, -1) + 0.5 * torch.diag(torch.diagonal(E))
        L2, L2i = eye + C, eye - C
    else:
        L2, L2i = chol_with_inv_auto(E + eye, config)
    Rinv = gemm(L1i.T, L2i.T, prec)
    Q = None
    if with_q:
        Q = gemm(A, Rinv, gprec)                             # pass 2
    R = torch.triu(gemm(L2.T, L1.T, prec))   # exact zeros below the diagonal
    d = torch.diagonal(L1).abs()
    cond_proxy = d.max() / torch.clamp(d.min(), min=1e-30)
    eps = torch.finfo(A.dtype).eps
    bad = (~torch.isfinite(Rinv.sum()) | (emax > 0.3)
           | (cond_proxy * cond_proxy * eps > 0.05))
    return Q, R, bad


def _complex_config(A, config: QRConfig) -> QRConfig:
    """Complex A keeps its dtype and takes Householder leaves with no kernel
    (``cuda_qr_tpu/models/tsqr.py:105-111``); real A keeps ``config``."""
    if is_complex(A):
        return complex_config(A, config).replace(tsqr_leaf="householder")
    return config


def _prepare(A, config: QRConfig):
    """(A as a matrix in the working dtype, the configuration it runs at)."""
    A = as_tensor(A, config)
    if A.dim() != 2:
        raise QRShapeError(f"tsqr needs a matrix, got shape {tuple(A.shape)}")
    config = _complex_config(A, config)
    return A.to(config.dtype), config


def tsqr(A, config: QRConfig = DEFAULT_CONFIG):
    """Thin QR of a tall-skinny A (m x n) via a binary reduction tree.
    Returns (Q (m x n), R (n x n)).

    R carries the TSQR sign ambiguity (each node applies its own reflector
    signs); diag(R) is not forced positive.  With ``tsqr_leaf="cholqr2"``
    the residual is always of float32 grade and ||Q^T Q - I||_F is bounded
    by ~sqrt(m)*eps (the Gram's accumulation error), the guarantee it is
    held to; on well-conditioned input it reads far below that bound (at
    2^20 x 128 N(0,1) on an H100, 2.7-3.0e-6, about 25 eps, against
    sqrt(m)*eps = 1.2e-4; the Householder tree reads 3.7e-6 there).  The
    default Householder leaves give n*eps-class orthogonality at any m.

    Differentiable through the shared thin-QR VJP (``models/qr.py``) for
    real input; complex input takes Householder leaves, not differentiated.
    The call is the span ``entry.tsqr``.
    """
    with span("entry.tsqr"):
        A, config = _prepare(A, config)
        if A.is_complex():
            return _tsqr_impl(A, config)
        return ThinQRFunction.apply(A, config, _tsqr_impl)


def _householder_small(A: torch.Tensor, config: QRConfig, with_q: bool = True):
    """(explicit Q or None, R) of a small matrix (one TSQR block, or the
    stacked R factors of ``parallel/tsqr_dist.py`` and ``polar_dist``):
    geqr2 + larft (``geqrt_auto``), then larfb of I at ``config.precision``."""
    m, n = A.shape
    packed, _, T = geqrt_auto(A, config)
    R = unpack_r(packed)[:n]
    if not with_q:
        return None, R
    return larfb(eye_like(m, A)[:, :n], unpack_v(packed), T, transpose=False,
                 precision=config.precision), R


def _tsqr_impl(A: torch.Tensor, config: QRConfig):
    m, n = A.shape
    if m <= max(config.block_rows, 2 * n):
        return _householder_small(A, config)
    if config.tsqr_leaf == "cholqr2":
        # Direct two-pass CholeskyQR2; the tree only as the fallback for
        # cond(A) >~ 1/sqrt(eps), where Householder leaves are required.
        Q, R = _direct(A, config)
        if R is not None:
            return Q, R
        config = config.replace(tsqr_leaf="householder")
    return _tsqr_tree(A, config)


def _direct(A: torch.Tensor, config: QRConfig, with_q: bool = True):
    """The direct attempt, in the span ``driver.tsqr_direct``: (Q, R) of
    ``_cholqr2_direct``, or (None, None) when its certificate sends the call
    to the tree (counted in ``direct_fallbacks``)."""
    global direct_fallbacks
    with span("driver.tsqr_direct"):
        Q, R, bad = _cholqr2_direct(A, config, with_q)
        if not host_decision(bad):
            return Q, R
    direct_fallbacks += 1
    return None, None


def _blocks(A: torch.Tensor, config: QRConfig) -> torch.Tensor:
    """A zero-padded to L whole blocks of b rows, as (L, b, n)."""
    m, n = A.shape
    b = max(config.block_rows, 2 * n)
    L = ceildiv(m, b)
    return F.pad(A, (0, 0, 0, L * b - m)).reshape(L, b, n)


def _tree_level(R: torch.Tensor) -> torch.Tensor:
    """Sibling R's stacked as (nodes, 2n, n); an odd count is padded with a
    zero R block (QR of zeros is zeros).  Every R is upper triangular with
    exact zeros below (``unpack_r``), so each node is a triangle pair."""
    if R.shape[0] % 2:
        R = torch.cat([R, torch.zeros_like(R[:1])])
    n = R.shape[-1]
    return R.reshape(R.shape[0] // 2, 2 * n, n)


def _tsqr_tree(A: torch.Tensor, config: QRConfig):
    """Binary-reduction-tree TSQR (leaves per config.tsqr_leaf)."""
    m, n = A.shape
    with span("driver.tsqr_leaves"):
        Qleaf, R = _leaf_qr(_blocks(A, config), config)
    L = Qleaf.shape[0]
    levels = []
    while R.shape[0] > 1:
        with span("driver.tsqr_level"):
            Qk, R = _leaf_qr(_tree_level(R), config, pair=True)
        levels.append(Qk)                              # (nodes, 2n, n)
    # Q build-down: root -> leaves.  A padded (phantom) sibling has no
    # parent slice: take only the real nodes' n x n pieces.
    prec = config.precision
    with span("driver.tsqr_q"):
        Qcur = None
        for Qk in reversed(levels):
            if Qcur is not None:
                Qk = gemm(Qk, Qcur[:Qk.shape[0]], prec)
            Qcur = Qk.reshape(Qk.shape[0] * 2, n, n)
        if Qcur is not None:
            Qleaf = gemm(Qleaf, Qcur[:L], prec)
        return Qleaf.reshape(-1, n)[:m], R[0]


def tsqr_r(A, config: QRConfig = DEFAULT_CONFIG) -> torch.Tensor:
    """R-only TSQR (no Q build-down; the direct cholqr2 path skips its Q
    pass): the cheap path for normal-equation style uses."""
    return _tsqr_r_impl(*_prepare(A, config))


def _tsqr_r_impl(A: torch.Tensor, config: QRConfig) -> torch.Tensor:
    m, n = A.shape
    if m <= max(config.block_rows, 2 * n):
        return _householder_small(A, config, with_q=False)[1]
    if config.tsqr_leaf == "cholqr2":
        _, R = _direct(A, config, with_q=False)
        if R is not None:
            return R
        config = config.replace(tsqr_leaf="householder")
    _, R = _leaf_qr(_blocks(A, config), config, with_q=False)
    while R.shape[0] > 1:
        _, R = _leaf_qr(_tree_level(R), config, with_q=False, pair=True)
    return R[0]
