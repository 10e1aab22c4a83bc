"""Distributed CAQR: communication-avoiding QR of a row-sharded matrix
(``cuda_qr_tpu/parallel/caqr.py``).

Each column panel is factored TSQR-style across the ranks:

  1. every rank reduces its live rows of the panel with local Householder
     reflectors: one geqrt kernel launch on the panel's column slice, read
     in place, from the rank's row offset (a host number here; the
     reference's offset is traced, so it runs a masked geqr2);
  2. the per-rank nb x nb R blocks are combined across the ranks;
  3. the trailing matrix gets the local update rank-locally (larfb) and the
     combined update on the nb-row strips.

Two combines.  "bk" (default): CholeskyQR2 on the all-reduced Gram of the
R blocks (two nb x nb all_reduces) and the tree transform in basis-kernel
form G = I - Y N Y^T, so a trailing block costs one all_reduce of nb x w;
a Cholesky breakdown falls back to an explicit stacked Householder QR.
"allgather": all P R blocks and strips are gathered, rotated so the
diagonal-owning rank sits in slot 0, and the P*nb x nb stack is factored
redundantly on every rank.  The stacked QRs run on the geqrt kernel too.

A dead rank (every row above the panel's diagonal) launches nothing: its
tau, T, R block and strip are zeros, and it still joins every collective.
Every data-dependent branch is one rank-uniform decision
(``collectives.agree``).

The Q operator is kept in two-level form: per-rank packed V/T (leaf level)
plus per-panel tree factors; ``caqr_orgqr`` forms the thin Q and
``caqr_ormqr`` applies Q or Q^H to a row-sharded B.

Complex input needs the "allgather" combine and a complex config dtype
(``models.caqr`` routes both): the "bk" combine's CholeskyQR2 takes real
Grams, as in the reference.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
from torch.distributed.device_mesh import DeviceMesh

from ..models.tsqr import _geqrt
from ..ops.blocked import is_complex
from ..ops.householder import larfb, unpack_v
from ..ops.smalllinalg import _eye, lu_with_inv
from ..utils.config import DEFAULT_CONFIG, QRConfig, matmul_precision
from ..utils.errors import QRShapeError
from ..utils.geometry import ceildiv
from .collectives import agree, all_gather, coord, psum
from .mesh import as_row_sharded, shard_rows
from .tsqr_dist import _cholesky_combine, _gathered_combine

COMBINES = ("bk", "allgather")
LAYOUTS = ("block", "cyclic")


class CAQRFactors(NamedTuple):
    """Two-level packed CAQR factors ("allgather" combine).

    local_packed: (m, n)        row-sharded leaf V/R (packed, per rank)
    local_taus:   (P, k, nb)    leaf taus, leading axis sharded
    local_Ts:     (P, k, nb, nb)
    tree_packed:  (k, P*nb, nb) replicated stacked-QR factors per panel
    tree_Ts:      (k, nb, nb)
    """
    local_packed: torch.Tensor
    local_taus: torch.Tensor
    local_Ts: torch.Tensor
    tree_packed: torch.Tensor
    tree_Ts: torch.Tensor


class CAQRFactorsBK(NamedTuple):
    """Two-level CAQR factors with the tree Q in compact kernel form
    ("bk" combine): per panel G = I - Y N Y^T with G E_owner S = M, where M
    (stacked over ranks) is the orthonormal map stacked_R = M R_final.

    local_packed: (m, n)         row-sharded leaf V/R
    local_taus:   (P, k, nb)
    local_Ts:     (P, k, nb, nb)
    Ys:           (P, k, nb, nb) Y_i per rank, leading axis sharded
    signs:        (k, nb)        per-panel sign vector S (replicated)
    Ns:           (k, nb, nb)    per-panel compact-WY T of G
    """
    local_packed: torch.Tensor
    local_taus: torch.Tensor
    local_Ts: torch.Tensor
    Ys: torch.Tensor
    signs: torch.Tensor
    Ns: torch.Tensor


def _roll_to_owner(gathered: torch.Tensor, owner: int) -> torch.Tensor:
    """(P, nb, x) gathered blocks -> (P*nb, x) stack with the owner in slot 0."""
    rolled = torch.cat([gathered[owner:], gathered[:owner]], 0)
    return rolled.reshape(-1, gathered.shape[2])


def _layout_fns(layout: str, nb: int, mloc: int, P: int):
    """(owner_of_panel, offset_of_rank) for a row distribution, as host ints.

    "block":  rank i owns contiguous global rows [i*mloc, (i+1)*mloc); its
              live local rows for panel k start at clip(k*nb - i*mloc).
    "cyclic": nb-row blocks dealt round-robin (global block g on rank g % P
              at local block g // P), the ScaLAPACK-style layout of
              BASELINE config 5.  Live blocks for panel k are g >= k, a
              contiguous local suffix, so both layouts share the offset
              machinery; cyclic keeps every rank busy until the last P
              panels.
    """
    if layout == "block":
        def owner(kk):
            return (kk * nb) // mloc

        def offset(i, kk):
            return min(max(kk * nb - i * mloc, 0), mloc)
    elif layout == "cyclic":
        def owner(kk):
            return kk % P

        def offset(i, kk):
            return min(max(kk - i + P - 1, 0) // P * nb, mloc)
    else:
        raise ValueError(f"unknown layout {layout!r}")
    return owner, offset


def cyclic_permutation(m: int, nb: int, P: int):
    """Global-row permutation mapping logical rows to the cyclic layout's
    storage order, and its inverse: the storage position of global block g
    is (g % P) * (blocks / P) + g // P."""
    nblk = m // nb
    order = np.argsort(np.arange(nblk) % P, kind="stable")
    perm = (order[:, None] * nb + np.arange(nb)[None, :]).reshape(-1)
    inv = np.empty_like(perm)
    inv[perm] = np.arange(m)
    return perm, inv


def _logical_rows(layout: str, nb: int, mloc: int, P: int, i: int, rows: int) -> torch.Tensor:
    """Logical (global) row index of each of rank i's first ``rows`` local rows."""
    r = torch.arange(rows)
    if layout == "cyclic":
        return ((r // nb) * P + i) * nb + r % nb
    return r + i * mloc


class _Ctx(NamedTuple):
    """What every panel step of one factorization shares."""
    mesh: DeviceMesh
    config: QRConfig
    P: int
    i: int
    nb: int
    mloc: int
    n: int
    owner_of: object
    offset_of: object


def _ctx(mesh: DeviceMesh, config: QRConfig, layout: str, mloc: int, n: int) -> _Ctx:
    nb, P = config.panel_width, mesh.size(0)
    owner_of, offset_of = _layout_fns(layout, nb, mloc, P)
    return _Ctx(mesh, config, P, coord(mesh), nb, mloc, n, owner_of, offset_of)


def _leaf(a: torch.Tensor, kk: int, c: _Ctx):
    """Factor this rank's live rows of panel kk in place in ``a``.
    Returns (off, V of rows >= off or None when dead, tau, T, R block)."""
    nb, pcol = c.nb, kk * c.nb
    off = c.offset_of(c.i, kk)
    if off >= c.mloc:                                   # dead: H = I
        z = torch.zeros((nb, nb), dtype=a.dtype, device=a.device)
        return off, None, z[0], z, z
    packed, tau, T = _geqrt(a[:, pcol:pcol + nb], c.config, off)
    a[:, pcol:pcol + nb] = packed
    return off, unpack_v(packed[off:]), tau, T, torch.triu(packed[off:off + nb])


def _strip(x: torch.Tensor, off: int, c: _Ctx) -> torch.Tensor:
    """This rank's nb-row strip at the panel's offset (zeros when dead)."""
    if off >= c.mloc:
        return torch.zeros((c.nb,) + tuple(x.shape[1:]), dtype=x.dtype, device=x.device)
    return x[off:off + c.nb]


def _bk_combine(Rl: torch.Tensor, owner: int, c: _Ctx):
    """Compact-kernel tree combine of the per-rank leaf R blocks.

    Returns (Y_i, N, s, Rfin): this rank's kernel block, the replicated
    nb x nb compact-WY factor N, the sign vector s and the combined panel
    R.  M is the CholeskyQR2 combine of ``tsqr_dist`` (two nb x nb
    all_reduces); on its breakdown, the explicit stacked Householder QR of
    the gathered R blocks.  The tree transform is built by Householder
    reconstruction on the owner's block of M (Ballard et al., IPDPS 2014):
    its LU is of Y_J = I - M_J S with |diag| >= 1.
    """
    nb, dt = Rl.shape[0], Rl.dtype
    eye = _eye(nb, Rl)
    M_i, Rfin, bad = _cholesky_combine(Rl, c.mesh)
    if agree(bad, c.mesh):
        M_i, Rfin = _gathered_combine(Rl, c.mesh, c.config)
    MJ = all_gather(M_i, c.mesh)[owner]
    s = torch.where(torch.diagonal(MJ) >= 0, -1.0, 1.0).to(dt)
    _, W, VJi, Wi = lu_with_inv(eye - MJ * s[None, :])
    N = W @ VJi.T                                       # W VJ^-T
    EmMS = (eye if c.i == owner else torch.zeros_like(eye)) - M_i * s[None, :]
    return EmMS @ Wi, N, s, Rfin


def _panel_step_bk(a: torch.Tensor, kk: int, c: _Ctx):
    """One panel of the "bk" combine, in place in ``a``.
    Returns (ltau, lT, Y_i, N, s, Rfin)."""
    nb, pcol = c.nb, kk * c.nb
    owner = c.owner_of(kk)
    off, V, tau, T, Rl = _leaf(a, kk, c)
    Y_i, N, s, Rfin = _bk_combine(Rl, owner, c)

    def apply_leaf_tree(cols: slice) -> None:
        """Leaf larfb + tree strip update of one column block, in place:
        X' = G^T (I - V T^T V^T) X, the strip rows through one all_reduce."""
        block = a[:, cols]
        if V is not None:
            block[off:] = larfb(block[off:], V, T, transpose=True)
        strip = _strip(block, off, c)
        C = psum(Y_i.T @ strip, c.mesh)
        if V is not None:
            block[off:off + nb] = strip - Y_i @ (N.T @ C)

    w = c.n - pcol - nb
    if w:
        # Depth-1 lookahead: the next panel's columns first, then the rest;
        # each is its own all_reduce (the per-column math is unchanged).
        apply_leaf_tree(slice(pcol + nb, pcol + 2 * nb))
        if w > nb:
            apply_leaf_tree(slice(pcol + 2 * nb, None))
    return tau, T, Y_i, N, s, Rfin


def _panel_step(a: torch.Tensor, kk: int, c: _Ctx):
    """One panel of the "allgather" combine, in place in ``a``.
    Returns (ltau, lT, tree_packed, tree_T)."""
    nb, pcol = c.nb, kk * c.nb
    owner = c.owner_of(kk)
    off, V, tau, T, Rl = _leaf(a, kk, c)
    w = c.n - pcol - nb
    if w and V is not None:
        a[off:, pcol + nb:] = larfb(a[off:, pcol + nb:], V, T, transpose=True)
    stacked = _roll_to_owner(all_gather(Rl, c.mesh), owner)     # (P*nb, nb)
    tp, _, T2 = _geqrt(stacked, c.config)
    if w:
        strip = _strip(a[:, pcol + nb:], off, c)
        stackW = _roll_to_owner(all_gather(strip, c.mesh), owner)
        stackW = larfb(stackW, unpack_v(tp), T2, transpose=True)
        slot = (c.i - owner) % c.P
        if V is not None:
            a[off:off + nb, pcol + nb:] = stackW[slot * nb:(slot + 1) * nb]
    return tau, T, tp, T2


def _top_rows(a: torch.Tensor, n: int, layout: str, c: _Ctx) -> torch.Tensor:
    """The logical top n rows of the row-sharded matrix (a this rank's
    rows), on every rank: each rank contributes only the rows it may hold
    there, in one all_gather."""
    if layout == "cyclic":
        t = min(c.mloc, c.nb * ceildiv(ceildiv(n, c.nb), c.P))
    else:
        t = min(c.mloc, n)
    gathered = all_gather(a[:t], c.mesh)                        # (P, t, cols)
    idx = torch.stack([_logical_rows(layout, c.nb, c.mloc, c.P, j, t) for j in range(c.P)])
    mask = idx < n
    out = torch.zeros((n, a.shape[1]), dtype=a.dtype, device=a.device)
    out[idx[mask].to(a.device)] = gathered[mask.to(a.device)]
    return out


def _assemble(a, cols, layout, combine, c: _Ctx):
    """(factors, R) from the factored shard ``a`` and the per-panel fields
    (``cols``: field name -> list over panels), as ``caqr_factor`` returns."""
    k, m = c.n // c.nb, c.mloc * c.P
    R = torch.triu(_top_rows(a, c.n, layout, c))
    stack = torch.stack

    def sharded(name):
        return as_row_sharded(stack(cols[name])[None], c.mesh, c.P)

    local = (as_row_sharded(a, c.mesh, m), sharded("ltau"), sharded("lT"))
    for kk in range(k):
        p = slice(kk * c.nb, (kk + 1) * c.nb)
        if combine == "bk":
            # the final R block carries the Yamamoto sign flip, as the
            # owner's physical strip rows do
            R[p, p] = torch.triu(cols["s"][kk][:, None] * cols["Rfin"][kk])
        else:
            R[p, p] = torch.triu(cols["tp"][kk][:c.nb])
    if combine == "bk":
        return CAQRFactorsBK(*local, Ys=sharded("Y"), signs=stack(cols["s"]),
                             Ns=stack(cols["N"])), R
    return CAQRFactors(*local, tree_packed=stack(cols["tp"]), tree_Ts=stack(cols["tT"])), R


FIELDS = {"bk": ("ltau", "lT", "Y", "N", "s", "Rfin"), "allgather": ("ltau", "lT", "tp", "tT")}
LOCAL_FIELDS = ("ltau", "lT", "Y")   # per rank; the others are replicated


def _check_factor(A, mesh: DeviceMesh, config: QRConfig, layout: str, combine: str):
    m, n = A.shape
    nb, P = config.panel_width, mesh.size(0)
    if m % P or (m // P) % nb or n % nb or n > m:
        raise QRShapeError(f"caqr_factor needs m%P==0, (m/P)%nb==0, n%nb==0, "
                           f"n<=m; got m={m} n={n} P={P} nb={nb}")
    if combine not in COMBINES:
        raise ValueError(f"unknown combine {combine!r}")
    if layout not in LAYOUTS:
        raise ValueError(f"unknown layout {layout!r}")
    if is_complex(A):
        if combine == "bk":
            raise QRShapeError(
                "complex CAQR needs combine='allgather' (the basis-kernel "
                "combine's CholeskyQR2 takes real Grams); models.caqr.caqr "
                "routes this automatically")
        if not config.dtype.is_complex:
            raise QRShapeError(f"complex CAQR needs a complex config dtype, got {config.dtype}")


def _local_copy(A, mesh: DeviceMesh, config: QRConfig) -> torch.Tensor:
    """This rank's rows of A in config.dtype, as a fresh tensor."""
    a, _ = shard_rows(A, mesh)
    return a.to(config.dtype, copy=True)


def caqr_factor(A, mesh: DeviceMesh, config: QRConfig = DEFAULT_CONFIG,
                layout: str = "block", combine: str = "bk"):
    """Factor a row-sharded A (m x n, m >= n), called by every rank.
    Returns (factors, R replicated).

    m must divide the mesh with rows per rank a multiple of nb, and
    n % nb == 0 (``models.caqr.caqr`` pads).  For layout="cyclic", A must
    already be in cyclic row order (``cyclic_permutation``).  A: a
    row-sharded DTensor, or the full matrix on every rank.  combine="bk"
    returns CAQRFactorsBK, "allgather" CAQRFactors.
    """
    _check_factor(A, mesh, config, layout, combine)
    a = _local_copy(A, mesh, config)
    c = _ctx(mesh, config, layout, a.shape[0], a.shape[1])
    step = _panel_step_bk if combine == "bk" else _panel_step
    cols = {f: [] for f in FIELDS[combine]}
    with matmul_precision(config.precision):
        for kk in range(c.n // c.nb):
            for f, v in zip(FIELDS[combine], step(a, kk, c)):
                cols[f].append(v)
        return _assemble(a, cols, layout, combine, c)


def _factors_local(factors):
    """(packed, Ts, tree fields) of this rank, as plain tensors."""
    bk = isinstance(factors, CAQRFactorsBK)
    ap = factors.local_packed.to_local()
    lTs = factors.local_Ts.to_local()[0]
    tree = ((factors.Ys.to_local()[0], factors.Ns) if bk
            else (factors.tree_packed, factors.tree_Ts))
    return bk, ap, lTs, tree


def _tree_apply(x, kk, off, owner, bk, tree, transpose, c: _Ctx):
    """The tree level of panel kk applied to this rank's rows x, in place."""
    nb = c.nb
    strip = _strip(x, off, c)
    if bk:
        Ys, Ns = tree
        Y_i, Nk = Ys[kk], Ns[kk]
        C = psum(Y_i.T @ strip, c.mesh)
        mine = strip - Y_i @ ((Nk.T if transpose else Nk) @ C)
    else:
        tpacked, tTs = tree
        stackW = _roll_to_owner(all_gather(strip, c.mesh), owner)
        stackW = larfb(stackW, unpack_v(tpacked[kk]), tTs[kk], transpose=transpose)
        slot = (c.i - owner) % c.P
        mine = stackW[slot * nb:(slot + 1) * nb]
    if off < c.mloc:
        x[off:off + nb] = mine


def _leaf_apply(x, ap, lTs, kk, off, transpose, c: _Ctx):
    """The leaf reflectors of panel kk applied to this rank's rows x, in place."""
    if off < c.mloc:
        V = unpack_v(ap[off:, kk * c.nb:(kk + 1) * c.nb])
        x[off:] = larfb(x[off:], V, lTs[kk], transpose=transpose)


def caqr_orgqr(factors, mesh: DeviceMesh, n_cols: int,
               config: QRConfig = DEFAULT_CONFIG, layout: str = "block"):
    """Explicit thin Q (m x n_cols) from two-level CAQR factors, as a
    row-sharded DTensor in the layout's storage order.  Applies the
    per-panel operators in reverse: Q <- H_leaf,k (H_tree,k Q)."""
    m, n = factors.local_packed.shape
    bk, ap, lTs, tree = _factors_local(factors)
    c = _ctx(mesh, config, layout, ap.shape[0], n)
    # my rows of I(m, n_cols), by logical row index
    logical = _logical_rows(layout, c.nb, c.mloc, c.P, c.i, c.mloc).to(ap.device)
    q = (logical[:, None] == torch.arange(n_cols, device=ap.device)[None, :]).to(ap.dtype)
    with matmul_precision(config.precision):
        for kk in reversed(range(n // c.nb)):
            off = c.offset_of(c.i, kk)
            _tree_apply(q, kk, off, c.owner_of(kk), bk, tree, False, c)
            _leaf_apply(q, ap, lTs, kk, off, False, c)
    return as_row_sharded(q, mesh, m)


def caqr_ormqr(factors, B, mesh: DeviceMesh, config: QRConfig = DEFAULT_CONFIG,
               layout: str = "block", transpose: bool = True):
    """Apply the distributed Q to a row-sharded B (m x w) without forming Q:
    Q^T B (transpose=True) or Q B, as a row-sharded DTensor.  B must be in
    the factors' storage order (for layout="cyclic", permuted by
    ``cyclic_permutation``) and padded to the factorization's m.

    transpose=True replays the factorization's per-panel transforms in
    forward order (leaf reflectors, then the tree combine); transpose=False
    is the reverse sweep of ``caqr_orgqr``.  Per panel: one all_reduce of
    nb x w for "bk" factors, one all_gather of nb x w strips for
    "allgather" factors.
    """
    m, n = factors.local_packed.shape
    bk, ap, lTs, tree = _factors_local(factors)
    b, mb = shard_rows(B, mesh)
    if mb != m:
        raise QRShapeError(f"B has {mb} rows, the factors {m}")
    b = b.to(ap.dtype, copy=True)
    c = _ctx(mesh, config, layout, ap.shape[0], n)
    order = range(n // c.nb) if transpose else reversed(range(n // c.nb))
    with matmul_precision(config.precision):
        for kk in order:
            off = c.offset_of(c.i, kk)
            if transpose:                  # leaf first (factorization order)
                _leaf_apply(b, ap, lTs, kk, off, True, c)
            _tree_apply(b, kk, off, c.owner_of(kk), bk, tree, transpose, c)
            if not transpose:              # leaf after the tree (reverse sweep)
                _leaf_apply(b, ap, lTs, kk, off, False, c)
    return as_row_sharded(b, mesh, m)
