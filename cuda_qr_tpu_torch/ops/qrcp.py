"""Randomized blocked column-pivoted QR (QRCP), the counterpart of
``cuda_qr_tpu/ops/qrcp.py`` (Duersch & Gu, SIAM JSC 2017):

  1. one Gaussian sketch B = Omega A (l x n, l = nb + 32) up front;
  2. per nb-wide block step, nb pivots chosen by greedy Gram-Schmidt on the
     sketch, restricted to the 4*nb candidate columns of largest sketch
     norm (kernel B3, ``ops/select_kernel.py``, where eligible);
  3. one gather that moves the chosen columns to the front of the active
     block, the regular panel factorization (``blocked._panel_factor``,
     kernel B1 on the default cholqr2_bk panel) and the block-reflector
     trailing update;
  4. the Duersch-Gu sketch downdate B_2 <- B_2 - B_1 R_11^{-1} R_12, which
     makes the sketch one of the new Schur complement without touching A.

As in ``ops/blocked.py``, the reference's fori_loop is a Python loop and
its masked full-width updates work on exact-width slices (rows >= j0,
columns >= j0 + nb): the same operator.  Every GEMM runs at
``config.precision``, the trailing update included, as in the reference
(``cuda_qr_tpu/ops/qrcp.py:194-196``): ``trailing_precision`` is not read, so
MIXED_CONFIG factors with pivots exactly as DEFAULT_CONFIG does.  The loop takes no host sync of its
own; the panel factorization's ``host_decision``s are the only ones.

The reference draws Omega with ``jax.random``, which this package cannot
reproduce: it draws from a ``torch.Generator`` seeded 12 on the input's
device, and takes Omega itself where the caller has one (the tests hand
both packages the same Omega, since the pivots depend on it).
"""

from __future__ import annotations

import math

import torch

from ..utils.config import DEFAULT_CONFIG, QRConfig
from ..utils.errors import QRShapeError
from ..utils.geometry import round_up
from .blocked import PackedQR, _panel_factor, as_tensor, complex_config, compute_dtype
from .gemm import gemm
from .householder import panel_v
from .select_kernel import select_pivots_auto

SKETCH_SEED = 12   # the reference's fixed key(12), after qr.cu:765's srand(12)


def sketch_rows(m_pad: int, nb: int) -> int:
    """l, the sketch height: nb + 32 rows of oversampling, at most m_pad."""
    return min(m_pad, nb + 32)


def _candidates(norms: torch.Tensor, cand: int) -> torch.Tensor:
    """Indices of the cand largest norms, ties in index order (the order of
    ``jax.lax.top_k``; ``torch.topk`` promises none on the card)."""
    return torch.sort(norms, descending=True, stable=True).indices[:cand]


def _select_pivots(B: torch.Tensor, j0: int, nb: int, cand: int,
                   config: QRConfig | None = None) -> torch.Tensor:
    """ordsel (n_pad,) int32: selection step 0..nb-1 of the nb columns chosen
    from the sketch B (l, n_pad) among columns >= j0, -1 elsewhere.

    The selection itself is ``select_kernel.select_pivots_auto``'s (kernel
    B3 or the plain loop), at "highest" for config=None.
    """
    n_pad = B.shape[1]
    col = torch.arange(n_pad, device=B.device)
    norms = torch.where(col >= j0, (B * B.conj()).real.sum(0), -1.0)   # real
    # Actives (>= 0) outrank inactives (-1) and number >= nb, so the
    # candidates hold at least nb active columns.
    cand_idx = _candidates(norms, cand)
    Sc = B.index_select(1, cand_idx)
    norms_c = norms.index_select(0, cand_idx)
    ord_c = select_pivots_auto(Sc, norms_c, nb, config)
    ordsel = torch.full((n_pad,), -1, dtype=torch.int32, device=B.device)
    return ordsel.index_copy_(0, cand_idx, ord_c)


def _block_perm(ordsel: torch.Tensor, j0: int, nb: int) -> torch.Tensor:
    """Bijective column permutation moving the nb selected columns to
    positions [j0, j0+nb) in selection order; the other active columns keep
    their relative order after them; columns < j0 stay.

    Returns perm with new[:, t] = old[:, perm[t]].
    """
    n_pad = ordsel.shape[0]
    col = torch.arange(n_pad, device=ordsel.device)
    active = col >= j0
    sel = ordsel >= 0
    nonsel_rank = torch.cumsum((active & ~sel).long(), 0) - 1
    dest = torch.where(~active, col,
                       torch.where(sel, j0 + ordsel.long(), j0 + nb + nonsel_rank))
    return torch.empty_like(col).index_copy_(0, dest, col)


def _sketch(m_pad: int, l: int, dtype, device, generator, omega) -> torch.Tensor:
    """Omega (l x m_pad), N(0, 1/l) entries; complex for a complex dtype
    (variance 1/2 on each part, as ``jax.random.normal``'s)."""
    if omega is not None:
        omega = torch.as_tensor(omega, dtype=dtype, device=device)
        if tuple(omega.shape) != (l, m_pad):
            raise QRShapeError(f"omega must be {l} x {m_pad}, got {tuple(omega.shape)}")
        return omega
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(SKETCH_SEED)
    G = torch.randn((l, m_pad), generator=generator, dtype=dtype, device=device)
    return G / math.sqrt(l)


def qrcp_blocked(A, config: QRConfig = DEFAULT_CONFIG,
                 generator: torch.Generator | None = None,
                 num_panels: int | None = None, omega=None):
    """Column-pivoted blocked QR: A[:, jpvt] = Q R (full) or, truncated,
    A[:, jpvt[:kb]] ~= Q R11 with R12 covering the remaining columns.

    Returns (factors, jpvt, R12):
      factors: PackedQR over the kb = num_panels*nb factored columns, which
               orgqr/ormqr/extract_r consume unchanged;
      jpvt:    (n_pad,) original column at each factorization position
               (positions >= n are the zero pad columns, which sort last);
      R12:     (kb, n_pad - kb) top rows of the unfactored trailing columns
               (empty for a full factorization).
    The sketch is ``omega`` (l x m_pad) if given, else drawn from
    ``generator`` (default: seeded 12 on A's device).  A is not modified.
    Complex A runs at ``complex_config``: geqr2 panels at its dtype, the
    plain pivot selection on real sketch norms, a complex Gaussian sketch
    (``cuda_qr_tpu/ops/qrcp.py:144-148``).
    """
    A = as_tensor(A, config)
    config = complex_config(A, config)
    m, n = A.shape
    if m < n:
        raise QRShapeError(f"qrcp_blocked requires m >= n, got {m}x{n}")
    nb = config.panel_width
    m_pad, n_pad = round_up(m, nb), round_up(n, nb)
    k = n_pad // nb
    kp = k if num_panels is None else min(num_panels, k)
    sdt = config.dtype
    cdt = compute_dtype(sdt)   # sketch, T, GEMMs
    dev = A.device
    Ap = torch.zeros((m_pad, n_pad), dtype=cdt, device=dev)
    Ap[:m, :n] = A.to(sdt)

    l = sketch_rows(m_pad, nb)
    cand = min(n_pad, 4 * nb)
    Omega = _sketch(m_pad, l, cdt, dev, generator, omega)
    prec = config.precision
    B = gemm(Omega, Ap, prec)

    jpvt = torch.arange(n_pad, device=dev)
    taus = torch.zeros((kp, nb), dtype=cdt, device=dev)
    Ts = torch.zeros((kp, nb, nb), dtype=cdt, device=dev)
    VJs = torch.zeros((kp, nb, nb), dtype=cdt, device=dev)
    eps = torch.finfo(cdt).eps
    for j in range(kp):
        j0, j1 = j * nb, (j + 1) * nb
        ordsel = _select_pivots(B, j0, nb, cand, config)
        src = _block_perm(ordsel, j0, nb)[j0:]
        # Every row moves: rows above j0 hold these columns' R12 entries.
        Ap[:, j0:] = Ap.index_select(1, src)
        B[:, j0:] = B.index_select(1, src)
        jpvt[j0:] = jpvt.index_select(0, src)

        packed, tau, T, VJ = _panel_factor(Ap[j0:, j0:j1], 0, config)
        Ap[j0:, j0:j1] = packed
        taus[j], Ts[j], VJs[j] = tau, T, VJ
        rest = Ap[j0:, j1:]
        if not rest.shape[1]:
            continue
        # Trailing update (I - V T V^H)^H on rows >= j0, columns >= j0 + nb,
        # at ``precision`` as in the reference (``trailing_precision`` is
        # qr_blocked's knob; the reference's QRCP does not read it).
        V, Tc = panel_v(packed, 0, VJ), T.to(cdt)
        rest -= gemm(V, gemm(Tc.mH, gemm(V.mH, rest, prec), prec), prec)
        if sdt != cdt:
            rest.copy_(rest.to(sdt))

        # Duersch-Gu sample update B2 <- B2 - B1 R11^{-1} R12.  A (numerically)
        # singular R11 (rank exhausted) gets unit diagonal stand-ins so the
        # solve stays finite; those directions are noise-level anyway.
        R1 = torch.triu(packed[:nb])
        d = torch.diagonal(R1)
        safe = d.abs() > eps * torch.clamp_min(d.abs().max(), 1)
        R1 = R1 + torch.diag(torch.where(safe, 0.0, 1.0 - d))
        X = torch.linalg.solve_triangular(R1, Ap[j0:j1, j1:], upper=True)
        B[:, j1:] -= gemm(B[:, j0:j1], X, prec)

    kb = kp * nb
    factors = PackedQR(packed=Ap[:, :kb].to(sdt), taus=taus, Ts=Ts, VJs=VJs)
    return factors, jpvt, Ap[:kb, kb:].to(sdt)
