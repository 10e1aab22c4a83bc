"""High-level QR API (counterpart of ``cuda_qr_tpu/models/qr.py``).

``qr(A)`` returns explicit (Q, R) in numpy.linalg.qr-style modes;
``qr_factor(A)`` returns the packed factorization for later orgqr/ormqr use.
The reduced mode is differentiable through ``thin_qr_vjp``, an
``autograd.Function`` that needs only the primal outputs, for real input;
complex input (cgeqrf conventions: complex tau, real diagonal of R) takes
the plain path, as the reference skips its custom VJP there.
"""

from __future__ import annotations

import torch

from ..ops.blocked import PackedQR, as_tensor, complex_config, extract_r, orgqr, ormqr, qr_blocked
from ..ops.gemm import gemm
from ..ops.qrcp import qrcp_blocked
from ..utils.config import DEFAULT_CONFIG, QRConfig
from ..utils.errors import QRShapeError
from ..utils.profiling import span


class QRResult:
    """Factorization handle: lazy Q/R extraction over packed factors."""

    def __init__(self, factors: PackedQR, m: int, n: int, config: QRConfig):
        self.factors = factors
        self.m, self.n = m, n
        self.config = config

    @property
    def Q(self) -> torch.Tensor:
        return orgqr(self.factors, self.m, self.n, self.config)

    @property
    def R(self) -> torch.Tensor:
        return extract_r(self.factors, self.n)

    def apply_qt(self, B) -> torch.Tensor:
        with span("entry.apply_qt"):
            return ormqr(self.factors, B, transpose=True, config=self.config)

    def apply_q(self, B) -> torch.Tensor:
        return ormqr(self.factors, B, transpose=False, config=self.config)


def qr_factor(A, config: QRConfig = DEFAULT_CONFIG) -> QRResult:
    A = as_tensor(A, config)
    config = complex_config(A, config)
    m, n = A.shape
    return QRResult(qr_blocked(A, config), m, n, config)


def thin_qr_vjp(Q, R, dQ, dR, precision: str = "highest"):
    """Reverse rule for any thin QR, m >= n (the copyltu formula):
        M = R dR^T - dQ^T Q
        dA = (dQ + Q (tril(M,-1) + tril(M,-1)^T + diag(M))) R^{-T}
    Depends only on the primal outputs, so every thin-QR algorithm of the
    package (blocked Householder, TSQR, batched CholeskyQR) shares it.
    Leading dimensions are a batch; the three GEMMs run at ``precision``,
    the factorization's ``config.precision`` (``cuda_qr_tpu/models/qr.py:60-83``).
    """
    M = gemm(R, dR.mT, precision) - gemm(dQ.mT, Q, precision)
    tri = torch.tril(M, -1)
    copyltu = tri + tri.mT + torch.diag_embed(torch.diagonal(M, 0, -2, -1))
    rhs = dQ + gemm(Q, copyltu, precision)
    return torch.linalg.solve_triangular(R, rhs.mT, upper=True).mT


class ThinQRFunction(torch.autograd.Function):
    """A thin QR ``factor(A, config) -> (Q, R)`` with the reference's custom
    VJP (``thin_qr_vjp``): the factorization's loops and host decisions are
    not differentiated through.  ``apply(A, config, factor)``; the backward
    runs at ``config.precision``."""

    @staticmethod
    def forward(ctx, A, config, factor):
        Q, R = factor(A, config)
        ctx.save_for_backward(Q, R)
        ctx.precision = config.precision
        return Q, R

    @staticmethod
    def backward(ctx, dQ, dR):
        Q, R = ctx.saved_tensors
        dQ = torch.zeros_like(Q) if dQ is None else dQ
        dR = torch.zeros_like(R) if dR is None else dR
        return thin_qr_vjp(Q, R, dQ, dR, ctx.precision), None, None


def _thin_qr_factor(A, config):
    res = qr_factor(A, config)
    return res.Q, res.R


def qr_pivoted(A, config: QRConfig = DEFAULT_CONFIG, rank: int | None = None,
               generator: torch.Generator | None = None, omega=None):
    """Column-pivoted (rank-revealing) QR: A[:, piv] = Q @ R, by randomized
    blocked QRCP (``ops/qrcp.py``).

    rank=None: full factorization, Q (m x n), R (n x n) upper-triangular,
      piv (n,) with A[:, piv] = Q R.
    rank=r: truncated rank-revealing factorization after ceil(r/nb) panel
      blocks, Q (m x r), R (r x n), piv (n,) with A[:, piv] ~= Q R up to
      the neglected singular values.
    generator / omega: the sketch's source, as for ``qrcp_blocked``.
    Complex input runs at ``complex_config`` (geqr2 panels, the plain pivot
    selection on |column|^2 sketch norms, no kernel).
    """
    A = as_tensor(A, config)
    config = complex_config(A, config)
    m, n = A.shape
    num_panels = None
    if rank is not None:
        if not 1 <= rank <= n:
            raise QRShapeError(f"rank must be in [1, {n}], got {rank}")
        num_panels = -(-rank // config.panel_width)
    factors, jpvt, R12 = qrcp_blocked(A, config, generator, num_panels, omega)
    kb = factors.packed.shape[1]
    Q = orgqr(factors, m, kb, config)
    R = torch.cat([extract_r(factors, kb), R12], 1)
    r = min(n, kb) if rank is None else rank
    return Q[:, :r], R[:r, :n], jpvt[:n]


def qr(A, config: QRConfig = DEFAULT_CONFIG, mode: str = "reduced"):
    """QR factorization with numpy.linalg.qr-style modes.

    mode='reduced': (Q (m x k), R (k x n)), k = min(m, n); wide matrices
      (m < n) factor the left m x m block and apply Q^T to the rest.
    mode='complete': (Q (m x m), R (m x n)).
    mode='r': R only.
    mode='raw': (h (n x m), tau (k,)), LAPACK geqrf packed storage
      transposed like numpy's raw mode; Householder-convention panels are
      forced (the basis-kernel default stores a non-LAPACK V block).  2-D
      m >= n input only.
    Leading batch dimensions are factored one matrix at a time.  Complex
    input works in every mode (geqr2 panels at its dtype; not differentiable).
    Each matrix's call is the span ``entry.qr``.
    """
    A = as_tensor(A, config)
    if mode not in ("reduced", "complete", "r", "raw"):
        raise ValueError(f"unknown mode {mode!r}")
    if mode != "raw" and A.dim() > 2:
        batch = A.shape[:-2]
        outs = [qr(a, config, mode) for a in A.reshape((-1,) + A.shape[-2:])]
        if mode == "r":
            return torch.stack(outs).reshape(batch + outs[0].shape)
        Qs = torch.stack([o[0] for o in outs])
        Rs = torch.stack([o[1] for o in outs])
        return (Qs.reshape(batch + Qs.shape[-2:]), Rs.reshape(batch + Rs.shape[-2:]))
    with span("entry.qr"):
        return _qr_matrix(A, config, mode)


def _qr_matrix(A: torch.Tensor, config: QRConfig, mode: str):
    """``qr`` of one matrix (``mode="raw"``: of any input, which it checks)."""
    if mode == "raw":
        if A.dim() != 2 or A.shape[0] < A.shape[1]:
            raise QRShapeError(
                f"mode='raw' needs a single m >= n matrix, got {tuple(A.shape)}")
        m, n = A.shape
        cfg = (config if config.panel_method != "cholqr2_bk"
               else config.replace(panel_method="cholqr2_hr"))
        fac = qr_blocked(A, cfg)
        return fac.packed[:m, :n].T, fac.taus.reshape(-1)[:n]
    m, n = A.shape
    if m >= n:
        if mode == "reduced" and not A.is_complex():
            return ThinQRFunction.apply(A, config, _thin_qr_factor)
        if mode == "reduced":
            return _thin_qr_factor(A, config)
        res = qr_factor(A, config)
        if mode == "r":
            return res.R
        Q = orgqr(res.factors, m, m, config)
        R = torch.nn.functional.pad(res.R, (0, 0, 0, m - n))
        return Q, R
    # wide: A = [A1 | A2], A1 = Q R11, R12 = Q^T A2
    res = qr_factor(A[:, :m], config)
    R12 = res.apply_qt(A[:, m:])[:m]
    R = torch.cat([res.R, R12], 1)
    if mode == "r":
        return R
    if mode == "complete":
        return orgqr(res.factors, m, m, config), R
    return res.Q, R
