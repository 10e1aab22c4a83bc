"""Blocked Householder QR driver (geqrf) and Q operators (orgqr/ormqr).

Counterpart of ``cuda_qr_tpu/ops/blocked.py``, as a plain Python loop: the
reference's staged scan, masked full-width loop body and nested-jit panel
exist to bound XLA/Mosaic compile size, which eager PyTorch does not pay.

Factorization: panels of nb columns in left-looking lookahead groups of
``factor_lookahead`` panels.  Inside a group, each panel first receives the
group's earlier reflectors, then is factored; after the group, ONE merged
g*nb-deep block reflector updates the trailing columns.  Each group works
on rows >= its first panel's offset, since the rows above are final.

Storage is ``PackedQR`` (packed V/R, taus, Ts, VJs), the reference's, so
factors compare one to one and carry across (``utils/interop.py``).  The
trailing, merge, Gram and orgqr GEMMs are plain ``torch.matmul``.

Complex input (LAPACK cgeqrf conventions) runs the plain geqr2 panels at its
own dtype whatever ``panel_method`` says, as the reference routes it
(``cuda_qr_tpu/ops/blocked.py:381-386``): the CholeskyQR2 panels and the
kernels are real-only.  The route is chosen here, before any kernel wrapper
is reached; every transpose of V and T is the conjugate one.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..utils.config import DEFAULT_CONFIG, QRConfig, matmul_precision
from ..utils.errors import QRShapeError
from ..utils.geometry import round_up
from .householder import geqr2, larfb, larft, merge_wy, panel_v, unit_vj, unpack_v


class PackedQR(NamedTuple):
    """Packed blocked-QR factors.

    VJs holds each panel's nb x nb diagonal V block: the unit-lower block
    for Householder-style panels, a dense block for basis-kernel panels
    (panel_method="cholqr2_bk"), which cannot be packed under R.
    """
    packed: torch.Tensor   # (m_pad, n_pad)
    taus: torch.Tensor     # (k, nb)
    Ts: torch.Tensor       # (k, nb, nb)
    VJs: torch.Tensor      # (k, nb, nb)


def as_tensor(A, config: QRConfig) -> torch.Tensor:
    """Tensor input stays on its device; numpy input goes to config.device."""
    if isinstance(A, torch.Tensor):
        return A
    return torch.tensor(np.asarray(A), device=config.device)


def is_complex(A) -> bool:
    """Whether A (a tensor, DTensor or numpy array) has a complex dtype."""
    dt = A.dtype
    return dt.is_complex if isinstance(dt, torch.dtype) else np.dtype(dt).kind == "c"


def _require_real(*tensors) -> None:
    """Raise for complex input to an entry point whose complex form is not
    ported yet (ROADMAP.md, Queue A, A5b)."""
    if any(is_complex(t) for t in tensors):
        raise NotImplementedError(
            "complex input to this function is not ported yet (ROADMAP.md, Queue A, A5b: "
            "complex Givens updates, QRCP and the rank solvers, the spectral family, "
            "the complex *_dist solvers)")


def complex_config(A, config: QRConfig) -> QRConfig:
    """The configuration complex A runs at: its own dtype, the plain geqr2
    panels and no kernel (the reference's ``use_pallas=False,
    use_chol_kernel=False``).  Real A keeps ``config``."""
    if not is_complex(A):
        return config
    dtype = A.dtype if isinstance(A.dtype, torch.dtype) else torch.from_numpy(
        np.empty(0, A.dtype)).dtype
    return config.replace(dtype=dtype, use_kernels=False, use_chol_kernel=False)


def as_real_matrix(A, config: QRConfig, name: str) -> torch.Tensor:
    """``as_tensor`` for an entry point ``name`` that takes one real matrix
    (its complex form is ROADMAP A5b)."""
    A = as_tensor(A, config)
    _require_real(A)
    if A.dim() != 2:
        raise QRShapeError(f"{name} needs a 2-D matrix, got shape {tuple(A.shape)}")
    return A


def _merge_group(Vs, Ts):
    """Pair-merge per-panel (V, T), left to right, into one wide (V, T)."""
    Vs, Ts = list(Vs), list(Ts)
    while len(Vs) > 1:
        nVs, nTs = [], []
        for a in range(0, len(Vs) - 1, 2):
            nTs.append(merge_wy(Vs[a], Ts[a], Vs[a + 1], Ts[a + 1]))
            nVs.append(torch.cat([Vs[a], Vs[a + 1]], 1))
        if len(Vs) % 2:
            nVs.append(Vs[-1])
            nTs.append(Ts[-1])
        Vs, Ts = nVs, nTs
    return Vs[0], Ts[0]


def _panel_factor(panel: torch.Tensor, off: int, config: QRConfig):
    """Factor rows >= off of a (m x nb) panel: (packed, tau, T, VJ)."""
    nb = panel.shape[1]
    method = config.panel_method if config.use_kernels else "geqr2"
    if method == "cholqr2_bk":
        from .fast_panel import panel_factor_cholqr2bk
        return panel_factor_cholqr2bk(panel, off, config)
    if method == "cholqr2_hr":
        from .fast_panel import panel_factor_cholqr2hr
        packed, tau, T = panel_factor_cholqr2hr(panel, off, config)
    elif method == "geqrt":
        from .geqrt import geqrt_panel
        packed, tau, T = geqrt_panel(panel, off, config)
    else:
        cdt = torch.float32 if panel.dtype == torch.bfloat16 else panel.dtype
        lo, tau = geqr2(panel[off:].to(cdt))
        T = larft(unpack_v(lo), tau)
        packed = torch.cat([panel[:off], lo.to(panel.dtype)], 0)
    return packed, tau, T, unit_vj(packed, off, nb)


def qr_blocked(A, config: QRConfig = DEFAULT_CONFIG) -> PackedQR:
    """Blocked QR factorization of A (m x n, m >= n).

    Any m, n: A is zero-padded to the panel grid.  A is not modified.
    bfloat16 storage keeps the packed panels in bfloat16 and taus/Ts/VJs and
    the GEMMs in float32.  Complex A is factored at its own dtype on geqr2
    panels (``complex_config``).
    """
    A = as_tensor(A, config)
    config = complex_config(A, config)
    m, n = A.shape
    if m < n:
        raise QRShapeError(f"qr_blocked requires m >= n, got {m}x{n}")
    nb = config.panel_width
    m_pad, n_pad = round_up(m, nb), round_up(n, nb)
    k = n_pad // nb
    sdt = config.dtype
    cdt = torch.float32 if sdt == torch.bfloat16 else sdt
    Ap = torch.zeros((m_pad, n_pad), dtype=cdt, device=A.device)
    Ap[:m, :n] = A.to(sdt)
    taus = torch.zeros((k, nb), dtype=cdt, device=A.device)
    Ts = torch.zeros((k, nb, nb), dtype=cdt, device=A.device)
    VJs = torch.zeros((k, nb, nb), dtype=cdt, device=A.device)
    g = max(1, config.factor_lookahead)
    for i0 in range(0, k, g):
        gsz = min(g, k - i0)
        r0 = i0 * nb
        Vs, Tg = [], []
        for l in range(gsz):
            i, off = i0 + l, l * nb
            c = r0 + off
            block = Ap[r0:, c:c + nb]
            if l:
                with matmul_precision(config.resolved_trailing_precision()):
                    for V, T in zip(Vs, Tg):
                        block = larfb(block, V, T, transpose=True)
            with matmul_precision(config.precision):
                packed, tau, T, VJ = _panel_factor(block.to(sdt), off, config)
            packed = packed.to(cdt)
            Ap[r0:, c:c + nb] = packed
            taus[i], Ts[i], VJs[i] = tau, T, VJ
            Vs.append(panel_v(packed, off, VJ))
            Tg.append(T.to(cdt))
        rest = Ap[r0:, r0 + gsz * nb:]
        if rest.shape[1]:
            with matmul_precision(config.resolved_trailing_precision()):
                V, T = _merge_group(Vs, Tg)
                rest -= V @ (T.mH @ (V.mH @ rest))
            if sdt != cdt:
                rest.copy_(rest.to(sdt))
    return PackedQR(packed=Ap.to(sdt), taus=taus, Ts=Ts, VJs=VJs)


def _groups(k: int, g: int):
    """Panel groups [i0, i1) of at most g panels, left to right."""
    g = max(1, g)
    return [(i0, min(i0 + g, k)) for i0 in range(0, k, g)]


def _group_reflector(factors: PackedQR, i0: int, i1: int, nb: int, dtype):
    """Merged (V, T) of panels [i0, i1), V restricted to rows >= i0*nb."""
    packed, _, Ts, VJs = factors
    r0 = i0 * nb
    Vs = [panel_v(packed[r0:, i * nb:(i + 1) * nb].to(dtype), (i - i0) * nb, VJs[i])
          for i in range(i0, i1)]
    return _merge_group(Vs, [Ts[i].to(dtype) for i in range(i0, i1)])


def orgqr(factors: PackedQR, m: int, n: int,
          config: QRConfig = DEFAULT_CONFIG) -> torch.Tensor:
    """Thin explicit Q (m x n) from packed factors.

    Groups of ``apply_aggregate`` panels are applied last to first, each as
    one merged block reflector.  When group [i0, i1) is applied, columns
    j < i0*nb of Q are still e_j and rows < i0*nb are still zero in the
    other columns, so each group works on the diagonal-trailing window
    Q[i0*nb:, min(i0*nb, n):].
    """
    packed = factors.packed
    m_pad, n_pad = packed.shape
    nb = config.panel_width
    k = n_pad // nb
    cdt = torch.float32 if packed.dtype == torch.bfloat16 else packed.dtype
    Q = torch.eye(m_pad, n, dtype=cdt, device=packed.device)
    with matmul_precision(config.resolved_orgqr_precision()):
        for i0, i1 in reversed(_groups(k, config.apply_aggregate)):
            r0 = i0 * nb
            c0 = min(r0, n)
            V, T = _group_reflector(factors, i0, i1, nb, cdt)
            Q[r0:, c0:] = larfb(Q[r0:, c0:], V, T, transpose=False)
    return Q[:m].to(packed.dtype)


def ormqr(factors: PackedQR, B, transpose: bool = True,
          config: QRConfig = DEFAULT_CONFIG) -> torch.Tensor:
    """Q^H B (transpose=True) or Q B for B (m x p), without forming Q."""
    packed = factors.packed
    B = as_tensor(B, config)
    m_pad, n_pad = packed.shape
    nb = config.panel_width
    k = n_pad // nb
    cdt = torch.float32 if packed.dtype == torch.bfloat16 else packed.dtype
    mB = B.shape[0]
    Bp = torch.zeros((m_pad, B.shape[1]), dtype=cdt, device=packed.device)
    Bp[:mB] = B.to(packed.device, cdt)
    groups = _groups(k, config.apply_aggregate)
    with matmul_precision(config.resolved_orgqr_precision()):
        for i0, i1 in (groups if transpose else reversed(groups)):
            r0 = i0 * nb
            V, T = _group_reflector(factors, i0, i1, nb, cdt)
            Bp[r0:] = larfb(Bp[r0:], V, T, transpose=transpose)
    return Bp[:mB].to(packed.dtype)


def extract_r(factors: PackedQR, n: int, square: bool = True) -> torch.Tensor:
    """R from packed storage (upper triangle)."""
    R = torch.triu(factors.packed[:, :n])
    return R[:n] if square else R
