"""Blocked Householder QR driver (geqrf) and Q operators (orgqr/ormqr).

Counterpart of ``cuda_qr_tpu/ops/blocked.py``, as a plain Python loop: the
reference's staged scan, masked full-width loop body and nested-jit panel
exist to bound XLA/Mosaic compile size, which eager PyTorch does not pay.
Its stages also decide how panels are grouped, and that is kept
(``_groups``): the k panels are cut into ``scan_stages`` stages (the
factor's into ``stage_schedule``'s when one is set), and a stage of kg
panels into groups of the largest power of two <= the width that divides
kg.  A group is merged into one block reflector, so the grouping sets Q's
rounding: the fewer panels merged, the more orthogonal Q.

Factorization: panels of nb columns in left-looking lookahead groups of up
to ``factor_lookahead`` panels.  Inside a group, each panel first receives
the group's earlier reflectors, then is factored; after the group, ONE
merged g*nb-deep block reflector updates the trailing columns.  Each group
works on rows >= its first panel's offset, since the rows above are final.

Storage is ``PackedQR`` (packed V/R, taus, Ts, VJs), the reference's, so
factors compare one to one and carry across (``utils/interop.py``).  Every
GEMM goes through ``ops/gemm.gemm``: the trailing, merge and orgqr GEMMs at
the trailing or orgqr precision, the panels' at ``config.precision`` ("high"
is 3xTF32 in each).

Complex input (LAPACK cgeqrf conventions) runs the plain geqr2 panels at its
own dtype whatever ``panel_method`` says, as the reference routes it
(``cuda_qr_tpu/ops/blocked.py:381-386``): the CholeskyQR2 panels and the
kernels are real-only.  The route is chosen here, before any kernel wrapper
is reached; every transpose of V and T is the conjugate one.
"""

from __future__ import annotations

import itertools
from typing import NamedTuple

import numpy as np
import torch

from ..utils.config import DEFAULT_CONFIG, QRConfig
from ..utils.errors import QRShapeError
from ..utils.geometry import round_up
from ..utils.profiling import span
from .gemm import gemm
from .fast_panel import panel_factor_cholqr2bk, panel_factor_cholqr2hr
from .geqrt import geqrt_base_plain, geqrt_panel
from .householder import larfb, merge_wy, panel_v, unit_vj


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


def complex_config(A, config: QRConfig) -> QRConfig:
    """The configuration complex A runs at: its own dtype, the plain geqr2
    panels, the plain pivot selection and no kernel (the reference's
    ``use_pallas=False, use_chol_kernel=False, use_select_kernel=False``),
    and every GEMM at "highest".  cuBLAS's TF32 mode reaches complex64
    GEMMs; the reference's MIXED trailing precision (bf16x3) keeps float32's
    accuracy, so "tf32" and "high" map to "highest" here.  Real A keeps
    ``config``."""
    if not is_complex(A):
        return config
    dtype = A.dtype if isinstance(A.dtype, torch.dtype) else torch.from_numpy(
        np.empty(0, A.dtype)).dtype

    def full(p):
        return "highest" if p in ("tf32", "high") else p
    return config.replace(dtype=dtype, use_kernels=False, use_chol_kernel=False,
                          use_select_kernel=False, precision=full(config.precision),
                          trailing_precision=full(config.trailing_precision),
                          orgqr_precision=full(config.orgqr_precision))


def as_matrix(A, config: QRConfig, name: str) -> torch.Tensor:
    """``as_tensor`` for an entry point ``name`` that takes one matrix."""
    A = as_tensor(A, config)
    if A.dim() != 2:
        raise QRShapeError(f"{name} needs a 2-D matrix, got shape {tuple(A.shape)}")
    return A


def _merge_group(Vs, Ts, precision: str):
    """Pair-merge per-panel (V, T), left to right, into one wide (V, T),
    the merges' GEMMs at ``precision``.

    len(Vs) must be a power of two, as ``_groups`` makes it."""
    Vs, Ts = list(Vs), list(Ts)
    while len(Vs) > 1:
        nVs, nTs = [], []
        for a in range(0, len(Vs), 2):
            nTs.append(merge_wy(Vs[a], Ts[a], Vs[a + 1], Ts[a + 1], precision))
            nVs.append(torch.cat([Vs[a], Vs[a + 1]], 1))
        Vs, Ts = nVs, nTs
    return Vs[0], Ts[0]


def _group_width(kg: int, width: int) -> int:
    """Largest power of two <= width that divides kg."""
    g = 1
    while g * 2 <= width and kg % (g * 2) == 0:
        g *= 2
    return g


def _stage_bounds(k: int, stages: int, schedule=None) -> list[int]:
    """Stage bounds 0 = b_0 < ... < b_S = k: the running sums of
    ``schedule`` (panels per stage), else round(s*k/stages).  A schedule
    that is not positive or does not sum to k raises the reference's
    ValueError (``cuda_qr_tpu/ops/blocked.py:141-151``)."""
    if schedule is not None:
        if any(c <= 0 for c in schedule) or sum(schedule) != k:
            raise ValueError(f"stage_schedule {schedule} must be positive "
                             f"and sum to the panel count k={k}")
        return list(itertools.accumulate(schedule, initial=0))
    stages = max(1, min(stages, k))
    return [round(s * k / stages) for s in range(stages + 1)]


def _groups(k: int, width: int, stages: int, schedule=None):
    """Panel groups [i0, i1), left to right, as the reference forms them
    (``cuda_qr_tpu/ops/blocked.py:141-152,211,432-438,493-505``): stages
    at ``_stage_bounds``, and in a stage of kg panels, groups of
    ``_group_width(kg, width)``."""
    bounds = _stage_bounds(k, stages, schedule)
    groups = []
    for ks, ke in zip(bounds[:-1], bounds[1:]):
        g = _group_width(ke - ks, width)
        groups += [(i0, i0 + g) for i0 in range(ks, ke, g)]
    return groups


def compute_dtype(dtype: torch.dtype) -> torch.dtype:
    """The dtype a storage dtype computes in: float32 for bfloat16, else
    itself."""
    return torch.float32 if dtype == torch.bfloat16 else dtype


def _panel_factor(panel: torch.Tensor, off: int, config: QRConfig):
    """Factor rows >= off of a (m x nb) panel: (packed, tau, T, VJ), its
    GEMMs at ``config.precision``.  The panel contract: the panel and the
    packed panel are each rounded once through the storage dtype
    ``config.dtype`` and handed over in the compute dtype; rows above
    ``off`` come back as they went in; VJ of a LAPACK-stored panel is formed
    here (the basis kernel's dense block is its own).  ``use_kernels=False``
    takes geqr2."""
    with span("panel.factor"):
        sdt = config.dtype
        cdt = compute_dtype(sdt)
        panel = panel.to(sdt).to(cdt)
        method = config.panel_method if config.use_kernels else "geqr2"
        VJ = None
        if method == "cholqr2_bk":
            packed, tau, T, VJ = panel_factor_cholqr2bk(panel, off, config)
        elif method == "cholqr2_hr":
            packed, tau, T = panel_factor_cholqr2hr(panel, off, config)
        elif method == "geqrt":
            packed, tau, T = geqrt_panel(panel, off, config)
        else:
            packed, tau, T = geqrt_base_plain(panel, off, config.precision)
        packed = packed.to(sdt).to(cdt)
        return packed, tau, T, unit_vj(packed, off, panel.shape[1]) if VJ is None else VJ


def qr_blocked(A, config: QRConfig = DEFAULT_CONFIG) -> PackedQR:
    """Blocked QR factorization of A (m x n, m >= n).

    Any m, n: A is zero-padded to the panel grid.  A is not modified.
    bfloat16 storage keeps the packed panels in bfloat16 and taus/Ts/VJs and
    the GEMMs in float32.  Complex A is factored at its own dtype on geqr2
    panels (``complex_config``).  Panels are grouped by
    ``config.stage_schedule`` when it is set (it must be positive and sum
    to the panel count, else ValueError before any work), else by
    ``scan_stages``; groups of up to ``factor_lookahead`` panels.
    """
    A = as_tensor(A, config)
    config = complex_config(A, config)
    m, n = A.shape
    if m < n:
        raise QRShapeError(f"qr_blocked requires m >= n, got {m}x{n}")
    nb = config.panel_width
    m_pad, n_pad = round_up(m, nb), round_up(n, nb)
    k = n_pad // nb
    groups = _groups(k, config.factor_lookahead, config.scan_stages, config.stage_schedule)
    with span("driver.factor"):
        sdt = config.dtype
        cdt = compute_dtype(sdt)
        Ap = torch.zeros((m_pad, n_pad), dtype=cdt, device=A.device)
        Ap[:m, :n] = A.to(sdt)
        taus = torch.zeros((k, nb), dtype=cdt, device=A.device)
        Ts = torch.zeros((k, nb, nb), dtype=cdt, device=A.device)
        VJs = torch.zeros((k, nb, nb), dtype=cdt, device=A.device)
        prec = config.resolved_trailing_precision()
        for i0, i1 in groups:
            with span("driver.group"):
                gsz = i1 - i0
                r0 = i0 * nb
                Vs, Tg = [], []
                for l in range(gsz):
                    i, off = i0 + l, l * nb
                    c = r0 + off
                    block = Ap[r0:, c:c + nb]
                    for V, T in zip(Vs, Tg):
                        block = larfb(block, V, T, transpose=True, precision=prec)
                    packed, tau, T, VJ = _panel_factor(block, off, config)
                    Ap[r0:, c:c + nb] = packed
                    taus[i], Ts[i], VJs[i] = tau, T, VJ
                    Vs.append(panel_v(packed, off, VJ))
                    Tg.append(T.to(cdt))
                rest = Ap[r0:, r0 + gsz * nb:]
                if rest.shape[1]:
                    V, T = _merge_group(Vs, Tg, prec)
                    rest -= gemm(V, gemm(T.mH, gemm(V.mH, rest, prec), prec), prec)
                    if sdt != cdt:
                        rest.copy_(rest.to(sdt))
        return PackedQR(packed=Ap.to(sdt), taus=taus, Ts=Ts, VJs=VJs)


def _group_reflector(factors: PackedQR, i0: int, i1: int, nb: int, dtype,
                     precision: str):
    """Merged (V, T) of panels [i0, i1), V restricted to rows >= i0*nb, the
    merges at ``precision``."""
    packed, _, Ts, VJs = factors
    r0 = i0 * nb
    Vs = [panel_v(packed[r0:, i * nb:(i + 1) * nb].to(dtype), (i - i0) * nb, VJs[i])
          for i in range(i0, i1)]
    return _merge_group(Vs, [Ts[i].to(dtype) for i in range(i0, i1)], precision)


def orgqr(factors: PackedQR, m: int, n: int,
          config: QRConfig = DEFAULT_CONFIG) -> torch.Tensor:
    """Thin explicit Q (m x n) from packed factors.

    Groups of up to ``apply_aggregate`` panels (``_groups`` at
    ``scan_stages``; ``stage_schedule`` is the factor's alone, as in the
    reference's orgqr) are applied last to first, each as one merged block
    reflector.  When group [i0, i1)
    is applied, columns j < i0*nb of Q are still e_j and rows < i0*nb are
    still zero in the other columns, so each group works on the
    diagonal-trailing window Q[i0*nb:, min(i0*nb, n):].
    """
    packed = factors.packed
    m_pad, n_pad = packed.shape
    nb = config.panel_width
    k = n_pad // nb
    cdt = compute_dtype(packed.dtype)
    with span("driver.orgqr"):
        Q = torch.eye(m_pad, n, dtype=cdt, device=packed.device)
        prec = config.resolved_orgqr_precision()
        for i0, i1 in reversed(_groups(k, config.apply_aggregate, config.scan_stages)):
            with span("driver.orgqr_group"):
                r0 = i0 * nb
                c0 = min(r0, n)
                V, T = _group_reflector(factors, i0, i1, nb, cdt, prec)
                Q[r0:, c0:] = larfb(Q[r0:, c0:], V, T, transpose=False, precision=prec)
        return Q[:m].to(packed.dtype)


def ormqr(factors: PackedQR, B, transpose: bool = True,
          config: QRConfig = DEFAULT_CONFIG) -> torch.Tensor:
    """Q^H B (transpose=True) or Q B for B (m x p), without forming Q.

    Groups as ``orgqr``'s: ``scan_stages`` even when a ``stage_schedule``
    is set, as the reference's ``_apply_panels_scan`` reads only that."""
    packed = factors.packed
    B = as_tensor(B, config)
    m_pad, n_pad = packed.shape
    nb = config.panel_width
    k = n_pad // nb
    cdt = compute_dtype(packed.dtype)
    mB = B.shape[0]
    with span("driver.ormqr"):
        Bp = torch.zeros((m_pad, B.shape[1]), dtype=cdt, device=packed.device)
        Bp[:mB] = B.to(packed.device, cdt)
        groups = _groups(k, config.apply_aggregate, config.scan_stages)
        prec = config.resolved_orgqr_precision()
        for i0, i1 in (groups if transpose else reversed(groups)):
            r0 = i0 * nb
            V, T = _group_reflector(factors, i0, i1, nb, cdt, prec)
            Bp[r0:] = larfb(Bp[r0:], V, T, transpose=transpose, precision=prec)
        return Bp[:mB].to(packed.dtype)


def extract_r(factors: PackedQR, n: int, square: bool = True) -> torch.Tensor:
    """R from packed storage (upper triangle)."""
    R = torch.triu(factors.packed[:, :n])
    return R[:n] if square else R
