"""Householder panel factorization on the geqrt kernel: kernel B2.

Replaces cuda_qr_tpu/ops/geqrt.py (``_geqrt_kernel`` through
``_geqrt_pallas``), the successor of the reference's
``panelHouseholderKernel`` (qr.cu:60-333).  The CUDA source is
``csrc/geqrt.cu``; its note says what bounds it on an H100 and what the
design does about that.  The plain PyTorch version is ``geqr2`` + ``larft``
(``geqrt_base_plain``).

``geqrt_auto`` routes TSQR's and CAQR's blocks: the kernel where the config
allows it and ``supported`` admits the shape, else the plain version at
``config.precision``.  ``geqrt_base`` and ``geqrt_batched`` take the plain
version only for a CPU tensor; a CUDA tensor launches the kernel or raises.
The panel method ``geqrt_panel`` halves the panel down to
``config.panel_base`` columns and joins the halves with GEMMs at
``config.precision``, as the reference does; the kernel computes in float32
at any precision, as the reference's does at HIGHEST.

``geqrt_batched`` factors a stack of equal panels in one launch of the
kernel's batch grid: the TSQR leaves and tree nodes (``models/tsqr.py``),
which the reference runs as a vmapped geqr2 + larft.  Its plain version,
``geqrt_batched_plain``, is the same batch-aware geqr2 + larft.  A tree
node stacks two upper triangles, [R_i; R_j]; its caller, which knows that,
passes ``pair=True`` and the kernel runs its triangle-pair body, which
reads only the triangles (LAPACK's tpqrt with l = n) and returns what the
dense body returns.

The kernel reads each panel as it lies (row-major) and writes contiguous
outputs.  ``plan`` decides from the shape alone, before the launch, how it
runs: the sub-panel width, whether the whole panel stays in shared memory,
when the panel is too tall for either, the streaming body, and whether a
float32 leaf takes the blocked body (a TSQR leaf of up to 1,024 rows).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from . import _build
from .gemm import gemm
from .householder import geqr2, larfb, panel_larft, unpack_v

MAX_W = 128
KB = 32                   # widest sub-panel: one warp's lanes
MIN_KB = 4                # narrowest shared-memory sub-panel
MAX_SLICES = 16           # row slices of the other-column products
RED_WORDS = 600           # the column steps' reduction scratch
SMEM_BUDGET = 232_448     # shared memory one CTA may use on an H100 (227 KB)
BLOCKED_ROWS = 1024       # rows the blocked body holds: two a thread of 512


def supported(shape, dtype) -> bool:
    """Whether a panel (m x w) or a stack (L x m x w) with row offset 0 fits
    the kernel: 1 <= w <= 128 and w <= m, float32 or float64."""
    m, w = shape[-2:]
    return dtype in (torch.float32, torch.float64) and 1 <= w <= min(MAX_W, m)


def geqrt_base_plain(panel: torch.Tensor, off: int, precision: str = "highest"):
    """geqr2 + larft on rows >= off: (packed, tau, T), the products at
    ``precision`` ("highest" is the kernel's function).  Leading dimensions
    are a batch, reduced column by column all at once.  T is
    ``panel_larft``'s: a float32 Gram accumulated in float64, as the kernel
    sums it from partial sums."""
    lo, tau = geqr2(panel[..., off:, :], precision=precision)
    T = panel_larft(unpack_v(lo), tau, precision)
    return torch.cat([panel[..., :off, :], lo], -2), tau, T


# The plain version of both wrappers: one panel, or a stack of them.
geqrt_batched_plain = geqrt_base_plain


def _check_shape(name: str, m: int, w: int, off: int) -> None:
    if not (1 <= w <= MAX_W and 0 <= off and off + w <= m):
        raise ValueError(f"{name}: need 1 <= w <= {MAX_W} and off + w <= m, "
                         f"got m={m}, w={w}, off={off}")


def _check_device(name: str, t: torch.Tensor) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {t.device}")
    if t.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"{name}: float32/float64 only, got {t.dtype}")


class Plan(NamedTuple):
    """The kernel's shape plan for one panel shape (see ``plan``)."""
    kb: int          # sub-panel width; 0: the streaming body
    resident: bool   # the whole panel in shared memory
    slices: int      # row slices of the other-column products (partial sums)
    blocked: bool = False   # the blocked body (kb, resident, slices unused)


def blocked_words(m: int, w: int) -> int:
    """The blocked body's shared memory at m x w, in floats: the sub-panel
    column-major (32 x ldr, ldr = m rounded up to 32, plus 4), R's, the
    Gram's and T_s's 32 x 33, tau, the column steps' sums (2 x 160 + 2 x 16
    + 2 x 8 + 16), the inner block's products (8 x 32), Z (32 x 100), each
    warp's ring (16 x 512) and T packed (w (w + 1) / 2)."""
    ldr = -(-m // 32) * 32 + 4
    return (KB * ldr + 3 * KB * (KB + 1) + KB + 2 * 160 + 2 * 16 + 2 * 8 + 16 + 8 * KB
            + KB * 100 + 16 * 512 + w * (w + 1) // 2)


def plan(m: int, w: int, off: int, dtype) -> Plan:
    """The kernel's plan for rows >= off of an m x w panel.

    kb is the sub-panel width, at most 32 (one warp's lanes): min(w, 32),
    then 16, 8, 4.  resident: the whole panel stays in shared memory (row
    stride w + 1), tried first; else only the sub-panel (row stride
    kb + 1).  Beside it the kernel keeps the Gram and T_s (2 x 32 x 33),
    tau (32), the column steps' reduction scratch (600 words) and the other
    columns' products (kb x w) once per row slice,
    up to 16 slices as the rest of the 227 KB allows.  kb = 0 when not even
    a 4-column sub-panel fits: the streaming body.

    blocked: a float32 panel of that sub-panel path (kb = 32, not resident)
    with off = 0 and at most 1,024 rows (a TSQR leaf) takes the blocked
    body instead, which keeps the rest of the plan unread.
    """
    dense = _dense_plan(m, w, off, dtype)
    blocked = (dtype == torch.float32 and off == 0 and m <= BLOCKED_ROWS
               and dense.kb == KB and not dense.resident)
    return dense._replace(blocked=blocked)


def _dense_plan(m: int, w: int, off: int, dtype) -> Plan:
    """The dense bodies' plan: kb, residency and slices as ``plan`` says."""
    size = 8 if dtype == torch.float64 else 4
    rows = m - off

    def room(kb: int, ldp: int) -> int:
        """Row slices that fit beside a sub-panel of stride ldp (0: none)."""
        free = SMEM_BUDGET // size - rows * ldp - 2 * KB * (KB + 1) - KB - RED_WORDS
        return max(0, min(MAX_SLICES, free // (kb * w)))

    top = min(w, KB)
    if room(top, w + 1):
        return Plan(top, True, room(top, w + 1))
    for kb in (top, *(k for k in (16, 8, MIN_KB) if k < top)):
        if room(kb, kb + 1):
            return Plan(kb, False, room(kb, kb + 1))
    return Plan(0, False, 0)


def body(m: int, w: int, off: int, dtype) -> str:
    """Which kernel body a panel shape takes: "blocked" (a float32 leaf),
    "resident" (the whole panel in shared memory), "subpanel" (one sub-panel
    at a time) or "stream"."""
    p = plan(m, w, off, dtype)
    if p.blocked:
        return "blocked"
    return "resident" if p.resident else ("subpanel" if p.kb else "stream")


def pair_occupancy(w: int, dtype) -> int:
    """CTAs of the triangle-pair body one SM holds, by the CUDA runtime's
    occupancy calculator (needs a card)."""
    n = _build.load().cqt_geqrt_pair_ctas_per_sm(w, int(dtype == torch.float64))
    if n < 0:
        raise RuntimeError(f"cqt_geqrt_pair_ctas_per_sm failed at w={w}, {dtype}")
    return n


def _launch(name: str, A: torch.Tensor, lda: int, off: int, pair: bool = False):
    """One launch over a stack A (L panels of m x w, row stride lda, panel
    stride m * lda): (packed (L, m, w) contiguous, tau (L, w), T (L, w, w)).
    ``pair``: the triangle-pair body's own entry (m = 2w, off = 0); a
    blocked plan: the blocked body's own entry."""
    L, m, w = A.shape
    packed = torch.empty((L, m, w), dtype=A.dtype, device=A.device)
    tau = torch.empty((L, w), dtype=A.dtype, device=A.device)
    T = torch.empty((L, w, w), dtype=A.dtype, device=A.device)
    if L == 0:
        return packed, tau, T
    lib = _build.load()
    f32 = A.dtype == torch.float32
    if pair:
        fn = lib.cqt_geqrt_pair_f32 if f32 else lib.cqt_geqrt_pair_f64
        shape = (L, w)
    elif (p := plan(m, w, off, A.dtype)).blocked:
        fn = lib.cqt_geqrt_blocked_f32
        shape = (L, m, w)
    else:
        fn = lib.cqt_geqrt_batched_f32 if f32 else lib.cqt_geqrt_batched_f64
        shape = (L, m, w, off, p.kb, int(p.resident), p.slices)
    with torch.cuda.device(A.device):
        stream = torch.cuda.current_stream().cuda_stream
        _build.check(fn(A.data_ptr(), lda, packed.data_ptr(), tau.data_ptr(), T.data_ptr(),
                        *shape, stream), name)
    return packed, tau, T


def geqrt_base(panel: torch.Tensor, off: int):
    """Factor rows >= off of an m x w panel (w <= 128, off + w <= m).

    Returns (packed (m x w), tau (w,), T (w x w)); rows above ``off`` are
    returned unchanged.  A column slice of a wider row-major matrix is read
    in place (its row stride goes to the kernel).  ``launches`` counts every
    launch, ``leaf_launches`` those of the blocked body.
    """
    m, w = panel.shape
    _check_shape("geqrt_base", m, w, off)
    if panel.device.type == "cpu":
        return geqrt_base_plain(panel, off)
    _check_device("geqrt_base", panel)
    if panel.stride(1) != 1 or panel.stride(0) < w:
        panel = panel.contiguous()
    packed, tau, T = _launch("geqrt", panel[None], panel.stride(0), off)
    geqrt_base.launches += 1
    geqrt_base.leaf_launches += int(plan(m, w, off, panel.dtype).blocked)
    return packed[0], tau[0], T[0]


geqrt_base.launches = 0
geqrt_base.leaf_launches = 0


def geqrt_batched(panels: torch.Tensor, off: int, pair: bool = False):
    """Factor rows >= off of each of L panels (L x m x w, w <= 128) in one
    launch: (packed (L x m x w), tau (L x w), T (L x w x w)), all contiguous.

    ``pair=True`` says that each panel is a triangle pair [R_i; R_j] (m = 2w,
    off = 0, both halves upper triangular; entries below their diagonals
    are not read) and takes the kernel's pair body; it raises on any other
    shape.  The result is the dense body's to rounding, with exact zeros
    below the diagonals of both halves and of T.  A CPU tensor takes the
    plain version either way.  ``launches`` counts every launch,
    ``pair_launches`` those of the pair body, ``leaf_launches`` those of
    the blocked body (``plan``).
    """
    L, m, w = panels.shape
    _check_shape("geqrt_batched", m, w, off)
    if pair and (m != 2 * w or off != 0):
        raise ValueError(f"geqrt_batched: pair=True needs m = 2w and off = 0, "
                         f"got m={m}, w={w}, off={off}")
    if panels.device.type == "cpu":
        return geqrt_batched_plain(panels, off)
    _check_device("geqrt_batched", panels)
    out = _launch("geqrt_batched", panels.contiguous(), w, off, pair)
    geqrt_batched.launches += 1
    geqrt_batched.pair_launches += int(pair)
    geqrt_batched.leaf_launches += int(not pair and plan(m, w, off, panels.dtype).blocked)
    return out


geqrt_batched.launches = 0
geqrt_batched.pair_launches = 0
geqrt_batched.leaf_launches = 0


def geqrt_auto(A: torch.Tensor, config, off: int = 0, pair: bool = False):
    """geqr2 + larft of rows >= off of one (b, n) block (a column slice is
    read in place), or of every block of a stack (L, b, n) at once: on the
    kernel (its batch grid for a stack; ``pair``: its triangle-pair body
    for a tree level) when ``config.use_kernels`` and ``supported``, else the
    plain version at ``config.precision``."""
    if config.use_kernels and supported(A.shape, A.dtype):
        if A.dim() == 2:
            return geqrt_base(A, off)
        return geqrt_batched(A, off, pair=pair)
    return geqrt_batched_plain(A, off, config.precision)


def geqrt_panel(panel: torch.Tensor, off: int, config):
    """Factor rows >= off of a full-height (m x nb) float32 or float64 panel:
    (packed, tau, T), the panel method "geqrt" (the reference's
    ``_geqrt_recursive``).  Recursive (Elmroth/Gustavson): factor the left
    half, apply its block reflector to the right half, factor the right
    half, and join T = [[T_l, -T_l (V_l^T V_r) T_r], [0, T_r]]."""
    nb = panel.shape[1]
    if nb <= config.panel_base:
        return geqrt_base(panel, off)
    h = nb // 2
    lp, tau_l, T_l = geqrt_panel(panel[:, :h], off, config)
    prec = config.precision
    V_l = unpack_v(lp, off)
    right = larfb(panel[:, h:], V_l, T_l, transpose=True, precision=prec)
    rp, tau_r, T_r = geqrt_panel(right, off + h, config)
    V_r = unpack_v(rp, off + h)
    T12 = -gemm(gemm(T_l, gemm(V_l.T, V_r, prec), prec), T_r, prec)
    z = torch.zeros((nb - h, h), dtype=T_l.dtype, device=T_l.device)
    T = torch.cat([torch.cat([T_l, T12], 1), torch.cat([z, T_r], 1)], 0)
    return torch.cat([lp, rp], 1), torch.cat([tau_l, tau_r]), T
