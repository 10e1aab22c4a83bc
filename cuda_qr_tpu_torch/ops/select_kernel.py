"""Greedy QRCP pivot selection on a sketch tile: kernel B3.

Replaces cuda_qr_tpu/ops/pallas_select.py (``_select_kernel`` through
``select_pivots_pallas``), which runs on every block step of the pivoted
factorization (``ops/qrcp.py``).  The CUDA source is
``csrc/select_pivots.cu``: a thread block cluster of 8 CTAs that holds the
tile in its shared memory; its note says what bounds it on an H100 and what
the design does about that.  The plain PyTorch version,
``select_pivots_plain``, is the reference's jnp loop
(``cuda_qr_tpu/ops/qrcp.py:86-104``).

``select_pivots_auto`` is the route QRCP takes: the kernel where the
config allows it and ``supported`` admits the tile, else the plain version.
``select_pivots_kernel`` itself takes the plain version only for a CPU
tensor; a CUDA tensor launches the kernel or raises, and a cluster the card
cannot place raises too.
"""

from __future__ import annotations

import torch

from . import _build
from .gemm import gemm

MAX_TILE_BYTES = 4 * 1024 * 1024
# The kernel's tiles: every one QRCP makes (l = nb + 32, cand = 4 nb, nb <= 256).
MAX_ROWS, MAX_CAND, CAND_STEP = 288, 1024, 64


def in_kernel_range(l: int, cand: int) -> bool:
    """Whether the kernel takes an l x cand tile: l <= 288 and cand <= 1024
    a multiple of 64 (eight CTAs of cand/8 columns, a multiple of 8)."""
    return 1 <= l <= MAX_ROWS and CAND_STEP <= cand <= MAX_CAND and cand % CAND_STEP == 0


def supported(l: int, cand: int, nb: int, dtype) -> bool:
    """The reference's eligibility gate (``pallas_select.supported``):
    float32, cand a multiple of 128, l a multiple of 8, 1 <= nb <= 256, a
    tile of at most 4 MiB.  It mirrors which block steps the reference sends
    to its kernel."""
    return (dtype == torch.float32 and cand % 128 == 0 and l % 8 == 0
            and 1 <= nb <= 256 and l * cand * 4 <= MAX_TILE_BYTES)


def select_pivots_plain(S: torch.Tensor, norms: torch.Tensor, nb: int,
                        precision: str = "highest") -> torch.Tensor:
    """ord (cand,) int32: selection step 0..nb-1 of each chosen column of the
    (l, cand) tile S, -1 elsewhere; norms (cand,) has -1 at ineligible
    columns.  Ties go to the lowest index (``torch.argmax``).  A complex S
    takes real norms and |proj|^2 downdates, as the reference's loop
    (``cuda_qr_tpu/ops/qrcp.py:94-104``), its projection at ``precision``
    ("highest" is the kernel's function).

    The argmax stays on the device and the column is taken with a device
    index, so the loop takes no host sync.
    """
    cand = S.shape[1]
    iota = torch.arange(cand, device=S.device)
    order = torch.full((cand,), -1, dtype=torch.int32, device=S.device)
    zero = torch.zeros((), dtype=norms.dtype, device=S.device)
    for i in range(nb):
        p = torch.argmax(norms)
        q = S.index_select(1, p.reshape(1))                      # (l, 1)
        nq = torch.sqrt(torch.clamp_min((q * q.conj()).real.sum(), 0))
        qn = q * torch.where(nq > 0, 1 / nq, zero)
        proj = gemm(qn.mH, S, precision)                         # (1, cand)
        S = S - qn * proj
        nn = torch.maximum(norms - (proj[0] * proj[0].conj()).real, zero)
        hit = iota == p
        norms = torch.where(hit | (norms < 0), -1.0, nn)
        order = torch.where(hit, i, order)
    return order


def selection_margin(S: torch.Tensor, norms: torch.Tensor, nb: int) -> float:
    """Smallest relative gap, over the nb greedy steps run in float64,
    between a step's largest norm and the largest one strictly below it.

    Exact ties are broken by index in every version; a margin far above
    float32 rounding (~1e-7) means the tile decides ord, so the kernel and
    the plain version must agree on it exactly.  One host sync a step.
    """
    S, norms = S.double(), norms.double()
    iota = torch.arange(S.shape[1], device=S.device)
    worst = 1.0
    for _ in range(nb):
        top = norms.max()
        below = norms[norms < top]
        if below.numel():
            worst = min(worst, float((top - below.max()) / top))
        p = torch.argmax(norms)
        qn = S[:, p] / S[:, p].norm()
        proj = qn @ S
        S = S - torch.outer(qn, proj)
        norms = torch.where((iota == p) | (norms < 0), -1.0,
                            torch.clamp_min(norms - proj * proj, 0))
    return worst


def select_pivots_auto(S: torch.Tensor, norms: torch.Tensor, nb: int,
                       config=None) -> torch.Tensor:
    """ord of the greedy selection of nb columns of the tile S (l, cand).
    config=None takes the plain selection at "highest"; a config with
    use_kernels and use_select_kernel takes the kernel where ``supported``
    admits the tile, else the plain selection at ``config.precision``."""
    if config is None:
        return select_pivots_plain(S, norms, nb)
    l, cand = S.shape
    if config.use_kernels and config.use_select_kernel and supported(l, cand, nb, S.dtype):
        return select_pivots_kernel(S, norms, nb)
    return select_pivots_plain(S, norms, nb, config.precision)


def select_pivots_kernel(S: torch.Tensor, norms: torch.Tensor, nb: int) -> torch.Tensor:
    """ord of the greedy selection of nb columns of S (l, cand); see
    ``select_pivots_plain``.  S is not modified."""
    if S.device.type == "cpu":
        return select_pivots_plain(S, norms, nb)
    if S.device.type != "cuda":
        raise ValueError(f"select_pivots_kernel: unsupported device {S.device}")
    if S.dtype != torch.float32 or norms.dtype != torch.float32:
        raise TypeError(f"select_pivots_kernel: float32 only, got {S.dtype}, {norms.dtype}")
    if S.dim() != 2 or tuple(norms.shape) != (S.shape[1],) or norms.device != S.device:
        raise ValueError(f"select_pivots_kernel: need S (l, cand) and norms (cand,) on one "
                         f"device, got {tuple(S.shape)}, {tuple(norms.shape)}")
    if not (S.is_contiguous() and norms.is_contiguous()):
        raise ValueError("select_pivots_kernel: S and norms must be contiguous")
    l, cand = S.shape
    if not (1 <= nb <= cand and in_kernel_range(l, cand)):
        raise ValueError(f"select_pivots_kernel: need 1 <= nb <= cand, l <= {MAX_ROWS} and "
                         f"cand <= {MAX_CAND} a multiple of {CAND_STEP}, got l={l}, "
                         f"cand={cand}, nb={nb}")
    order = torch.empty(cand, dtype=torch.int32, device=S.device)
    lib = _build.load()
    with torch.cuda.device(S.device):
        stream = torch.cuda.current_stream().cuda_stream
        _build.check(lib.cqt_select_pivots_f32(S.data_ptr(), norms.data_ptr(),
                                               order.data_ptr(), l, cand, nb, stream),
                     "select_pivots")
    select_pivots_kernel.launches += 1
    return order


select_pivots_kernel.launches = 0
