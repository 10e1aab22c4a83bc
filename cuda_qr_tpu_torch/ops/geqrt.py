"""Householder panel factorization on the geqrt kernel: kernel B2.

Replaces cuda_qr_tpu/ops/geqrt.py (``_geqrt_kernel`` through
``_geqrt_pallas``), the successor of the reference's
``panelHouseholderKernel`` (qr.cu:60-333).  The CUDA source is
``csrc/geqrt.cu``; its note says what bounds it on an H100 and what the
design does about that.  The plain PyTorch version is ``geqr2`` + ``larft``
(``geqrt_base_plain``).

``geqrt_base`` takes the plain version only for a CPU tensor; a CUDA tensor
launches the kernel or raises.  Around it, ``_geqrt_recursive`` halves the
panel down to ``config.panel_base`` columns and joins the halves with GEMMs,
as the reference does.

``geqrt_batched`` factors a stack of equal panels in one launch of the
kernel's batch grid: the TSQR leaves and tree nodes (``models/tsqr.py``),
which the reference runs as a vmapped geqr2 + larft.  Its plain version,
``geqrt_batched_plain``, is the same batch-aware geqr2 + larft.
"""

from __future__ import annotations

import torch

from . import _build
from .householder import geqr2, larfb, larft, unpack_v

MAX_W = 128


def supported(shape, dtype) -> bool:
    """Whether a panel (m x w) or a stack (L x m x w) with row offset 0 fits
    the kernel: 1 <= w <= 128 and w <= m, float32 or float64."""
    m, w = shape[-2:]
    return dtype in (torch.float32, torch.float64) and 1 <= w <= min(MAX_W, m)


def geqrt_base_plain(panel: torch.Tensor, off: int):
    """geqr2 + larft on rows >= off: (packed, tau, T).  Leading dimensions
    are a batch, reduced column by column all at once."""
    lo, tau = geqr2(panel[..., off:, :])
    T = larft(unpack_v(lo), tau)
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


def geqrt_base(panel: torch.Tensor, off: int):
    """Factor rows >= off of an m x w panel (w <= 128, off + w <= m).

    Returns (packed (m x w), tau (w,), T (w x w)); rows above ``off`` are
    returned unchanged.
    """
    m, w = panel.shape
    _check_shape("geqrt_base", m, w, off)
    if panel.device.type == "cpu":
        return geqrt_base_plain(panel, off)
    _check_device("geqrt_base", panel)
    panelT = panel.t().contiguous()      # each panel column contiguous
    packedT = torch.empty_like(panelT)
    tau = torch.empty(w, dtype=panel.dtype, device=panel.device)
    T = torch.empty((w, w), dtype=panel.dtype, device=panel.device)
    lib = _build.load()
    fn = lib.cqt_geqrt_f32 if panel.dtype == torch.float32 else lib.cqt_geqrt_f64
    with torch.cuda.device(panel.device):
        stream = torch.cuda.current_stream().cuda_stream
        _build.check(fn(panelT.data_ptr(), packedT.data_ptr(), tau.data_ptr(),
                        T.data_ptr(), m, w, off, stream), "geqrt")
    geqrt_base.launches += 1
    return packedT.t(), tau, T


geqrt_base.launches = 0


def geqrt_batched(panels: torch.Tensor, off: int):
    """Factor rows >= off of each of L panels (L x m x w, w <= 128) in one
    launch: (packed (L x m x w), tau (L x w), T (L x w x w)).

    The kernel reads each panel column-contiguous, so the wrapper makes a
    transposed copy of the stack (the size of the stack) and returns a
    transposed view of the kernel's output.
    """
    L, m, w = panels.shape
    _check_shape("geqrt_batched", m, w, off)
    if panels.device.type == "cpu":
        return geqrt_batched_plain(panels, off)
    _check_device("geqrt_batched", panels)
    panelsT = panels.transpose(1, 2).contiguous()
    packedT = torch.empty_like(panelsT)
    tau = torch.empty((L, w), dtype=panels.dtype, device=panels.device)
    T = torch.empty((L, w, w), dtype=panels.dtype, device=panels.device)
    if L == 0:
        return packedT.transpose(1, 2), tau, T
    lib = _build.load()
    fn = (lib.cqt_geqrt_batched_f32 if panels.dtype == torch.float32
          else lib.cqt_geqrt_batched_f64)
    with torch.cuda.device(panels.device):
        stream = torch.cuda.current_stream().cuda_stream
        _build.check(fn(panelsT.data_ptr(), packedT.data_ptr(), tau.data_ptr(),
                        T.data_ptr(), L, m, w, off, stream), "geqrt_batched")
    geqrt_batched.launches += 1
    return packedT.transpose(1, 2), tau, T


geqrt_batched.launches = 0


def _geqrt_recursive(panel: torch.Tensor, off: int, config):
    """Recursive panel factorization (Elmroth/Gustavson): factor the left
    half, apply its block reflector to the right half, factor the right
    half, and join T = [[T_l, -T_l (V_l^T V_r) T_r], [0, T_r]]."""
    nb = panel.shape[1]
    if nb <= config.panel_base:
        return geqrt_base(panel, off)
    h = nb // 2
    lp, tau_l, T_l = _geqrt_recursive(panel[:, :h], off, config)
    V_l = unpack_v(lp, off)
    right = larfb(panel[:, h:], V_l, T_l, transpose=True)
    rp, tau_r, T_r = _geqrt_recursive(right, off + h, config)
    V_r = unpack_v(rp, off + h)
    T12 = -(T_l @ (V_l.T @ V_r) @ T_r)
    z = torch.zeros((nb - h, h), dtype=T_l.dtype, device=T_l.device)
    T = torch.cat([torch.cat([T_l, T12], 1), torch.cat([z, T_r], 1)], 0)
    return torch.cat([lp, rp], 1), torch.cat([tau_l, tau_r]), T


def geqrt_panel(panel: torch.Tensor, off: int, config):
    """Factor rows >= off of a full-height (m x nb) panel: (packed, tau, T).

    float32 and float64 run the kernel at the base; bfloat16 is factored in
    float32 and the packed panel cast back.
    """
    cast_back = panel.dtype if panel.dtype == torch.bfloat16 else None
    if cast_back is not None:
        panel = panel.float()
    packed, tau, T = _geqrt_recursive(panel, off, config)
    if cast_back is not None:
        packed = packed.to(cast_back)
    return packed, tau, T
