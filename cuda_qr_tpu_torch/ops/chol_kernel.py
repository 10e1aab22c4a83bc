"""Fused Cholesky + inverse of the panel Gram matrix: kernel B1.

Replaces cuda_qr_tpu/ops/pallas_chol.py (``_chol_inv_kernel`` through
``chol_with_inv_pallas``), the one Pallas kernel on the default factor
path: every cholqr2 panel runs it once or twice (``fast_panel._cholqr2``).
The CUDA source is ``csrc/chol_inv.cu``; its note says what bounds it on an
H100 and what the design does about that.  The plain PyTorch version is
``smalllinalg.cholesky_with_inv``.

``chol_with_inv_kernel`` takes the plain version only for a CPU tensor; a
CUDA tensor launches the kernel or raises.
"""

from __future__ import annotations

import torch

from . import _build
from .smalllinalg import cholesky_with_inv

_BB = 16
MAX_NB = 512


def supported(shape, dtype) -> bool:
    """The reference's eligibility gate (``pallas_chol.supported``): square
    float32 of side a multiple of 16 in [16, 512].  The kernel itself takes
    any side up to 512 in float32 or float64; this gate only mirrors which
    panels the reference sends to its kernel."""
    nb = shape[0]
    return dtype == torch.float32 and nb % _BB == 0 and 16 <= nb <= MAX_NB


def chol_with_inv_kernel(G: torch.Tensor):
    """(L, L^{-1}) of SPD G (nb x nb, or a stack b x nb x nb).

    Non-PD input gives non-finite output, no raise.
    """
    if G.device.type == "cpu":
        if G.dim() == 3:
            pairs = [cholesky_with_inv(g) for g in G]
            return (torch.stack([p[0] for p in pairs]),
                    torch.stack([p[1] for p in pairs]))
        return cholesky_with_inv(G)
    if G.device.type != "cuda":
        raise ValueError(f"chol_with_inv_kernel: unsupported device {G.device}")
    if G.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"chol_with_inv_kernel: float32/float64 only, got {G.dtype}")
    if G.dim() not in (2, 3) or G.shape[-1] != G.shape[-2]:
        raise ValueError(f"chol_with_inv_kernel: square matrix or stack, got {tuple(G.shape)}")
    nb = G.shape[-1]
    if not 1 <= nb <= MAX_NB:
        raise ValueError(f"chol_with_inv_kernel: side must be in [1, {MAX_NB}], got {nb}")
    G = G.contiguous()
    batch = G.shape[0] if G.dim() == 3 else 1
    L = torch.empty_like(G)
    Li = torch.empty_like(G)
    lib = _build.load()
    fn = lib.cqt_chol_inv_f32 if G.dtype == torch.float32 else lib.cqt_chol_inv_f64
    with torch.cuda.device(G.device):
        stream = torch.cuda.current_stream().cuda_stream
        _build.check(fn(G.data_ptr(), L.data_ptr(), Li.data_ptr(), nb, batch,
                        stream), "chol_inv")
    chol_with_inv_kernel.launches += 1
    return L, Li


chol_with_inv_kernel.launches = 0
