"""Fused Cholesky + inverse of the panel Gram matrix: kernel B1.

Replaces cuda_qr_tpu/ops/pallas_chol.py (``_chol_inv_kernel`` through
``chol_with_inv_pallas``), the one Pallas kernel on the default factor
path: every cholqr2 panel runs it once or twice (``fast_panel._cholqr2``).
The CUDA source is ``csrc/chol_inv.cu``; its note says what bounds it on an
H100 and what the design does about that.  The plain PyTorch version is
``smalllinalg.cholesky_with_inv``.

``chol_with_inv_auto`` is the route every caller takes: the kernel where
the config allows it and ``supported`` admits the matrix (``on_kernel``),
else the plain version at ``config.precision``.  ``chol_with_inv_kernel``
itself takes the plain version only for a CPU tensor; a CUDA tensor
launches the kernel or raises.
"""

from __future__ import annotations

import torch

from . import _build
from .smalllinalg import cholesky_with_inv

_BB = 16
MAX_NB = 512


def supported(shape, dtype) -> bool:
    """The reference's eligibility gate (``pallas_chol.supported``): square
    float32 of side a multiple of 16 in [16, 512], one matrix or a stack.
    The kernel itself takes any side up to 512 in float32 or float64; this
    gate only mirrors which panels the reference sends to its kernel."""
    nb = shape[-1]
    return (dtype == torch.float32 and len(shape) in (2, 3) and shape[-2] == nb
            and nb % _BB == 0 and 16 <= nb <= MAX_NB)


def on_kernel(shape, dtype, config) -> bool:
    """Whether ``chol_with_inv_auto`` sends a matrix of this shape and dtype
    to the kernel under ``config``: the kernels on, the chol_inv kernel on,
    and ``supported``."""
    return config.use_kernels and config.use_chol_kernel and supported(shape, dtype)


def chol_with_inv_auto(G: torch.Tensor, config):
    """cholesky_with_inv of G (n x n) or a stack (b x n x n), on the chol_inv
    kernel's batch grid where ``on_kernel`` (the reference's routing,
    ``smalllinalg.py:148-162``), else the recursion at ``config.precision``.
    The kernel computes in float32 at any precision, as the reference's
    kernel does at HIGHEST (``ops/pallas_chol.py:63,76``)."""
    if on_kernel(G.shape, G.dtype, config):
        return chol_with_inv_kernel(G)
    return cholesky_with_inv(G, config.precision)


def chol_with_inv_kernel(G: torch.Tensor):
    """(L, L^{-1}) of SPD G (nb x nb, or a stack b x nb x nb).

    Non-PD input gives non-finite output, no raise.
    """
    if G.device.type == "cpu":
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
