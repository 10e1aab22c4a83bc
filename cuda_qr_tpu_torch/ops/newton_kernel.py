"""Newton-Schulz inverse of the basis-kernel panel and its certificate in
one launch: kernel B4.

Replaces no Pallas kernel.  It stands beside the reference's jnp loop
``newton_inverse`` (``cuda_qr_tpu/ops/smalllinalg.py``), which the reference
runs as one device-side ``lax.while_loop``, and the certificate
``max|N|^2 max|I - M N|`` that its basis-kernel panel computes after it
(``cuda_qr_tpu/ops/fast_panel.py``).  Eager PyTorch ran that loop from the
host, one host sync and ~9 launches an iteration; every float32 "highest"
``cholqr2_bk`` panel on the card now launches this kernel once and takes no
sync before the certificate's.  The CUDA source is ``csrc/newton_inv.cu``:
a thread block cluster of 8 CTAs; its note says what bounds it on an H100
and what the design does about that.  The plain PyTorch version is
``smalllinalg.newton_certified``.

``newton_certified_auto`` is the route the panel takes: the kernel where
``on_kernel`` says so, else the plain version at ``config.precision``.
``newton_certified_kernel`` itself checks dtype and shape first, then takes
the plain version for a CPU tensor; a CUDA tensor launches the kernel or
raises.
"""

from __future__ import annotations

import torch

from . import _build
from .smalllinalg import newton_certified

NB_STEP, MAX_NB = 16, 128
TOL, MAX_ITERS = 2e-4, 48   # newton_inverse's float32 defaults


def supported(shape, dtype) -> bool:
    """The kernel's matrices: one square float32 M of side a multiple of 16
    in [16, 128] (eight CTAs of side/8 rows, two rows a thread)."""
    return (dtype == torch.float32 and len(shape) == 2 and shape[0] == shape[1]
            and shape[0] % NB_STEP == 0 and NB_STEP <= shape[0] <= MAX_NB)


def on_kernel(M: torch.Tensor, config) -> bool:
    """Whether the basis-kernel panel's Newton-Schulz inverse and its
    certificate run on the kernel: a float32 M on the card at "highest" (the
    kernel computes in float32 FFMA), of a side the kernel takes.  float64,
    the "tf32"/"high" panels, wider panels and the CPU keep the plain chain."""
    return (config.use_kernels and config.precision == "highest" and M.is_cuda
            and supported(M.shape, M.dtype))


def newton_certified_auto(M: torch.Tensor, config):
    """(N, err, cert, iters) of M (nb x nb): the kernel where ``on_kernel``,
    else ``smalllinalg.newton_certified`` at ``config.precision``."""
    if on_kernel(M, config):
        return newton_certified_kernel(M)
    return newton_certified(M, config.precision)


def newton_certified_kernel(M: torch.Tensor, tol: float = TOL, max_iters: int = MAX_ITERS):
    """(N, err, cert, iters) of M (nb x nb): N = M^{-1} by Newton-Schulz,
    err = max|I - M X| of the iterate before N (inf if no iteration ran),
    cert = max|N|^2 max|I - M N|, iters the iterations run (int32); all
    0-d tensors on M's device but N.  See ``smalllinalg.newton_certified``.
    A NaN in M gives a NaN err and cert after one iteration, no raise."""
    if M.dtype != torch.float32:
        raise TypeError(f"newton_certified_kernel: float32 only, got {M.dtype}")
    if not supported(M.shape, M.dtype):
        raise ValueError(f"newton_certified_kernel: need a square side a multiple of {NB_STEP} "
                         f"in [{NB_STEP}, {MAX_NB}], got {tuple(M.shape)}")
    if M.device.type == "cpu":
        return newton_certified(M, "highest", tol, max_iters)
    if M.device.type != "cuda":
        raise ValueError(f"newton_certified_kernel: unsupported device {M.device}")
    M = M.contiguous()
    nb = M.shape[0]
    N = torch.empty_like(M)
    out = torch.empty(2, dtype=torch.float32, device=M.device)
    iters = torch.empty((), dtype=torch.int32, device=M.device)
    lib = _build.load()
    with torch.cuda.device(M.device):
        stream = torch.cuda.current_stream().cuda_stream
        _build.check(lib.cqt_newton_inv_f32(M.data_ptr(), N.data_ptr(), out[0].data_ptr(),
                                            out[1].data_ptr(), iters.data_ptr(), nb, tol,
                                            max_iters, stream), "newton_inv")
    newton_certified_kernel.launches += 1
    return N, out[0], out[1], iters


newton_certified_kernel.launches = 0
