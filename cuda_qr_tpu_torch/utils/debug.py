"""Debug utilities (``cuda_qr_tpu/utils/debug.py``): matrix printing, an
environment-gated trace print and a finiteness guard.

The source paper's CPU oracle doubles as a golden-trace debugger (printf of
every panel, reflector and tau, qr.c:88-90, 153-156, 238-251) and ships a
``printMat`` (qr.cu:35-47).  Here:

  * ``print_mat``: aligned print of a (possibly truncated) matrix;
  * ``trace_print``: a formatted print when CUDA_QR_TRACE=1, which reads its
    tensor arguments from the device only then (nothing is read otherwise);
  * ``assert_finite``: a NaN/inf guard with a structured error.
"""

from __future__ import annotations

import os

import numpy as np
import torch


def trace_enabled() -> bool:
    return os.environ.get("CUDA_QR_TRACE", "0") == "1"


def _host(x):
    if isinstance(x, torch.Tensor):
        from .hostio import to_host
        return to_host(x)
    return np.asarray(x)


def print_mat(A, name: str = "", max_dim: int = 16) -> None:
    """Aligned print of a (possibly truncated) matrix (printMat analog)."""
    A = _host(A)
    if name:
        print(f"{name} ({A.shape[0]}x{A.shape[1]}):")
    r, c = min(A.shape[0], max_dim), min(A.shape[1], max_dim)
    for i in range(r):
        print(" ".join(f"{A[i, j]:9f}" for j in range(c))
              + (" ..." if c < A.shape[1] else ""))
    if r < A.shape[0]:
        print("...")


def trace_print(fmt: str, *args) -> None:
    """``print(fmt.format(*args))`` when CUDA_QR_TRACE=1, tensors read to
    the host first; with the flag off nothing is read or printed."""
    if trace_enabled():
        print(fmt.format(*(_host(a) if isinstance(a, torch.Tensor) else a for a in args)))


def assert_finite(x, what: str = "array") -> None:
    """Host-side finiteness check with a structured error."""
    from .errors import QRNumericalError
    arr = _host(x)
    if not np.all(np.isfinite(arr)):
        bad = int(np.sum(~np.isfinite(arr)))
        raise QRNumericalError(
            f"{what}: {bad}/{arr.size} non-finite entries "
            f"(first at {tuple(np.argwhere(~np.isfinite(arr))[0])})")
