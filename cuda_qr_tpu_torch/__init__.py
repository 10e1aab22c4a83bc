"""cuda_qr_tpu_torch: the blocked-Householder QR of ``cuda_qr_tpu`` in
PyTorch, with hand-written CUDA kernels for an NVIDIA H100 (sm_90a).

The JAX package ``cuda_qr_tpu`` is the reference; this package keeps its
factor storage and conventions so the two compare piece by piece.  It
imports neither JAX nor the JAX package.  Kernels (``csrc/``) are built with
nvcc at first use on a CUDA tensor; CPU tensors take each kernel's plain
PyTorch version.
"""

from .models.qr import QRResult, qr, qr_factor
from .ops.blocked import PackedQR, extract_r, orgqr, ormqr, qr_blocked
from .ops.householder import geqr2, larfb, larft, make_reflector, unpack_r, unpack_v
from .utils.config import DEFAULT_CONFIG, MIXED_CONFIG, QRConfig
from .utils.errors import QRError, QRNumericalError, QRShapeError
from .utils.verify import QRCheck, check_qr, check_qr_device

__all__ = [
    "qr", "qr_factor", "QRResult", "PackedQR", "qr_blocked", "orgqr", "ormqr",
    "extract_r", "geqr2", "larfb", "larft", "make_reflector", "unpack_r",
    "unpack_v", "QRConfig", "DEFAULT_CONFIG", "MIXED_CONFIG", "QRCheck",
    "check_qr", "check_qr_device", "QRError", "QRShapeError", "QRNumericalError",
]
