"""cuda_qr_tpu_torch: the blocked-Householder QR of ``cuda_qr_tpu``, its
column-pivoted QR and the solvers on both, tall-skinny QR (TSQR), batched
QR, the LQ/RQ/QL family, QR updating, the single-device spectral family
(randomized range finders, QDWH polar and SVD, QDWH-eig) and the
distributed layer over ``torch.distributed`` (row mesh, TSQR and CAQR
across ranks, and the ``*_dist`` solvers), in PyTorch, with hand-written
CUDA kernels for an NVIDIA H100 (sm_90a).  Complex input (cgeqrf
conventions) runs on every entry point but ``qr_batched`` and ``slogdet``,
by the reference's routes and with no kernel.  ``python -m
cuda_qr_tpu_torch`` is the command line (``cli.py``); ``oracle/`` holds the
C99 sliding-panel oracle.

The JAX package ``cuda_qr_tpu`` is the reference; this package keeps its
factor storage and conventions so the two compare piece by piece.  It
imports neither JAX nor the JAX package.  Kernels (``csrc/``) are built with
nvcc at first use on a CUDA tensor; CPU tensors take each kernel's plain
PyTorch version.
"""

from .models.batched import qr_batched
from .models.caqr import caqr, caqr_r
from .models.decomp import lq, ql, qr_multiply, rq
from .models.eigh import eigh, eigh_batched
from .models.lstsq import LstsqResult, lstsq, lstsq_dist, solve
from .models.polar import polar, polar_dist, svd, svd_dist
from .models.qr import QRResult, qr, qr_factor, qr_pivoted
from .models.rank import lstsq_rr, matrix_rank, null_space, pinv, slogdet
from .models.rsvd import cond_est, eigh_rand, eigh_rand_dist, norm2_est, orth, rsvd, rsvd_dist
from .models.tsqr import tsqr, tsqr_r
from .models.update import (qr_col_delete, qr_col_insert, qr_rank1_update,
                            qr_row_delete, qr_row_insert, qr_update)
from .ops.blocked import PackedQR, extract_r, orgqr, ormqr, qr_blocked
from .ops.householder import geqr2, larfb, larft, make_reflector, unpack_r, unpack_v
from .parallel.caqr import caqr_ormqr
from .parallel.mesh import row_mesh, row_sharding
from .parallel.tsqr_dist import tsqr_dist
from .utils.config import DEFAULT_CONFIG, MIXED_CONFIG, QRConfig
from .utils.errors import QRError, QRNumericalError, QRShapeError
from .utils.hostio import to_device, to_host
from .utils.verify import QRCheck, check_qr, check_qr_device

__all__ = [
    "qr", "qr_factor", "QRResult", "qr_pivoted", "matrix_rank", "lstsq_rr",
    "pinv", "null_space", "slogdet", "lstsq", "solve", "LstsqResult",
    "PackedQR", "qr_blocked", "orgqr", "ormqr",
    "extract_r", "geqr2", "larfb", "larft", "make_reflector", "unpack_r",
    "unpack_v", "QRConfig", "DEFAULT_CONFIG", "MIXED_CONFIG", "QRCheck",
    "check_qr", "check_qr_device", "QRError", "QRShapeError", "QRNumericalError",
    "tsqr", "tsqr_r", "qr_batched", "lq", "rq", "ql", "qr_multiply", "qr_update",
    "qr_rank1_update", "qr_row_insert", "qr_row_delete", "qr_col_insert",
    "qr_col_delete", "orth", "rsvd", "eigh_rand", "norm2_est", "cond_est", "polar", "svd",
    "eigh", "eigh_batched", "caqr", "caqr_r", "caqr_ormqr", "tsqr_dist", "lstsq_dist",
    "rsvd_dist", "eigh_rand_dist", "polar_dist", "svd_dist", "row_mesh", "row_sharding",
    "to_device", "to_host",
]

__version__ = "0.3.0"
