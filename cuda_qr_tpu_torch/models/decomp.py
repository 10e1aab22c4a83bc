"""Triangular-orthogonal decompositions derived from QR: LQ, RQ, QL and
``qr_multiply`` (counterpart of ``cuda_qr_tpu/models/decomp.py``).

Each is a reduction onto the port's blocked QR by conjugate transposes and
row/column reversals, so every member runs the same panels and kernels as
``qr`` and inherits its gradient (real input) and its complex support.  Conventions match scipy.linalg:
  lq: A = L Q          L (m x k) lower-trapezoidal, Q (k x n) orthonormal rows
  rq: A = R Q          R (m x k) upper-trapezoidal (k = n when m >= n)
  ql: A = Q L          Q (m x k) orthonormal cols,  L (k x n) lower
with k = min(m, n) in economic ("reduced") mode.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..ops.blocked import as_tensor
from ..utils.config import DEFAULT_CONFIG, QRConfig
from ..utils.errors import QRShapeError
from .qr import qr, qr_factor


def _ct(X: torch.Tensor) -> torch.Tensor:
    """Conjugate transpose, resolved (a real X gives the plain transpose view)."""
    return X.mH.resolve_conj()


def lq(A, config: QRConfig = DEFAULT_CONFIG, mode: str = "reduced"):
    """LQ decomposition: A = L @ Q with Q's rows orthonormal.

    The conjugate transpose of qr(A^H): A^H = Q~ R~ gives A = R~^H Q~^H.
    mode='reduced' gives L (m x k), Q (k x n); mode='l' returns L only;
    mode='complete' gives L (m x n), Q (n x n).
    """
    A = as_tensor(A, config)
    if mode == "l":
        return _ct(qr(A.mH, config, mode="r"))
    qmode = "complete" if mode == "complete" else "reduced"
    Qt, Rt = qr(A.mH, config, mode=qmode)
    return _ct(Rt), _ct(Qt)


def rq(A, config: QRConfig = DEFAULT_CONFIG, mode: str = "reduced"):
    """RQ decomposition: A = R @ Q with Q's rows orthonormal, R upper.

    With J the exchange matrix, (J_m A)^H = Q~ R~ gives
    A = (J R~^H J)(J Q~^H), and J L J of a lower-triangular L is upper.
    mode='r' returns R only; mode='complete' gives R (m x n), Q (n x n).
    """
    A = as_tensor(A, config)
    B = torch.flip(A, (0,)).mH        # (J_m A)^H, n x m
    if mode == "r":
        return torch.flip(_ct(qr(B, config, mode="r")), (0, 1))
    qmode = "complete" if mode == "complete" else "reduced"
    Qt, Rt = qr(B, config, mode=qmode)
    return torch.flip(_ct(Rt), (0, 1)), torch.flip(_ct(Qt), (0,))


def ql(A, config: QRConfig = DEFAULT_CONFIG, mode: str = "reduced"):
    """QL decomposition: A = Q @ L with Q's columns orthonormal, L lower.

    A J_n = Q~ R~ gives A = (Q~ J)(J R~ J), and J R~ J is lower.
    mode='l' returns L only; mode='complete' gives Q (m x m), L (m x n).
    """
    A = as_tensor(A, config)
    B = torch.flip(A, (1,))           # A J_n
    if mode == "l":
        return torch.flip(qr(B, config, mode="r"), (0, 1))
    qmode = "complete" if mode == "complete" else "reduced"
    Qt, Rt = qr(B, config, mode=qmode)
    return torch.flip(Qt, (1,)), torch.flip(Rt, (0, 1))


def qr_multiply(A, C, mode: str = "left", transpose: bool = False,
                config: QRConfig = DEFAULT_CONFIG):
    """Factor A = Q R and multiply C by the thin Q without forming it.

    Returns (QC, R) for mode='left' (C is (k x p); (m x p) out) or
    (CQ, R) for mode='right' (C is (p x m); (p x k) out), k = min(m, n).
    transpose=True applies Q^H instead of Q (then mode='left' takes C
    (m x p) -> (k x p), mode='right' takes C (p x k) -> (p x m)).
    Everything goes through the compact ormqr panel sweep.
    """
    A, C = as_tensor(A, config), as_tensor(C, config)
    m, n = A.shape
    k = min(m, n)
    if m < n:   # factor the square left block; R gets the Q^T A2 tail
        res = qr_factor(A[:, :m], config)
        R12 = res.apply_qt(A[:, m:].to(res.factors.packed.dtype))[:m]
        R = torch.cat([res.R, R12], 1)
    else:
        res = qr_factor(A, config)
        R = res.R
    C2 = C if C.dim() == 2 else C[:, None]

    if mode == "left":
        if transpose:
            out = res.apply_qt(C2)[:k]
        else:
            if C2.shape[0] != k:
                raise QRShapeError(f"mode='left' expects C with {k} rows, "
                                   f"got {tuple(C2.shape)}")
            out = res.apply_q(F.pad(C2, (0, 0, 0, m - k)))
    elif mode == "right":
        if transpose:
            out = _ct(res.apply_q(F.pad(C2.mH, (0, 0, 0, m - k))))
        else:
            out = _ct(res.apply_qt(C2.mH)[:k])
    else:
        raise QRShapeError(f"mode must be 'left' or 'right', got {mode!r}")
    if C.dim() == 1:
        out = out[:, 0] if mode == "left" else out[0, :]
    return out, R
