"""scipy.linalg-compatible QR-updating surface: ``qr_update``,
``qr_insert`` and ``qr_delete`` with scipy's signatures, over the Givens
chains of ``models/update.py`` (counterpart of
``cuda_qr_tpu/models/scipy_compat.py``).

Differences from scipy, stated rather than hidden:
  * thin factors only (Q m x n, R n x n), as ``cuda_qr_tpu_torch.qr``
    returns them; scipy's square-Q modes are not supported;
  * ``overwrite_*`` / ``check_finite`` flags are accepted and ignored
    (inputs are never modified; non-finite inputs propagate NaNs);
  * tensors stay on their device; numpy input goes to
    ``DEFAULT_CONFIG.device`` (the card).
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils.config import DEFAULT_CONFIG
from .update import qr_col_delete, qr_col_insert, qr_row_delete, qr_row_insert
from .update import qr_update as _qr_update_k

__all__ = ["qr_update", "qr_insert", "qr_delete"]


def _t(x) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x
    return torch.tensor(np.asarray(x), device=DEFAULT_CONFIG.device)


def qr_update(Q, R, u, v, overwrite_qruv=False, check_finite=True):
    """QR of A + u v^T from (Q, R); u (m,) or (m, k), v (n,) or (n, k)."""
    del overwrite_qruv, check_finite
    return _qr_update_k(_t(Q), _t(R), _t(u), _t(v))


def qr_insert(Q, R, u, k, which="row", rcond=None, overwrite_qru=False,
              check_finite=True):
    """QR of A with row(s)/column(s) ``u`` inserted before index k.

    which='row': u (n,) or (p, n) -- p rows inserted at k.
    which='col': u (m,) or (m, p) -- p columns inserted at k (needs
    m > n + p so the thin basis can grow).
    """
    del rcond, overwrite_qru, check_finite
    Q, R, u = _t(Q), _t(R), _t(u)
    if which == "row":
        rows = u[None] if u.dim() == 1 else u
        for i in range(rows.shape[0]):
            Q, R = qr_row_insert(Q, R, rows[i], k=k + i)
        return Q, R
    if which == "col":
        cols = u[:, None] if u.dim() == 1 else u
        for i in range(cols.shape[1]):
            Q, R = qr_col_insert(Q, R, cols[:, i], k=k + i)
        return Q, R
    raise ValueError(f"which must be 'row' or 'col', got {which!r}")


def qr_delete(Q, R, k, p=1, which="row", overwrite_qr=False, check_finite=True):
    """QR of A with p rows (or columns) removed starting at index k."""
    del overwrite_qr, check_finite
    Q, R = _t(Q), _t(R)
    if which == "row":
        for _ in range(p):
            Q, R = qr_row_delete(Q, R, k)
        return Q, R
    if which == "col":
        for _ in range(p):
            Q, R = qr_col_delete(Q, R, k)
        return Q, R
    raise ValueError(f"which must be 'row' or 'col', got {which!r}")
