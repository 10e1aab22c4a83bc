"""Carry the reference's state across: packed factors and configuration.

A QR library has no weights; its state is the packed factorization and the
configuration that produced it.  These helpers let a caller factor with the
JAX package, carry the factors over as numpy arrays, and run this package's
orgqr/ormqr/extract_r on the same factors.  Nothing here imports JAX: the
reference's objects are read by attribute and name.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.blocked import PackedQR
from .config import QRConfig

# jax.lax.Precision name -> this package's precision string.  DEFAULT and
# HIGH are the reduced-precision MXU modes; their nearest counterpart on the
# card is TF32 (which is not bitwise or accuracy-equivalent).
_PRECISION = {"HIGHEST": "highest", "HIGH": "tf32", "DEFAULT": "tf32"}

_DTYPES = {"float32": torch.float32, "float64": torch.float64,
           "bfloat16": torch.bfloat16}


def packed_from_numpy(packed, taus, Ts, VJs, device="cpu") -> PackedQR:
    """PackedQR of tensors on ``device`` from four numpy-convertible arrays."""
    def t(x):
        return torch.tensor(np.asarray(x), device=device)
    return PackedQR(packed=t(packed), taus=t(taus), Ts=t(Ts), VJs=t(VJs))


def _precision(p):
    if p is None:
        return None
    name = getattr(p, "name", str(p))
    try:
        return _PRECISION[name]
    except KeyError:
        raise ValueError(f"no counterpart for precision {p!r}") from None


def config_from_reference(cfg, device: str = "cpu") -> QRConfig:
    """This package's QRConfig from a ``cuda_qr_tpu.QRConfig``.

    Carried over: panel_width, panel_base, dtype, precision,
    trailing_precision, orgqr_precision, use_pallas (as use_kernels),
    panel_method, apply_aggregate, factor_lookahead, use_chol_kernel.
    Ignored (no counterpart): driver, scan_stages, stage_schedule,
    interpret, max_vmem_panel_rows, block_rows, use_select_kernel,
    tsqr_leaf.
    """
    dtype_name = np.dtype(cfg.dtype).name
    if dtype_name not in _DTYPES:
        raise ValueError(f"no counterpart for dtype {dtype_name}")
    return QRConfig(
        panel_width=cfg.panel_width,
        panel_base=cfg.panel_base,
        dtype=_DTYPES[dtype_name],
        precision=_precision(cfg.precision),
        trailing_precision=_precision(cfg.trailing_precision),
        orgqr_precision=_precision(cfg.orgqr_precision),
        use_kernels=cfg.use_pallas,
        panel_method=cfg.panel_method,
        apply_aggregate=cfg.apply_aggregate,
        factor_lookahead=cfg.factor_lookahead,
        use_chol_kernel=cfg.use_chol_kernel,
        device=device,
    )
