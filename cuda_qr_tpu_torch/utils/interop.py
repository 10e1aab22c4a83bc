"""Carry the reference's state across: packed factors and configuration.

A QR library has no weights; its state is the packed factorization and the
configuration that produced it.  These helpers let a caller factor with the
JAX package, carry the factors over as numpy arrays, and run this package's
orgqr/ormqr/extract_r (for distributed CAQR factors, caqr_orgqr and
caqr_ormqr) on the same factors.  Nothing here imports JAX: the
reference's objects are read by attribute and name.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.blocked import PackedQR
from .config import DEFAULT_CONFIG, QRConfig

# jax.lax.Precision name -> this package's precision string: HIGH (bf16x3)
# -> "high" (3xTF32), DEFAULT (one bf16 pass) -> "tf32" (one TF32 pass).
_PRECISION = {"HIGHEST": "highest", "HIGH": "high", "DEFAULT": "tf32"}

_DTYPES = {"float32": torch.float32, "float64": torch.float64,
           "bfloat16": torch.bfloat16}


def packed_from_numpy(packed, taus, Ts, VJs, device: str = DEFAULT_CONFIG.device) -> PackedQR:
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


def config_from_reference(cfg, device: str = DEFAULT_CONFIG.device) -> QRConfig:
    """This package's QRConfig from a ``cuda_qr_tpu.QRConfig``.

    Carried over: panel_width, panel_base, dtype, precision,
    trailing_precision, orgqr_precision (each HIGH as "high", 3xTF32),
    use_pallas (as use_kernels),
    panel_method, apply_aggregate, factor_lookahead, scan_stages and
    stage_schedule (they set the panel grouping), use_chol_kernel,
    use_select_kernel, block_rows, tsqr_leaf.  driver="unrolled" becomes
    factor_lookahead=1: the reference's unrolled loop factors one panel,
    then updates the exact trailing block with it (a K = nb larfb), which
    is the factor's group of one; it raises the reference's ValueError
    together with a schedule (``cuda_qr_tpu/ops/blocked.py:375-380``).
    Ignored (no counterpart): interpret and max_vmem_panel_rows, since the
    geqrt panel computes geqr2 + larft's function at any height.
    """
    dtype_name = np.dtype(cfg.dtype).name
    if dtype_name not in _DTYPES:
        raise ValueError(f"no counterpart for dtype {dtype_name}")
    lookahead = cfg.factor_lookahead
    if cfg.driver != "scan":   # the reference runs every other driver unrolled
        if cfg.stage_schedule is not None:
            raise ValueError(
                f"stage_schedule is a scan-driver knob; driver={cfg.driver!r} "
                "ignores it (use driver='scan' or drop the schedule)")
        lookahead = 1
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
        factor_lookahead=lookahead,
        scan_stages=cfg.scan_stages,
        stage_schedule=cfg.stage_schedule,
        use_chol_kernel=cfg.use_chol_kernel,
        use_select_kernel=cfg.use_select_kernel,
        block_rows=cfg.block_rows,
        tsqr_leaf=cfg.tsqr_leaf,
        device=device,
    )


def factors_from_reference(factors, mesh):
    """This package's CAQR factors from the reference's ``CAQRFactors`` or
    ``CAQRFactorsBK`` (any arrays numpy can read), on every rank of
    ``mesh``: each rank takes its slice of the row-sharded fields
    (local_packed, local_taus, local_Ts, Ys), the replicated ones whole."""
    from ..parallel.caqr import CAQRFactors, CAQRFactorsBK
    from ..parallel.mesh import as_row_sharded, mesh_device, shard_rows

    type_ = CAQRFactorsBK if hasattr(factors, "Ys") else CAQRFactors
    sharded = ("local_packed", "local_taus", "local_Ts", "Ys")
    fields = {}
    for name in type_._fields:
        value = np.asarray(getattr(factors, name))
        if name in sharded:
            local, rows = shard_rows(value, mesh)
            fields[name] = as_row_sharded(local, mesh, rows)
        else:
            fields[name] = torch.as_tensor(value, device=mesh_device(mesh))
    return type_(**fields)
