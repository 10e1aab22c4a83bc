"""Configuration for the PyTorch/CUDA QR library.

Counterpart of ``cuda_qr_tpu/utils/config.py``: one frozen dataclass of the
knobs the blocked factorization reads.  Knobs that existed only to bound
XLA/Mosaic compile size or the TPU's VMEM (``driver``, ``scan_stages``,
``stage_schedule``, ``interpret``, ``max_vmem_panel_rows``) have no
counterpart, nor do the QRCP/TSQR knobs (``block_rows``,
``use_select_kernel``, ``tsqr_leaf``) whose modules are not ported yet.

Precision.  The reference's ``jax.lax.Precision`` becomes a string:
  "highest": float32 GEMMs in full float32 (TF32 off) -- Precision.HIGHEST;
  "tf32":    TF32 tensor-core GEMMs (10-bit mantissa inputs).  TF32 is NOT
             the TPU's bf16x3 ``HIGH`` (~24 bits): no accuracy certificate
             carries over from the reference's MIXED mode.
float64 GEMMs are unaffected by either value.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Optional

import torch

PRECISIONS = ("highest", "tf32")


@dataclasses.dataclass(frozen=True)
class QRConfig:
    """Configuration for blocked QR.

    Attributes:
      panel_width: columns per panel (nb).
      panel_base: base width of the recursive geqrt panel; sub-panels of at
        most this many columns run the geqrt kernel.
      dtype: computation dtype (float32, float64, or bfloat16 storage with
        float32 panels).
      precision: GEMM precision of the panel factorization.
      trailing_precision / orgqr_precision: precision overrides for the
        trailing update and for orgqr/ormqr (None = follow ``precision``).
      use_kernels: False forces the plain ``geqr2`` panel path whatever
        ``panel_method`` says (the reference's ``use_pallas`` escape hatch,
        ``cuda_qr_tpu/ops/blocked.py:84``).
      panel_method: "cholqr2_bk" (CholeskyQR2 + basis-kernel V/T, default),
        "cholqr2_hr" (CholeskyQR2 + Householder reconstruction), "geqrt"
        (recursive column Householder on the geqrt kernel), "geqr2" (plain
        per-column Householder).
      apply_aggregate: orgqr/ormqr apply up to this many panels as one merged
        block reflector.
      factor_lookahead: panels per left-looking group of the factorization;
        one merged g*nb-deep trailing update per group.
      use_chol_kernel: run the panel Gram Cholesky + inverse on the chol_inv
        kernel where it is eligible (float32, nb a multiple of 16, <= 512).
      device: where numpy input is placed; tensor input stays on its device.
    """

    panel_width: int = 128
    panel_base: int = 32
    dtype: torch.dtype = torch.float32
    precision: str = "highest"
    trailing_precision: Optional[str] = None
    orgqr_precision: Optional[str] = None
    use_kernels: bool = True   # the reference's ``use_pallas``
    panel_method: str = "cholqr2_bk"
    apply_aggregate: int = 4
    factor_lookahead: int = 4
    use_chol_kernel: bool = True
    device: str = "cpu"

    def __post_init__(self):
        for name in ("precision", "trailing_precision", "orgqr_precision"):
            value = getattr(self, name)
            if value is not None and value not in PRECISIONS:
                raise ValueError(f"{name}={value!r}; expected one of {PRECISIONS}")
        if self.panel_method not in ("cholqr2_bk", "cholqr2_hr", "geqrt", "geqr2"):
            raise ValueError(f"unknown panel_method {self.panel_method!r}")

    def resolved_trailing_precision(self) -> str:
        return self.trailing_precision or self.precision

    def resolved_orgqr_precision(self) -> str:
        return self.orgqr_precision or self.precision

    def replace(self, **kw) -> "QRConfig":
        return dataclasses.replace(self, **kw)


@contextlib.contextmanager
def matmul_precision(precision: str):
    """Set float32 GEMM precision for the enclosed GEMMs and restore it after.

    The flag is process-global in PyTorch, so it is set around exactly the
    GEMMs that asked for it and never left changed.
    """
    flags = torch.backends.cuda.matmul
    saved = flags.allow_tf32
    flags.allow_tf32 = precision == "tf32"
    try:
        yield
    finally:
        flags.allow_tf32 = saved


DEFAULT_CONFIG = QRConfig()

# Trailing-update GEMMs in TF32, panels and orgqr in full float32: the
# counterpart of the reference's MIXED_CONFIG (trailing bf16x3).  orgqr stays
# full precision for the reference's reason: every panel application adds a
# rounded term directly into Q.  Whether TF32 keeps the n*eps residual gate
# at 8192^2 is measured on the card (PERF.md), not inherited.
MIXED_CONFIG = QRConfig(trailing_precision="tf32")
