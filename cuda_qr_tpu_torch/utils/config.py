"""Configuration for the PyTorch/CUDA QR library.

Counterpart of ``cuda_qr_tpu/utils/config.py``: one frozen dataclass of the
knobs the blocked factorization reads.  ``scan_stages`` and
``stage_schedule`` are kept for the panel grouping they set (the reference
sized them for compile time; here they decide Q's rounding and the GEMM
depths).  The reference's ``driver="unrolled"`` is ``factor_lookahead=1``
(``utils/interop.config_from_reference``).  ``interpret`` and
``max_vmem_panel_rows`` have no counterpart: the geqrt panel computes
geqr2 + larft's function at any height.

Precision.  The reference's ``jax.lax.Precision`` becomes a string
(``ops/gemm.py`` computes each on the card):
  "highest": float32 GEMMs in full float32 (TF32 off) -- Precision.HIGHEST;
  "tf32":    one TF32 tensor-core pass (10 explicit mantissa bits in) --
             the nearest counterpart of Precision.DEFAULT;
  "high":    3xTF32, three TF32 passes on operands split as hi + lo -- the
             counterpart of Precision.HIGH (bf16x3 on the TPU).  Its error
             beyond float32's is the rounding of lo, ~2^-22 |x|.
Each of ``precision``, ``trailing_precision`` and ``orgqr_precision`` takes
any of the three.  Every float32 GEMM of the package is
``ops.gemm.gemm(a, b, precision)`` with its precision passed down as an
argument, so no module sets a process-wide flag around a block of code and
no result depends on the TF32 state the caller left set.  float64 and
complex GEMMs run with TF32 off whatever the value.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

PRECISIONS = ("highest", "tf32", "high")
TSQR_LEAVES = ("householder", "cholqr2")


@dataclasses.dataclass(frozen=True)
class QRConfig:
    """Configuration for blocked QR.

    Attributes:
      panel_width: columns per panel (nb).
      panel_base: base width of the recursive geqrt panel; sub-panels of at
        most this many columns run the geqrt kernel.
      dtype: computation dtype (float32, float64, or bfloat16 storage with
        float32 panels).
      precision: GEMM precision of the panel factorization and of every
        GEMM the reference runs at ``config.precision`` (QRCP, TSQR, the
        spectral family, CAQR, the VJP): "highest", "tf32" or "high".
      trailing_precision / orgqr_precision: precision overrides for the
        trailing update of ``qr_blocked`` (and the two full-height GEMMs of
        TSQR's direct cholqr2 path) and for orgqr/ormqr (None = follow
        ``precision``).  The pivoted factorization runs every GEMM at
        ``precision``, as the reference's does.
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
      scan_stages: the k panels are cut into this many stages, and a stage of
        kg panels is grouped in the largest power of two <= apply_aggregate
        (or factor_lookahead) that divides kg, as the reference groups them.
        Here it sets only that grouping, which decides Q's rounding; nothing
        here is about compile size.
      stage_schedule: panels per stage of the FACTOR, summing to its panel
        count k (None = ``scan_stages`` equal stages); a stage of kg panels
        is grouped as above, in groups of ``_group_width(kg,
        factor_lookahead)``.  orgqr and ormqr keep ``scan_stages``, as the
        reference's do.  ``qr_blocked`` raises ValueError on a schedule that
        is not positive or does not sum to k.
      use_chol_kernel: run the panel Gram Cholesky + inverse on the chol_inv
        kernel where it is eligible (float32, nb a multiple of 16, <= 512).
      use_select_kernel: run the QRCP pivot selection on the select_pivots
        kernel where it is eligible (``ops/select_kernel.supported``).
      block_rows: rows per TSQR leaf (at least 2n are used).
      tsqr_leaf: TSQR leaf factorization, "householder" (unconditionally
        stable) or "cholqr2" (two-pass CholeskyQR2 with a Householder-tree
        fallback when its certificates fail).
      device: where numpy input is placed, the card unless the caller asks
        for "cpu"; tensor input stays on its device.  Without a card, numpy
        input under the default raises torch's own error: nothing falls back
        to the host.
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
    scan_stages: int = 4
    stage_schedule: Optional[tuple[int, ...]] = None
    use_chol_kernel: bool = True
    use_select_kernel: bool = True
    block_rows: int = 1024
    tsqr_leaf: str = "householder"
    device: str = "cuda"

    def __post_init__(self):
        if self.precision not in PRECISIONS:
            raise ValueError(f"precision={self.precision!r}; expected one of {PRECISIONS}")
        for name in ("trailing_precision", "orgqr_precision"):
            value = getattr(self, name)
            if value is not None and value not in PRECISIONS:
                raise ValueError(f"{name}={value!r}; expected one of {PRECISIONS}")
        if self.panel_method not in ("cholqr2_bk", "cholqr2_hr", "geqrt", "geqr2"):
            raise ValueError(f"unknown panel_method {self.panel_method!r}")
        if self.tsqr_leaf not in TSQR_LEAVES:
            raise ValueError(f"tsqr_leaf={self.tsqr_leaf!r}; expected one of {TSQR_LEAVES}")

    def resolved_trailing_precision(self) -> str:
        return self.trailing_precision or self.precision

    def resolved_orgqr_precision(self) -> str:
        return self.orgqr_precision or self.precision

    def replace(self, **kw) -> "QRConfig":
        return dataclasses.replace(self, **kw)


DEFAULT_CONFIG = QRConfig()

# qr_blocked's trailing-update GEMMs (and the two full-height GEMMs of the
# direct cholqr2 TSQR) at "high", 3xTF32; panels and orgqr in full float32
# (QRCP stays at ``precision`` throughout): the counterpart of the
# reference's MIXED_CONFIG (trailing bf16x3).  orgqr stays full precision for
# the reference's reason: every panel application adds a rounded term
# directly into Q.  One TF32 pass (trailing_precision="tf32") is not this
# mode: its residual stays near 7e-4 at every n, over the n*eps gate below
# n ~ 6,000 (PERF.md).
MIXED_CONFIG = QRConfig(trailing_precision="high")
