"""float32 GEMMs at the reference's precisions, as the card computes them.

No counterpart module in the reference: there, every einsum takes XLA's
``precision=``, and XLA picks the TPU's passes.  Here every float32 GEMM of
the package is ``gemm(a, b, precision)``, its precision a string passed
down as an argument, and this module is how the card computes each:

  "highest": full float32, TF32 off (``Precision.HIGHEST``);
  "tf32":    one TF32 tensor-core product, 10 explicit mantissa bits in
             (the nearest counterpart of ``Precision.DEFAULT``);
  "high":    3xTF32, the counterpart of ``Precision.HIGH`` (bf16x3 on the
             TPU).  Each operand x is split as hi + lo, hi x rounded to TF32
             (exact in TF32) and lo = x - hi (exact in float32); then
             a b ~ hi_a lo_b + lo_a hi_b + hi_a hi_b in TF32 with float32
             accumulation, the small terms first.  What it adds to float32's
             error is the rounding of lo, ~2^-22 |x|.

The tensor cores add the products of one TF32 GEMM with a bias toward zero
that grows with K (H100: ~23x cuBLAS's float32 GEMM error at K = 8,192,
PERF.md).  So up to K = ``K_CHUNK`` "high" is ONE product of the operands
concatenated along K, [hi_a | lo_a | hi_a] [lo_b; hi_b; hi_b] (one output
written, not three); past it, three products, hi_a hi_b summed over K in
chunks of ``K_CHUNK`` whose products are added in float32 by ``torch.sum``.
cuBLAS has no TF32 matrix-vector product: a 1-D operand's passes run in
IEEE float32 on the card whatever the precision.

Inputs that are not float32 (float64, complex) ignore the precision and
run with TF32 off.  ``_product`` is the one place in the package that
touches PyTorch's TF32 state: it sets
``torch.backends.cuda.matmul.fp32_precision`` around exactly one product
and restores it after, also when the product raises.  It never reads or
writes PyTorch's legacy TF32 flag or its setter: PyTorch (2.9 and later)
refuses to read the legacy flag once a caller has used the
``fp32_precision`` API.
"""

from __future__ import annotations

import torch

from ..utils.config import PRECISIONS

K_CHUNK = 256
_LOW = (1 << 13) - 1               # float32's 23 mantissa bits minus TF32's 10
_HALF = 1 << 12
_MIN_NORMAL, _INF = 0x00800000, 0x7F800000
_LAST_ROUNDED = 0x7F7FEFFF         # larger magnitudes would round up into inf


def split_tf32(x: torch.Tensor):
    """(hi, lo) of float32 x, both float32: hi is x rounded to nearest at 10
    explicit mantissa bits, ties away from zero (PTX's cvt.rna.tf32.f32),
    by integer operations on its bits; lo = x - hi, exactly.  +-0,
    subnormals, inf and NaN give hi = x, lo = 0; a magnitude whose rounding
    would carry past the largest finite float is truncated instead."""
    mag = x.view(torch.int32) & 0x7FFFFFFF
    normal = (mag >= _MIN_NORMAL) & (mag < _INF)
    hi_mag = mag.clamp_(max=_LAST_ROUNDED).add_(_HALF).bitwise_and_(~_LOW)
    hi = torch.where(normal, torch.copysign(hi_mag.view(torch.float32), x), x)
    return hi, torch.where(normal, x - hi, 0.0)


def _product(a: torch.Tensor, b: torch.Tensor, mode: str) -> torch.Tensor:
    """``torch.matmul(a, b)`` with cuBLAS's float32 mode ``mode`` ("ieee" or
    "tf32").  The mode is written only when it differs from the caller's
    ("none", nothing set anywhere, is IEEE), and the caller's comes back
    after: "none" first, so that a mode inherited from
    ``torch.backends.fp32_precision`` stays inherited, else the value read."""
    flags = torch.backends.cuda.matmul
    saved = flags.fp32_precision
    if saved == mode or (saved == "none" and mode == "ieee"):
        return torch.matmul(a, b)
    flags.fp32_precision = mode
    try:
        return torch.matmul(a, b)
    finally:
        flags.fp32_precision = "none"
        if flags.fp32_precision != saved:
            flags.fp32_precision = saved


def _tf32_product(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """One float32 product with TF32 on (``torch.matmul`` semantics)."""
    return _product(a, b, "tf32")


def _tf32_chunked(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a b with TF32 on, K cut into chunks of K_CHUNK: one batched product
    of the chunks (a single ``_tf32_product``), summed in float32, plus the
    remainder's product."""
    k = a.shape[-1]
    q = k // K_CHUNK
    if q < 2 or a.dim() < 2 or b.dim() < 2:
        return _tf32_product(a, b)
    head = q * K_CHUNK
    a_chunks = a[..., :head].unflatten(-1, (q, K_CHUNK)).movedim(-2, -3)   # (..., q, m, c)
    b_chunks = b[..., :head, :].unflatten(-2, (q, K_CHUNK))                # (..., q, c, n)
    out = _tf32_product(a_chunks, b_chunks).sum(-3)
    if head < k:
        out += _tf32_product(a[..., head:], b[..., head:, :])
    return out


def gemm(a: torch.Tensor, b: torch.Tensor, precision: str) -> torch.Tensor:
    """``torch.matmul(a, b)`` (batch-aware, 1-D operands as matmul takes
    them) at ``precision``: "highest", "tf32" or "high" (3xTF32) for float32
    operands; other dtypes run with TF32 off whatever ``precision`` says.
    "highest" is one ``torch.matmul``, nothing more."""
    if precision not in PRECISIONS:
        raise ValueError(f"precision={precision!r}; expected one of {PRECISIONS}")
    if precision == "highest" or a.dtype != torch.float32 or b.dtype != torch.float32:
        return _product(a, b, "ieee")
    if precision == "tf32":
        return _tf32_product(a, b)
    hi_a, lo_a = split_tf32(a)
    hi_b, lo_b = split_tf32(b)
    if a.shape[-1] <= K_CHUNK:
        k_axis = -2 if b.dim() > 1 else 0
        return _tf32_product(torch.cat([hi_a, lo_a, hi_a], -1),
                             torch.cat([lo_b, hi_b, hi_b], k_axis))
    small = _tf32_product(hi_a, lo_b) + _tf32_product(lo_a, hi_b)
    return small + _tf32_chunked(hi_a, hi_b)

