"""Structured errors (the counterpart of ``cuda_qr_tpu/utils/errors.py``).

Shape problems raise typed exceptions; numerical breakdown inside a
factorization degrades to the same fallbacks as the reference (tau = 0
identity reflectors for zero columns, CholeskyQR2 -> Householder on
breakdown) rather than producing NaN.
"""

from __future__ import annotations


class QRError(Exception):
    """Base class for cuda_qr_tpu_torch errors."""


class QRShapeError(QRError, ValueError):
    """Invalid or incompatible matrix shapes."""


class QRNumericalError(QRError, ArithmeticError):
    """Non-finite values or numerical breakdown detected."""
