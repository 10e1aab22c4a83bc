"""Panel-grid arithmetic (``cuda_qr_tpu/utils/geometry.py:17-23``)."""

from __future__ import annotations


def ceildiv(a: int, b: int) -> int:
    return -(-a // b)


def round_up(x: int, m: int) -> int:
    return ceildiv(x, m) * m
