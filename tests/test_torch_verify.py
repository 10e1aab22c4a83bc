"""check_qr / check_qr_device of the port against the reference's check_qr
on the same factorization (numpy.linalg.qr's): complex factors are widened
to complex128 and Q^T reads Q^H, and real input gives the numbers it always
gave.  check_qr runs the reference's float64 host arithmetic, so its
numbers are equal; check_qr_device sums in another order and agrees to 1e-6
relative or 1e-15 (the float64 rounding of entries of size 1e-8).
"""

import numpy as np
import pytest
import torch

from cuda_qr_tpu.utils import verify as rverify
from cuda_qr_tpu_torch import check_qr, check_qr_device


def _factorization(rng, dtype, m=40, n=10):
    A = rng.standard_normal((m, n))
    if np.dtype(dtype).kind == "c":
        A = A + 1j * rng.standard_normal((m, n))
    A = A.astype(dtype)
    Q, R = np.linalg.qr(A)
    return A, Q.astype(dtype), np.triu(R).astype(dtype)


@pytest.mark.parametrize("dtype", [np.complex64, np.complex128])
@pytest.mark.parametrize("as_tensor", [False, True])
def test_check_qr_complex_matches_reference(rng, dtype, as_tensor):
    A, Q, R = _factorization(rng, dtype)
    want = rverify.check_qr(A, Q, R)
    args = [torch.from_numpy(x) for x in (A, Q, R)] if as_tensor else [A, Q, R]
    got = check_qr(*args)
    assert want.ok and got.ok
    assert got.eps == want.eps == float(np.finfo(np.dtype(dtype).char.lower()).eps)
    assert (got.residual, got.orthogonality, got.r_triangular, got.n) == \
        (want.residual, want.orthogonality, want.r_triangular, want.n)


@pytest.mark.parametrize("dtype", [np.complex64, np.complex128])
def test_check_qr_device_complex_matches_reference(rng, dtype):
    A, Q, R = _factorization(rng, dtype)
    want = rverify.check_qr(A, Q, R)
    got = check_qr_device(*(torch.from_numpy(x) for x in (A, Q, R)))
    assert got.ok and got.eps == want.eps and got.n == want.n
    assert got.residual == pytest.approx(want.residual, rel=1e-6, abs=1e-15)
    assert got.orthogonality == pytest.approx(want.orthogonality, rel=1e-6, abs=1e-15)


def test_check_qr_complex_catches_a_transposed_q(rng):
    """Q^T Q of a complex Q is far from I; a check that passes must have used Q^H."""
    A, Q, R = _factorization(rng, np.complex128)
    assert np.linalg.norm(Q.T @ Q - np.eye(10)) > 0.1
    assert not check_qr(A, Q.conj(), R).ok


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_check_qr_real_input_unchanged(rng, dtype):
    """Real input: the float64 arithmetic this check always ran, bit for bit,
    and the reference's numbers."""
    A, Q, R = _factorization(rng, dtype, 60, 24)
    got = check_qr(A, Q, R)
    A64, Q64, R64 = (x.astype(np.float64) for x in (A, Q, R))
    assert got.residual == float(np.linalg.norm(A64 - Q64 @ R64)) / float(np.linalg.norm(A64))
    assert got.orthogonality == float(np.linalg.norm(Q64.T @ Q64 - np.eye(24)))
    want = rverify.check_qr(A, Q, R)
    assert (got.residual, got.orthogonality, got.eps, got.ok) == \
        (want.residual, want.orthogonality, want.eps, True)
    dev = check_qr_device(*(torch.from_numpy(x) for x in (A, Q, R)))
    G = torch.from_numpy(Q64).T @ torch.from_numpy(Q64)
    G.diagonal().sub_(1.0)
    assert dev.orthogonality == float(torch.linalg.norm(G)) and dev.ok
