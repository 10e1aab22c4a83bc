"""Small-matrix primitives of the PyTorch port against the JAX reference.

fp64 inputs through ``cuda_qr_tpu.ops.smalllinalg`` and its port; the two
run the same recursions, so they agree to 1e-11 (summation order times the
modest condition numbers of these inputs).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cuda_qr_tpu.ops import smalllinalg as ref
from cuda_qr_tpu_torch.ops import smalllinalg as port

from torch_threads import one_thread  # noqa: F401  (autouse: one intra-op thread)

TOL = 1e-11


def T(x):
    return torch.from_numpy(np.array(x))


def close(a, b, tol=TOL):
    np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=tol)


@pytest.mark.parametrize("n", [16, 32, 24, 40])
def test_inv_upper_lower(rng, n):
    """Power-of-two sizes take block doubling, others the recursion."""
    U = np.triu(rng.standard_normal((n, n))) + 4 * np.eye(n)
    close(port.inv_upper(T(U)), ref.inv_upper(jnp.asarray(U)))
    close(port.inv_lower(T(U.T.copy())), ref.inv_lower(jnp.asarray(U.T)))


@pytest.mark.parametrize("n", [8, 32, 48])
def test_cholesky_with_inv(rng, n):
    B = rng.standard_normal((n, 2 * n))
    G = B @ B.T / (2 * n)
    L, Li = port.cholesky_with_inv(T(G))
    rL, rLi = ref.cholesky_with_inv(jnp.asarray(G))
    close(L, rL)
    close(Li, rLi)
    assert np.abs(np.triu(L.numpy(), 1)).max() == 0.0


def test_cholesky_not_pd_gives_nan():
    L, _ = port.cholesky_with_inv(T(-np.eye(32)))
    assert np.isnan(L.numpy()).any()


@pytest.mark.parametrize("n", [16, 40])
def test_lu_with_inv(rng, n):
    Y = rng.standard_normal((n, n)) + 8 * np.eye(n)
    for a, b in zip(port.lu_with_inv(T(Y)), ref.lu_with_inv(jnp.asarray(Y))):
        close(a, b)


@pytest.mark.parametrize("near_identity", [True, False])
def test_newton_inverse(rng, near_identity):
    n = 32
    M = (np.eye(n) + 0.01 * rng.standard_normal((n, n)) if near_identity
         else rng.standard_normal((n, n)) + 6 * np.eye(n))
    before = port.host_syncs
    X, err = port.newton_inverse(T(M))
    rX, rerr = ref.newton_inverse(jnp.asarray(M))
    close(X, rX, 1e-10)
    assert float(err) <= 3e-8 and float(rerr) <= 3e-8
    assert port.host_syncs > before   # one host decision per iteration


def test_chol_with_inv_auto_routes_cpu_to_plain(rng):
    from cuda_qr_tpu_torch.ops.chol_kernel import chol_with_inv_kernel
    from cuda_qr_tpu_torch.utils.config import QRConfig
    B = rng.standard_normal((32, 64)).astype(np.float32)
    G = T(B @ B.T / 64)
    before = chol_with_inv_kernel.launches
    L, Li = port.chol_with_inv_auto(G, QRConfig())
    rL, rLi = port.cholesky_with_inv(G)
    assert torch.equal(L, rL) and torch.equal(Li, rLi)
    assert chol_with_inv_kernel.launches == before   # CPU: no kernel launch


@pytest.mark.parametrize("n", [8, 24, 32, 40])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_batched_cholesky_with_inv_matches_2d(rng, n, dtype):
    """A stack (and a 4-D stack) through the batched plain recursion gives
    each matrix's 2-D result up to summation order."""
    B = rng.standard_normal((2, 3, n, 2 * n))
    G = torch.from_numpy(B @ np.swapaxes(B, -1, -2) / (2 * n)).to(dtype)
    L, Li = port.cholesky_with_inv(G)
    tol = 1e-5 if dtype == torch.float32 else 1e-12
    for i in range(2):
        for j in range(3):
            L2, Li2 = port.cholesky_with_inv(G[i, j])
            assert float((L[i, j] - L2).abs().max()) <= tol
            assert float((Li[i, j] - Li2).abs().max()) <= tol * 10
    U = torch.triu(G) + 4 * torch.eye(n, dtype=dtype)
    close_b = port.inv_upper(U[0])
    for j in range(3):
        assert float((close_b[j] - port.inv_upper(U[0, j])).abs().max()) <= tol


def test_chol_with_inv_auto_takes_a_stack(rng):
    from cuda_qr_tpu_torch.ops.chol_kernel import chol_with_inv_kernel, supported
    from cuda_qr_tpu_torch.utils.config import QRConfig
    B = rng.standard_normal((5, 32, 64)).astype(np.float32)
    G = T(B @ np.swapaxes(B, -1, -2) / 64)
    assert supported(G.shape, G.dtype) and supported(G.shape[1:], G.dtype)
    assert not supported((5, 32, 16), G.dtype)
    before = chol_with_inv_kernel.launches
    L, Li = port.chol_with_inv_auto(G, QRConfig())
    assert chol_with_inv_kernel.launches == before
    rL, rLi = ref.cholesky_with_inv(jnp.asarray(B[2] @ B[2].T / 64))
    close(L[2], rL, 1e-5)
    close(Li[2], rLi, 1e-5)
