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
