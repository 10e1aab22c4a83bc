"""The solvers of the port (models/rank.py, models/lstsq.py) against the JAX
reference on the inputs of tests/test_rank.py and tests/test_lstsq.py.

The rank solvers draw their sketch on each side (seed 12 in both, from
different generators), so they are compared on what the sketch does not
decide: the rank, the minimum-norm solution and the pseudoinverse (both
unique), the null space's projector N N^T, and slogdet.  float32 solvers:
1e-4 absolute on O(1) solutions, 1e-3 where a rank-deficient system's
conditioning enters (the reference's own tests use the same bounds against
numpy).  float64 least squares: 1e-9, and gradients 1e-8 relative.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cuda_qr_tpu.models import lstsq as rlstsq
from cuda_qr_tpu.models import rank as rrank
from cuda_qr_tpu.utils.config import QRConfig as RefConfig
from cuda_qr_tpu_torch import (QRShapeError, lstsq, lstsq_rr, matrix_rank, null_space, pinv,
                               slogdet, solve)
from cuda_qr_tpu_torch.utils.interop import config_from_reference

from torch_threads import one_thread  # noqa: F401  (autouse: one intra-op thread)

RCFG = RefConfig(dtype=jnp.float32, panel_width=16, scan_stages=2)
CFG = config_from_reference(RCFG, device="cpu")
RCFG64 = RefConfig(panel_width=16, dtype=jnp.float64, use_pallas=False)
CFG64 = config_from_reference(RCFG64, device="cpu")


def rank_deficient(rng, m, n, r):
    B = rng.standard_normal((m, r)).astype(np.float32)
    C = rng.standard_normal((r, n)).astype(np.float32)
    return B @ C


@pytest.mark.parametrize("m,n,r", [(80, 48, 48), (80, 48, 20), (64, 40, 1)])
def test_matrix_rank(rng, m, n, r):
    A = rank_deficient(rng, m, n, r)
    assert matrix_rank(A, config=CFG) == rrank.matrix_rank(A, config=RCFG) == r


def test_lstsq_rr_full_rank(rng):
    A = rng.standard_normal((60, 33)).astype(np.float32)
    b = rng.standard_normal(60).astype(np.float32)
    x, resid, r, piv = lstsq_rr(A, b, config=CFG)
    rx, rres, rr, _ = rrank.lstsq_rr(A, b, config=RCFG)
    assert r == rr == 33 and x.shape == (33,)
    assert sorted(piv.tolist()) == list(range(33))
    assert np.abs(x.numpy() - np.asarray(rx)).max() < 1e-4
    assert abs(float(resid) - float(rres)) < 1e-4


def test_lstsq_rr_minimum_norm(rng):
    m, n, r = 70, 40, 15
    A = rank_deficient(rng, m, n, r)
    b = rng.standard_normal((m, 3)).astype(np.float32)
    x, resid, rk, _ = lstsq_rr(A, b, config=CFG)
    rx, rres, rrk, _ = rrank.lstsq_rr(A, b, config=RCFG)
    assert rk == rrk == r
    assert np.abs(x.numpy() - np.asarray(rx)).max() < 1e-3
    assert np.abs(resid.numpy() - np.asarray(rres)).max() < 1e-3
    x64 = np.linalg.lstsq(A.astype(np.float64), b, rcond=1e-6)[0]
    assert np.abs(x.numpy() - x64).max() < 1e-3


def test_pinv(rng):
    m, n, r = 48, 32, 12
    A = rank_deficient(rng, m, n, r)
    P = pinv(A, config=CFG).double().numpy()
    assert P.shape == (n, m)
    assert np.abs(P - np.asarray(rrank.pinv(A, config=RCFG), np.float64)).max() < 1e-3
    assert np.abs(A @ P @ A - A).max() < 1e-3
    assert np.abs(P @ A @ P - P).max() < 1e-3


@pytest.mark.parametrize("m,n,r", [(48, 32, 20), (40, 24, 24)])
def test_null_space(rng, m, n, r):
    A = rank_deficient(rng, m, n, r)
    N = null_space(A, config=CFG).double().numpy()
    rN = np.asarray(rrank.null_space(A, config=RCFG), np.float64)
    assert N.shape == rN.shape == (n, n - r)
    if n > r:
        assert np.abs(N.T @ N - np.eye(n - r)).max() < 1e-4
        assert np.abs(A @ N).max() < 1e-3 * np.abs(A).max()
        assert np.abs(N @ N.T - rN @ rN.T).max() < 1e-4


@pytest.mark.parametrize("scale", [1e-200, 1e200])
def test_rank_decision_keeps_float64_range(rng, scale):
    """A float64 input far outside float32's range: the rank is decided on
    R's diagonal in float64, as in the reference, so the solvers see full
    rank where a float32 copy of the diagonal reads 0 or inf."""
    A = rng.standard_normal((64, 32)) * scale
    b = rng.standard_normal(64)
    assert matrix_rank(A, config=CFG64) == rrank.matrix_rank(A, config=RCFG64) == 32
    x, resid, r, _ = lstsq_rr(A, b, config=CFG64)
    rx, rres, rr, _ = rrank.lstsq_rr(A, b, config=RCFG64)
    assert r == rr == 32
    np.testing.assert_allclose(x.numpy() * scale, np.asarray(rx) * scale, atol=1e-9)
    np.testing.assert_allclose(x.numpy() * scale, np.linalg.lstsq(A / scale, b, rcond=None)[0],
                               atol=1e-9)
    assert abs(float(resid) - float(rres)) < 1e-9
    P = pinv(A, config=CFG64).numpy()
    np.testing.assert_allclose(P * scale, np.asarray(rrank.pinv(A, config=RCFG64)) * scale,
                               atol=1e-9)
    N = null_space(A, config=CFG64)
    assert tuple(N.shape) == tuple(rrank.null_space(A, config=RCFG64).shape) == (32, 0)


@pytest.mark.parametrize("n", [16, 48, 130])
def test_slogdet(rng, n):
    A = rng.standard_normal((n, n)).astype(np.float32)
    sign, logabs = slogdet(A, config=CFG)
    rs, rl = rrank.slogdet(A, config=RCFG)
    assert float(sign) == float(rs) == np.linalg.slogdet(A.astype(np.float64))[0]
    assert abs(float(logabs) - float(rl)) < n * 1e-5 * max(1.0, abs(float(rl)))


def test_slogdet_singular_and_shape(rng):
    A = rng.standard_normal((24, 24)).astype(np.float32)
    A[:, 3] = 0.0
    assert float(slogdet(A, config=CFG)[0]) == float(rrank.slogdet(A, config=RCFG)[0]) == 0.0
    with pytest.raises(QRShapeError):
        slogdet(np.zeros((4, 3), np.float32), config=CFG)


@pytest.mark.parametrize("m,n,k,damp", [(64, 32, 1, 0.0), (100, 40, 3, 0.0), (50, 50, 2, 0.0),
                                        (80, 24, 2, 0.7)])
def test_lstsq_matches_reference(rng, m, n, k, damp):
    A = rng.standard_normal((m, n))
    B = rng.standard_normal((m, k))
    res = lstsq(A, B, CFG64, damp=damp)
    want = rlstsq.lstsq(jnp.asarray(A), jnp.asarray(B), RCFG64, damp=damp)
    np.testing.assert_allclose(res.x.numpy(), np.asarray(want.x), atol=1e-9)
    np.testing.assert_allclose(res.residual_norm.numpy(), np.asarray(want.residual_norm),
                               atol=1e-9)


def test_lstsq_vector_rhs_solve_and_shapes(rng):
    A = rng.standard_normal((80, 20))
    b = rng.standard_normal(80)
    res = lstsq(torch.from_numpy(A), torch.from_numpy(b), CFG64)
    assert res.x.shape == (20,) and res.residual_norm.dim() == 0
    np.testing.assert_allclose(res.x.numpy(), np.linalg.lstsq(A, b, rcond=None)[0], atol=1e-9)
    S = rng.standard_normal((40, 40))
    x_true = rng.standard_normal(40)
    np.testing.assert_allclose(solve(S, S @ x_true, CFG64).numpy(), x_true, atol=1e-9)
    with pytest.raises(QRShapeError):
        lstsq(np.zeros((10, 20)), np.zeros(10), CFG64)
    with pytest.raises(QRShapeError):
        solve(np.zeros((4, 5)), np.zeros(4), CFG64)


@pytest.mark.parametrize("shape,damp", [((24, 8, 2), 0.0), ((24, 8, 0), 0.0),
                                        ((30, 8, 0), 0.5)])
def test_lstsq_gradient_matches_reference_vjp(shape, damp):
    """The autograd.Function against jax.vjp of the reference's custom VJP,
    for loss = sum(x^2) + 0.5 sum(residual^2); k = 0 means a vector b."""
    m, n, k = shape
    rng = np.random.default_rng(m + k)
    A = rng.standard_normal((m, n))
    b = rng.standard_normal((m, k) if k else (m,))

    def ref_loss(A, b):
        r = rlstsq.lstsq(A, b, RCFG64, damp=damp)
        return jnp.sum(r.x ** 2) + 0.5 * jnp.sum(r.residual_norm ** 2)

    _, vjp = jax.vjp(ref_loss, jnp.asarray(A), jnp.asarray(b))
    gA_ref, gb_ref = (np.asarray(g) for g in vjp(jnp.ones(())))
    At = torch.from_numpy(A).requires_grad_()
    bt = torch.from_numpy(b).requires_grad_()
    r = lstsq(At, bt, CFG64, damp=damp)
    (torch.sum(r.x ** 2) + 0.5 * torch.sum(r.residual_norm ** 2)).backward()
    assert np.abs(At.grad.numpy() - gA_ref).max() <= 1e-8 * np.abs(gA_ref).max()
    assert np.abs(bt.grad.numpy() - gb_ref).max() <= 1e-8 * np.abs(gb_ref).max()
