"""The PyTorch port's ``qr_batched`` (shifted CholeskyQR3 over a stack)
against the JAX reference on the same input: the stack shapes of the
reference's tests (a 4-D stack included), mode='r', the round-3 branch, the
gradient and the error paths.

Both run the same rounds with positive diag(R): float32 1e-4 and float64
1e-10, relative to max|A| (R) or 1 (Q).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cuda_qr_tpu_torch as ct
from cuda_qr_tpu.models.batched import qr_batched as ref_qr_batched
from cuda_qr_tpu_torch.models import batched as port
from cuda_qr_tpu_torch.ops import smalllinalg

TOLS = {np.float64: 1e-10, np.float32: 1e-4}
CPU = ct.QRConfig(device="cpu")


def close(a, b, tol, scale=1.0):
    a = a.detach().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    b = np.asarray(b)
    assert a.shape == b.shape
    assert np.abs(a.astype(np.float64) - b.astype(np.float64)).max() <= tol * scale


def check_stack(Q, R, A, tol):
    Q, R, A = (x.reshape((-1,) + x.shape[-2:]) for x in (Q.double().numpy(),
                                                           R.double().numpy(), A))
    for q, r, a in zip(Q, R, A):
        assert np.linalg.norm(q @ r - a) / np.linalg.norm(a) < tol
        assert np.linalg.norm(q.T @ q - np.eye(q.shape[1])) < tol
        assert np.abs(np.tril(r, -1)).max() == 0.0
        assert (np.diagonal(r) > 0).all()


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("shape", [(4, 32, 8), (7, 65, 17), (2, 3, 128, 24)])
def test_matches_reference(shape, dtype):
    A = np.random.default_rng(5).standard_normal(shape).astype(dtype)
    Q, R = ct.qr_batched(A, CPU)
    rQ, rR = ref_qr_batched(jnp.asarray(A))
    assert Q.dtype == torch.from_numpy(A).dtype
    close(Q, rQ, TOLS[dtype])
    close(R, rR, TOLS[dtype], np.abs(A).max())
    check_stack(Q, R, A, 1e-4 if dtype == np.float32 else 1e-12)


def test_mode_r_matches_reference():
    A = np.random.default_rng(5).standard_normal((5, 40, 12)).astype(np.float32)
    R = ct.qr_batched(A, CPU, mode="r")
    close(R, ref_qr_batched(jnp.asarray(A), mode="r"), 1e-4, np.abs(A).max())
    _, Rf = ct.qr_batched(A, CPU)
    assert torch.equal(R, Rf)


@pytest.mark.parametrize("dtype,cond_exp,rounds", [(np.float64, 5, 3), (np.float64, 1, 2),
                                                   (np.float32, 2, 3)])
def test_round_three_only_when_needed(monkeypatch, dtype, cond_exp, rounds):
    """The third round runs (one host decision for the batch) exactly when
    round 2's Gram defect exceeds the tolerance: at cond 1e5 in float64 and,
    through the shift, always at this size in float32.  (cond 1e5 in
    float32, the reference's own round-3 input, is outside sCholQR3's
    float32 envelope: its round-2 Gram is indefinite at rounding level, and
    which element's Cholesky breaks depends on summation order.)"""
    rng = np.random.default_rng(5)
    m, n, b = 96, 16, 3
    U, _ = np.linalg.qr(rng.standard_normal((b, m, n)))
    V, _ = np.linalg.qr(rng.standard_normal((b, n, n)))
    A = ((U * np.logspace(0, -cond_exp, n)) @ np.transpose(V, (0, 2, 1))).astype(dtype)
    calls = []
    real = port._chol_round
    monkeypatch.setattr(port, "_chol_round", lambda X, c: calls.append(1) or real(X, c))
    before = smalllinalg.host_syncs
    Q, R = ct.qr_batched(A, CPU)
    assert smalllinalg.host_syncs - before == 1
    assert len(calls) == rounds - 1
    rQ, rR = ref_qr_batched(jnp.asarray(A))
    close(R, rR, TOLS[dtype], np.abs(A).max())
    close(Q, rQ, TOLS[dtype] * 10 ** cond_exp)
    check_stack(Q, R, A, 2e-4 if dtype == np.float32 else 1e-12)


def test_gradient_matches_reference():
    rng = np.random.default_rng(3)
    A = rng.standard_normal((3, 20, 5))
    W1 = rng.standard_normal((3, 20, 5))
    W2 = rng.standard_normal((3, 5, 5))

    def loss_ref(a):
        Q, R = ref_qr_batched(a)
        return jnp.sum(Q * W1) + jnp.sum(R * W2)

    g_ref = np.asarray(jax.grad(loss_ref)(jnp.asarray(A)))
    At = torch.from_numpy(A).requires_grad_(True)
    Q, R = ct.qr_batched(At, CPU)
    ((Q * torch.from_numpy(W1)).sum() + (R * torch.from_numpy(W2)).sum()).backward()
    close(At.grad, g_ref, 1e-10, np.abs(g_ref).max())


def test_batched_thin_qr_vjp_matches_2d():
    """The batch-aware thin-QR VJP is the 2-D one applied per matrix."""
    from cuda_qr_tpu_torch.models.qr import thin_qr_vjp
    rng = np.random.default_rng(4)
    Q, R = torch.linalg.qr(torch.from_numpy(rng.standard_normal((3, 12, 5))))
    dQ = torch.from_numpy(rng.standard_normal((3, 12, 5)))
    dR = torch.from_numpy(rng.standard_normal((3, 5, 5)))
    got = thin_qr_vjp(Q, R, dQ, dR)
    for b in range(3):
        close(got[b], thin_qr_vjp(Q[b], R[b], dQ[b], dR[b]).numpy(), 1e-13)


def test_rank_deficient_element_gives_nan():
    A = np.random.default_rng(5).standard_normal((2, 24, 6)).astype(np.float32)
    A[1, :, 3] = A[1, :, 2]
    Q, R = ct.qr_batched(A, CPU)
    rQ, _ = ref_qr_batched(jnp.asarray(A))
    assert torch.isfinite(Q[0]).all()
    assert np.linalg.norm(Q[0].numpy() @ R[0].numpy() - A[0]) < 1e-4 * np.linalg.norm(A[0])
    assert not torch.isfinite(Q[1]).all()
    assert not np.isfinite(np.asarray(rQ[1])).all()


def test_error_paths():
    with pytest.raises(ct.QRShapeError):
        ct.qr_batched(np.ones(4), CPU)
    with pytest.raises(ct.QRShapeError):
        ct.qr_batched(np.ones((2, 3, 5)), CPU)
    with pytest.raises(ct.QRShapeError):
        ct.qr_batched(np.ones((2, 5, 3)), CPU, mode="complete")
    with pytest.raises(ct.QRShapeError):
        ct.qr_batched(torch.ones((2, 5, 3), dtype=torch.complex64))
