"""The PyTorch port's QR updating (``models/update.py``) and its
scipy-compatible surface (``models/scipy_compat.py``) against the JAX
reference, on the same thin factors of the same seeded input.

Both packages run the same Givens chains with the same rotation
convention, so the updated factors agree directly: float64 1e-10 and
float32 1e-4 (Q; R relative to max|R|).  Each result also passes the
residual / orthogonality gates on the modified matrix.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cuda_qr_tpu_torch as ct
from cuda_qr_tpu.models import scipy_compat as ref_sc
from cuda_qr_tpu.models import update as ref
from cuda_qr_tpu_torch.models import scipy_compat as sc
from cuda_qr_tpu_torch.ops import smalllinalg

from torch_threads import one_thread  # noqa: F401  (autouse: one intra-op thread)

TOLS = {np.float64: 1e-10, np.float32: 1e-4}


@pytest.fixture
def rng():
    return np.random.default_rng(12)


def factors(A, dtype):
    Q, R = np.linalg.qr(A)
    return Q.astype(dtype), R.astype(dtype)


def agree(got, want, A1, dtype):
    """Port == reference, and the port's factors pass the gates on A1."""
    Q, R = got
    rQ, rR = (np.asarray(x, np.float64) for x in want)
    tol = TOLS[dtype]
    np.testing.assert_allclose(Q.double().numpy(), rQ, rtol=0, atol=tol)
    np.testing.assert_allclose(R.double().numpy(), rR, rtol=0, atol=tol * np.abs(rR).max())
    chk = ct.check_qr(A1, Q, R)
    assert chk.residual < 8 * max(A1.shape) * chk.eps, chk
    assert chk.orthogonality < 8 * max(A1.shape) * chk.eps, chk
    assert chk.r_triangular == 0.0


T = torch.from_numpy
J = jnp.asarray


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("m,n", [(24, 8), (64, 64), (40, 17)])
def test_rank1_update(rng, dtype, m, n):
    A = rng.standard_normal((m, n)).astype(dtype)
    u, v = rng.standard_normal(m).astype(dtype), rng.standard_normal(n).astype(dtype)
    Q, R = factors(A, dtype)
    before = smalllinalg.host_syncs
    got = ct.qr_rank1_update(T(Q), T(R), T(u), T(v))
    assert smalllinalg.host_syncs == before
    agree(got, ref.qr_rank1_update(J(Q), J(R), J(u), J(v)), A + np.outer(u, v), dtype)


def test_rank1_update_u_in_span(rng):
    A = rng.standard_normal((30, 10))
    Q, R = factors(A, np.float64)
    u = A @ rng.standard_normal(10)
    v = rng.standard_normal(10)
    got = ct.qr_rank1_update(T(Q), T(R), T(u), T(v))
    agree(got, ref.qr_rank1_update(J(Q), J(R), J(u), J(v)), A + np.outer(u, v), np.float64)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_rank_k_update(rng, dtype):
    A = rng.standard_normal((40, 12)).astype(dtype)
    U, V = rng.standard_normal((40, 3)).astype(dtype), rng.standard_normal((12, 3)).astype(dtype)
    Q, R = factors(A, dtype)
    got = ct.qr_update(T(Q), T(R), T(U), T(V))
    agree(got, ref.qr_update(J(Q), J(R), J(U), J(V)), A + U @ V.T, dtype)
    with pytest.raises(ValueError):
        ct.qr_update(T(Q), T(R), T(U), T(V[:, :2]))


@pytest.mark.parametrize("k", [0, 3, 24, None])
def test_row_insert(rng, k):
    A = rng.standard_normal((24, 9))
    a = rng.standard_normal(9)
    Q, R = factors(A, np.float64)
    got = ct.qr_row_insert(T(Q), T(R), T(a), k)
    A1 = np.insert(A, 24 if k is None else k, a, 0)
    agree(got, ref.qr_row_insert(J(Q), J(R), J(a), k), A1, np.float64)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("k", [0, 7, 23])
def test_row_delete(rng, dtype, k):
    A = rng.standard_normal((24, 9)).astype(dtype)
    Q, R = factors(A, dtype)
    Q0 = T(Q).clone()
    got = ct.qr_row_delete(T(Q), T(R), k)
    assert torch.equal(T(Q), Q0)   # inputs are not modified
    agree(got, ref.qr_row_delete(J(Q), J(R), k), np.delete(A, k, 0), dtype)


@pytest.mark.parametrize("k", [0, 4, 9])
def test_col_insert(rng, k):
    A = rng.standard_normal((24, 9))
    a = rng.standard_normal(24)
    Q, R = factors(A, np.float64)
    got = ct.qr_col_insert(T(Q), T(R), T(a), k)
    agree(got, ref.qr_col_insert(J(Q), J(R), J(a), k), np.insert(A, k, a, 1), np.float64)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("k", [0, 4, 8])
def test_col_delete(rng, dtype, k):
    A = rng.standard_normal((24, 9)).astype(dtype)
    Q, R = factors(A, dtype)
    Q0 = T(Q).clone()
    got = ct.qr_col_delete(T(Q), T(R), k)
    assert torch.equal(T(Q), Q0)
    agree(got, ref.qr_col_delete(J(Q), J(R), k), np.delete(A, k, 1), dtype)


def test_shape_errors(rng):
    Q, R = factors(rng.standard_normal((8, 8)), np.float64)
    with pytest.raises(ValueError):
        ct.qr_row_delete(T(Q), T(R), 0)
    with pytest.raises(ValueError):
        ct.qr_col_insert(T(Q), T(R), T(np.ones(8)), 0)
    # complex factors (tests/test_torch_complex_rank.py): the clartg chains
    Qc, Rc = T(Q).to(torch.complex128), T(R).to(torch.complex128)
    u, v = T(np.ones(8) + 1j), T(np.ones(8) - 2j)
    got = ct.qr_rank1_update(Qc, Rc, u, v)
    want = ref.qr_rank1_update(J(Q.astype(np.complex128)), J(R.astype(np.complex128)),
                               J(u.numpy()), J(v.numpy()))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=1e-10 * 8)
    A1 = Q @ R + np.outer(u.numpy(), v.numpy().conj())
    assert np.abs(got[0].numpy() @ got[1].numpy() - A1).max() < 1e-12 * np.abs(A1).max() * 8


def test_update_chain(rng):
    """A mixed chain of updates stays accurate (error accumulation) and
    agrees with the reference's chain."""
    A = rng.standard_normal((32, 8)).astype(np.float32)
    Q, R = factors(A, np.float32)
    Qt, Rt, Qj, Rj = T(Q), T(R), J(Q), J(R)
    for _ in range(5):
        u = rng.standard_normal(A.shape[0]).astype(np.float32)
        v = rng.standard_normal(A.shape[1]).astype(np.float32)
        A = A + np.outer(u, v)
        Qt, Rt = ct.qr_rank1_update(Qt, Rt, T(u), T(v))
        Qj, Rj = ref.qr_rank1_update(Qj, Rj, J(u), J(v))
        a = rng.standard_normal(A.shape[1]).astype(np.float32)
        A = np.concatenate([A, a[None]])
        Qt, Rt = ct.qr_row_insert(Qt, Rt, T(a))
        Qj, Rj = ref.qr_row_insert(Qj, Rj, J(a))
    agree((Qt, Rt), (Qj, Rj), A, np.float32)


@pytest.mark.parametrize("which,p", [("row", 1), ("row", 3), ("col", 1), ("col", 2)])
def test_scipy_insert_delete(rng, which, p):
    A = rng.standard_normal((30, 8))
    Q, R = factors(A, np.float64)
    if which == "row":
        u = rng.standard_normal((p, 8))
        A1 = np.insert(A, [4] * p, u, 0)
    else:
        u = rng.standard_normal((30, p))
        A1 = np.insert(A, [4] * p, u, 1)
    uu = u[0] if (p == 1 and which == "row") else (u[:, 0] if p == 1 else u)
    got = sc.qr_insert(T(Q), T(R), T(np.asarray(uu)), 4, which=which)
    agree(got, ref_sc.qr_insert(Q, R, uu, 4, which=which), A1, np.float64)
    got = sc.qr_delete(got[0], got[1], 4, p=p, which=which)
    agree(got, ref_sc.qr_delete(*ref_sc.qr_insert(Q, R, uu, 4, which=which), 4, p=p,
                                which=which), A, np.float64)


@pytest.mark.parametrize("rank", [1, 2])
def test_scipy_update(rng, rank):
    A = rng.standard_normal((20, 6))
    Q, R = factors(A, np.float64)
    u = rng.standard_normal((20, rank)).squeeze()
    v = rng.standard_normal((6, rank)).squeeze()
    got = sc.qr_update(T(Q), T(R), T(u), T(v), overwrite_qruv=True, check_finite=False)
    A1 = A + (np.outer(u, v) if rank == 1 else u @ v.T)
    agree(got, ref_sc.qr_update(Q, R, u, v), A1, np.float64)


def test_scipy_numpy_input_goes_to_default_device(monkeypatch):
    """Numpy input to the scipy surface goes to DEFAULT_CONFIG.device (the
    card unless changed); a tensor stays where it is."""
    assert ct.DEFAULT_CONFIG.device == "cuda"
    monkeypatch.setattr(sc, "DEFAULT_CONFIG", ct.QRConfig(device="meta"))
    assert sc._t(np.ones(3)).device.type == "meta"
    x = torch.ones(3)
    assert sc._t(x) is x


def test_scipy_which_rejected(rng):
    Q, R = factors(rng.standard_normal((10, 4)), np.float64)
    with pytest.raises(ValueError):
        sc.qr_insert(T(Q), T(R), T(np.ones(4)), 0, which="diag")
    with pytest.raises(ValueError):
        sc.qr_delete(T(Q), T(R), 0, which="diag")
