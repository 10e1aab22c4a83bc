"""The randomized spectral tools of the port (models/rsvd.py) against the JAX
reference on the inputs of tests/test_rsvd.py.

The reference draws its sketches from jax.random (key 12, and fold_in(key, 1)
for cond_est's second block), which torch cannot reproduce, so each test
computes the reference's own Omega and hands it to the port (``omega=``).
With one Omega both packages run the same algorithm and differ by float32
rounding only.  Tolerances, with n the smaller dimension and eps of float32:
singular values and eigenvalues 50 n eps max|.|; vectors through what is
unique (U diag(s) V^T, V diag(w) V^T, the projector Q Q^T) at 50 n eps of the
matrix norm, and orthogonality 50 n eps; norm2_est 1e-4 relative; cond_est
cond * 50 n eps relative (sigma_min of a float32 R is known to cond * eps).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cuda_qr_tpu.models import rsvd as rr
from cuda_qr_tpu.utils.config import QRConfig as RefConfig
from cuda_qr_tpu_torch import (QRShapeError, cond_est, eigh_rand, norm2_est, orth, rsvd)
from cuda_qr_tpu_torch.models import rsvd as pr
from cuda_qr_tpu_torch.utils.interop import config_from_reference

RCFG = RefConfig(dtype=jnp.float32, panel_width=16, scan_stages=2)
CFG = config_from_reference(RCFG, device="cpu")
EPS = float(np.finfo(np.float32).eps)
KEY = jax.random.PRNGKey(12)


def ref_omega(shape, key=KEY):
    return np.array(jax.random.normal(key, shape, dtype=jnp.float32))


def low_rank(rng, m, n, r, decay=0.5):
    U = np.linalg.qr(rng.standard_normal((m, r)))[0]
    V = np.linalg.qr(rng.standard_normal((n, r)))[0]
    return ((U * decay ** np.arange(r)) @ V.T).astype(np.float32)


def f64(*xs):
    return [np.asarray(x, np.float64) for x in xs]


@pytest.mark.parametrize("m,n", [(200, 16), (64, 40), (30, 16)])
def test_thin_qr_takes_the_reference_route(rng, m, n):
    """n <= panel_width and m >= 2n goes to tsqr, the rest to qr, in both
    packages; the basis differs by column signs at most, the projector by
    rounding."""
    Y = rng.standard_normal((m, n)).astype(np.float32)
    Q, = f64(pr._thin_qr(torch.from_numpy(Y), CFG))
    Qr, = f64(rr._thin_qr(jnp.asarray(Y), RCFG))
    assert Q.shape == Qr.shape == (m, n)
    assert np.linalg.norm(Q.T @ Q - np.eye(n)) < 50 * n * EPS
    assert np.abs(Q @ Q.T - Qr @ Qr.T).max() < 50 * n * EPS


def test_orth_full_rank(rng):
    A = rng.standard_normal((96, 40)).astype(np.float32)
    Q, Qr = f64(orth(A, config=CFG), rr.orth(A, config=RCFG))
    assert Q.shape == Qr.shape == (96, 40)
    assert np.linalg.norm(Q.T @ Q - np.eye(40)) < 50 * 40 * EPS
    assert np.abs(Q @ Q.T - Qr @ Qr.T).max() < 50 * 40 * EPS
    assert np.linalg.norm(Q @ (Q.T @ A) - A) / np.linalg.norm(A) < 1e-5


def test_orth_rank_deficient(rng):
    A = low_rank(rng, 80, 48, 12, decay=1.0)
    Q, Qr = f64(orth(A, rcond=1e-5, config=CFG), rr.orth(A, rcond=1e-5, config=RCFG))
    assert Q.shape == Qr.shape == (80, 12)
    assert np.linalg.norm(Q.T @ Q - np.eye(12)) < 50 * 12 * EPS
    assert np.abs(Q @ Q.T - Qr @ Qr.T).max() < 50 * 48 * EPS
    assert np.linalg.norm(Q @ (Q.T @ A) - A) / np.linalg.norm(A) < 1e-4
    Z = orth(np.zeros((20, 8), np.float32), rcond=1e-5, config=CFG)
    assert tuple(Z.shape) == (20, 1)            # the trivial one-column slot


@pytest.mark.parametrize("m,n,r,k,p,it", [(200, 64, 10, 10, 6, 2), (64, 200, 10, 10, 6, 2),
                                          (150, 90, 60, 8, 8, 3)])
def test_rsvd_matches_reference(rng, m, n, r, k, p, it):
    A = low_rank(rng, m, n, r, decay=0.7 if r == 10 else 0.6)
    Om = ref_omega((n, min(k + p, m, n)))
    U, s, Vt = f64(*rsvd(A, k=k, p=p, n_iter=it, config=CFG, omega=Om))
    Ur, sr, Vtr = f64(*rr.rsvd(A, k=k, p=p, n_iter=it, config=RCFG))
    nn = min(m, n)
    assert U.shape == (m, k) and s.shape == (k,) and Vt.shape == (k, n)
    assert np.abs(s - sr).max() < 50 * nn * EPS * sr[0]
    assert np.abs((U * s) @ Vt - (Ur * sr) @ Vtr).max() < 50 * nn * EPS * sr[0]
    assert np.linalg.norm(U.T @ U - np.eye(k)) < 50 * nn * EPS
    assert np.linalg.norm(Vt @ Vt.T - np.eye(k)) < 50 * nn * EPS
    s_ref = np.linalg.svd(A.astype(np.float64), compute_uv=False)
    if r == k:      # exactly rank k: reproduced to float32 accuracy
        assert np.linalg.norm((U * s) @ Vt - A) / np.linalg.norm(A) < 1e-5
        assert np.allclose(s, s_ref[:k], rtol=1e-4)
    else:           # fast decay: rank-k error ~ s_{k+1}
        assert np.linalg.norm((U * s) @ Vt - A, 2) < 3 * s_ref[k]
        assert np.allclose(s, s_ref[:k], rtol=1e-2)


def test_rsvd_default_generator_and_errors(rng):
    A = low_rank(rng, 60, 40, 6, 0.8)
    s1 = rsvd(A, k=6, config=CFG)[1]
    s2 = rsvd(torch.from_numpy(A), k=6, config=CFG)[1]
    assert torch.equal(s1, s2)                  # seed 12 on each call
    g = torch.Generator().manual_seed(3)
    s3 = rsvd(A, k=6, generator=g, config=CFG)[1]
    assert np.allclose(s3.numpy(), np.linalg.svd(A, compute_uv=False)[:6], rtol=1e-4)
    with pytest.raises(QRShapeError):
        rsvd(A, k=41, config=CFG)
    with pytest.raises(QRShapeError):
        rsvd(A, k=0, config=CFG)
    with pytest.raises(QRShapeError):
        rsvd(A, k=6, config=CFG, omega=np.zeros((40, 3), np.float32))
    # complex input: the reference's real sketch, cast (tests/test_torch_complex_spectral.py)
    Ac = A.astype(np.complex64)
    sc = rsvd(Ac, k=6, config=CFG, omega=ref_omega((40, 14)).astype(np.complex64))[1]
    sr = np.asarray(rr.rsvd(jnp.asarray(Ac), k=6, config=RCFG)[1], np.float64)
    assert sc.dtype == torch.float32
    assert np.abs(sc.numpy() - sr).max() < 50 * 40 * EPS * sr[0]


def test_eigh_rand_indefinite_matches_reference(rng):
    m, r = 140, 10
    V = np.linalg.qr(rng.standard_normal((m, r)))[0]
    w_true = np.array([9.0, -7.5, 6.0, -4.8, 3.5, -2.6, 1.9, -1.3, 0.9, -0.6])
    A = ((V * w_true) @ V.T).astype(np.float32)
    Om = ref_omega((m, r + 6))
    w, Ve = f64(*eigh_rand(A, k=r, p=6, n_iter=2, config=CFG, omega=Om))
    wr, Vr = f64(*rr.eigh_rand(A, k=r, p=6, n_iter=2, config=RCFG))
    assert w.shape == (r,) and Ve.shape == (m, r)
    assert np.abs(w - wr).max() < 50 * m * EPS * 9.0
    assert np.allclose(w, w_true, rtol=1e-4, atol=1e-4)          # |w|-descending
    assert np.abs((Ve * w) @ Ve.T - (Vr * wr) @ Vr.T).max() < 50 * m * EPS * 9.0
    assert np.linalg.norm(Ve.T @ Ve - np.eye(r)) < 50 * m * EPS


def test_eigh_rand_truncation_and_errors(rng):
    m, k = 96, 6
    Vf = np.linalg.qr(rng.standard_normal((m, m)))[0]
    w_full = 0.65 ** np.arange(m) * np.where(np.arange(m) % 2, -1.0, 1.0)
    A = ((Vf * w_full) @ Vf.T).astype(np.float32)
    Om = ref_omega((m, k + 8))
    w, Ve = f64(*eigh_rand(A, k=k, p=8, n_iter=3, config=CFG, omega=Om))
    wr, _ = f64(*rr.eigh_rand(A, k=k, p=8, n_iter=3, config=RCFG))
    assert np.abs(w - wr).max() < 50 * m * EPS
    assert np.allclose(w, w_full[:k], rtol=1e-3, atol=1e-4)
    assert np.linalg.norm((Ve * w) @ Ve.T - A, 2) < 3 * abs(w_full[k])
    with pytest.raises(QRShapeError):
        eigh_rand(rng.standard_normal((8, 6)).astype(np.float32), k=2, config=CFG)
    with pytest.raises(QRShapeError):
        eigh_rand(A, k=97, config=CFG)


@pytest.mark.parametrize("shape", [(120, 50), (50, 120)])
def test_norm2_est_matches_reference(rng, shape):
    A = rng.standard_normal(shape).astype(np.float32)
    Om = ref_omega((shape[1], 4))
    est = float(norm2_est(A, n_iter=12, config=CFG, omega=Om))
    want = float(rr.norm2_est(A, n_iter=12, config=RCFG))
    ref = np.linalg.norm(A.astype(np.float64), 2)
    assert abs(est - want) < 1e-4 * want
    assert est <= ref * (1 + 1e-4)     # a lower bound up to rounding
    assert est > 0.97 * ref


@pytest.mark.parametrize("target_cond", [10.0, 1e4])
def test_cond_est_matches_reference(rng, target_cond):
    m, n = 120, 40
    U = np.linalg.qr(rng.standard_normal((m, n)))[0]
    V = np.linalg.qr(rng.standard_normal((n, n)))[0]
    A = ((U * np.geomspace(1.0, 1.0 / target_cond, n)) @ V.T).astype(np.float32)
    est = float(cond_est(A, n_iter=16, config=CFG, omega=ref_omega((n, 4)),
                         omega_inv=ref_omega((n, 4), jax.random.fold_in(KEY, 1))))
    want = float(rr.cond_est(A, n_iter=16, config=RCFG))
    assert abs(est - want) < target_cond * 50 * n * EPS * want
    assert 0.9 * target_cond < est < 1.05 * target_cond
    drawn = float(cond_est(A, n_iter=16, config=CFG))      # both blocks from seed 12
    assert 0.9 * target_cond < drawn < 1.05 * target_cond
    with pytest.raises(QRShapeError):
        cond_est(A.T, config=CFG)


def test_rsvd_float64_input_under_a_float32_config(rng):
    """The thin QRs run at config.dtype (float32) and the GEMMs against the
    float64 A promote, in both packages: float32-grade results in float64."""
    A = low_rank(rng, 90, 50, 8, 0.7).astype(np.float64)
    Ut, st, Vtt = rsvd(A, k=8, p=4, n_iter=1, config=CFG, omega=ref_omega((50, 12)))
    assert Ut.dtype == st.dtype == Vtt.dtype == torch.float64
    U, s, Vt = f64(Ut, st, Vtt)
    Ur, sr, Vtr = f64(*rr.rsvd(A, k=8, p=4, n_iter=1, config=RCFG))
    assert np.abs(s - sr).max() < 50 * 50 * EPS * sr[0]
    assert np.abs((U * s) @ Vt - (Ur * sr) @ Vtr).max() < 50 * 50 * EPS * sr[0]
