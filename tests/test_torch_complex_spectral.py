"""Complex input of the port's spectral family against the JAX reference on
the same complex numpy input: orth, rsvd, eigh_rand, norm2_est, cond_est
(models/rsvd.py), polar and svd (models/polar.py), eigh and eigh_batched
(models/eigh.py).

The randomized functions get the reference's own sketch: for complex A it
draws a real Gaussian in the real dtype (key 12; ``fold_in(key, 1)`` for
cond_est's second block) and casts it to A's dtype, and the test hands that
array over as ``omega=`` / ``omega_inv=``.

Singular and eigen vectors of a complex matrix are unique up to a unit
phase per column, so they are compared through what is unique: U diag(s)
V^H, V diag(w) V^H, projectors Q Q^H, and |diag(V_ref^H V)| = 1; never
entry by entry.  The polar factors are unique at full rank and are compared
directly.  Tolerances: values and unique products 1e-4 relative
(complex64) and 1e-10 (complex128); orthogonality and reconstruction gates
as the real tests (50 n eps); the phase-factor Jacobi and the divide and
conquer are also held to at most 1.1 x the reference's orthogonality and
residual on the same input.  The reference's single-device ``polar``
runs complex128 on float32's eps schedule; the port runs float64's (its
``_real_dtype``), so complex128 polar is held to scipy at 1e-10 and to the
reference at float32's schedule accuracy.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.linalg as sla
import torch

import cuda_qr_tpu_torch as ct
from cuda_qr_tpu.models import eigh as re_
from cuda_qr_tpu.models import polar as rp
from cuda_qr_tpu.models import rsvd as rr
from cuda_qr_tpu.utils.config import QRConfig as RefConfig
from cuda_qr_tpu_torch.models import eigh as pe
from cuda_qr_tpu_torch.models import polar as pp
from cuda_qr_tpu_torch.models import rsvd as pr
from cuda_qr_tpu_torch.utils.interop import config_from_reference

from torch_threads import one_thread  # noqa: F401  (autouse: one intra-op thread)

RCFG = RefConfig(dtype=jnp.float32, panel_width=16, scan_stages=2)
CFG = config_from_reference(RCFG, device="cpu")
TOL = {np.complex64: 1e-4, np.complex128: 1e-10}
EPS = {np.complex64: float(np.finfo(np.float32).eps), np.complex128: float(np.finfo(float).eps)}
KEY = jax.random.PRNGKey(12)


def crand(rng, shape, dtype=np.complex64):
    return (rng.standard_normal(shape) + 1j * rng.standard_normal(shape)).astype(dtype)


def unitary(rng, m, n):
    return np.linalg.qr(crand(rng, (m, n), np.complex128))[0]


def low_rank(rng, m, n, r, decay=0.5, dtype=np.complex64):
    return ((unitary(rng, m, r) * decay ** np.arange(r)) @ unitary(rng, n, r).conj().T
            ).astype(dtype)


def hermitian(rng, n, dtype=np.complex64, w=None):
    if w is None:
        A = crand(rng, (n, n), np.complex128)
        return ((A + A.conj().T) / 2).astype(dtype)
    V = unitary(rng, n, len(w))
    return ((V * w) @ V.conj().T).astype(dtype)


def ref_omega(shape, dtype, key=KEY):
    """The reference's complex sketch: a real Gaussian cast to A's dtype."""
    rdt = jnp.float64 if dtype == np.complex128 else jnp.float32
    return np.array(jax.random.normal(key, shape, dtype=rdt)).astype(dtype)


def c128(*xs):
    return [x.resolve_conj().numpy().astype(np.complex128) if isinstance(x, torch.Tensor)
            else np.asarray(x).astype(np.complex128) for x in xs]


def close(got, want, tol, scale=1.0):
    got, want = c128(got, want)
    assert got.shape == want.shape, (got.shape, want.shape)
    err = np.abs(got - want).max() if got.size else 0.0
    assert err <= tol * scale, f"{err:.3e} > {tol:g} x {scale:g}"


def orth_err(U):
    U, = c128(U)
    k = min(U.shape)
    G = U.conj().T @ U if U.shape[0] >= U.shape[1] else U @ U.conj().T
    return np.linalg.norm(G - np.eye(k))


def same_columns_up_to_phase(V, Vr, tol):
    """|diag(V_ref^H V)| = 1: each column equals the reference's up to a
    unit phase."""
    V, Vr = c128(V, Vr)
    d = np.abs(np.sum(Vr.conj() * V, axis=0))
    assert np.abs(d - 1).max() < tol, np.abs(d - 1).max()


# -- randomized: orth, rsvd, eigh_rand, norm2_est, cond_est
def test_orth_complex_matches_reference(rng):
    A = crand(rng, (90, 12))
    Q = ct.orth(A, config=CFG)
    Qr = rr.orth(jnp.asarray(A), config=RCFG)
    assert Q.shape == (90, 12) and Q.dtype == torch.complex64
    P, Pr = c128(Q, Qr)
    close(P @ P.conj().T, Pr @ Pr.conj().T, TOL[np.complex64])
    assert orth_err(Q) < 50 * 12 * EPS[np.complex64]


def test_orth_rcond_complex_matches_reference(rng):
    A = (crand(rng, (80, 9), np.complex128) @ crand(rng, (9, 40), np.complex128)
         ).astype(np.complex64)
    Q = ct.orth(A, rcond=1e-4, config=CFG)
    Qr = rr.orth(jnp.asarray(A), rcond=1e-4, config=RCFG)
    assert Q.shape == tuple(Qr.shape) == (80, 9)
    P, Pr = c128(Q, Qr)
    close(P @ P.conj().T, Pr @ Pr.conj().T, TOL[np.complex64])
    close(P @ (P.conj().T @ A), A, TOL[np.complex64], np.abs(A).max())


@pytest.mark.parametrize("dtype", [np.complex64, np.complex128])
def test_rsvd_complex_matches_reference(rng, dtype):
    m, n, k, p = 120, 60, 6, 6
    A = low_rank(rng, m, n, 20, dtype=dtype)
    U, s, Vh = ct.rsvd(A, k=k, p=p, n_iter=2, config=CFG, omega=ref_omega((n, k + p), dtype))
    Ur, sr, Vhr = rr.rsvd(jnp.asarray(A), k=k, p=p, n_iter=2, config=RCFG)
    assert U.dtype == Vh.dtype == torch.from_numpy(A).dtype and not s.is_complex()
    tol = TOL[dtype]
    close(s, sr, tol, float(sr[0]))
    U, s, Vh, Ur, sr, Vhr = c128(U, s, Vh, Ur, sr, Vhr)
    close((U * s) @ Vh, (Ur * sr) @ Vhr, tol, float(sr[0].real))
    close(s.real, np.linalg.svd(A.astype(np.complex128), compute_uv=False)[:k], 10 * tol, 1.0)
    same_columns_up_to_phase(U, Ur, 10 * tol)
    assert orth_err(U) < 50 * n * EPS[dtype]


def test_rsvd_complex_draws_a_real_sketch(rng):
    """Without omega the sketch is real Gaussian numbers in A's dtype, the
    reference's draw (``jax.random.normal(..., real_dtype).astype(A.dtype)``)."""
    A = torch.from_numpy(crand(rng, (10, 4)))
    Om = pr._sketch((4, 3), A, None, None)
    assert Om.dtype == torch.complex64 and float(Om.imag.abs().max()) == 0.0
    g = torch.Generator().manual_seed(12)
    assert torch.equal(Om.real, torch.randn((4, 3), generator=g))
    s = ct.rsvd(A, k=2, config=CFG)[1]
    assert torch.allclose(s, torch.linalg.svdvals(A)[:2], rtol=1e-3)


def test_eigh_rand_complex_matches_reference(rng):
    m, r = 96, 8
    w_true = np.array([9.0, -7.5, 6.0, -4.8, 3.5, -2.6, 1.9, -1.3])
    A = hermitian(rng, m, w=w_true)
    w, V = ct.eigh_rand(A, k=r, p=6, n_iter=2, config=CFG, omega=ref_omega((m, r + 6),
                                                                           np.complex64))
    wr, Vr = rr.eigh_rand(jnp.asarray(A), k=r, p=6, n_iter=2, config=RCFG)
    assert not w.is_complex() and V.dtype == torch.complex64 and V.shape == (m, r)
    tol = TOL[np.complex64]
    close(w, wr, tol, 9.0)
    np.testing.assert_allclose(w.numpy(), w_true, rtol=1e-4, atol=1e-4)
    V, Vr, w, wr = c128(V, Vr, w, wr)
    close((V * w) @ V.conj().T, (Vr * wr) @ Vr.conj().T, tol, 9.0)
    same_columns_up_to_phase(V, Vr, 10 * tol)
    assert orth_err(V) < 50 * m * EPS[np.complex64]


@pytest.mark.parametrize("dtype,shape", [(np.complex64, (120, 50)), (np.complex128, (50, 80))])
def test_norm2_est_complex_matches_reference(rng, dtype, shape):
    k = min(shape)
    A = ((unitary(rng, shape[0], k) * np.geomspace(1.0, 1e-2, k))
         @ unitary(rng, shape[1], k).conj().T).astype(dtype)
    est = ct.norm2_est(A, n_iter=12, config=CFG, omega=ref_omega((shape[1], 4), dtype))
    want = float(rr.norm2_est(jnp.asarray(A), n_iter=12, config=RCFG))
    assert not est.is_complex()
    assert abs(float(est) - want) < TOL[dtype] * want
    ref = np.linalg.norm(A.astype(np.complex128), 2)
    assert 0.97 * ref < float(est) <= ref * (1 + TOL[dtype])


@pytest.mark.parametrize("target_cond", [10.0, 1e3])
def test_cond_est_complex_matches_reference(rng, target_cond):
    m, n = 120, 40
    A = ((unitary(rng, m, n) * np.geomspace(1.0, 1.0 / target_cond, n))
         @ unitary(rng, n, n).conj().T).astype(np.complex64)
    est = ct.cond_est(A, n_iter=16, config=CFG, omega=ref_omega((n, 4), np.complex64),
                      omega_inv=ref_omega((n, 4), np.complex64, jax.random.fold_in(KEY, 1)))
    want = float(rr.cond_est(jnp.asarray(A), n_iter=16, config=RCFG))
    assert not est.is_complex()
    assert abs(float(est) - want) < target_cond * 50 * n * EPS[np.complex64] * want
    assert 0.9 * target_cond < float(est) < 1.05 * target_cond


# -- QDWH polar and svd: QR steps throughout
def polar_checks(A, U, H, side, tol):
    A, U, H = c128(A, U, H)
    assert orth_err(U) < tol * min(A.shape)
    rec = U @ H if side == "right" else H @ U
    assert np.linalg.norm(rec - A) / np.linalg.norm(A) < tol
    assert np.abs(H - H.conj().T).max() < tol * np.abs(H).max()
    assert np.linalg.eigvalsh((H + H.conj().T) / 2).min() > -tol * np.abs(H).max()


@pytest.mark.parametrize("shape,side", [((64, 24), "right"), ((64, 24), "left"),
                                        ((20, 50), "right")])
def test_polar_complex_matches_reference(rng, shape, side):
    A = crand(rng, shape)
    U, H = ct.polar(A, side=side, config=CFG)
    Ur, Hr = rp.polar(jnp.asarray(A), side=side, config=RCFG)
    assert U.dtype == H.dtype == torch.complex64
    tol = TOL[np.complex64]
    close(U, Ur, tol)
    close(H, Hr, tol, np.abs(np.asarray(Hr)).max())
    polar_checks(A, U, H, side, 50 * EPS[np.complex64] * min(shape))


def test_polar_complex_takes_qr_steps_only(rng, monkeypatch):
    """No Cholesky step (so no chol_inv) and no TSQR for complex input, at
    MIXED_CONFIG too: every stacked QR is the blocked Householder one, and
    every GEMM runs at "highest"."""
    A = crand(rng, (64, 8))
    seen = []
    real_qr = pp.qr
    monkeypatch.setattr(pp, "_chol_inv_padded", lambda *a: pytest.fail("Cholesky step"))
    monkeypatch.setattr(pp, "tsqr", lambda *a: pytest.fail("TSQR on complex input"))
    monkeypatch.setattr(pp, "qr", lambda Y, cfg, mode: seen.append(cfg) or real_qr(Y, cfg, mode))
    U, _ = ct.polar(A, config=ct.MIXED_CONFIG.replace(device="cpu"))
    assert seen and all(c.precision == c.resolved_trailing_precision() == "highest"
                        for c in seen)
    assert orth_err(U) < 50 * 8 * EPS[np.complex64]


def test_polar_complex128(rng):
    """complex128 runs float64's schedule (``_real_dtype``): U to 1e-10 of
    scipy's polar factor.  The reference's single-device polar takes
    float32's eps for complex128 (``cuda_qr_tpu/models/polar.py:262``), so
    it is held to the port at float32's schedule accuracy."""
    A = crand(rng, (48, 16), np.complex128)
    assert pp._real_dtype(torch.complex128) == torch.float64
    U, H = ct.polar(A, config=CFG)
    Us, Hs = sla.polar(A)
    close(U, Us, TOL[np.complex128])
    close(H, Hs, TOL[np.complex128], np.abs(Hs).max())
    polar_checks(A, U, H, "right", 50 * EPS[np.complex128] * 16)
    Ur, Hr = rp.polar(jnp.asarray(A), config=RCFG)
    close(U, Ur, 50 * 16 * EPS[np.complex64])


@pytest.mark.parametrize("dtype,shape,full", [(np.complex64, (60, 24), False),
                                              (np.complex64, (40, 16), True),
                                              (np.complex64, (20, 44), False),
                                              (np.complex128, (36, 20), False)])
def test_svd_complex_matches_reference(rng, dtype, shape, full):
    A = crand(rng, shape, dtype)
    U, s, Vh = ct.svd(A, full_matrices=full, config=CFG)
    Ur, sr, Vhr = rp.svd(jnp.asarray(A), full_matrices=full, config=RCFG)
    k = min(shape)
    assert U.shape == tuple(Ur.shape) and Vh.shape == tuple(Vhr.shape) and s.shape == (k,)
    assert not s.is_complex() and U.dtype == Vh.dtype == torch.from_numpy(A).dtype
    s_np = np.linalg.svd(A.astype(np.complex128), compute_uv=False)
    tol = TOL[dtype]
    close(s, s_np, tol, s_np[0])
    close(s, sr, 50 * k * EPS[np.complex64], s_np[0])    # the reference: float32's schedule
    U, s, Vh = c128(U, s, Vh)
    close((U[:, :k] * s.real) @ Vh[:k], A, 50 * k * EPS[dtype], s_np[0])
    assert orth_err(U) < 50 * max(shape) * EPS[dtype]
    assert orth_err(Vh) < 50 * max(shape) * EPS[dtype]
    if dtype == np.complex64 and not full:
        Ur, sr, Vhr = c128(Ur, sr, Vhr)
        close((U * s.real) @ Vh, (Ur * sr.real) @ Vhr, tol, s_np[0])


def test_svd_complex_qdwh_eigh(rng):
    """eigh_impl="qdwh": H's eigenvectors from the port's own Hermitian eigh."""
    A = crand(rng, (40, 24))
    U, s, Vh = ct.svd(A, config=CFG, eigh_impl="qdwh")
    Ur, sr, Vhr = rp.svd(jnp.asarray(A), config=RCFG, eigh_impl="qdwh")
    tol = TOL[np.complex64]
    close(s, sr, tol, float(sr[0]))
    U, s, Vh, Ur, sr, Vhr = c128(U, s, Vh, Ur, sr, Vhr)
    close((U * s.real) @ Vh, (Ur * sr.real) @ Vhr, tol, float(sr[0].real))
    same_columns_up_to_phase(Vh.conj().T, Vhr.conj().T, 10 * tol)


# -- eigh: phase-factor Jacobi, the divide and conquer, the batched Jacobi
def eig_checks(A, w, V, dtype):
    A, V = c128(A, V)
    w = np.asarray(w, np.float64)
    n = A.shape[0]
    tol = 50 * n * EPS[dtype]
    assert np.linalg.norm(A @ V - V * w) / np.linalg.norm(A) < tol
    assert orth_err(V) < tol
    assert (np.diff(w) >= -tol * np.abs(w).max()).all()
    close(w, np.linalg.eigvalsh(A), tol, np.abs(w).max())


@pytest.mark.parametrize("dtype,n", [(np.complex64, 24), (np.complex128, 20)])
def test_jacobi_complex_matches_reference(rng, dtype, n):
    A = hermitian(rng, n, dtype)
    sched = pe._round_robin(n)
    w, V = pe._jacobi_eigh(torch.from_numpy(A), torch.from_numpy(sched.astype(np.int64)))
    wr, Vr = re_._jacobi_eigh(jnp.asarray(A), jnp.asarray(sched))
    assert not w.is_complex() and V.dtype == torch.from_numpy(A).dtype
    close(w, wr, TOL[dtype], np.abs(np.asarray(wr)).max())
    eig_checks(A, w, V, dtype)
    same_columns_up_to_phase(V, Vr, 10 * TOL[dtype])


def as_accurate(A, w, V, wr, Vr, factor=1.1):
    """||V^H V - I|| and ||A V - V W|| / ||A|| at most ``factor`` x the
    reference's on the same input."""
    def res(w, V):
        A_, V_ = c128(A, V)
        w = np.asarray(w, np.float64)
        return np.linalg.norm(A_ @ V_ - V_ * w) / np.linalg.norm(A_)
    orth, orth_r = orth_err(V), orth_err(Vr)
    assert orth <= factor * orth_r, f"orthogonality {orth:.3e} > {factor} x {orth_r:.3e}"
    assert res(w, V) <= factor * res(wr, Vr), f"residual {res(w, V):.3e} > {factor} x " \
        f"{res(wr, Vr):.3e}"


def test_jacobi_complex_as_accurate_as_reference():
    """The phase-factor Jacobi on a 48^2 complex64 matrix, same pair table."""
    A = hermitian(np.random.default_rng(12), 48)
    sched = pe._round_robin(48)
    w, V = pe._jacobi_eigh(torch.from_numpy(A), torch.from_numpy(sched.astype(np.int64)))
    wr, Vr = re_._jacobi_eigh(jnp.asarray(A), jnp.asarray(sched))
    as_accurate(A, w, V, np.asarray(wr), np.asarray(Vr))


@pytest.mark.parametrize("dtype,n", [(np.complex64, 40), (np.complex128, 30)])
def test_eigh_complex_base_matches_reference(rng, dtype, n):
    """n <= base_n: the direct Jacobi path with sentinel padding."""
    A = hermitian(rng, n, dtype)
    w, V = ct.eigh(A, CFG, base_n=64, bucket=16)
    wr, Vr = re_.eigh(jnp.asarray(A), RCFG, base_n=64, bucket=16)
    assert w.shape == (n,) and not w.is_complex()
    close(w, wr, TOL[dtype], np.abs(np.asarray(wr)).max())
    eig_checks(A, w, V, dtype)
    same_columns_up_to_phase(V, Vr, 10 * TOL[dtype])


D_AND_C = {"n": 72, "base_n": 16}


@pytest.fixture(scope="module")
def dc_input():
    """One complex64 divide-and-conquer input and the reference's result (a
    D&C call of the reference compiles for most of a minute on the CPU)."""
    A = hermitian(np.random.default_rng(21), D_AND_C["n"])
    w, V = re_.eigh(jnp.asarray(A), RCFG, base_n=D_AND_C["base_n"])
    return A, np.asarray(w), np.asarray(V)


def test_eigh_complex_divide_and_conquer_matches_reference(dc_input):
    A, wr, Vr = dc_input
    w, V = ct.eigh(A, CFG, base_n=D_AND_C["base_n"])
    assert pe.last_stats["split_nodes"] > 0 and pe.last_stats["leaves"] > 1
    close(w, wr, TOL[np.complex64], np.abs(wr).max())
    eig_checks(A, w, V, np.complex64)
    same_columns_up_to_phase(V, Vr, 10 * TOL[np.complex64])


def test_eigh_complex_divide_and_conquer_as_accurate_as_reference(dc_input):
    A, wr, Vr = dc_input
    w, V = ct.eigh(A, CFG, base_n=D_AND_C["base_n"])
    as_accurate(A, w, V, wr, Vr)


def test_split_node_complex(rng):
    """One divide step: Hermitian projector bases that split the spectrum,
    with a certificate ||V+^H H V-|| at eps."""
    A = torch.from_numpy(hermitian(rng, 40, np.complex128))
    V_minus, V_plus, k = pe._split_node(A, CFG.replace(dtype=torch.complex128))
    assert 0 < k < 40 and V_minus.shape == (40, k) and V_plus.shape == (40, 40 - k)
    Q = torch.cat([V_minus, V_plus], 1)
    assert torch.linalg.norm(Q.mH @ Q - torch.eye(40, dtype=Q.dtype)) < 1e-12
    assert torch.linalg.norm(V_plus.mH @ A @ V_minus) < 1e-12 * torch.linalg.norm(A)
    lo = torch.linalg.eigvalsh(V_minus.mH @ A @ V_minus)
    hi = torch.linalg.eigvalsh(V_plus.mH @ A @ V_plus)
    assert lo.max() < hi.min()


@pytest.mark.parametrize("dtype,B,n", [(np.complex64, 5, 24), (np.complex64, 3, 15),
                                       (np.complex128, 2, 12)])
def test_eigh_batched_complex_matches_reference(rng, dtype, B, n):
    As = np.stack([hermitian(rng, n, dtype) for _ in range(B)])
    ws, Vs = ct.eigh_batched(As, config=CFG)
    wr, Vr = re_.eigh_batched(jnp.asarray(As))
    assert ws.shape == (B, n) and Vs.shape == (B, n, n) and not ws.is_complex()
    close(ws, wr, TOL[dtype], np.abs(np.asarray(wr)).max())
    for i in range(B):
        eig_checks(As[i], ws[i], Vs[i], dtype)
        same_columns_up_to_phase(Vs[i], np.asarray(Vr)[i], 10 * TOL[dtype])
