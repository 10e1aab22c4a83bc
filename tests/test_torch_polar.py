"""QDWH polar and SVD of the port (models/polar.py) against the JAX reference
on the inputs of tests/test_polar.py.

The polar factors are unique at full rank, so U and H are compared entry by
entry: within 50 n eps ||A||_2 (eps of the input's dtype).  Singular values:
50 n eps s_max; singular vectors through U diag(s) V^T, the residual and
orthogonality (signs and cluster bases are free).  The weight schedules are
host arithmetic and must be equal; the dynamic-weight recurrence runs in
numpy scalars of the working dtype and is held to the reference's jnp
formulas: same step count, weights to 1e-5 relative.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.linalg as sla
import torch

from cuda_qr_tpu.models import polar as rp
from cuda_qr_tpu.utils.config import QRConfig as RefConfig
from cuda_qr_tpu_torch import QRShapeError, polar, svd
from cuda_qr_tpu_torch.models import polar as pp
from cuda_qr_tpu_torch.ops import smalllinalg
from cuda_qr_tpu_torch.utils.interop import config_from_reference

from torch_threads import one_thread  # noqa: F401  (autouse: one intra-op thread)

RCFG = RefConfig(dtype=jnp.float32, panel_width=16, scan_stages=2)
CFG = config_from_reference(RCFG, device="cpu")


def wide(*xs):
    return [np.asarray(x, np.float64) for x in xs]


def tol_of(A):
    n = min(A.shape)
    return 50 * n * float(np.finfo(A.dtype).eps) * np.linalg.norm(A.astype(np.float64), 2)


def checks(A, U, H, side="right", tol=5e-6):
    """The gates of tests/test_polar.py."""
    k = min(A.shape)
    UU = U.T @ U if U.shape[0] >= U.shape[1] else U @ U.T
    assert np.linalg.norm(UU - np.eye(k)) < tol * k
    rec = U @ H if side == "right" else H @ U
    assert np.linalg.norm(rec - A) / np.linalg.norm(A) < tol
    assert np.abs(H - H.T).max() < tol * np.abs(H).max()
    assert np.linalg.eigvalsh((H + H.T) / 2).min() > -tol * np.abs(H).max()


@pytest.mark.parametrize("l0,eps,max_iter", [(1.2e-8, 1.2e-7, 24), (2e-17, 2.2e-16, 24),
                                             (0.5, 1.2e-7, 24), (1e-9, 1.2e-7, 3)])
def test_schedule_equals_reference(l0, eps, max_iter):
    got = pp._qdwh_schedule(l0, eps, max_iter)
    assert got == rp._qdwh_schedule(l0, eps, max_iter)
    assert 1 <= len(got) <= 8 and all(use_qr == (c > 100.0) for _, _, c, use_qr in got)


@pytest.mark.parametrize("rdt,jdt", [(np.float32, jnp.float32), (np.float64, jnp.float64)])
@pytest.mark.parametrize("b", [33, 96, 2048])
def test_dynamic_schedule_matches_reference_recurrence(rdt, jdt, b):
    """l0 = eps/10/sqrt(b), the divide step's bound: the step count equals
    the static schedule's for the same l0, as the reference states of its
    device loop, and the weights follow the reference's jnp formulas."""
    eps = float(np.finfo(rdt).eps)
    l0 = eps / 10.0 / float(b) ** 0.5
    got = pp._qdwh_dyn_schedule(l0, rdt)
    static = pp._qdwh_schedule(l0, eps)
    assert len(got) == len(static)
    assert [s[3] for s in got] == [s[3] for s in static]
    l = jnp.asarray(l0, jdt)                    # the reference's loop, step by step
    for a, b_, c, use_qr in got:
        assert float(1.0 - l) > 5.0 * eps
        ar, br, cr = rp._halley_weights(l, jdt)
        np.testing.assert_allclose([a, b_, c], [float(ar), float(br), float(cr)], rtol=1e-5)
        assert use_qr == bool(cr > 100.0)
        l = jnp.clip(l * (ar + br * l * l) / (1.0 + cr * l * l), 0.0, 1.0)
    assert float(1.0 - l) <= 5.0 * eps


def test_polar_tall_f32(rng):
    A = rng.standard_normal((96, 48)).astype(np.float32)
    U, H = wide(*polar(A, config=CFG))
    Ur, Hr = wide(*rp.polar(A, config=RCFG))
    checks(A, U, H)
    assert np.abs(U - Ur).max() < tol_of(A) and np.abs(H - Hr).max() < tol_of(A)
    assert np.abs(U - sla.polar(A.astype(np.float64))[0]).max() < 1e-4


def test_polar_square_f64_under_a_float32_config(rng):
    """float64 input runs the QR core in float64 whatever config.dtype says."""
    A = rng.standard_normal((64, 64))
    Ut, Ht = polar(A, config=CFG)
    assert Ut.dtype == Ht.dtype == torch.float64
    U, H = wide(Ut, Ht)
    Ur, Hr = wide(*rp.polar(A, config=RCFG))
    checks(A, U, H, tol=1e-12)
    assert np.abs(U - Ur).max() < tol_of(A) and np.abs(H - Hr).max() < tol_of(A)
    assert np.abs(U - sla.polar(A)[0]).max() < 1e-12


def test_polar_ill_conditioned(rng):
    # cond 1e6 in float32: U's orthogonality must still be O(eps); U itself
    # is only determined to ~cond * eps, so it is not compared entry by entry
    Qa = np.linalg.qr(rng.standard_normal((80, 48)))[0]
    Qb = np.linalg.qr(rng.standard_normal((48, 48)))[0]
    A = ((Qa * np.geomspace(1.0, 1e-6, 48)) @ Qb).astype(np.float32)
    U, H = wide(*polar(A, config=CFG))
    _, Hr = wide(*rp.polar(A, config=RCFG))
    assert np.linalg.norm(U.T @ U - np.eye(48)) < 5e-5
    checks(A, U, H, tol=5e-5)
    assert np.abs(H - Hr).max() < tol_of(A)


@pytest.mark.parametrize("side,hshape", [("right", (90, 90)), ("left", (40, 40))])
def test_polar_wide_and_left(rng, side, hshape):
    A = rng.standard_normal((40, 90)).astype(np.float32)
    U, H = wide(*polar(A, side=side, config=CFG))
    Ur, Hr = wide(*rp.polar(A, side=side, config=RCFG))
    assert U.shape == (40, 90) and H.shape == hshape
    checks(A, U, H, side=side)
    assert np.abs(U - Ur).max() < tol_of(A)
    if side == "left":      # H = (A A^T)^(1/2) is unique; the right H of a wide A is not
        assert np.abs(H - Hr).max() < tol_of(A)
        assert np.abs(U - sla.polar(A.astype(np.float64), side="left")[0]).max() < 1e-4


def test_polar_tall_left(rng):
    A = rng.standard_normal((70, 30)).astype(np.float32)
    U, H = wide(*polar(A, side="left", config=CFG))
    Ur, _ = wide(*rp.polar(A, side="left", config=RCFG))
    assert U.shape == (70, 30) and H.shape == (70, 70)
    checks(A, U, H, side="left")
    assert np.abs(U - Ur).max() < tol_of(A)


def test_polar_identity_like_short_schedule(rng):
    Q0 = np.linalg.qr(rng.standard_normal((32, 32)))[0].astype(np.float32)
    U, H = wide(*polar(Q0, l0=0.5, config=CFG))
    assert np.abs(U - Q0).max() < 1e-5 and np.abs(H - np.eye(32)).max() < 1e-5
    Ur, _ = wide(*rp.polar(Q0, l0=0.5, config=RCFG))
    assert np.abs(U - Ur).max() < tol_of(Q0)


def test_polar_cholesky_steps_go_through_chol_with_inv_auto(rng, monkeypatch):
    """One call per Cholesky step of the schedule, each on an n x n float32
    matrix with n a multiple of 16: the shapes the chol_inv kernel takes on
    the card."""
    from cuda_qr_tpu_torch.ops.chol_kernel import supported
    seen = []
    real = smalllinalg.chol_with_inv_auto

    def spy(G, config=None):
        seen.append((tuple(G.shape), G.dtype, config))
        return real(G, config)

    monkeypatch.setattr(pp, "chol_with_inv_auto", spy)
    A = rng.standard_normal((96, 48)).astype(np.float32)
    polar(A, config=CFG)
    eps = float(np.finfo(np.float32).eps)
    sched = pp._qdwh_schedule(eps / 10.0 / (96 * 48) ** 0.25, eps)
    n_chol = sum(not s[3] for s in sched)
    assert n_chol >= 1 and len(sched) - n_chol >= 1
    assert len(seen) == n_chol
    assert all(supported(s, d) and c is not None and c.use_chol_kernel for s, d, c in seen)


@pytest.mark.parametrize("n", [45, 40, 13])
def test_qdwh_cholesky_step_pads_to_the_kernel_gate(rng, monkeypatch, n):
    """A side that is no multiple of 16 reaches chol_with_inv_auto grown to
    the next one with an identity block, and comes back cut to size with the
    factors of the plain route; with the kernels off nothing is padded."""
    from cuda_qr_tpu_torch.ops.chol_kernel import supported
    seen = []
    real = smalllinalg.chol_with_inv_auto

    def spy(G, config=None):
        seen.append(tuple(G.shape))
        return real(G, config)

    monkeypatch.setattr(pp, "chol_with_inv_auto", spy)
    B = rng.standard_normal((n, 3 * n)).astype(np.float32)
    Z = torch.from_numpy(np.eye(n, dtype=np.float32) + B @ B.T / (3 * n))
    L, Li = pp._chol_inv_padded(Z, CFG)
    Lp, Lip = smalllinalg.cholesky_with_inv(Z)
    npad = -(-n // 16) * 16
    assert seen == [(npad, npad)] and supported(seen[0], Z.dtype)
    assert tuple(L.shape) == tuple(Li.shape) == (n, n)
    assert float((L - Lp).abs().max()) < 1e-5 and float((Li - Lip).abs().max()) < 1e-5
    for cfg, Zx in ((CFG.replace(use_kernels=False), Z), (CFG, Z.double())):
        seen.clear()
        out = pp._chol_inv_padded(Zx, cfg)
        assert seen == [(n, n)]
        assert all(torch.equal(a, b) for a, b in zip(out, smalllinalg.cholesky_with_inv(Zx)))


def test_polar_odd_width_matches_reference(rng):
    """n = 45: every Cholesky step is padded to 48; U and H still agree with
    the reference, which takes the plain route there."""
    A = rng.standard_normal((90, 45)).astype(np.float32)
    U, H = wide(*polar(A, config=CFG))
    Ur, Hr = wide(*rp.polar(A, config=RCFG))
    checks(A, U, H)
    assert np.abs(U - Ur).max() < tol_of(A) and np.abs(H - Hr).max() < tol_of(A)


def test_library_eigh_on_the_cpu_is_torch_eigh(rng):
    """The float64 detour of small float32 matrices exists for the card's
    solver only; on the CPU the core is torch.linalg.eigh as it stands."""
    H = rng.standard_normal((40, 40)).astype(np.float32)
    H = torch.from_numpy(H + H.T)
    w, V = smalllinalg.library_eigh(H)
    wt, Vt = torch.linalg.eigh(H)
    assert w.dtype == V.dtype == torch.float32
    assert torch.equal(w, wt) and torch.equal(V, Vt)


def test_polar_errors():
    with pytest.raises(QRShapeError):
        polar(np.zeros((3, 3, 3), np.float32), config=CFG)
    with pytest.raises(ValueError):
        polar(np.eye(4, dtype=np.float32), side="up", config=CFG)
    # complex input (tests/test_torch_complex_spectral.py): (1+i) I = U H with
    # U = (1+i)/sqrt(2) I and H = sqrt(2) I, as the reference gives it
    Ac = np.eye(4, dtype=np.complex64) * (1 + 1j)
    U, H = polar(Ac, config=CFG)
    rU, rH = rp.polar(jnp.asarray(Ac), config=RCFG)
    np.testing.assert_allclose(U.numpy(), np.asarray(rU), rtol=0, atol=1e-6)
    np.testing.assert_allclose(H.numpy(), np.asarray(rH), rtol=0, atol=1e-6)
    np.testing.assert_allclose(U.numpy(), np.eye(4) * (1 + 1j) / np.sqrt(2), rtol=0, atol=1e-6)


@pytest.mark.parametrize("shape,dtype,tol", [((96, 48), np.float32, 5e-6),
                                             ((40, 70), np.float64, 1e-12)])
def test_svd_matches_reference(rng, shape, dtype, tol):
    A = rng.standard_normal(shape).astype(dtype)
    k = min(shape)
    U, s, Vh = wide(*svd(A, config=CFG))
    Ur, sr, Vhr = wide(*rp.svd(A, config=RCFG))
    assert U.shape == (shape[0], k) and s.shape == (k,) and Vh.shape == (k, shape[1])
    assert np.abs(s - sr).max() < tol_of(A)
    assert np.abs((U * s) @ Vh - (Ur * sr) @ Vhr).max() < tol_of(A)
    assert np.linalg.norm((U * s) @ Vh - A) / np.linalg.norm(A) < tol
    assert np.linalg.norm(U.T @ U - np.eye(k)) < 20 * tol
    assert np.linalg.norm(Vh @ Vh.T - np.eye(k)) < 20 * tol
    s_ref = np.linalg.svd(A.astype(np.float64), compute_uv=False)
    assert np.abs(s - s_ref).max() < 20 * tol * s_ref[0] and (np.diff(s) <= 0).all()


def test_svd_full_matrices_tall(rng):
    A = rng.standard_normal((80, 48)).astype(np.float32)
    U, s, Vh = wide(*svd(A, full_matrices=True, config=CFG))
    sr = np.asarray(rp.svd(A, full_matrices=True, config=RCFG)[1], np.float64)
    assert U.shape == (80, 80) and Vh.shape == (48, 48)
    assert np.abs(s - sr).max() < tol_of(A)
    assert np.linalg.norm(U.T @ U - np.eye(80)) < 2e-4
    Smat = np.zeros((80, 48))
    np.fill_diagonal(Smat, s)
    assert np.linalg.norm(U @ Smat @ Vh - A) / np.linalg.norm(A) < 5e-6


def test_svd_full_matrices_wide_f64(rng):
    A = rng.standard_normal((32, 56))
    Ut, st, Vht = svd(A, full_matrices=True, config=CFG)
    assert Ut.dtype == st.dtype == Vht.dtype == torch.float64
    U, s, Vh = wide(Ut, st, Vht)
    assert U.shape == (32, 32) and Vh.shape == (56, 56)
    assert np.linalg.norm(Vh @ Vh.T - np.eye(56)) < 1e-12 * 56
    Smat = np.zeros((32, 56))
    np.fill_diagonal(Smat, s)
    assert np.linalg.norm(U @ Smat @ Vh - A) / np.linalg.norm(A) < 1e-12


def test_svd_eigh_impl_names(rng):
    """The library route is named "torch" here; the reference's "xla" is not
    accepted."""
    A = rng.standard_normal((24, 16)).astype(np.float32)
    for bad in ("xla", "nope"):
        with pytest.raises(ValueError):
            svd(A, config=CFG, eigh_impl=bad)
    with pytest.raises(QRShapeError):
        svd(np.zeros((2, 3, 3), np.float32), config=CFG)
    s = svd(A, config=CFG, eigh_impl="torch")[1]
    assert np.abs(s.numpy() - np.linalg.svd(A, compute_uv=False)).max() < 1e-5
