"""Complex input of the port's pivoted QR family against the JAX reference
on the same complex numpy input: the plain pivot selection
(``select_pivots_plain``), ``qrcp_blocked``, ``qr_pivoted``, the rank
solvers and the six Givens updates, plus the C3 repair
(``complex_config`` leaves no TF32 GEMM) and the pin that real input
comes out bit for bit as before.

QRCP's pivots depend on the sketch, so the port gets the reference's own
complex Omega (``jax.random.normal`` with key 12 at the complex dtype,
divided by sqrt(l)); jpvt must then be identical up to the numerical rank,
and the same set past it.  The rank solvers draw their own sketch on each
side, so they are compared on what it does not decide: the rank, the
minimum-norm solution, the pseudoinverse and the null space's projector.

Tolerances: factors and solutions 1e-4 (complex64) and 1e-10
(complex128), relative to max |A| for R and to the solution's size
elsewhere; the Givens updates as tests/test_torch_update.py (the same
chains with the same clartg rotations, so Q and R agree directly).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cuda_qr_tpu_torch as ct
from cuda_qr_tpu.models import qr as rqr
from cuda_qr_tpu.models import rank as rrank
from cuda_qr_tpu.models import update as rupd
from cuda_qr_tpu.ops import qrcp as rq
from cuda_qr_tpu.utils.config import QRConfig as RefConfig
from cuda_qr_tpu_torch.ops import blocked, qrcp as pq
from cuda_qr_tpu_torch.ops.select_kernel import select_pivots_plain
from cuda_qr_tpu_torch.utils.geometry import round_up
from cuda_qr_tpu_torch.utils.interop import config_from_reference

from torch_threads import one_thread  # noqa: F401  (autouse: one intra-op thread)

TOL = {np.complex64: 1e-4, np.complex128: 1e-10}
RCFG = RefConfig(dtype=jnp.float32, panel_width=16, scan_stages=2)
CFG = config_from_reference(RCFG, device="cpu")
T = torch.from_numpy


def crand(rng, shape, dtype=np.complex64):
    return (rng.standard_normal(shape) + 1j * rng.standard_normal(shape)).astype(dtype)


def rank_deficient(rng, m, n, r, dtype=np.complex64):
    return (crand(rng, (m, r), np.complex128) @ crand(rng, (r, n), np.complex128)).astype(dtype)


def ref_omega(m, nb, dtype):
    """The reference's complex sketch for an m-row input at panel width nb
    (``cuda_qr_tpu/ops/qrcp.py:166-168``)."""
    m_pad = round_up(m, nb)
    l = pq.sketch_rows(m_pad, nb)
    om = jax.random.normal(jax.random.key(12), (l, m_pad), dtype=dtype)
    return np.array(om / jnp.sqrt(jnp.asarray(l, dtype)))


def npy(x):
    return x.resolve_conj().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def close(got, want, tol, scale=1.0):
    got, want = npy(got), npy(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    err = np.abs(got - want).max() if got.size else 0.0
    assert err <= tol * scale, f"{err:.3e} > {tol:g} x {scale:g}"


@pytest.mark.parametrize("dtype", [np.complex64, np.complex128])
@pytest.mark.parametrize("j0", [0, 16])
def test_select_pivots_plain_complex(rng, dtype, j0):
    """The plain greedy selection on a complex sketch: real norms, |proj|^2
    downdates, the reference's ordsel exactly."""
    l, n_pad, nb, cand = 48, 96, 16, 64
    B = crand(rng, (l, n_pad), dtype) * np.linspace(1, 3, n_pad)
    got = pq._select_pivots(T(B), j0, nb, cand)
    want = rq._select_pivots(jnp.asarray(B), jnp.int32(j0), nb, cand, jax.lax.Precision.HIGHEST)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert (got[:j0] == -1).all() and sorted(got[got >= 0].tolist()) == list(range(nb))
    # the tile-level function: chosen columns are the largest |.|-norm ones first
    S = T(B[:, :cand])
    norms = (S * S.conj()).real.sum(0)
    order = select_pivots_plain(S, norms, nb)
    assert int(order[torch.argmax(norms)]) == 0 and order.dtype == torch.int32


def _qrcp_both(A, nb, num_panels=None):
    m = A.shape[0]
    rcfg = dataclasses.replace(RCFG, panel_width=nb)
    cfg = config_from_reference(rcfg, device="cpu")
    rf, rj, rR12 = rq.qrcp_blocked(jnp.asarray(A), rcfg, num_panels=num_panels)
    f, j, R12 = pq.qrcp_blocked(A, cfg, num_panels=num_panels,
                                omega=ref_omega(m, nb, A.dtype.type))
    return (rf, np.asarray(rj), rR12), (f, j.numpy(), R12)


def pivots_agree(j, rj, r):
    """jpvt identical up to the numerical rank r, the same set past it."""
    np.testing.assert_array_equal(j[:r], rj[:r])
    assert sorted(j[r:].tolist()) == sorted(rj[r:].tolist())


@pytest.mark.parametrize("dtype,m,n,nb", [(np.complex64, 96, 64, 16),
                                          (np.complex64, 130, 70, 16),
                                          (np.complex128, 80, 48, 16)])
def test_qrcp_blocked_complex_matches_reference(rng, dtype, m, n, nb):
    A = crand(rng, (m, n), dtype)
    (rf, rj, rR12), (f, j, R12) = _qrcp_both(A, nb)
    np.testing.assert_array_equal(j, rj)
    tol, scale = TOL[dtype], np.abs(A).max()
    assert f.packed.dtype == T(A).dtype and f.taus.dtype == T(A).dtype
    close(f.packed, rf.packed, tol, scale)
    close(f.taus, rf.taus, tol)
    close(f.Ts, rf.Ts, tol, 10)
    assert R12.shape == (round_up(n, nb), 0)
    kb = f.packed.shape[1]
    Q, R = ct.orgqr(f, m, kb, CFG), ct.extract_r(f, kb)
    chk = ct.check_qr(A[:, j[:n]], Q[:, :n], R[:n, :n])
    assert chk.ok, chk
    assert float(R.diagonal().imag.abs().max()) == 0.0          # clarfg: a real diagonal


def test_qrcp_blocked_complex_truncated(rng):
    A = crand(rng, (96, 64))
    (rf, rj, rR12), (f, j, R12) = _qrcp_both(A, 16, num_panels=2)
    np.testing.assert_array_equal(j[:32], rj[:32])
    close(f.packed, rf.packed, TOL[np.complex64], np.abs(A).max())
    close(R12, rR12, TOL[np.complex64], np.abs(A).max())


@pytest.mark.parametrize("dtype", [np.complex64, np.complex128])
@pytest.mark.parametrize("rank", [None, 20])
def test_qr_pivoted_complex_matches_reference(rng, dtype, rank):
    m, n, nb = 80, 40, 16
    A = crand(rng, (m, n), dtype)
    Q, R, piv = ct.qr_pivoted(A, CFG, rank=rank, omega=ref_omega(m, nb, dtype))
    rQ, rR, rpiv = rqr.qr_pivoted(jnp.asarray(A), RCFG, rank=rank)
    k = n if rank is None else rank
    assert Q.shape == (m, k) and R.shape == (k, n) and Q.dtype == T(A).dtype
    np.testing.assert_array_equal(piv.numpy(), np.asarray(rpiv))
    tol = TOL[dtype]
    close(Q, rQ, tol)
    close(R, rR, tol, np.abs(A).max())
    if rank is None:
        assert ct.check_qr(A[:, piv.numpy()], Q, R).ok


def test_qr_pivoted_complex_rank_deficient(rng):
    """Rank 12 of 40: the pivots agree up to the rank, as a set past it; the
    leading factor reconstructs the chosen columns."""
    m, n, r = 80, 40, 12
    A = rank_deficient(rng, m, n, r)
    Q, R, piv = ct.qr_pivoted(A, CFG, omega=ref_omega(m, 16, np.complex64))
    _, rR, rpiv = rqr.qr_pivoted(jnp.asarray(A), RCFG)
    pivots_agree(piv.numpy(), np.asarray(rpiv), r)
    close(np.abs(np.diag(npy(R)))[:r], np.abs(np.diag(np.asarray(rR)))[:r],
          TOL[np.complex64], np.abs(A).max())
    assert np.abs(np.diag(npy(R)))[r:].max() < 1e-4 * np.abs(A).max()
    close(npy(Q) @ npy(R), A[:, piv.numpy()], 1e-4, np.abs(A).max())


@pytest.mark.parametrize("dtype,m,n,r", [(np.complex64, 80, 48, 48), (np.complex64, 80, 48, 20),
                                         (np.complex128, 64, 40, 1)])
def test_matrix_rank_complex(rng, dtype, m, n, r):
    A = rank_deficient(rng, m, n, r, dtype)
    assert ct.matrix_rank(A, config=CFG) == rrank.matrix_rank(A, config=RCFG) == r


@pytest.mark.parametrize("dtype", [np.complex64, np.complex128])
def test_lstsq_rr_complex_matches_reference(rng, dtype):
    m, n, r = 70, 40, 15
    A = rank_deficient(rng, m, n, r, dtype)
    b = crand(rng, (m, 3), dtype)
    x, resid, rk, piv = ct.lstsq_rr(A, b, config=CFG)
    rx, rres, rrk, _ = rrank.lstsq_rr(A, b, config=RCFG)
    assert rk == rrk == r and x.dtype == T(A).dtype and resid.dtype == T(A).real.dtype
    assert sorted(piv.tolist()) == list(range(n))
    tol = 10 * TOL[dtype]            # a rank-deficient system's conditioning enters
    close(x, rx, tol, np.abs(np.asarray(rx)).max())
    close(resid, rres, tol, np.abs(np.asarray(rres)).max())
    x_np = np.linalg.lstsq(A.astype(np.complex128), b.astype(np.complex128), rcond=1e-5)[0]
    close(x, x_np.astype(dtype), tol, np.abs(x_np).max())
    xv, rv, _, _ = ct.lstsq_rr(A, b[:, 0], config=CFG)
    assert xv.shape == (n,) and rv.dim() == 0
    close(xv, npy(x)[:, 0], tol, np.abs(np.asarray(rx)).max())


@pytest.mark.parametrize("dtype", [np.complex64, np.complex128])
def test_pinv_complex_matches_reference(rng, dtype):
    A = rank_deficient(rng, 60, 30, 10, dtype)
    P = ct.pinv(A, config=CFG)
    rP = np.asarray(rrank.pinv(A, config=RCFG))
    tol = 10 * TOL[dtype]
    close(P, rP, tol, np.abs(rP).max())
    close(P, np.linalg.pinv(A.astype(np.complex128), rcond=1e-5).astype(dtype), tol,
          np.abs(rP).max())


@pytest.mark.parametrize("dtype", [np.complex64, np.complex128])
def test_null_space_complex_matches_reference(rng, dtype):
    A = rank_deficient(rng, 60, 30, 10, dtype)
    N = npy(ct.null_space(A, config=CFG))
    rN = np.asarray(rrank.null_space(A, config=RCFG))
    assert N.shape == rN.shape == (30, 20)
    tol = 10 * TOL[dtype]
    close(N @ N.conj().T, rN @ rN.conj().T, tol)
    close(N.conj().T @ N, np.eye(20), tol)
    assert np.abs(A @ N).max() < tol * np.abs(A).max() * 30


def test_slogdet_rejects_complex():
    A = np.eye(4, dtype=np.complex64)
    with pytest.raises(ct.QRShapeError):
        ct.slogdet(A, config=CFG)
    with pytest.raises(Exception, match="square real"):
        rrank.slogdet(jnp.asarray(A), config=RCFG)


def test_complex_config_leaves_no_tf32():
    """C3: cuBLAS's TF32 mode reaches complex64 GEMMs, so every GEMM of a
    complex input runs at "highest" whatever the configuration says ("tf32"
    and MIXED_CONFIG's "high" alike); real MIXED_CONFIG keeps its 3xTF32
    trailing update."""
    A = torch.zeros((8, 4), dtype=torch.complex64)
    for base in (ct.MIXED_CONFIG, ct.QRConfig(precision="tf32", orgqr_precision="tf32"),
                 ct.QRConfig(trailing_precision="tf32", orgqr_precision="high")):
        cfg = blocked.complex_config(A, base)
        precisions = (cfg.precision, cfg.trailing_precision, cfg.orgqr_precision,
                      cfg.resolved_trailing_precision(), cfg.resolved_orgqr_precision())
        assert set(precisions) <= {"highest", None}
        assert cfg.dtype == torch.complex64 and not cfg.use_kernels
        assert not cfg.use_chol_kernel and not cfg.use_select_kernel
    real = blocked.complex_config(A.real, ct.MIXED_CONFIG)
    assert real is ct.MIXED_CONFIG and real.resolved_trailing_precision() == "high"


# -- the Givens updates: the same chains as the reference (clartg rotations)
def factors(A):
    Q, R = np.linalg.qr(A)
    return Q.astype(A.dtype), R.astype(A.dtype)


def agree(got, want, A1, dtype):
    """Port == reference, and the port's factors pass the gates on A1."""
    Q, R = got
    rQ, rR = (np.asarray(x) for x in want)
    tol = TOL[dtype]
    close(Q, rQ, tol)
    close(R, rR, tol, np.abs(rR).max())
    chk = ct.check_qr(A1, Q, R)
    assert chk.residual < 8 * max(A1.shape) * chk.eps, chk
    assert chk.orthogonality < 8 * max(A1.shape) * chk.eps, chk
    assert chk.r_triangular == 0.0


UPDATES = ["qr_rank1_update", "qr_update", "qr_row_insert", "qr_row_delete", "qr_col_insert",
           "qr_col_delete"]


@pytest.mark.parametrize("dtype", [np.complex64, np.complex128])
@pytest.mark.parametrize("name", UPDATES)
def test_update_complex_matches_reference(rng, dtype, name):
    m, n, k = 30, 10, 4
    A = crand(rng, (m, n), dtype)
    Q, R = factors(A)
    Qt, Rt, Qj, Rj = T(Q), T(R), jnp.asarray(Q), jnp.asarray(R)
    u, v = crand(rng, m, dtype), crand(rng, n, dtype)
    U, V = crand(rng, (m, 2), dtype), crand(rng, (n, 2), dtype)
    a_row, a_col = crand(rng, n, dtype), crand(rng, m, dtype)
    calls = {
        "qr_rank1_update": ((T(u), T(v)), (jnp.asarray(u), jnp.asarray(v)), {},
                            A + np.outer(u, v.conj())),
        "qr_update": ((T(U), T(V)), (jnp.asarray(U), jnp.asarray(V)), {}, A + U @ V.conj().T),
        "qr_row_insert": ((T(a_row),), (jnp.asarray(a_row),), {"k": k},
                          np.insert(A, k, a_row, 0)),
        "qr_row_delete": ((), (), {"k": k}, np.delete(A, k, 0)),
        "qr_col_insert": ((T(a_col),), (jnp.asarray(a_col),), {"k": k},
                          np.insert(A, k, a_col, 1)),
        "qr_col_delete": ((), (), {"k": k}, np.delete(A, k, 1)),
    }
    pargs, rargs, kw, A1 = calls[name]
    got = getattr(ct, name)(Qt, Rt, *pargs, **kw)
    assert torch.equal(Qt, T(Q)) and torch.equal(Rt, T(R))      # inputs unchanged
    assert got[0].dtype == got[1].dtype == T(A).dtype
    agree(got, getattr(rupd, name)(Qj, Rj, *rargs, **kw), A1, dtype)


def test_givens_clartg():
    """c real, r carries a's phase, G [a, b] = [r, 0]; a = b = 0 is the identity."""
    from cuda_qr_tpu_torch.models.update import _givens
    for a, b in ((3 - 4j, 1 + 2j), (0j, 2 - 1j), (1.5 + 0j, 0j), (0j, 0j)):
        at, bt = torch.tensor(a, dtype=torch.complex128), torch.tensor(b, dtype=torch.complex128)
        c, s, r = _givens(at, bt)
        assert not c.is_complex()
        G = np.array([[float(c), -complex(s)], [complex(s).conjugate(), float(c)]])
        np.testing.assert_allclose(G @ np.array([a, b]), [complex(r), 0], atol=1e-14)
        np.testing.assert_allclose(G.conj().T @ G, np.eye(2), atol=1e-14)
        if a:
            assert abs(complex(r) / abs(complex(r)) - a / abs(a)) < 1e-14


def test_real_results_unchanged(rng):
    """Real input through every function this slice touched, against the
    parent's arithmetic written out here (transposes where the code now has
    conjugate transposes): torch.equal."""
    from cuda_qr_tpu_torch.models import eigh as pe, polar as pp, rsvd as pr, update as pu
    for dtype in (torch.float32, torch.float64):
        S = torch.from_numpy(rng.standard_normal((48, 256))).to(dtype)
        norms = (S * S).sum(0)
        old = torch.full((256,), -1, dtype=torch.int32)
        Sc, nc = S.clone(), norms.clone()
        for i in range(32):
            p = torch.argmax(nc)
            q = Sc[:, p:p + 1]
            nq = torch.sqrt(torch.clamp_min((q * q).sum(), 0))
            qn = q * torch.where(nq > 0, 1 / nq, torch.zeros((), dtype=dtype))
            proj = qn.T @ Sc
            Sc = Sc - qn * proj
            nn = torch.maximum(nc - proj[0] * proj[0], torch.zeros((), dtype=dtype))
            hit = torch.arange(256) == p
            nc = torch.where(hit | (nc < 0), -1.0, nn)
            old = torch.where(hit, i, old)
        assert torch.equal(select_pivots_plain(S, norms, 32), old)

        a, b = torch.from_numpy(rng.standard_normal(2)).to(dtype)
        r = torch.hypot(a, b)
        assert all(torch.equal(x, y) for x, y in zip(pu._givens(a, b), (a / r, -b / r, r)))
        M = torch.from_numpy(rng.standard_normal((6, 4))).to(dtype)
        Qm = torch.from_numpy(rng.standard_normal((9, 6))).to(dtype)
        c, s, _ = pu._givens(M[1, 1], M[2, 1])
        G = torch.stack([c, -s, s, c]).reshape(2, 2)
        rows, cols = G @ torch.stack([M[1], M[2]]), torch.stack([Qm[:, 1], Qm[:, 2]], 1) @ G.T
        pu._rotate(M, Qm, 1, 2, c, s)
        assert torch.equal(M[1], rows[0]) and torch.equal(Qm[:, 2], cols[:, 1])

        H = torch.from_numpy(rng.standard_normal((3, 16, 16))).to(dtype)
        H = (H + H.mT) * 0.5
        w, V = pe._jacobi_eigh(H, pe._schedule("round_robin", 16, "cpu"))
        wo, Vo = _old_jacobi(H, pe._schedule("round_robin", 16, "cpu"))
        assert torch.equal(w, wo) and torch.equal(V, Vo)

        Z = torch.from_numpy(rng.standard_normal((40, 4))).to(dtype)
        G = Z.T @ Z
        L = torch.linalg.cholesky_ex(G + torch.finfo(dtype).tiny * torch.eye(4, dtype=dtype)).L
        assert torch.equal(pr._gram_orthonormalize(Z, CFG),
                           torch.linalg.solve_triangular(L, Z.T, upper=False).T)
        g = torch.Generator().manual_seed(5)
        assert torch.equal(pr._sketch((7, 3), Z, g, None),
                           torch.randn((7, 3), generator=torch.Generator().manual_seed(5),
                                       dtype=dtype))
        X = torch.from_numpy(rng.standard_normal((20, 6))).to(dtype)
        U = pp._qdwh_core(X / 8, [(3.0, 1.0, 3.0, True), (2.0, 0.5, 1.5, False)], CFG)
        Uo = _old_qdwh(X / 8, [(3.0, 1.0, 3.0, True), (2.0, 0.5, 1.5, False)], CFG)
        assert torch.equal(U, Uo)
        assert torch.equal(pp._form_h(U, X, "right", CFG), ((U.T @ X) + (U.T @ X).T) * 0.5)


def _old_jacobi(A, schedule):
    """The parent's real Jacobi sweep loop (``_jacobi_eigh`` before complex
    input), for the bit-for-bit pin; c formed as ``eigh._rotation`` forms it
    since the rotation's bias was repaired (C4)."""
    from cuda_qr_tpu_torch.models.eigh import _real_dtype
    from cuda_qr_tpu_torch.ops.smalllinalg import eye_like
    n = A.shape[-1]
    eps = torch.finfo(_real_dtype(A.dtype)).eps
    tol2 = (4.0 * n ** 0.5 * eps * torch.linalg.norm(A, dim=(-2, -1))) ** 2
    offmask = 1.0 - eye_like(n, A)
    V = eye_like(n, A).expand_as(A).contiguous()
    for _ in range(30):
        active = ((A * offmask) ** 2).sum((-2, -1)) > tol2
        if not bool(active.any()):
            break
        A1, V1 = A, V
        for r in range(n - 1):
            p, q = schedule[r][:, 0], schedule[r][:, 1]
            app, aqq, apq = A1[:, p, p], A1[:, q, q], A1[:, p, q]
            ab = apq.abs()
            live = ab > 0
            tau = (aqq - app) / (2.0 * torch.where(live, ab, 1.0))
            t = torch.sign(tau) / (tau.abs() + torch.sqrt(1.0 + tau * tau))
            t = torch.where(tau == 0, 1.0, t)
            t2 = t * t
            r2 = torch.sqrt(1.0 + t2)
            c = 1.0 - t2 / (r2 * (1.0 + r2))
            s = torch.where(live, t * c, 0.0)
            c = torch.where(live, c, 1.0)
            ph = torch.where(live, torch.sign(apq), 1.0)
            J = torch.zeros_like(A1)
            J[:, p, p], J[:, p, q], J[:, q, p], J[:, q, q] = c, s, -s * ph, c * ph
            A1, V1 = J.mT @ (A1 @ J), V1 @ J
        A1 = (A1 + A1.mT) * 0.5
        keep = active[:, None, None]
        A, V = torch.where(keep, A1, A), torch.where(keep, V1, V)
    w, order = torch.sort(torch.diagonal(A, 0, -2, -1), dim=-1, stable=True)
    return w, torch.gather(V, 2, order[:, None, :].expand_as(V))


def _old_qdwh(X, schedule, config):
    """The parent's ``_qdwh_core`` (real transposes)."""
    import math
    from cuda_qr_tpu_torch.models.polar import _chol_inv_padded, _thin_q2
    from cuda_qr_tpu_torch.ops.smalllinalg import eye_like
    m, n = X.shape
    eye = eye_like(n, X)
    for a, b, c, use_qr in schedule:
        bc = b / c
        if use_qr:
            sc = math.sqrt(c)
            Q = _thin_q2(torch.cat([sc * X, eye], 0), config).to(X.dtype)
            X = bc * X + ((a - bc) / sc) * (Q[:m] @ Q[m:].T)
        else:
            _, Li = _chol_inv_padded(eye + c * (X.T @ X), config)
            X = bc * X + (a - bc) * ((X @ Li.T) @ Li)
    return X
