"""Complex QR of the port (the Householder family) against the JAX reference
on the same complex numpy input: every case of tests/test_complex.py, and
the distributed CAQR/TSQR on P = 4 gloo ranks against the reference on the
virtual mesh.

Tolerances, relative to max |A| (or to 1 for the reflector's O(1) values):
the reflector's v, tau and beta 1e-6 (complex64) and 1e-13 (complex128);
geqr2's packed/tau and qr_blocked's packed factors 1e-5 and 1e-12; Q, R,
lstsq's x and the LQ family 1e-4 and 1e-10 (a thin QR's factors move by
cond(A) times the rounding).  TSQR and CAQR leave a unit phase per row of
R: they are compared by QR, |R| and the phase-normalized factors.  Real
input is unchanged: every helper now written with conjugate transposes
gives results torch.equal to its former real-transpose form.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cuda_qr_tpu_torch as ct
from cuda_qr_tpu.models import decomp as ref_decomp
from cuda_qr_tpu.models.lstsq import lstsq as ref_lstsq
from cuda_qr_tpu.models.qr import qr as ref_qr, qr_factor as ref_qr_factor
from cuda_qr_tpu.models.tsqr import tsqr as ref_tsqr, tsqr_r as ref_tsqr_r
from cuda_qr_tpu.ops import householder as ref_hh
from cuda_qr_tpu.ops.blocked import qr_blocked as ref_qr_blocked
from cuda_qr_tpu.parallel.mesh import row_mesh as ref_row_mesh, row_sharding as ref_sharding
from cuda_qr_tpu.parallel.tsqr_dist import tsqr_dist as ref_tsqr_dist
from cuda_qr_tpu.models.caqr import caqr as ref_caqr
from cuda_qr_tpu.utils.config import QRConfig as RefConfig
from cuda_qr_tpu_torch.models import tsqr as tsqr_mod
from cuda_qr_tpu_torch.ops import householder as hh
from cuda_qr_tpu_torch.parallel.launch import MESH, call_many, run_ranks

DTYPES = [np.complex64, np.complex128]
TOL_REFL = {np.complex64: 1e-6, np.complex128: 1e-13}
TOL_FAC = {np.complex64: 1e-5, np.complex128: 1e-12}
TOL_QR = {np.complex64: 1e-4, np.complex128: 1e-10}
CFG = ct.QRConfig(panel_width=16, device="cpu")
RCFG = RefConfig(panel_width=16, scan_stages=2)


def crand(rng, shape, dtype=np.complex64):
    return (rng.standard_normal(shape) + 1j * rng.standard_normal(shape)).astype(dtype)


def T(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def close(port, ref, tol, scale=1.0):
    port = port.resolve_conj().numpy() if isinstance(port, torch.Tensor) else np.asarray(port)
    ref = np.asarray(ref)
    assert port.shape == ref.shape, (port.shape, ref.shape)
    err = np.abs(port - ref).max() if port.size else 0.0
    assert err <= tol * scale, f"{err:.3e} > {tol:g} x {scale:g}"


def gates(A, Q, R, tol):
    Q, R = (x.resolve_conj().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
            for x in (Q, R))
    resid = np.linalg.norm(Q @ R - A) / np.linalg.norm(A)
    orth = np.linalg.norm(Q.conj().T @ Q - np.eye(Q.shape[1]))
    assert resid < tol and orth < tol, (resid, orth)
    assert np.abs(np.tril(R, -1)).max(initial=0.0) == 0.0


def phase_normalized(Q, R):
    """(Q D, D^H R) with D the unit phases of diag(R): unique for full rank."""
    Q, R = np.asarray(Q), np.asarray(R)
    d = np.diag(R)
    ph = np.where(np.abs(d) > 0, d / np.where(d == 0, 1, np.abs(d)), 1)
    return Q * ph[None, :], R * ph.conj()[:, None]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("case", ["random", "zero-tail-real-x0", "zero-tail-complex-x0",
                                  "zero-column", "tiny"])
def test_make_reflector(rng, dtype, case):
    x = crand(rng, 12, dtype)
    if case.startswith("zero-tail"):
        x[4:] = 0
        x[3] = 2.5 if case.endswith("real-x0") else 1.5 - 0.5j
    elif case == "zero-column":
        x[:] = 0
    elif case == "tiny":
        x *= 1e-30
    v, tau, beta = hh.make_reflector(T(x), 3)
    rv, rtau, rbeta = ref_hh.make_reflector(jnp.asarray(x), 3)
    tol = TOL_REFL[dtype]
    close(v, rv, tol)
    close(tau, rtau, tol)
    close(beta, rbeta, tol, max(1.0, abs(complex(rbeta))))
    assert v.dtype == T(x).dtype and float(beta.imag) == 0.0     # beta is real
    if case in ("zero-tail-real-x0", "zero-column"):
        assert complex(tau) == 0                                  # degenerate: H = I
    else:
        H = np.eye(12) - complex(tau) * np.outer(v.numpy(), v.numpy().conj())
        y = H.conj().T @ x
        assert np.abs(y[4:]).max() <= 10 * tol * np.abs(x).max()


@pytest.mark.parametrize("dtype", DTYPES)
def test_geqr2_larft(rng, dtype):
    A = crand(rng, (16, 6), dtype)
    packed, tau = hh.geqr2(T(A))
    rpacked, rtau = ref_hh.geqr2(jnp.asarray(A))
    tol = TOL_FAC[dtype]
    close(packed, rpacked, tol, np.abs(A).max())
    close(tau, rtau, tol)
    V = hh.unpack_v(packed)
    Tm = hh.larft(V, tau)
    close(Tm, ref_hh.larft(ref_hh.unpack_v(rpacked, 0), rtau), tol, 10)
    Q = torch.eye(16, dtype=V.dtype) - V @ Tm @ V.mH
    gates(A, Q[:, :6], torch.triu(packed)[:6], 100 * TOL_FAC[dtype])
    # larfb applies Q^H and Q; merge_wy joins two block reflectors
    B = T(crand(rng, (16, 3), dtype))
    close(hh.larfb(B, V, Tm, transpose=True), Q.mH @ B, tol, 10)
    close(hh.larfb(B, V, Tm, transpose=False), Q @ B, tol, 10)
    Tmerged = hh.merge_wy(V[:, :3], Tm[:3, :3], V[:, 3:], Tm[3:, 3:])
    close(Tmerged, ref_hh.merge_wy(jnp.asarray(V[:, :3].numpy()), jnp.asarray(Tm[:3, :3].numpy()),
                                   jnp.asarray(V[:, 3:].numpy()), jnp.asarray(Tm[3:, 3:].numpy())),
          tol, 10)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("m,n", [(48, 48), (96, 33), (200, 64)])
def test_qr_blocked(rng, dtype, m, n):
    A = crand(rng, (m, n), dtype)
    fac = ct.qr_blocked(A, CFG)
    ref = ref_qr_blocked(jnp.asarray(A), RCFG)
    assert fac.packed.dtype == torch.from_numpy(A).dtype
    tol, scale = TOL_FAC[dtype], np.abs(A).max()
    close(fac.packed, ref.packed, tol, scale)
    close(fac.taus, ref.taus, tol)
    close(fac.Ts, ref.Ts, tol, 10)
    Q, R = ct.orgqr(fac, m, n, CFG), ct.extract_r(fac, n)
    gates(A, Q, R, TOL_QR[dtype])
    assert float(R.diagonal().imag.abs().max()) == 0.0      # clarfg: R's diagonal is real
    close(Q, ref_qr(jnp.asarray(A), RCFG)[0], TOL_QR[dtype])


@pytest.mark.parametrize("dtype", DTYPES)
def test_qr_modes(rng, dtype):
    A = crand(rng, (20, 8), dtype)
    tol = TOL_QR[dtype]
    Q, R = ct.qr(A, CFG)
    rQ, rR = ref_qr(jnp.asarray(A), RCFG)
    close(Q, rQ, tol)
    close(R, rR, tol, np.abs(A).max())
    gates(A, Q, R, tol)
    Qc, Rc = ct.qr(A, CFG, mode="complete")
    rQc, rRc = ref_qr(jnp.asarray(A), RCFG, mode="complete")
    assert Qc.shape == (20, 20) and Rc.shape == (20, 8)
    close(Qc, rQc, tol)
    close(Rc, rRc, tol, np.abs(A).max())
    assert np.linalg.norm(Qc.numpy().conj().T @ Qc.numpy() - np.eye(20)) < tol
    close(ct.qr(A, CFG, mode="r"), ref_qr(jnp.asarray(A), RCFG, mode="r"), tol, np.abs(A).max())
    h, tau = ct.qr(A, CFG, mode="raw")
    rh, rtau = ref_qr(jnp.asarray(A), RCFG, mode="raw")
    close(h, rh, TOL_FAC[dtype], np.abs(A).max())
    close(tau, rtau, TOL_FAC[dtype])
    Ab = crand(rng, (2, 3, 20, 8), dtype)                    # a batch, one matrix at a time
    Qb, Rb = ct.qr(Ab, CFG)
    close(Qb @ Rb, Ab, tol, np.abs(Ab).max())


@pytest.mark.parametrize("dtype", DTYPES)
def test_qr_wide(rng, dtype):
    A = crand(rng, (8, 20), dtype)
    Q, R = ct.qr(A, CFG)
    rQ, rR = ref_qr(jnp.asarray(A), RCFG)
    close(Q, rQ, TOL_QR[dtype])
    close(R, rR, TOL_QR[dtype], np.abs(A).max())
    close(Q @ R, A, TOL_QR[dtype], np.abs(A).max())


@pytest.mark.parametrize("dtype", DTYPES)
def test_ormqr_round_trip(rng, dtype):
    A = crand(rng, (32, 12), dtype)
    B = crand(rng, (32, 5), dtype)
    cfg, rcfg = CFG.replace(panel_width=8), RefConfig(panel_width=8, scan_stages=1)
    res, ref = ct.qr_factor(A, cfg), ref_qr_factor(jnp.asarray(A), rcfg)
    QtB = res.apply_qt(T(B))
    close(QtB, ref.apply_qt(jnp.asarray(B)), TOL_QR[dtype], np.abs(B).max())
    close(res.apply_q(QtB), B, TOL_QR[dtype], np.abs(B).max())
    close(ct.ormqr(res.factors, T(B), transpose=True, config=cfg), QtB, 0.0)


def test_complex_vs_numpy_r(rng):
    A = crand(rng, (24, 10))
    _, R = ct.qr(A, CFG)
    close(np.abs(R.numpy()), np.abs(np.linalg.qr(A, mode="r")), 1e-4)


@pytest.mark.parametrize("dtype", DTYPES)
def test_lstsq_and_solve(rng, dtype):
    A = crand(rng, (40, 12), dtype)
    x_true = crand(rng, (12, 3), dtype)
    b = A @ x_true + 0.01 * crand(rng, (40, 3), dtype)
    res = ct.lstsq(A, b, CFG)
    ref = ref_lstsq(jnp.asarray(A), jnp.asarray(b), RCFG)
    tol = TOL_QR[dtype]
    close(res.x, ref.x, tol)
    close(res.residual_norm, ref.residual_norm, tol)
    x_np = np.linalg.lstsq(A.astype(np.complex128), b.astype(np.complex128), rcond=None)[0]
    close(res.x, x_np.astype(dtype), 10 * tol)
    vec = ct.lstsq(A, b[:, 0], CFG)
    close(vec.x, res.x[:, 0], tol)
    S = crand(rng, (12, 12), dtype) + 4 * np.eye(12)
    close(ct.solve(S, b[:12], CFG), np.linalg.solve(S, b[:12]), 10 * tol)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("name,shape", [("lq", (20, 50)), ("lq", (50, 20)), ("rq", (20, 50)),
                                        ("rq", (50, 20)), ("ql", (50, 20)), ("ql", (20, 50))])
def test_lq_rq_ql(rng, dtype, name, shape):
    A = crand(rng, shape, dtype)
    X, Y = getattr(ct, name)(A, CFG)
    rX, rY = getattr(ref_decomp, name)(jnp.asarray(A), RCFG)
    tol = TOL_QR[dtype]
    close(X, rX, tol, np.abs(A).max())
    close(Y, rY, tol)
    close(X @ Y, A, tol, np.abs(A).max())
    only = {"lq": "l", "rq": "r", "ql": "l"}[name]
    close(getattr(ct, name)(A, CFG, mode=only), Y if name == "ql" else X, tol, np.abs(A).max())


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("mode,transpose,cshape", [("left", False, (12, 3)),
                                                   ("left", True, (40, 3)),
                                                   ("right", False, (3, 40)),
                                                   ("right", True, (3, 12))])
def test_qr_multiply(rng, dtype, mode, transpose, cshape):
    A = crand(rng, (40, 12), dtype)
    C = crand(rng, cshape, dtype)
    out, R = ct.qr_multiply(A, C, mode=mode, transpose=transpose, config=CFG)
    rout, rR = ref_decomp.qr_multiply(jnp.asarray(A), jnp.asarray(C), mode=mode,
                                      transpose=transpose, config=RCFG)
    close(out, rout, TOL_QR[dtype], np.abs(C).max())
    close(R, rR, TOL_QR[dtype], np.abs(A).max())


@pytest.mark.parametrize("dtype", DTYPES)
def test_tsqr(rng, dtype):
    """QR and |R| (each tree node leaves a phase per row), never R entry by
    entry; the cholqr2 configuration routes complex to Householder."""
    A = crand(rng, (4096, 32), dtype)
    cfg = ct.QRConfig(block_rows=512, device="cpu")
    rcfg = RefConfig(block_rows=512, use_pallas=False)
    tol = TOL_QR[dtype]
    Q, R = ct.tsqr(A, cfg)
    rQ, rR = ref_tsqr(jnp.asarray(A), rcfg)
    assert Q.dtype == torch.from_numpy(A).dtype
    gates(A, Q, R, tol)
    close(np.abs(R.numpy()), np.abs(np.asarray(rR)), tol, np.abs(A).max())
    close(Q @ R, np.asarray(rQ) @ np.asarray(rR), tol, np.abs(A).max())
    R2 = ct.tsqr_r(A, cfg)
    close(np.abs(R2.numpy()), np.abs(np.asarray(ref_tsqr_r(jnp.asarray(A), rcfg))), tol,
          np.abs(A).max())
    Q3, R3 = ct.tsqr(A, cfg.replace(tsqr_leaf="cholqr2"))
    gates(A, Q3, R3, tol)
    assert tsqr_mod._complex_config(T(A), cfg.replace(tsqr_leaf="cholqr2")).tsqr_leaf \
        == "householder"


def test_qr_batched_rejects_complex():
    with pytest.raises(ct.QRShapeError):
        ct.qr_batched(torch.ones((2, 5, 3), dtype=torch.complex64), CFG)


def test_real_results_unchanged_by_conjugate_transposes(rng):
    """Every helper switched to .mH/.conj() against its former .mT form, on
    real tensors: torch.equal."""
    for dtype in (torch.float32, torch.float64):
        A = torch.from_numpy(rng.standard_normal((3, 40, 12))).to(dtype)
        packed, tau = hh.geqr2(A, 2)
        # geqr2's former column update
        old = A.clone()
        m, n = old.shape[-2:]
        old_tau = torch.zeros(old.shape[:-2] + (n,), dtype=dtype)
        for j in range(n):
            d = 2 + j
            v, tj, beta = hh.make_reflector(old[..., :, j], d)
            vl = v[..., d:]
            if j + 1 < n:
                w = tj[..., None] * hh.vecmat(vl, old[..., d:, j + 1:])
                old[..., d:, j + 1:] -= vl[..., :, None] * w[..., None, :]
            old[..., d, j] = beta
            old[..., d + 1:, j] = vl[..., 1:]
            old_tau[..., j] = tj
        assert torch.equal(packed, old) and torch.equal(tau, old_tau)
        V = hh.unpack_v(packed, 2)
        Tm = hh.larft(V, tau)
        G = V.mT @ V
        Told = torch.zeros_like(Tm)
        for j in range(n):
            if j:
                Told[..., :j, j] = -tau[..., j, None] * hh.matvec(Told[..., :j, :j], G[..., :j, j])
            Told[..., j, j] = tau[..., j]
        assert torch.equal(Tm, Told)
        B = torch.from_numpy(rng.standard_normal((3, 40, 5))).to(dtype)
        for tr in (True, False):
            old_b = B - V @ ((Tm.mT if tr else Tm) @ (V.mT @ B))
            assert torch.equal(hh.larfb(B, V, Tm, transpose=tr), old_b)
        V1, T1, V2, T2 = V[0, :, :5], Tm[0, :5, :5], V[0, :, 5:], Tm[0, 5:, 5:]
        T12 = -(T1 @ ((V1.T @ V2) @ T2))
        old_m = torch.cat([torch.cat([T1, T12], 1),
                           torch.cat([torch.zeros((7, 5), dtype=dtype), T2], 1)], 0)
        assert torch.equal(hh.merge_wy(V1, T1, V2, T2), old_m)
        Qb = tsqr_mod._batched_orgqr(packed[..., 2:, :], hh.larft(hh.unpack_v(packed[..., 2:, :]),
                                                                  tau))
        Vb = hh.unpack_v(packed[..., 2:, :])
        Tb = hh.larft(Vb, tau)
        old_q = -(Vb @ (Tb @ Vb[..., :n, :].mT))
        old_q[..., :n, :] += torch.eye(n, dtype=dtype)
        assert torch.equal(Qb, old_q)


# -- distributed: CAQR (allgather) and TSQR (allgather, butterfly) on 4 gloo
# ranks against the reference on the virtual mesh
P = 4
CAQR_SHAPES = {"c64": (256, 48, np.complex64), "c128": (192, 32, np.complex128)}


def _dist_inputs():
    rng = np.random.default_rng(31)
    return {name: crand(rng, (m, n), dt) for name, (m, n, dt) in CAQR_SHAPES.items()} | {
        "tsqr": crand(rng, (512, 16), np.complex64)}


@pytest.fixture(scope="module")
def port_dist():
    x = _dist_inputs()
    cfg = CFG.replace(block_rows=64)
    z = x["tsqr"]
    cases = [
        ("caqr-c64", ("caqr", (x["c64"], MESH, cfg), {})),
        ("caqr-c64-cyclic", ("caqr", (x["c64"], MESH, cfg), {"layout": "cyclic"})),
        ("caqr-c128", ("caqr", (x["c128"], MESH, cfg), {"combine": "bk"})),
        ("caqr_r-c128", ("caqr_r", (x["c128"], MESH, cfg), {})),
        ("factor-bk", ("parallel.caqr:caqr_factor", (x["c64"], MESH, cfg.replace(
            dtype=torch.complex64)), {"combine": "bk"})),
        ("factor-real-dtype", ("parallel.caqr:caqr_factor", (x["c64"], MESH, cfg),
                               {"combine": "allgather"})),
        ("tsqr-allgather", ("tsqr_dist", (z, MESH, cfg), {"strategy": "allgather"})),
        ("tsqr-butterfly", ("tsqr_dist", (z, MESH, cfg), {"strategy": "butterfly"})),
        ("tsqr-cholesky", ("tsqr_dist", (z, MESH, cfg), {"strategy": "cholesky"})),
    ]
    out = run_ranks(P, call_many, [c for _, c in cases], device="cpu", join_timeout=300)[0]
    return dict(zip([name for name, _ in cases], out)), x


@pytest.fixture(scope="module")
def ref_mesh():
    return ref_row_mesh(P)


@pytest.mark.parametrize("case", ["caqr-c64", "caqr-c64-cyclic", "caqr-c128"])
def test_caqr_allgather_matches_reference(port_dist, ref_mesh, case):
    res, x = port_dist
    A = x[case.split("-")[1]]
    dtype = A.dtype.type
    Q, R = res[case]
    n = A.shape[1]
    assert Q.shape == A.shape and R.shape == (n, n) and Q.dtype == A.dtype
    gates(A, Q, R, TOL_QR[dtype])
    layout = "cyclic" if case.endswith("cyclic") else "block"
    Ad = jax.device_put(jnp.asarray(A), ref_sharding(ref_mesh))
    rQ, rR = ref_caqr(Ad, ref_mesh, RCFG, layout=layout)
    Qn, Rn = phase_normalized(Q, R)
    rQn, rRn = phase_normalized(np.asarray(rQ), np.asarray(rR))
    close(Rn, rRn, TOL_QR[dtype], np.abs(A).max())
    close(Qn, rQn, TOL_QR[dtype])


def test_caqr_r_complex128(port_dist):
    res, x = port_dist
    A = x["c128"]
    close(np.abs(np.diag(res["caqr_r-c128"])), np.abs(np.diag(np.linalg.qr(A, mode="r"))),
          TOL_QR[np.complex128], np.abs(A).max())


def test_caqr_factor_rejects(port_dist):
    res, _ = port_dist
    for case in ("factor-bk", "factor-real-dtype"):
        assert isinstance(res[case], ct.QRShapeError), res[case]
    assert "allgather" in str(res["factor-bk"])


@pytest.mark.parametrize("strategy", ["allgather", "butterfly"])
def test_tsqr_dist_matches_reference(port_dist, ref_mesh, strategy):
    res, x = port_dist
    A = x["tsqr"]
    Q, R = res[f"tsqr-{strategy}"]
    gates(A, Q, R, TOL_QR[np.complex64])
    Ad = jax.device_put(jnp.asarray(A), ref_sharding(ref_mesh))
    rQ, rR = ref_tsqr_dist(Ad, ref_mesh, RefConfig(block_rows=64, use_pallas=False),
                           strategy=strategy)
    close(np.abs(R), np.abs(np.asarray(rR)), TOL_QR[np.complex64], np.abs(A).max())
    close(Q @ R, np.asarray(rQ) @ np.asarray(rR), TOL_QR[np.complex64], np.abs(A).max())


def test_tsqr_dist_cholesky_rejects_complex(port_dist, ref_mesh):
    res, x = port_dist
    err = res["tsqr-cholesky"]
    assert isinstance(err, ValueError) and "real-only" in str(err)
    with pytest.raises(ValueError, match="real-only"):
        ref_tsqr_dist(jnp.asarray(x["tsqr"]), ref_mesh, RefConfig(block_rows=64),
                      strategy="cholesky")
