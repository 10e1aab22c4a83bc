"""The port's distributed solvers (lstsq_dist, rsvd_dist, eigh_rand_dist,
polar_dist, svd_dist) and its multi-rank dry run against the JAX reference.

The reference runs on row_mesh(P) of the conftest's 8 virtual CPU devices;
the port on P gloo ranks on the CPU (``run_ranks``), one spawn per mesh
size (P = 4 and 8) holding every case.  The randomized solvers get the
reference's own sketch (jax.random.normal with PRNGKey(12), handed over as
``omega=``), so both run one algorithm.  Tolerances (float32 inputs, eps of
float32, n the smaller dimension): x of lstsq_dist 1e-4 relative to
max|x|; singular values and eigenvalues 50 n eps max|.|; vectors through
what is unique (U diag(s) V^T, V diag(w) V^T, U H) at 50 n eps of the
matrix norm; orthogonality 50 n eps.  float64: 1e-10.

Complex input (P = 4, plus polar_dist at P = 8): complex64 shapes of the
real cases, each solver against the reference's own complex call on the
same input; the sketch of the randomized solvers is the reference's real
Gaussian cast to complex64.  Vectors are compared through what a column
phase does not change (U diag(s) V^H, V diag(w) V^H, U H); the same
tolerances as the real cases, with 1e-4 relative on x.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import cuda_qr_tpu as ref
from cuda_qr_tpu.parallel.mesh import row_mesh as ref_row_mesh
from cuda_qr_tpu.utils.config import QRConfig as RefConfig
from cuda_qr_tpu_torch import (QRShapeError, eigh_rand_dist, lstsq_dist, polar_dist,
                               rsvd_dist, svd_dist)
from cuda_qr_tpu_torch.parallel.dryrun import dryrun_multichip
from cuda_qr_tpu_torch.parallel.launch import MESH, call_many, run_ranks
from cuda_qr_tpu_torch.utils.interop import config_from_reference

EPS = float(np.finfo(np.float32).eps)
RCFG = RefConfig(dtype=jnp.float32, panel_width=8, use_pallas=False)
RCFG16 = RefConfig(dtype=jnp.float32, panel_width=16, scan_stages=2)
RCFG64 = RefConfig(dtype=jnp.float64, panel_width=16, scan_stages=2)


def port_cfg(rcfg):
    return config_from_reference(rcfg, device="cpu").replace(use_kernels=True)


def gaussian(seed, m, n, dtype=np.float32):
    return np.random.default_rng(seed).standard_normal((m, n)).astype(dtype)


def low_rank(seed, m, n, r, decay=0.6):
    rng = np.random.default_rng(seed)
    U = np.linalg.qr(rng.standard_normal((m, r)))[0]
    V = np.linalg.qr(rng.standard_normal((n, r)))[0]
    return ((U * decay ** np.arange(r)) @ V.T).astype(np.float32)


def symmetric(seed, m):
    rng = np.random.default_rng(seed)
    V = np.linalg.qr(rng.standard_normal((m, 10)))[0]
    w = np.array([8.0, -6.5, 5.0, -3.8, 2.5, -1.6, 0.9, -0.5, 0.3, -0.2])
    return ((V * w) @ V.T).astype(np.float32)


def ref_omega(shape):
    return np.array(jax.random.normal(jax.random.PRNGKey(12), shape, dtype=jnp.float32))


def to_complex(seed, X):
    """X plus an independent imaginary part of the same structure."""
    rng = np.random.default_rng(seed)
    return (X + 1j * rng.standard_normal(X.shape)).astype(np.complex64)


def complex_low_rank(seed, m, n, r, decay=0.6):
    rng = np.random.default_rng(seed)
    U = np.linalg.qr(rng.standard_normal((m, r)) + 1j * rng.standard_normal((m, r)))[0]
    V = np.linalg.qr(rng.standard_normal((n, r)) + 1j * rng.standard_normal((n, r)))[0]
    return ((U * decay ** np.arange(r)) @ V.conj().T).astype(np.complex64)


def complex_hermitian(seed, m):
    rng = np.random.default_rng(seed)
    V = np.linalg.qr(rng.standard_normal((m, 10)) + 1j * rng.standard_normal((m, 10)))[0]
    w = np.array([8.0, -6.5, 5.0, -3.8, 2.5, -1.6, 0.9, -0.5, 0.3, -0.2])
    return ((V * w) @ V.conj().T).astype(np.complex64)


# Inputs, by mesh size: the shapes of the reference's own dist tests, cut to
# multiples of P
def inputs(P):
    return {
        "lstsq": (gaussian(1, 16 * P, 24), gaussian(2, 16 * P, 3)),
        "lstsq-pad": (gaussian(3, 100, 20), gaussian(4, 100, 1)[:, 0]),
        "rsvd": low_rank(5, 40 * P, 48, 20),
        "eigh_rand": symmetric(6, 20 * P),
        "polar": gaussian(7, 32 * P, 32),
        "polar-f64": gaussian(8, 16 * P, 16, np.float64),
        "svd": gaussian(9, 32 * P, 32),
        "c-lstsq": (to_complex(10, gaussian(1, 16 * P, 24)), to_complex(11, gaussian(2, 16 * P, 3))),
        "c-rsvd": complex_low_rank(12, 40 * P, 48, 20),
        "c-eigh_rand": complex_hermitian(13, 20 * P),
        "c-polar": gaussian(7, 32 * P, 32) * (1 + 1j),
        "c-svd": to_complex(14, gaussian(9, 32 * P, 32)),
    }


def cases(P):
    x = inputs(P)
    k, p = 6, 6
    cfg, cfg16, cfg64 = port_cfg(RCFG), port_cfg(RCFG16), port_cfg(RCFG64)
    return [
        ("lstsq", ("lstsq_dist", (*x["lstsq"], MESH, cfg), {})),
        ("lstsq-allgather", ("lstsq_dist", (*x["lstsq"], MESH, cfg), {"combine": "allgather"})),
        ("lstsq-pad", ("lstsq_dist", (*x["lstsq-pad"], MESH, cfg), {})),
        ("rsvd", ("rsvd_dist", (x["rsvd"], k, MESH), {"p": p, "n_iter": 2, "config": cfg16,
                                                      "omega": ref_omega((48, k + p))})),
        ("eigh_rand", ("eigh_rand_dist", (x["eigh_rand"], k, MESH),
                       {"p": p, "n_iter": 2, "config": cfg16,
                        "omega": ref_omega((20 * P, k + p))})),
        ("polar", ("polar_dist", (x["polar"], MESH), {"config": cfg16})),
        ("polar-cholesky", ("polar_dist", (x["polar"], MESH),
                            {"config": cfg16, "strategy": "cholesky"})),
        ("polar-f64", ("polar_dist", (x["polar-f64"], MESH), {"config": cfg64})),
        ("svd", ("svd_dist", (x["svd"], MESH), {"config": cfg16})),
        ("svd-qdwh", ("svd_dist", (x["polar-f64"], MESH), {"config": cfg64,
                                                            "eigh_impl": "qdwh"})),
        ("c-polar", ("polar_dist", (x["c-polar"], MESH), {"config": cfg16})),
    ] + ([] if P != 4 else [
        ("c-lstsq", ("lstsq_dist", (*x["c-lstsq"], MESH, cfg), {})),
        ("c-rsvd", ("rsvd_dist", (x["c-rsvd"], k, MESH),
                    {"p": p, "n_iter": 2, "config": cfg16,
                     "omega": ref_omega((48, k + p)).astype(np.complex64)})),
        ("c-eigh_rand", ("eigh_rand_dist", (x["c-eigh_rand"], k, MESH),
                         {"p": p, "n_iter": 2, "config": cfg16,
                          "omega": ref_omega((20 * P, k + p)).astype(np.complex64)})),
        ("c-svd", ("svd_dist", (x["c-svd"], MESH), {"config": cfg16})),
    ])


@pytest.fixture(scope="module")
def port():
    results = {}
    for P in (4, 8):
        cs = cases(P)
        out = run_ranks(P, call_many, [c for _, c in cs], device="cpu", join_timeout=300)[0]
        results.update({(P, cid): r for (cid, _), r in zip(cs, out)})
    return results


def close(a, b, tol):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert a.shape == b.shape, (a.shape, b.shape)
    err = np.abs(a - b).max()
    assert err <= tol, err


@pytest.mark.parametrize("P", [4, 8])
@pytest.mark.parametrize("case", ["lstsq", "lstsq-allgather", "lstsq-pad"])
def test_lstsq_dist_matches_reference(port, P, case):
    A, b = inputs(P)["lstsq" if case != "lstsq-pad" else case]
    combine = "allgather" if case == "lstsq-allgather" else "bk"
    got = port[(P, case)]
    want = ref.lstsq_dist(A, b, ref_row_mesh(P), RCFG, combine=combine)
    x = np.asarray(want.x, np.float64)
    close(got.x, x, 1e-4 * np.abs(x).max())
    close(got.residual_norm, want.residual_norm, 1e-4 * np.abs(np.asarray(want.residual_norm)).max())
    assert np.shape(got.x) == np.shape(want.x) and np.shape(got.residual_norm) == np.shape(
        want.residual_norm)


@pytest.mark.parametrize("P", [4, 8])
def test_rsvd_dist_matches_reference(port, P):
    A = inputs(P)["rsvd"]
    U, s, Vt = port[(P, "rsvd")]
    rU, rs, rVt = (np.asarray(v, np.float64) for v in
                   ref.rsvd_dist(A, 6, ref_row_mesh(P), p=6, n_iter=2, config=RCFG16))
    tol = 50 * 48 * EPS
    close(s, rs, tol * rs[0])
    close((U * s) @ Vt, (rU * rs) @ rVt, tol * rs[0])
    assert np.linalg.norm(np.float64(U).T @ U - np.eye(6)) < tol


@pytest.mark.parametrize("P", [4, 8])
def test_eigh_rand_dist_matches_reference(port, P):
    A = inputs(P)["eigh_rand"]
    w, V = port[(P, "eigh_rand")]
    rw, rV = (np.asarray(v, np.float64) for v in
              ref.eigh_rand_dist(A, 6, ref_row_mesh(P), p=6, n_iter=2, config=RCFG16))
    tol = 50 * A.shape[0] * EPS
    close(w, rw, tol * np.abs(rw).max())
    close((V * w) @ np.float64(V).T, (rV * rw) @ rV.T, tol * np.abs(rw).max())
    assert np.linalg.norm(np.float64(V).T @ V - np.eye(6)) < tol


@pytest.mark.parametrize("P", [4, 8])
@pytest.mark.parametrize("case,strategy", [("polar", None), ("polar-cholesky", "cholesky"),
                                           ("polar-f64", None)])
def test_polar_dist_matches_reference(port, P, case, strategy):
    A = inputs(P)[case if case != "polar-cholesky" else "polar"]
    U, H = port[(P, case)]
    f64 = A.dtype == np.float64
    rU, rH = (np.asarray(v, np.float64) for v in
              ref.polar_dist(A, ref_row_mesh(P), config=RCFG64 if f64 else RCFG16,
                             strategy=strategy))
    n = A.shape[1]
    tol = 1e-10 if f64 else 50 * n * EPS
    close(U, rU, tol)
    close(H, rH, tol * np.abs(rH).max())
    assert np.linalg.norm(np.float64(U).T @ U - np.eye(n)) < tol * n
    close(np.float64(U) @ H, A, tol * np.abs(A).max())


@pytest.mark.parametrize("P", [4, 8])
@pytest.mark.parametrize("case", ["svd", "svd-qdwh"])
def test_svd_dist_matches_reference(port, P, case):
    A = inputs(P)["svd" if case == "svd" else "polar-f64"]
    U, s, Vh = port[(P, case)]
    f64 = case == "svd-qdwh"
    rU, rs, rVh = (np.asarray(v, np.float64) for v in
                   ref.svd_dist(A, ref_row_mesh(P), config=RCFG64 if f64 else RCFG16,
                                eigh_impl="qdwh" if f64 else "xla"))
    n = A.shape[1]
    tol = 1e-10 if f64 else 50 * n * EPS
    close(s, rs, tol * rs[0])
    close((U * s) @ Vh, (rU * rs) @ rVh, tol * rs[0])
    assert np.linalg.norm(np.float64(U).T @ U - np.eye(n)) < tol * n
    assert (np.diff(s) <= tol * rs[0]).all()


@pytest.mark.parametrize("P", [4, 8])
def test_polar_dist_complex_matches_reference(port, P):
    """QR steps throughout on the allgather combine of Householder leaves."""
    A = inputs(P)["c-polar"]
    U, H = port[(P, "c-polar")]
    rU, rH = (np.asarray(v) for v in ref.polar_dist(A, ref_row_mesh(P), config=RCFG16))
    n = A.shape[1]
    tol = 50 * n * EPS
    assert U.dtype == H.dtype == np.complex64
    close_c(U, rU, tol)
    close_c(H, rH, tol * np.abs(rH).max())
    U = np.complex128(U)
    assert np.linalg.norm(U.conj().T @ U - np.eye(n)) < tol * n
    close_c(U @ H, A, tol * np.abs(A).max())


def close_c(a, b, tol):
    a, b = np.asarray(a, np.complex128), np.asarray(b, np.complex128)
    assert a.shape == b.shape, (a.shape, b.shape)
    err = np.abs(a - b).max()
    assert err <= tol, err


@pytest.mark.parametrize("name", ["lstsq_dist", "rsvd_dist", "eigh_rand_dist", "svd_dist"])
def test_complex_dist_solvers_match_reference(port, name):
    """The complex *_dist solvers at P = 4 against the reference's."""
    P, x, k, p = 4, inputs(4), 6, 6
    mesh = ref_row_mesh(P)
    got = port[(P, "c-" + name.split("_dist")[0])]
    if name == "lstsq_dist":
        A, b = x["c-lstsq"]
        want = ref.lstsq_dist(A, b, mesh, RCFG)
        xr = np.asarray(want.x)
        assert got.x.dtype == np.complex64 and got.x.shape == xr.shape
        close_c(got.x, xr, 1e-4 * np.abs(xr).max())
        rr = np.asarray(want.residual_norm)
        close(got.residual_norm, rr, 1e-4 * np.abs(rr).max())
    elif name == "rsvd_dist":
        A = x["c-rsvd"]
        U, s, Vt = got
        rU, rs, rVt = (np.asarray(v) for v in ref.rsvd_dist(A, k, mesh, p=p, n_iter=2,
                                                              config=RCFG16))
        tol = 50 * 48 * EPS
        close(s, rs, tol * rs[0])
        close_c((U * s) @ Vt, (rU * rs) @ rVt, tol * rs[0])
        U = np.complex128(U)
        assert np.linalg.norm(U.conj().T @ U - np.eye(k)) < tol
    elif name == "eigh_rand_dist":
        A = x["c-eigh_rand"]
        w, V = got
        rw, rV = (np.asarray(v) for v in ref.eigh_rand_dist(A, k, mesh, p=p, n_iter=2,
                                                            config=RCFG16))
        tol = 50 * A.shape[0] * EPS
        close(w, rw, tol * np.abs(rw).max())
        V = np.complex128(V)
        close_c((V * w) @ V.conj().T, (rV * rw) @ rV.conj().T, tol * np.abs(rw).max())
        assert np.linalg.norm(V.conj().T @ V - np.eye(k)) < tol
    else:
        A = x["c-svd"]
        U, s, Vh = got
        rU, rs, rVh = (np.asarray(v) for v in ref.svd_dist(A, mesh, config=RCFG16))
        n = A.shape[1]
        tol = 50 * n * EPS
        close(s, rs, tol * rs[0])
        close_c((U * s) @ Vh, (rU * rs) @ rVh, tol * rs[0])
        U = np.complex128(U)
        assert np.linalg.norm(U.conj().T @ U - np.eye(n)) < tol * n
        assert (np.diff(s) <= tol * rs[0]).all()


def stand_in(P):
    """A mesh that only knows its size: enough for the checks that run
    before any collective."""
    return types.SimpleNamespace(size=lambda dim=0: P)


@pytest.mark.parametrize("call,exc", [
    (lambda: lstsq_dist(np.zeros((64, 8)), np.zeros(60), stand_in(4)), QRShapeError),
    (lambda: rsvd_dist(np.zeros((64, 8)), 9, stand_in(4)), QRShapeError),
    (lambda: rsvd_dist(np.zeros((66, 8)), 2, stand_in(4)), QRShapeError),
    (lambda: eigh_rand_dist(np.zeros((64, 60)), 2, stand_in(4)), QRShapeError),
    (lambda: eigh_rand_dist(np.zeros((66, 66)), 2, stand_in(4)), QRShapeError),
    (lambda: polar_dist(np.zeros((16, 32)), stand_in(4)), QRShapeError),
    (lambda: polar_dist(np.zeros((66, 8)), stand_in(4)), QRShapeError),
    (lambda: svd_dist(np.zeros((16, 32)), stand_in(4)), QRShapeError),
    (lambda: svd_dist(np.zeros((64, 8)), stand_in(4), eigh_impl="nope"), ValueError),
    (lambda: polar_dist(np.zeros((64, 8)), stand_in(4), strategy="tree"), ValueError),
    (lambda: polar_dist(np.zeros((48, 8)), stand_in(6), strategy="butterfly"), ValueError),
    (lambda: svd_dist(np.zeros((64, 8)), stand_in(4), strategy="tree"), ValueError),
], ids=["lstsq-rows", "rsvd-k", "rsvd-m", "eigh_rand-square", "eigh_rand-m", "polar-wide",
        "polar-m", "svd-wide", "svd-eigh_impl", "polar-strategy", "polar-butterfly-P6",
        "svd-strategy"])
def test_error_paths(call, exc):
    """The reference's exception types, before any collective."""
    with pytest.raises(exc):
        call()


def test_dryrun_multichip():
    """The dry run's checks on 4 gloo ranks, as the reference's
    dryrun_multichip runs them on its virtual mesh."""
    line = dryrun_multichip(4)
    for check in ("caqr-bk-block", "caqr-allgather-block", "caqr-bk-cyclic",
                  "ormqr-roundtrip-bk", "ormqr-roundtrip-allgather", "resume-bk-block",
                  "resume-bk-cyclic", "caqr-bk-nb32", "tsqr-butterfly",
                  "tsqr-cholqr2-leaves", "lstsq_dist ok", "polar_dist"):
        assert check in line, (check, line)
