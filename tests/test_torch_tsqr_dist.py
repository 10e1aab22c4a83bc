"""The port's distributed TSQR (parallel/tsqr_dist.py) against the JAX
reference.

The reference runs on row_mesh(P) of the conftest's 8 virtual CPU devices;
the port on P gloo ranks on the CPU (``run_ranks``), one spawn per mesh
size (P = 4 and 8) holding every case.  TSQR's R carries a sign ambiguity
at each tree node, so R is compared up to row signs and Q up to the same
column signs: float64 to 1e-10 (R relative to max|A|), float32 to 1e-4.
Every result also passes the reference's gates (residual 4 n eps,
orthogonality 8 n eps).  Error paths that raise before any collective are
checked on a stand-in mesh that only knows its size.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from cuda_qr_tpu.parallel.mesh import row_mesh as ref_row_mesh, row_sharding as ref_sharding
from cuda_qr_tpu.parallel.tsqr_dist import tsqr_dist as ref_tsqr_dist
from cuda_qr_tpu.utils.config import QRConfig as RefConfig
from cuda_qr_tpu_torch import check_qr, tsqr_dist
from cuda_qr_tpu_torch.parallel.launch import MESH, call_many, run_ranks
from cuda_qr_tpu_torch.utils.interop import config_from_reference

from torch_threads import one_thread  # noqa: F401  (autouse: one intra-op thread)

TOLS = {np.float64: 1e-10, np.float32: 1e-4}
STRATEGIES = ("allgather", "butterfly", "cholesky")
RCFG = RefConfig(block_rows=64, dtype=jnp.float64, use_pallas=False)
RCFG32 = RefConfig(block_rows=64, dtype=jnp.float32, use_pallas=False)
# (case id, reference config, dtype, m, n, strategy): each strategy in
# float64 with Householder leaves (512 x 16: 128 rows a rank at P = 4, two
# leaves), CholeskyQR2 leaves, and float32
CASES = ([(f"{s}-f64", RCFG, np.float64, 512, 16, s) for s in STRATEGIES]
         + [(f"{s}-cholqr2", RCFG.replace(tsqr_leaf="cholqr2"), np.float64, 1024, 16, s)
            for s in STRATEGIES]
         + [(f"{s}-f32", RCFG32, np.float32, 512, 32, s) for s in STRATEGIES])


def port_cfg(rcfg):
    return config_from_reference(rcfg, device="cpu").replace(use_kernels=True)


def gaussian(seed, m, n, dtype=np.float64):
    return np.random.default_rng(seed).standard_normal((m, n)).astype(dtype)


def ill_conditioned(seed, m, n, decades=7.2):
    rng = np.random.default_rng(seed)
    U = np.linalg.qr(rng.standard_normal((m, n)))[0]
    V = np.linalg.qr(rng.standard_normal((n, n)))[0]
    return ((U * np.logspace(0, -decades, n)) @ V.T).astype(np.float32)


@pytest.fixture(scope="module")
def port():
    """Every case on the port, one spawn per mesh size: {(P, id): result}."""
    results = {}
    for P in (4, 8):
        cases = [(cid, ("tsqr_dist", (gaussian(m + n, m, n, dt), MESH, port_cfg(rc), s), {}))
                 for cid, rc, dt, m, n, s in CASES]
        cases += [("ill", ("tsqr_dist", (ill_conditioned(7, 1024, 16), MESH, port_cfg(RCFG32),
                                         "cholesky"), {})),
                  ("complex", ("tsqr_dist", (gaussian(8, 64, 8) * (1 + 1j), MESH,
                                             port_cfg(RCFG), "cholesky"), {}))]
        out = run_ranks(P, call_many, [c for _, c in cases], device="cpu", join_timeout=300)[0]
        results.update({(P, cid): r for (cid, _), r in zip(cases, out)})
    return results


def signs(R):
    d = np.sign(np.diag(np.asarray(R, np.float64)))
    return np.where(d == 0, 1.0, d)


def gates(A, Q, R, n):
    chk = check_qr(A, Q, R)
    assert chk.residual < 4 * n * chk.eps, chk
    assert chk.orthogonality < 8 * n * chk.eps, chk
    assert chk.r_triangular == 0.0


@pytest.mark.parametrize("P", [4, 8])
@pytest.mark.parametrize("cid,rcfg,dt,m,n,strategy", CASES, ids=[c[0] for c in CASES])
def test_tsqr_dist_matches_reference(port, P, cid, rcfg, dt, m, n, strategy):
    A = gaussian(m + n, m, n, dt)
    Q, R = port[(P, cid)]
    mesh = ref_row_mesh(P)
    rQ, rR = ref_tsqr_dist(jax.device_put(jnp.asarray(A), ref_sharding(mesh)), mesh, rcfg,
                           strategy=strategy)
    rQ, rR = np.asarray(rQ, np.float64), np.asarray(rR, np.float64)
    gates(A, Q, R, n)
    d, rd = signs(R), signs(rR)
    tol = TOLS[dt]
    assert np.abs(R * d[:, None] - rR * rd[:, None]).max() <= tol * np.abs(A).max()
    assert np.abs(Q * d[None, :] - rQ * rd[None, :]).max() <= tol


@pytest.mark.parametrize("P", [4, 8])
def test_tsqr_dist_cholesky_fallback_ill_conditioned(port, P):
    """cond 1e7 >> 1/sqrt(eps) in float32: the cholesky strategy's guard
    trips on every rank and the stacked Householder combine takes over."""
    A = ill_conditioned(7, 1024, 16)
    Q, R = port[(P, "ill")]
    chk = check_qr(A, Q, R)
    assert chk.orthogonality < 8 * 16 * chk.eps, chk


@pytest.mark.parametrize("P", [4, 8])
def test_tsqr_dist_complex_not_ported(port, P):
    """Complex input runs "allgather" and "butterfly" (tests/test_torch_complex.py);
    the CholeskyQR2 combine is real-only, as in the reference."""
    err = port[(P, "complex")]
    assert isinstance(err, ValueError) and "real-only" in str(err), err


def stand_in(P):
    """A mesh that only knows its size: enough for the checks that run
    before any collective."""
    return types.SimpleNamespace(size=lambda dim=0: P)


@pytest.mark.parametrize("strategy,P,m,match", [
    ("butterfly", 6, 96, "power-of-two"), ("tree", 4, 96, "unknown strategy"),
    ("allgather", 4, 98, "must divide")])
def test_tsqr_dist_errors(strategy, P, m, match):
    """The reference's exception type and message for each error path."""
    with pytest.raises(ValueError, match=match):
        tsqr_dist(np.zeros((m, 8)), stand_in(P), strategy=strategy)
    if strategy == "butterfly":
        mesh = ref_row_mesh(6)
        with pytest.raises(ValueError, match=match):
            ref_tsqr_dist(jax.device_put(jnp.zeros((96, 8)), ref_sharding(mesh)), mesh,
                          RCFG, strategy=strategy)
