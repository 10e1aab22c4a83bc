"""The port's distributed CAQR (parallel/caqr.py, models/caqr.py,
parallel/caqr_resumable.py, utils/checkpoint.py) against the JAX reference.

The reference runs on row_mesh(P) of the conftest's 8 virtual CPU devices;
the port runs on P gloo ranks on the CPU (``run_ranks``), each of the two
mesh sizes (P = 4 and 8) in ONE spawn that holds every case, so that the
file costs two spawns.  Inputs come from seeded numpy generators.

Both packages run the same Householder leaves and the same combines, so Q
and R agree directly: float64 to 1e-10 (R relative to max|A|), float32 to
1e-4.  Every result also passes the reference's own gates (residual
4 n eps, orthogonality 8 n eps).  Error paths raise the reference's
exception types.  Complex CAQR is compared in tests/test_torch_complex.py;
here only its error paths.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from cuda_qr_tpu.models import caqr as ref_models
from cuda_qr_tpu.parallel import caqr as ref_caqr
from cuda_qr_tpu.parallel import caqr_resumable as ref_res
from cuda_qr_tpu.parallel.mesh import row_mesh as ref_row_mesh, row_sharding as ref_sharding
from cuda_qr_tpu.utils.config import QRConfig as RefConfig
from cuda_qr_tpu_torch import QRShapeError, check_qr
from cuda_qr_tpu_torch.parallel.caqr import _layout_fns, cyclic_permutation
from cuda_qr_tpu_torch.parallel.caqr_resumable import state_file
from cuda_qr_tpu_torch.parallel.launch import MESH, call_many, run_ranks
from cuda_qr_tpu_torch.utils.checkpoint import load_state, save_state
from cuda_qr_tpu_torch.utils.interop import config_from_reference

TOLS = {np.float64: 1e-10, np.float32: 1e-4}
RCFG = RefConfig(panel_width=8, dtype=jnp.float64, use_pallas=False)
RCFG32 = RefConfig(panel_width=8, dtype=jnp.float32, use_pallas=False)
RCFG32_16 = RefConfig(panel_width=16, dtype=jnp.float32, use_pallas=False)


def port_cfg(rcfg):
    """The port's counterpart on the CPU, kernel wrappers on (they take the
    plain versions for CPU tensors)."""
    return config_from_reference(rcfg, device="cpu").replace(use_kernels=True)


def gaussian(seed, m, n, dtype=np.float64):
    return np.random.default_rng(seed).standard_normal((m, n)).astype(dtype)


def ill_conditioned(seed, m, n, decades=7.2):
    rng = np.random.default_rng(seed)
    U = np.linalg.qr(rng.standard_normal((m, n)))[0]
    V = np.linalg.qr(rng.standard_normal((n, n)))[0]
    return ((U * np.logspace(0, -decades, n)) @ V.T).astype(np.float32)


def rank_deficient(seed):
    A = gaussian(seed, 128, 32, np.float32)
    A[:, 3] = A[:, 2]   # exactly dependent columns within a panel
    return A


COMBINES = ("bk", "allgather")
LAYOUTS = ("block", "cyclic")
# (P, combine, layout, m, n): every combine and layout at each mesh size,
# over three shapes (two panel rows a rank; square, whose last panels live
# on the last rank only; one that needs padding), the full A on every rank
CAQR = [(4, "bk", "block", 128, 64), (4, "bk", "cyclic", 64, 64),
        (4, "allgather", "block", 200, 50), (4, "allgather", "cyclic", 128, 64),
        (8, "bk", "block", 128, 128), (8, "bk", "cyclic", 200, 50),
        (8, "allgather", "block", 128, 64), (8, "allgather", "cyclic", 128, 128)]
# (P, combine, layout, m, n) handed to the port as a row-sharded DTensor:
# uneven shards with padding, even ones that pad only columns or only
# change layout
SHARDED = [(4, "bk", "cyclic", 202, 50), (8, "allgather", "block", 130, 40),
           (4, "bk", "block", 128, 60), (8, "bk", "cyclic", 128, 64)]
# (P, combine, layout) of the reference's factors carried across
CARRIED = [(4, "bk", "block"), (4, "allgather", "cyclic"),
           (8, "bk", "cyclic"), (8, "allgather", "block")]


def caqr_cases(P):
    """(case id, port call) of the caqr cases at mesh size P."""
    cases = []
    for P_, combine, layout, m, n in CAQR:
        if P_ == P:
            cases.append((f"caqr-{combine}-{layout}-{m}x{n}",
                           ("caqr", (gaussian(m + n, m, n), MESH, port_cfg(RCFG), layout,
                                     combine), {})))
    for P_, combine, layout, m, n in SHARDED:
        if P_ == P:
            cases.append((f"sharded-{combine}-{layout}-{m}x{n}",
                           ("parallel.dryrun:caqr_sharded",
                            (MESH, gaussian(m + n, m, n), port_cfg(RCFG), layout, combine), {})))
    if P == 4:
        cases.append(("caqr-f32", ("caqr", (gaussian(3, 256, 128, np.float32), MESH,
                                            port_cfg(RCFG32_16)), {})))
    else:
        cases.append(("caqr_r", ("caqr_r", (gaussian(4, 128, 64), MESH, port_cfg(RCFG)), {})))
    cases.append(("ill", ("caqr", (ill_conditioned(5, 128, 32), MESH, port_cfg(RCFG32)), {})))
    cases.append(("deficient", ("caqr", (rank_deficient(6), MESH, port_cfg(RCFG32)), {})))
    return cases


def storage(A, layout, P, nb=8):
    return A[cyclic_permutation(A.shape[0], nb, P)[0]] if layout == "cyclic" else A


def ormqr_cases(P, carried_fields):
    cases = []
    for combine in COMBINES:
        for layout in LAYOUTS:
            A = storage(gaussian(21, 8 * 16, 32, np.float32), layout, P)
            B = storage(gaussian(22, 8 * 16, 5, np.float32), layout, P)
            cases.append((f"roundtrip-{combine}-{layout}",
                          ("parallel.dryrun:ormqr_roundtrip",
                           (MESH, A, B, port_cfg(RCFG32), layout, combine), {})))
            if (P, combine, layout) in carried_fields:
                fields, Bc = carried_fields[(P, combine, layout)]
                cases.append((f"carried-{combine}-{layout}",
                              ("parallel.dryrun:carried",
                               (MESH, fields, Bc, 32, port_cfg(RCFG), layout), {})))
    return cases


def resumable_cases(P, tmp):
    cfg = port_cfg(RCFG)
    cases = []
    for combine in COMBINES:
        A = gaussian(31, 128, 64)
        cases.append((f"resumable-{combine}",
                      ("parallel.caqr_resumable:caqr_factor_resumable",
                       (A, MESH, cfg), {"combine": combine})))
        for layout in LAYOUTS:
            cases.append((f"crash-{combine}-{layout}",
                          ("parallel.dryrun:crash_and_resume",
                           (MESH, storage(A, layout, P), cfg, layout, combine, 5, 2,
                            str(tmp / f"ck-{P}-{combine}-{layout}")), {})))
    mismatched = tmp / f"mismatched-{P}"
    for r in range(P):
        save_state(state_file(str(mismatched), r, 1), {"A": np.zeros((1, 1))},
                   {"next_panel": 1, "m": 999, "n": 64, "nb": 8, "layout": "block", "P": P})
    cases.append(("mismatched", ("parallel.caqr_resumable:caqr_factor_resumable",
                                 (gaussian(32, 128, 64), MESH, cfg),
                                 {"checkpoint_path": str(mismatched)})))
    return cases


def error_cases():
    cfg = port_cfg(RCFG)
    A = gaussian(41, 64, 16)
    return [
        ("err-combine", ("parallel.caqr:caqr_factor", (A, MESH, cfg), {"combine": "tree"})),
        ("err-layout", ("parallel.caqr:caqr_factor", (A, MESH, cfg), {"layout": "2d"})),
        ("err-shape", ("parallel.caqr:caqr_factor", (gaussian(42, 68, 16), MESH, cfg), {})),
        ("err-wide", ("caqr", (gaussian(43, 16, 32), MESH, cfg), {})),
        ("lstsq-complex", ("lstsq_dist", (A + 1j * A, A[:, 0], MESH, cfg), {})),
        ("err-complex-factor", ("parallel.caqr:caqr_factor",
                                (np.ones((64, 16), np.complex64), MESH, cfg), {})),
    ]


@pytest.fixture(scope="module")
def ref_meshes():
    return {P: ref_row_mesh(P) for P in (4, 8)}


@pytest.fixture(scope="module")
def carried_fields(ref_meshes):
    """The reference's own factors of each combine and layout, as numpy,
    with the B they are applied to."""
    out = {}
    for P, combine, layout in CARRIED:
        mesh = ref_meshes[P]
        A = storage(gaussian(23, 8 * 16, 32), layout, P)
        Ad = jax.device_put(jnp.asarray(A), ref_sharding(mesh))
        fac, _ = ref_caqr.caqr_factor(Ad, mesh, RCFG, layout=layout, combine=combine)
        fields = {k: np.asarray(v) for k, v in fac._asdict().items()}
        out[(P, combine, layout)] = (fields, gaussian(24, 8 * 16, 5))
    return out


@pytest.fixture(scope="module")
def port(carried_fields, tmp_path_factory):
    """Every case of this file on the port, one spawn per mesh size:
    {(P, case id): result}."""
    tmp = tmp_path_factory.mktemp("caqr")
    results = {}
    for P in (4, 8):
        cases = (caqr_cases(P) + ormqr_cases(P, carried_fields) + resumable_cases(P, tmp)
                 + error_cases())
        out = run_ranks(P, call_many, [call for _, call in cases], device="cpu", join_timeout=300)[0]
        results.update({(P, cid): res for (cid, _), res in zip(cases, out)})
    return results


def close(a, b, tol, scale=1.0):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert a.shape == b.shape, (a.shape, b.shape)
    err = np.abs(a - b).max()
    assert err <= tol * scale, err


def gates(A, Q, R, n, orth=8):
    chk = check_qr(A, Q, R)
    assert chk.residual < 4 * max(n, 16) * chk.eps, chk
    assert chk.orthogonality < orth * max(n, 16) * chk.eps, chk
    assert chk.r_triangular == 0.0


@pytest.mark.parametrize("P,combine,layout,m,n", CAQR)
def test_caqr_matches_reference(port, ref_meshes, P, combine, layout, m, n):
    A = gaussian(m + n, m, n)
    Q, R = port[(P, f"caqr-{combine}-{layout}-{m}x{n}")]
    rQ, rR = ref_models.caqr(jnp.asarray(A), ref_meshes[P], RCFG, layout=layout, combine=combine)
    gates(A, Q, R, n)
    close(Q, rQ, TOLS[np.float64])
    close(R, rR, TOLS[np.float64], np.abs(A).max())


@pytest.mark.parametrize("P,combine,layout,m,n", SHARDED)
def test_caqr_sharded_input_matches_reference(port, ref_meshes, P, combine, layout, m, n):
    """A row-sharded DTensor in, rows moved to the padded storage layout
    and Q moved back by all-to-all: the same Q and R as the reference."""
    A = gaussian(m + n, m, n)
    Q, R = port[(P, f"sharded-{combine}-{layout}-{m}x{n}")]
    rQ, rR = ref_models.caqr(jnp.asarray(A), ref_meshes[P], RCFG, layout=layout, combine=combine)
    gates(A, Q, R, n)
    close(Q, rQ, TOLS[np.float64])
    close(R, rR, TOLS[np.float64], np.abs(A).max())


@pytest.mark.parametrize("P", [4])
def test_caqr_f32_matches_reference(port, ref_meshes, P):
    A = gaussian(3, 256, 128, np.float32)
    Q, R = port[(P, "caqr-f32")]
    rQ, rR = ref_models.caqr(jnp.asarray(A), ref_meshes[P], RCFG32_16)
    gates(A, Q, R, 128)
    close(Q, rQ, TOLS[np.float32])
    close(R, rR, TOLS[np.float32], np.abs(A).max())


@pytest.mark.parametrize("P", [8])
def test_caqr_r_matches_reference(port, ref_meshes, P):
    A = gaussian(4, 128, 64)
    rR = ref_models.caqr_r(jnp.asarray(A), ref_meshes[P], RCFG)
    close(port[(P, "caqr_r")], rR, TOLS[np.float64], np.abs(A).max())


@pytest.mark.parametrize("P", [4, 8])
def test_caqr_bk_ill_conditioned_falls_back(port, P):
    """cond 1e7 in float32: the bk combine's CholeskyQR2 must break down on
    some panel and take the stacked Householder QR on every rank."""
    A = ill_conditioned(5, 128, 32)
    Q, R = port[(P, "ill")]
    gates(A, Q, R, 32)


@pytest.mark.parametrize("P", [4, 8])
def test_caqr_bk_rank_deficient(port, P):
    A = rank_deficient(6)
    Q, R = port[(P, "deficient")]
    assert np.all(np.isfinite(Q))
    assert np.linalg.norm(np.float64(Q) @ np.float64(R) - A) < 1e-4 * np.linalg.norm(A)


@pytest.mark.parametrize("P", [4, 8])
@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("combine", COMBINES)
def test_caqr_ormqr_roundtrip(port, P, combine, layout):
    """On the port's own factors: R passes the gates with the explicit Q,
    the n coefficient rows of Q^T B (at the storage rows of R's rows) equal
    Q^T B by the explicit Q, and Q (Q^T B) gives B back.  (The reference's
    Q operator is compared on its own factors below.)"""
    n = 32
    A = storage(gaussian(21, 8 * 16, n, np.float32), layout, P)
    B = storage(gaussian(22, 8 * 16, 5, np.float32), layout, P)
    R, Q, QtB, back = port[(P, f"roundtrip-{combine}-{layout}")]
    inv = cyclic_permutation(8 * 16, 8, P)[1] if layout == "cyclic" else np.arange(8 * 16)
    gates(A[inv], Q[inv], R, n)
    close(QtB[inv[:n]], np.float64(Q).T @ B, TOLS[np.float32], n)
    close(back, B, TOLS[np.float32], n)


@pytest.mark.parametrize("P,combine,layout", CARRIED)
def test_carried_factors_match_reference(port, ref_meshes, carried_fields, P, combine, layout):
    """caqr_orgqr and caqr_ormqr of the port applied to the reference's own
    factors give the reference's Q, Q^T B and Q B."""
    Q, QtB, QB = port[(P, f"carried-{combine}-{layout}")]
    fields, B = carried_fields[(P, combine, layout)]
    mesh = ref_meshes[P]
    fac = (ref_caqr.CAQRFactorsBK if combine == "bk" else ref_caqr.CAQRFactors)(
        **{k: jnp.asarray(v) for k, v in fields.items()})
    Bd = jax.device_put(jnp.asarray(B), ref_sharding(mesh))
    close(Q, ref_caqr.caqr_orgqr(fac, mesh, 32, RCFG, layout=layout), TOLS[np.float64])
    for transpose, got in ((True, QtB), (False, QB)):
        want = ref_caqr.caqr_ormqr(fac, Bd, mesh, RCFG, layout=layout, transpose=transpose)
        close(got, want, TOLS[np.float64], np.abs(B).max())


def live(P, m, n, nb=8, layout="block"):
    """(P, k) mask of the (rank, panel) pairs whose leaf is live."""
    _, offset = _layout_fns(layout, nb, m // P, P)
    return np.array([[offset(i, kk) < m // P for kk in range(n // nb)] for i in range(P)])


@pytest.mark.parametrize("P,combine", [(4, "bk"), (4, "allgather"), (8, "bk")])
def test_resumable_matches_reference(port, ref_meshes, P, combine):
    """Every factor field of the resumable driver matches the reference's
    resumable driver on the same input.  A dead rank's leaf tau and T are
    zeros in the port; the reference's masked geqr2 leaves 2 there, beside
    V = 0 (the operator is I either way), so those entries are not compared."""
    A = gaussian(31, 128, 64)
    fac, R = port[(P, f"resumable-{combine}")]
    mesh = ref_meshes[P]
    Ad = jax.device_put(jnp.asarray(A), ref_sharding(mesh))
    rfac, rR = ref_res.caqr_factor_resumable(Ad, mesh, RCFG, combine=combine)
    close(R, rR, TOLS[np.float64], np.abs(A).max())
    alive = live(P, 128, 64)
    for name, got, want in zip(rfac._fields, fac, rfac):
        want = np.asarray(want)
        if name in ("local_taus", "local_Ts"):
            assert not np.any(got[~alive]), name
            got, want = got[alive], want[alive]
        close(got, want, TOLS[np.float64], max(1.0, np.abs(want).max()))


@pytest.mark.parametrize("P", [4, 8])
@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("combine", COMBINES)
def test_crash_and_resume(port, P, combine, layout):
    """A crash after 5 panels (snapshots every 2) leaves partial progress;
    the rerun resumes and ends with the monolithic factorization's factors."""
    snapshots, files, (fac, R), (fac_m, R_m) = port[(P, f"crash-{combine}-{layout}")]
    assert snapshots and 0 < snapshots[-1] < 64 // 8 and snapshots[-1] % 2 == 0
    assert len(files) == 5            # one file per finished panel, this rank's
    close(R, R_m, TOLS[np.float64])
    for got, want in zip(fac, fac_m):
        close(got, want, TOLS[np.float64])


@pytest.mark.parametrize("P", [4, 8])
def test_resume_rejects_mismatched_problem(port, P):
    err = port[(P, "mismatched")]
    assert isinstance(err, ValueError) and "does not match" in str(err)


@pytest.mark.parametrize("P", [4, 8])
@pytest.mark.parametrize("case,exc", [("err-combine", ValueError), ("err-layout", ValueError),
                                      ("err-shape", QRShapeError), ("err-wide", QRShapeError),
                                      ("err-complex-factor", QRShapeError)])
def test_error_paths(port, ref_meshes, P, case, exc):
    """The reference's exception types: complex caqr_factor needs the
    allgather combine (QRShapeError)."""
    assert isinstance(port[(P, case)], exc), port[(P, case)]
    if case in ("err-combine", "err-shape"):
        A = gaussian(41, 64, 16) if case == "err-combine" else gaussian(42, 68, 16)
        with pytest.raises(ValueError):
            ref_caqr.caqr_factor(jnp.asarray(A), ref_meshes[P], RCFG,
                                 **({"combine": "tree"} if case == "err-combine" else {}))


@pytest.mark.parametrize("P", [4, 8])
def test_lstsq_dist_complex_matches_reference(port, ref_meshes, P):
    """complex128 [A | b] through caqr_r's allgather combine: x = e_0 / (1 + i)
    exactly, and the reference's x, at float64's 1e-10."""
    A = gaussian(41, 64, 16)
    got = port[(P, "lstsq-complex")]
    want = ref_models_lstsq_dist(A + 1j * A, A[:, 0], ref_meshes[P])
    x = np.asarray(got.x)
    assert x.dtype == np.complex128 and x.shape == (16,)
    assert np.abs(x - np.asarray(want.x)).max() <= TOLS[np.float64]
    assert np.abs(x - np.eye(16)[0] / (1 + 1j)).max() <= TOLS[np.float64]
    close(got.residual_norm, np.asarray(want.residual_norm), TOLS[np.float64])


def ref_models_lstsq_dist(A, b, mesh):
    from cuda_qr_tpu.models.lstsq import lstsq_dist
    return lstsq_dist(jnp.asarray(A), jnp.asarray(b), mesh, RCFG)


def test_checkpoint_roundtrip(tmp_path):
    p = str(tmp_path / "ck.npz")
    save_state(p, {"x": np.arange(6.0).reshape(2, 3), "y": np.ones(4)},
               {"next_panel": 3, "tag": "t"})
    s, meta = load_state(p)
    assert meta["next_panel"] == 3
    np.testing.assert_array_equal(s["x"], np.arange(6.0).reshape(2, 3))
    assert load_state(str(tmp_path / "missing.npz")) == (None, None)
