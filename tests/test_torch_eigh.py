"""The symmetric eigensolver of the port (models/eigh.py) against the JAX
reference and numpy float64 LAPACK, on the spectra of tests/test_eigh.py.

Every result passes that file's ``_check`` (residual and orthogonality below
tol n, eigenvalues within tol n max(|w|, 1) of LAPACK's, ascending).  Against
the reference the eigenvalues agree within 50 n eps max|w|; eigenvectors are
compared through residual and orthogonality only (signs and the bases of
clusters are free), and neither may exceed 1.1 x the reference's on the same
input: the Jacobi alone, the divide and conquer, the batched Jacobi.  The
pair schedules are host tables and must be equal.  A divide-and-conquer
call of the reference compiles for most of a minute on the CPU, so it is
called four times in all, from one module-scoped fixture (Gaussian float32
and float64, the clustered spectrum, the odd size, whose pad coordinate goes
through the divide and conquer); the near-identity input, done at the root,
is held to LAPACK alone.  The Jacobi's rotation itself is held to c^2 + s^2
- 1 with no one-sided bias, without JAX.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cuda_qr_tpu.models import eigh as re_
from cuda_qr_tpu.models import polar as rp
from cuda_qr_tpu.utils.config import QRConfig as RefConfig
from cuda_qr_tpu_torch import QRShapeError, eigh, eigh_batched, svd
from cuda_qr_tpu_torch.models import eigh as pe
from cuda_qr_tpu_torch.ops import smalllinalg
from cuda_qr_tpu_torch.utils.interop import config_from_reference

from torch_threads import one_thread  # noqa: F401  (autouse: one intra-op thread)

RCFG = RefConfig(dtype=jnp.float32, panel_width=16, scan_stages=2)
CFG = config_from_reference(RCFG, device="cpu")
RCFG64 = RefConfig(dtype=jnp.float64, panel_width=16, scan_stages=2)
CFG64 = config_from_reference(RCFG64, device="cpu")


def check(A, w, V, tol):
    """tests/test_eigh.py:_check."""
    A64 = np.asarray(A, np.float64)
    V = np.asarray(V, np.float64)
    w = np.asarray(w, np.float64)
    n = A.shape[0]
    resid = np.linalg.norm(A64 @ V - V * w[None, :]) / max(np.linalg.norm(A64), 1e-30)
    orth = np.linalg.norm(V.T @ V - np.eye(n))
    assert resid < tol * n, f"resid {resid:.2e}"
    assert orth < tol * n, f"orth {orth:.2e}"
    w_ref = np.linalg.eigvalsh(A64)
    assert (np.diff(w) >= -tol * np.abs(w).max()).all()
    assert np.abs(np.sort(w) - w_ref).max() < tol * n * max(np.abs(w_ref).max(), 1.0)


def accuracy(A, w, V):
    """(||V^H V - I||_F, ||A V - V diag(w)||_F / ||A||_F) in complex128."""
    A, V = (np.asarray(x, np.complex128) for x in (A, V))
    w = np.asarray(w, np.float64)
    return (np.linalg.norm(V.conj().T @ V - np.eye(V.shape[1])),
            np.linalg.norm(A @ V - V * w[None, :]) / np.linalg.norm(A))


def as_accurate(A, w, V, wr, Vr, factor=1.1):
    """The port's orthogonality and residual are at most ``factor`` x the
    reference's on the same input."""
    (orth, res), (orth_r, res_r) = accuracy(A, w, V), accuracy(A, wr, Vr)
    assert orth <= factor * orth_r, f"orthogonality {orth:.3e} > {factor} x {orth_r:.3e}"
    assert res <= factor * res_r, f"residual {res:.3e} > {factor} x {res_r:.3e}"


def rotation_defect(c, s):
    """c^2 + s^2 - 1 in float64 with each square split into its rounded value
    and its exact error (Dekker's product): exact far below float64's eps."""
    def square(a):
        p = a * a
        t = 134217729.0 * a                      # 2^27 + 1
        hi = t - (t - a)
        lo = a - hi
        return p, ((hi * hi - p) + 2.0 * hi * lo) + lo * lo
    (p1, e1), (p2, e2) = square(np.asarray(c, np.float64)), square(np.asarray(s, np.float64))
    return ((p1 - 1.0) + p2) + (e1 + e2)


def sym(rng, n, dtype):
    A = rng.standard_normal((n, n)).astype(dtype)
    return (A + A.T) / 2


def clustered(rng):
    """Repeated eigenvalues plus a tight cluster (tests/test_eigh.py:96-106)."""
    w_true = np.concatenate([np.full(20, 1.0), np.full(20, 1.0 + 3e-3), np.linspace(2, 5, 24)])
    Q, _ = np.linalg.qr(rng.standard_normal((64, 64)))
    A = (Q * w_true) @ Q.T
    return ((A + A.T) / 2).astype(np.float32)


def near_identity(rng):
    A = np.eye(48, dtype=np.float32) * 3.0
    return A + 1e-7 * sym(rng, 48, np.float32)


# name: (matrix, config pair, base_n, bucket, _check's tol)
def _cases():
    rng = np.random.default_rng(12)
    return {
        "gaussian_f32": (sym(rng, 96, np.float32), (CFG, RCFG), 32, 16, 1e-5),
        "gaussian_f64": (sym(rng, 80, np.float64), (CFG64, RCFG64), 32, 16, 1e-12),
        "clustered": (clustered(rng), (CFG, RCFG), 32, 16, 2e-5),
        "odd_n": (sym(rng, 45, np.float32), (CFG, RCFG), 16, 16, 1e-5),
        "near_identity": (near_identity(rng), (CFG, RCFG), 32, 16, 1e-5),
    }


CASES = _cases()
WITH_REFERENCE = ("gaussian_f32", "gaussian_f64", "clustered", "odd_n")


@pytest.fixture(scope="module")
def reference_w():
    """The reference's (w, V): its four divide-and-conquer calls."""
    out = {}
    for name in WITH_REFERENCE:
        A, (_, rcfg), base_n, bucket, _ = CASES[name]
        w, V = re_.eigh(A, rcfg, base_n=base_n, bucket=bucket)
        out[name] = np.asarray(w, np.float64), np.asarray(V)
    return out


@pytest.mark.parametrize("n", [4, 8, 14, 32])
def test_pair_schedules_equal_reference(n):
    s = pe._round_robin(n)
    assert s.shape == (n - 1, n // 2, 2) and np.array_equal(s, re_._round_robin(n))
    c = pe._rr_pairs(n)
    for r in range(n - 1):
        p, q = re_._rr_pairs(r, n)
        assert np.array_equal(c[r, :, 0], np.asarray(p)) and np.array_equal(c[r, :, 1], np.asarray(q))
    assert len(set(map(tuple, c.reshape(-1, 2)))) == n * (n - 1) // 2   # every pair once
    assert all(len(set(rnd.reshape(-1).tolist())) == n for rnd in c)    # perfect matchings


@pytest.mark.parametrize("n,dtype,tol", [(48, np.float32, 5e-6), (32, np.float64, 1e-13)])
def test_jacobi_matches_reference(rng, n, dtype, tol):
    A = sym(rng, n, dtype)
    sched = pe._round_robin(n)
    w, V = pe._jacobi_eigh(torch.from_numpy(A), torch.from_numpy(sched.astype(np.int64)))
    wr, _ = re_._jacobi_eigh(jnp.asarray(A), jnp.asarray(sched))
    check(A, w, V, tol)
    eps = float(np.finfo(dtype).eps)
    assert np.abs(w.numpy() - np.asarray(wr)).max() < 50 * n * eps * np.abs(wr).max()


@pytest.mark.parametrize("n,dtype", [(48, np.float32), (96, np.float32), (128, np.float64)])
def test_jacobi_as_accurate_as_reference(n, dtype):
    """Same matrix, same pair table: orthogonality and residual at most 1.1 x
    the reference's (a rotation with c^2 + s^2 - 1 biased by +eps/2 read
    1.5-2.5 x)."""
    A = sym(np.random.default_rng(12), n, dtype)
    sched = pe._round_robin(n)
    w, V = pe._jacobi_eigh(torch.from_numpy(A), torch.from_numpy(sched.astype(np.int64)))
    wr, Vr = re_._jacobi_eigh(jnp.asarray(A), jnp.asarray(sched))
    as_accurate(A, w.numpy(), V.numpy(), np.asarray(wr), np.asarray(Vr))


@pytest.mark.parametrize("dtype", [np.float32, np.float64, np.complex64, np.complex128])
def test_jacobi_rotation_has_no_one_sided_bias(dtype):
    """One Jacobi round on 100,000 2x2 blocks [[0, e], [conj(e), 2 tau]],
    |e| = 1, is one rotation each, V = J: mean (c^2 + s^2 - 1) / eps within
    +-0.1 at |tau| in a decade around 1, 1e3 and 1e5 (1/sqrt(1 + t^2) reads
    +0.5 in float32 at 1e3 and in float64 at 1e5)."""
    rng = np.random.default_rng(12)
    L = 100_000
    eps = float(np.finfo(dtype).eps)
    sched = torch.zeros(1, 1, 2, dtype=torch.int64)
    sched[0, 0, 1] = 1
    for scale in (1.0, 1e3, 1e5):
        tau = rng.choice([-1.0, 1.0], L) * scale * 10.0 ** rng.uniform(-0.5, 0.5, L)
        e = np.exp(1j * rng.uniform(0, 2 * np.pi, L)) if np.iscomplexobj(dtype(0)) else 1.0
        A = np.zeros((L, 2, 2), np.complex128)
        A[:, 0, 1], A[:, 1, 0], A[:, 1, 1] = e, np.conj(e), 2.0 * tau
        A = A.astype(dtype) if np.iscomplexobj(dtype(0)) else A.real.astype(dtype)
        _, V = pe._jacobi_eigh(torch.from_numpy(A), sched, max_sweeps=1, sort=False)
        V = V.numpy()
        d = rotation_defect(V[:, 0, 0].real, V[:, 0, 1].real) / eps
        assert abs(d.mean()) <= 0.1, f"|tau| ~ {scale:g}: mean {d.mean():+.4f} eps"


def test_jacobi_stack_freezes_converged_matrices(rng):
    """A matrix's result does not depend on its neighbours: alone, beside a
    matrix that needs more sweeps, or beside one that needs none."""
    n = 16
    sched = torch.from_numpy(pe._rr_pairs(n).astype(np.int64))
    A = torch.from_numpy(sym(rng, n, np.float32))
    hard = torch.from_numpy(clustered(rng)[:n, :n].copy())
    done = torch.diag(torch.arange(n, dtype=torch.float32))
    w0, V0 = pe._jacobi_eigh(A, sched, sort=False)
    for other in (hard, done, torch.zeros(n, n)):
        ws, Vs = pe._jacobi_eigh(torch.stack([other, A]), sched, sort=False)
        assert torch.equal(ws[1], w0) and torch.equal(Vs[1], V0)
    ws, Vs = pe._jacobi_eigh(torch.stack([done, A]), sched, sort=False)
    assert torch.equal(ws[0], torch.diagonal(done)) and torch.equal(Vs[0], torch.eye(n))


@pytest.mark.parametrize("name", list(CASES))
def test_eigh_spectra(name, reference_w):
    A, (cfg, _), base_n, bucket, tol = CASES[name]
    smalllinalg.host_syncs = 0
    w, V = eigh(A, cfg, base_n=base_n, bucket=bucket)
    n = A.shape[0]
    assert tuple(w.shape) == (n,) and tuple(V.shape) == (n, n)
    assert w.dtype == V.dtype == (torch.float64 if A.dtype == np.float64 else torch.float32)
    check(A, w.numpy(), V.numpy(), tol)
    st = pe.last_stats
    assert smalllinalg.host_syncs > 0
    if name == "near_identity":                 # one cluster: done at the root
        assert st["diag_exits"] == 1 and st["leaves"] == st["jacobi_calls"] == 0
        assert np.abs(w.numpy() - 3.0).max() < 1e-5
    else:
        assert st["split_nodes"] >= 1 and st["leaves"] >= 2
        assert st["jacobi_calls"] == 1 + st["fallbacks"]   # one batched leaf solve
    if name in reference_w:
        eps = float(np.finfo(A.dtype).eps)
        wr, _ = reference_w[name]
        assert np.abs(w.numpy() - wr).max() < 50 * n * eps * max(np.abs(wr).max(), 1.0)


@pytest.mark.parametrize("name", WITH_REFERENCE)
def test_eigh_as_accurate_as_reference(name, reference_w):
    """The divide and conquer's orthogonality and residual at most 1.1 x the
    reference's on the same input (its V from the module's fixture)."""
    A, (cfg, _), base_n, bucket, _ = CASES[name]
    w, V = eigh(A, cfg, base_n=base_n, bucket=bucket)
    as_accurate(A, w.numpy(), V.numpy(), *reference_w[name])


def test_pair_table_cache_keeps_small_sizes_only():
    """Leaf-size tables are kept between calls; a whole-node table (the
    Jacobi fallback) is built for its one use."""
    a = pe._schedule("circle", 16, "cpu")
    assert pe._schedule("circle", 16, "cpu") is a
    held = pe._schedule_cached.cache_info().currsize
    n = pe._SCHEDULE_CACHE_MAX_N + 2
    big = pe._schedule("circle", n, "cpu")
    assert tuple(big.shape) == (n - 1, n // 2, 2) and big.dtype == torch.int64
    assert np.array_equal(big.numpy(), pe._rr_pairs(n))
    assert pe._schedule_cached.cache_info().currsize == held


def test_eigh_direct_path_matches_reference(rng):
    """n <= base_n: Jacobi on the same sentinel-padded matrix with the same
    pair schedule as the reference, so the eigenvectors agree up to sign."""
    A = sym(rng, 24, np.float32)
    w, V = eigh(A, CFG, base_n=32, bucket=16)
    wr, Vr = re_.eigh(A, RCFG, base_n=32, bucket=16)
    check(A, w.numpy(), V.numpy(), 5e-6)
    assert pe.last_stats["leaves"] == 0 and pe.last_stats["jacobi_calls"] == 1
    assert np.abs(w.numpy() - np.asarray(wr)).max() < 50 * 24 * 1.2e-7 * np.abs(wr).max()
    overlap = np.abs(V.numpy().T.astype(np.float64) @ np.asarray(Vr, np.float64))
    assert np.abs(overlap - np.eye(24)).max() < 1e-3


def test_eigh_diagonal_input_exits_at_the_root():
    d = np.linspace(-3, 7, 40).astype(np.float32)[::-1].copy()
    w, V = eigh(np.diag(d), CFG, base_n=16)
    assert pe.last_stats["diag_exits"] == 1 and pe.last_stats["split_nodes"] == 0
    assert np.array_equal(w.numpy(), np.sort(d))
    check(np.diag(d), w.numpy(), V.numpy(), 1e-6)


def test_eigh_jacobi_fallback_when_nothing_splits(rng, monkeypatch):
    """No sigma candidate splits: Jacobi solves the node whole (odd size:
    one decoupled pad coordinate)."""
    monkeypatch.setattr(pe, "_split_node", lambda H, config: None)
    A = sym(rng, 37, np.float32)
    w, V = eigh(A, CFG, base_n=16)
    assert pe.last_stats["fallbacks"] == 1 and pe.last_stats["leaves"] == 0
    check(A, w.numpy(), V.numpy(), 5e-6)


def test_split_node_splits_at_the_median(rng):
    A = torch.from_numpy(sym(rng, 40, np.float64))
    V_minus, V_plus, k = pe._split_node(A, CFG64)
    assert 0 < k < 40 and V_minus.shape == (40, k) and V_plus.shape == (40, 40 - k)
    Q = torch.cat([V_minus, V_plus], 1)
    assert torch.linalg.norm(Q.T @ Q - torch.eye(40, dtype=torch.float64)) < 1e-12
    assert torch.linalg.norm(V_plus.T @ A @ V_minus) < 1e-12 * torch.linalg.norm(A)
    lo = torch.linalg.eigvalsh(V_minus.T @ A @ V_minus)
    hi = torch.linalg.eigvalsh(V_plus.T @ A @ V_plus)
    assert lo.max() < hi.min()


def test_eigh_errors():
    with pytest.raises(QRShapeError):
        eigh(np.zeros((3, 4), np.float32), CFG)
    with pytest.raises(QRShapeError):
        eigh(np.zeros(4, np.float32), CFG)
    # complex Hermitian input (tests/test_torch_complex_spectral.py)
    Hc = np.array([[2, 1j, 0, 0], [-1j, 2, 0, 0], [0, 0, 5, 1 - 1j], [0, 0, 1 + 1j, 3]],
                  np.complex64)
    w, V = eigh(Hc, CFG)
    wr = np.asarray(re_.eigh(jnp.asarray(Hc), RCFG)[0])
    assert w.dtype == torch.float32 and V.dtype == torch.complex64
    np.testing.assert_allclose(w.numpy(), wr, rtol=0, atol=1e-5)
    np.testing.assert_allclose(w.numpy(), np.linalg.eigvalsh(Hc.astype(np.complex128)), atol=1e-5)
    Vn = V.numpy().astype(np.complex128)
    assert np.abs(Hc @ Vn - Vn * w.numpy()).max() < 1e-5 * 6
    with pytest.raises(QRShapeError):
        eigh_batched(np.zeros((2, 3, 4), np.float32), config=CFG)
    with pytest.raises(QRShapeError):
        eigh_batched(np.zeros((3, 3), np.float32), config=CFG)


def batched_stack(rng, B, n):
    As = rng.standard_normal((B, n, n)).astype(np.float32)
    return (As + np.swapaxes(As, 1, 2)) / 2


@pytest.mark.parametrize("B,n", [(5, 24), (3, 15)])
def test_eigh_batched_matches_reference(rng, B, n):
    """Odd n takes the decoupled pad row, whose eigenpair is removed."""
    As = batched_stack(rng, B, n)
    ws, Vs = eigh_batched(As, config=CFG)
    wr, _ = re_.eigh_batched(As)
    assert tuple(ws.shape) == (B, n) and tuple(Vs.shape) == (B, n, n)
    for b in range(B):
        check(As[b], ws[b].numpy(), Vs[b].numpy(), 5e-6)
    assert np.abs(ws.numpy() - np.asarray(wr)).max() < 50 * n * 1.2e-7 * np.abs(wr).max()


@pytest.mark.parametrize("B,n", [(5, 24), (3, 15)])
def test_eigh_batched_as_accurate_as_reference(rng, B, n):
    """Each matrix of the stack: orthogonality and residual at most 1.1 x the
    reference's."""
    As = batched_stack(rng, B, n)
    ws, Vs = eigh_batched(As, config=CFG)
    wr, Vr = (np.asarray(x) for x in re_.eigh_batched(As))
    for b in range(B):
        as_accurate(As[b], ws[b].numpy(), Vs[b].numpy(), wr[b], Vr[b])


def test_svd_qdwh_eigh_routing(rng):
    A = rng.standard_normal((64, 40)).astype(np.float32)
    U, s, Vh = (x.double().numpy() for x in svd(A, config=CFG, eigh_impl="qdwh"))
    sr = np.asarray(rp.svd(A, config=RCFG, eigh_impl="qdwh")[1], np.float64)
    assert pe.last_stats["jacobi_calls"] == 1            # the in-house eigensolver ran
    assert np.linalg.norm((U * s) @ Vh - A) / np.linalg.norm(A) < 2e-5
    assert np.linalg.norm(U.T @ U - np.eye(40)) < 40 * 5e-6
    s_ref = np.linalg.svd(A.astype(np.float64), compute_uv=False)
    assert np.abs(s - s_ref).max() < 2e-4 * s_ref[0] and (np.diff(s) <= 1e-6).all()
    assert np.abs(s - sr).max() < 50 * 40 * 1.2e-7 * sr[0]
