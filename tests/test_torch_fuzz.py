"""Random-shape fuzz sweep across the port's public API, on the CPU.

The twin of tests/test_fuzz.py: the same seeds, the same shape and value
draws and the same gates, run on the port with ``device="cpu"``.  Two
families the reference's sweep does not call are added, each held to a
ground truth that does not come from the port: ``slogdet``'s sign against
numpy's in float64 at random n (n a multiple of the panel width among
them), and ``matrix_rank``/``null_space`` of a product of exact random
rank.  No JAX call: every new shape would be one more XLA compile.
"""

import numpy as np
import pytest
import torch

from cuda_qr_tpu_torch import (QRConfig, lq, matrix_rank, null_space, qr, qr_batched,
                               qr_col_delete, qr_col_insert, qr_rank1_update, qr_row_delete,
                               qr_row_insert, ql, rq, slogdet)

from torch_threads import one_thread  # noqa: F401  (autouse: one intra-op thread)

NB = 16
CFG = QRConfig(panel_width=NB, dtype=torch.float64, use_kernels=False, device="cpu")
CFG_FAST = QRConfig(panel_width=NB, dtype=torch.float64, device="cpu")  # cholqr2_bk
CFG32 = QRConfig(panel_width=NB, device="cpu")
EPS = np.finfo(np.float64).eps


def host(x) -> np.ndarray:
    return x.detach().numpy()


@pytest.mark.parametrize("seed", range(6))
def test_fuzz_shapes_and_values(seed):
    rng = np.random.default_rng(100 + seed)
    m = int(rng.integers(1, 200))
    n = int(rng.integers(1, 200))
    kind = seed % 3
    A = rng.standard_normal((m, n))
    if kind == 1:
        A[:, rng.integers(0, n)] = 0.0            # dead column
    elif kind == 2:
        A *= np.logspace(0, 4, n)[None, :]        # graded columns
    cfg = CFG if seed % 2 else CFG_FAST
    Q, R = qr(A, cfg)
    k = min(m, n)
    assert Q.shape == (m, k) and R.shape == (k, n)
    Qn, Rn = host(Q), host(R)
    resid = np.linalg.norm(Qn @ Rn - A)
    scale = max(np.linalg.norm(A), 1.0)
    assert resid / scale < 4 * max(m, n, 16) * EPS, (seed, m, n, kind, resid / scale)
    orth = np.linalg.norm(Qn.T @ Qn - np.eye(k))
    assert orth < 8 * max(m, n, 16) * EPS, (seed, m, n, orth)


@pytest.mark.parametrize("seed", range(4))
def test_fuzz_complex(seed):
    rng = np.random.default_rng(300 + seed)
    m = int(rng.integers(2, 120))
    n = int(rng.integers(1, 120))
    A = (rng.standard_normal((m, n)) + 1j * rng.standard_normal((m, n)))
    if seed == 1:
        A[:, rng.integers(0, n)] = 0.0           # dead column
    if seed == 2:
        A = A.real.astype(complex)               # complex dtype, zero imag
    Q, R = qr(A.astype(np.complex128), QRConfig(panel_width=NB, use_kernels=False, device="cpu"))
    k = min(m, n)
    Qn, Rn = host(Q), host(R)
    scale = max(np.linalg.norm(A), 1.0)
    assert np.linalg.norm(Qn @ Rn - A) / scale < 8 * max(m, n, 16) * EPS
    assert np.linalg.norm(Qn.conj().T @ Qn - np.eye(k)) < 8 * max(m, n, 16) * EPS
    assert np.abs(np.tril(Rn[:, :k], -1)).max() == 0.0


@pytest.mark.parametrize("seed", range(3))
def test_fuzz_update_chains(seed):
    rng = np.random.default_rng(400 + seed)
    n = int(rng.integers(2, 40))
    m = n + int(rng.integers(1, 60))
    A = rng.standard_normal((m, n))
    Qa, Ra = np.linalg.qr(A)
    Q, R = torch.from_numpy(Qa), torch.from_numpy(Ra)

    def ok(Qt, Rt, Anew):
        Qn, Rn = host(Qt), host(Rt)
        assert np.linalg.norm(Qn @ Rn - Anew) / max(np.linalg.norm(Anew), 1) \
            < 64 * max(m, n) * EPS
        assert np.linalg.norm(Qn.T @ Qn - np.eye(Qn.shape[1])) < 64 * max(m, n) * EPS

    u, v = rng.standard_normal(m), rng.standard_normal(n)
    if seed == 1:
        u = Qa[:, 0] * 2.0                       # u in span(Q): rho == 0
    ok(*qr_rank1_update(Q, R, torch.from_numpy(u), torch.from_numpy(v)), A + np.outer(u, v))
    kr = int(rng.integers(0, m))
    ok(*qr_row_delete(Q, R, kr), np.delete(A, kr, axis=0))
    a = rng.standard_normal(n)
    ki = int(rng.integers(0, m + 1))
    ok(*qr_row_insert(Q, R, torch.from_numpy(a), ki), np.insert(A, ki, a, axis=0))
    kc = int(rng.integers(0, n))
    ok(*qr_col_delete(Q, R, kc), np.delete(A, kc, axis=1))
    c = rng.standard_normal(m)
    ok(*qr_col_insert(Q, R, torch.from_numpy(c), kc), np.insert(A, kc, c, axis=1))


@pytest.mark.parametrize("seed", range(3))
def test_fuzz_batched(seed):
    """At the default float32 dtype, as the reference's call."""
    rng = np.random.default_rng(500 + seed)
    B = int(rng.integers(1, 12))
    n = int(rng.integers(1, 24))
    m = n + int(rng.integers(0, 40))
    A = rng.standard_normal((B, m, n))
    if seed == 2:
        A *= np.logspace(0, 3, n)[None, None, :]  # graded columns
    Q, R = qr_batched(A, CFG32)
    Qn, Rn = host(Q).astype(np.float64), host(R).astype(np.float64)
    resid = np.linalg.norm(Qn @ Rn - A) / max(np.linalg.norm(A), 1)
    assert resid < 1e-5, (seed, B, m, n, resid)
    for i in range(B):
        assert np.linalg.norm(Qn[i].T @ Qn[i] - np.eye(n)) < 1e-5
        assert (np.diag(Rn[i]) >= 0).all()        # positive-diagonal convention


@pytest.mark.parametrize("seed", range(6))
def test_fuzz_decomp_family(seed):
    """lq/rq/ql at random shapes/dtypes: reconstruction + orthonormality."""
    rng = np.random.default_rng(500 + seed)
    m = int(rng.integers(2, 150))
    n = int(rng.integers(2, 150))
    complex_ = seed % 2 == 1
    A = rng.standard_normal((m, n))
    if complex_:
        A = A + 1j * rng.standard_normal((m, n))
        A = A.astype(np.complex128)
    fn = (lq, rq, ql)[seed % 3]
    X, Y = fn(A, CFG)
    X, Y = host(X), host(Y)
    k = min(m, n)
    resid = np.linalg.norm(X @ Y - A) / max(np.linalg.norm(A), 1.0)
    assert resid < 8 * max(m, n, 16) * EPS, (seed, m, n, fn.__name__, resid)
    Q = Y if fn in (lq, rq) else X
    G = Q @ Q.conj().T if fn in (lq, rq) else Q.conj().T @ Q
    assert np.linalg.norm(G - np.eye(k)) < 16 * max(m, n, 16) * EPS


@pytest.mark.parametrize("seed", range(16))
def test_fuzz_slogdet(seed):
    """Random n in [1, 200), every other seed a multiple of the panel width
    (a square last panel); float64 and float32, geqr2 and reconstruction
    panels.  The sign must equal numpy's in float64 on the same input."""
    rng = np.random.default_rng(600 + seed)
    n = int(rng.integers(1, 200))
    if seed % 2 == 0:
        n = NB * int(rng.integers(1, 200 // NB))
    cfg = (CFG_FAST, CFG32, CFG, CFG32.replace(use_kernels=False))[seed // 2 % 4]
    A = rng.standard_normal((n, n))
    if seed % 3 == 2:
        A *= np.logspace(0, 4, n)[None, :]        # graded columns
    A = A.astype(np.float32 if cfg.dtype == torch.float32 else np.float64)
    sign, logabs = slogdet(A, cfg)
    want_sign, want_logabs = np.linalg.slogdet(A.astype(np.float64))
    assert float(sign) == want_sign, (seed, n, float(sign), want_sign)
    tol = 1e-3 if cfg.dtype == torch.float32 else 1e-10
    assert abs(float(logabs) - want_logabs) < tol * max(1.0, abs(want_logabs)), (seed, n)


@pytest.mark.parametrize("seed", range(6))
def test_fuzz_rank_and_null_space(seed):
    """A = B C with B (m x r), C (r x n) Gaussian has rank r exactly:
    matrix_rank gives r, null_space n - r orthonormal columns that A maps
    to ~0."""
    rng = np.random.default_rng(700 + seed)
    n = int(rng.integers(2, 120))
    m = n + int(rng.integers(0, 60))
    r = int(rng.integers(1, n + 1))
    cfg = CFG if seed % 2 else CFG32
    A = rng.standard_normal((m, r)) @ rng.standard_normal((r, n))
    A = A.astype(np.float32 if cfg.dtype == torch.float32 else np.float64)
    eps = np.finfo(A.dtype).eps
    assert matrix_rank(A, config=cfg) == r, (seed, m, n, r)
    N = host(null_space(A, config=cfg)).astype(np.float64)
    assert N.shape == (n, n - r), (seed, m, n, r, N.shape)
    if n > r:
        assert np.linalg.norm(N.T @ N - np.eye(n - r)) < 16 * max(m, n, 16) * eps
        assert np.linalg.norm(A @ N) < 16 * max(m, n, 16) * eps * np.linalg.norm(A)
