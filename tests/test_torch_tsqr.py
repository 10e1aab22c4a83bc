"""The PyTorch port's TSQR against the JAX reference: Householder and
CholeskyQR2 leaves, the padded last leaf and odd tree levels, the cholqr2
fallbacks, ``tsqr_r``, the gradient, the error paths and the config fields.

Householder TSQR uses the same reflector conventions in both packages, so Q
and R agree directly; CholeskyQR2 gives a positive diag(R) in both.  float64
1e-10 and float32 1e-4, relative to max|A| (R) or 1 (Q).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cuda_qr_tpu_torch as ct
from cuda_qr_tpu.models import tsqr as ref
from cuda_qr_tpu.utils.config import QRConfig as RefConfig
from cuda_qr_tpu_torch.models import tsqr as port
from cuda_qr_tpu_torch.ops import smalllinalg
from cuda_qr_tpu_torch.ops.geqrt import geqrt_base, geqrt_batched
from cuda_qr_tpu_torch.utils.interop import config_from_reference

from torch_threads import one_thread  # noqa: F401  (autouse: one intra-op thread)

TOLS = {np.float64: 1e-10, np.float32: 1e-4}
ref_tree = jax.jit(ref._tsqr_tree, static_argnums=1)


def configs(dtype, **kw):
    """The reference's config (plain path) and the port's counterpart, with
    the kernel wrappers enabled (on the CPU they take the plain versions)."""
    rcfg = RefConfig(dtype=jnp.dtype(dtype), use_pallas=False, **kw)
    return rcfg, config_from_reference(rcfg, device="cpu").replace(use_kernels=True)


def close(a, b, tol, scale=1.0):
    a = a.detach().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    b = np.asarray(b)
    assert a.shape == b.shape
    err = np.abs(a.astype(np.float64) - b.astype(np.float64)).max()
    assert err <= tol * scale, err


def gates(A, Q, R, n, factor=1):
    chk = ct.check_qr(A, Q, R)
    assert chk.residual < 4 * n * chk.eps, chk
    assert chk.orthogonality < factor * 8 * n * chk.eps, chk
    assert chk.r_triangular == 0.0


@pytest.mark.parametrize("m,n", [(64, 16), (256, 16), (1000, 16), (640, 32), (512, 64)],
                         ids=["one-block", "4-leaves", "padded-16-leaves", "odd-10-leaves",
                              "n64"])
def test_householder_matches_reference(rng, m, n):
    rcfg, cfg = configs(np.float64, block_rows=64)
    A = rng.standard_normal((m, n))
    Q, R = ct.tsqr(A, cfg)
    rQ, rR = ref.tsqr(jnp.asarray(A), rcfg)
    close(Q, rQ, 1e-10)
    close(R, rR, 1e-10, np.abs(A).max())
    gates(A, Q, R, n)


def test_householder_float32_matches_reference(rng):
    rcfg, cfg = configs(np.float32, block_rows=128)
    A = rng.standard_normal((2048, 64)).astype(np.float32)
    Q, R = ct.tsqr(A, cfg)
    rQ, rR = ref.tsqr(jnp.asarray(A), rcfg)
    assert Q.dtype == torch.float32
    close(Q, rQ, 1e-4)
    close(R, rR, 1e-4, np.abs(A).max())
    gates(A, Q, R, 64)


def test_odd_levels_pad_like_reference(rng):
    """640 x 32 at block_rows=64: 10 leaves, then levels of 5, 3 and 2 nodes
    -- each odd level padded with a zero R block."""
    rcfg, cfg = configs(np.float64, block_rows=64)
    A = rng.standard_normal((640, 32))
    blocks = port._blocks(torch.from_numpy(A), cfg)
    assert blocks.shape == (10, 64, 32)
    R = torch.zeros(5, 32, 32, dtype=torch.float64)
    assert port._tree_level(R).shape == (3, 64, 32)
    Q, R = port._tsqr_tree(torch.from_numpy(A), cfg)
    rQ, rR = ref_tree(jnp.asarray(A), rcfg)
    close(Q, rQ, 1e-10)
    close(R, rR, 1e-10, np.abs(A).max())


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("m,n", [(1000, 16), (4096, 32)])
def test_cholqr2_direct_matches_reference(rng, dtype, m, n):
    rcfg, cfg = configs(dtype, block_rows=256, tsqr_leaf="cholqr2")
    A = rng.standard_normal((m, n)).astype(dtype)
    before = smalllinalg.host_syncs
    Q, R = ct.tsqr(A, cfg)
    assert smalllinalg.host_syncs - before == 2    # Taylor bypass + fallback gate
    rQ, rR = ref.tsqr(jnp.asarray(A), rcfg)
    close(Q, rQ, TOLS[dtype])
    close(R, rR, TOLS[dtype], np.abs(A).max())
    assert (torch.diagonal(R) > 0).all()
    gates(A, Q, R, n)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_cholqr2_leaves_of_a_tree_match_reference(rng, dtype):
    """The tree with cholqr2 leaves and nodes (the reference reaches it
    through ``_tsqr_tree``): one host decision per leaf batch and level."""
    rcfg, cfg = configs(dtype, block_rows=64, tsqr_leaf="cholqr2")
    A = rng.standard_normal((640, 16)).astype(dtype)
    before = smalllinalg.host_syncs
    Q, R = port._tsqr_tree(torch.from_numpy(A), cfg)
    assert smalllinalg.host_syncs - before == 5    # leaves, then levels of 5, 3, 2, 1
    rQ, rR = ref_tree(jnp.asarray(A), rcfg)
    close(Q, rQ, TOLS[dtype])
    close(R, rR, TOLS[dtype], np.abs(A).max())


def test_cholqr2_leaf_fallback_rank_deficient(rng):
    """A rank-deficient leaf breaks Cholesky: the batch falls back to
    Householder leaves, as the reference's lax.cond does."""
    rcfg, cfg = configs(np.float32, block_rows=64, tsqr_leaf="cholqr2")
    A = rng.standard_normal((256, 8)).astype(np.float32)
    A[:, 3] = A[:, 2]
    Qc, Rc, emax = port._batched_cholqr2(port._blocks(torch.from_numpy(A), cfg), cfg)
    assert not (torch.isfinite(Qc).all() and float(emax) <= 0.05)   # cholqr2 fails
    Q, R = port._tsqr_tree(torch.from_numpy(A), cfg)
    rQ, rR = ref_tree(jnp.asarray(A), rcfg)
    assert torch.isfinite(Q).all()
    close(Q @ R, np.asarray(rQ) @ np.asarray(rR), 1e-4, np.abs(A).max())
    assert np.linalg.norm(Q.double().numpy() @ R.double().numpy() - A) < 1e-4 * np.linalg.norm(A)


def test_cholqr2_direct_falls_back_on_ill_conditioning(rng):
    """cond(A) ~ 3e7 in float32: the direct path's certificates fail and
    both packages take the Householder tree; then Q and R agree as
    Householder TSQR does."""
    dtype = np.float32
    n = 16
    U, _ = np.linalg.qr(rng.standard_normal((2048, n)))
    V, _ = np.linalg.qr(rng.standard_normal((n, n)))
    A = ((U * np.logspace(0, -7.5, n)) @ V.T).astype(dtype)
    rcfg, cfg = configs(dtype, block_rows=64, tsqr_leaf="cholqr2")
    _, _, bad = port._cholqr2_direct(torch.from_numpy(A), cfg)
    assert bool(bad)
    Q, R = ct.tsqr(A, cfg)
    rQ, rR = ref.tsqr(jnp.asarray(A), rcfg)
    tQ, tR = ct.tsqr(A, cfg.replace(tsqr_leaf="householder"))
    assert torch.equal(Q, tQ) and torch.equal(R, tR)   # exactly the tree's result
    close(R, rR, TOLS[dtype], np.abs(A).max())
    close(Q @ R, np.asarray(rQ) @ np.asarray(rR), TOLS[dtype], np.abs(A).max())
    chk = ct.check_qr(A, Q, R)
    assert chk.orthogonality < 8 * n * chk.eps, chk


@pytest.mark.parametrize("leaf,m", [("householder", 512), ("householder", 48),
                                    ("cholqr2", 512), ("cholqr2", 48)])
def test_tsqr_r_matches_tsqr_and_reference(rng, leaf, m):
    rcfg, cfg = configs(np.float64, block_rows=64, tsqr_leaf=leaf)
    A = rng.standard_normal((m, 24))
    _, R = ct.tsqr(A, cfg)
    Rr = ct.tsqr_r(A, cfg)
    close(Rr, R.numpy(), 1e-12, np.abs(A).max())
    close(Rr, ref.tsqr_r(jnp.asarray(A), rcfg), 1e-10, np.abs(A).max())


def test_gradient_matches_reference():
    """tsqr shares the thin-QR VJP: the gradient of a sign-invariant loss
    agrees with jax.grad of the reference's tsqr."""
    rng = np.random.default_rng(9)
    A = rng.standard_normal((96, 6))
    rcfg, cfg = configs(np.float64, block_rows=32)
    w = np.arange(6.0)

    def loss_ref(a):
        Q, R = ref.tsqr(a, rcfg)
        return jnp.sum(Q ** 2 * w) + jnp.sum(R ** 2)

    g_ref = np.asarray(jax.grad(loss_ref)(jnp.asarray(A)))
    At = torch.from_numpy(A).requires_grad_(True)
    Q, R = ct.tsqr(At, cfg)
    ((Q ** 2 * torch.from_numpy(w)).sum() + (R ** 2).sum()).backward()
    close(At.grad, g_ref, 1e-10, np.abs(g_ref).max())


def test_cpu_takes_the_plain_versions(rng):
    """On the CPU the eligible geqrt calls take the plain version: no launch."""
    _, cfg = configs(np.float32, block_rows=64)
    A = rng.standard_normal((256, 32)).astype(np.float32)
    before = (geqrt_batched.launches, geqrt_base.launches)
    ct.tsqr(A, cfg)
    ct.tsqr(A[:40], cfg)
    assert (geqrt_batched.launches, geqrt_base.launches) == before


def test_wide_block_above_kernel_width(rng):
    """n > 128 is outside the geqrt kernel's width: the plain version."""
    rcfg, cfg = configs(np.float64, block_rows=64)
    A = rng.standard_normal((600, 130))
    Q, R = ct.tsqr(A, cfg)
    rQ, rR = ref.tsqr(jnp.asarray(A), rcfg)
    close(Q, rQ, 1e-10)
    close(R, rR, 1e-10, np.abs(A).max())


def test_error_paths():
    Q, R = ct.tsqr(torch.zeros((64, 4), dtype=torch.complex64))   # complex works: H = I
    assert Q.dtype == torch.complex64 and torch.equal(Q, torch.eye(64, 4, dtype=Q.dtype))
    with pytest.raises(ct.QRShapeError):
        ct.tsqr(torch.zeros((2, 64, 4)))
    with pytest.raises(ct.QRShapeError):
        ct.tsqr_r(torch.zeros(64))
    with pytest.raises(ValueError):
        ct.QRConfig(tsqr_leaf="qr")


def test_config_round_trips_tsqr_fields():
    rcfg = RefConfig(tsqr_leaf="cholqr2", block_rows=256)
    cfg = config_from_reference(rcfg, device="cpu")
    assert (cfg.tsqr_leaf, cfg.block_rows) == ("cholqr2", 256)
    default = config_from_reference(RefConfig(), device="cpu")
    assert (default.tsqr_leaf, default.block_rows) == ("householder", 1024)
    assert (default.tsqr_leaf, default.block_rows) == (ct.QRConfig().tsqr_leaf,
                                                       ct.QRConfig().block_rows)
