"""Column-pivoted QR of the PyTorch port (ops/qrcp.py, qr_pivoted) against
the JAX reference on the same input and the same sketch.

The pivots depend on the Gaussian sketch Omega, and the port cannot draw
``jax.random``'s numbers, so each test builds the reference's Omega exactly
as ``cuda_qr_tpu/ops/qrcp.py`` does (key 12) and hands it to the port as
numpy.  jpvt must then be identical.  Tolerances, float32: Q within 1e-4
and R within 1e-4 * max|A| (CholeskyQR2 panels square a panel's condition
number, and the last, square live block of a square matrix may take
another fallback in each package); each package's pivoted factorization
must reconstruct to n*eps, and the port's orthogonality may be no worse
than 2x the reference's or the 4n*eps gate.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cuda_qr_tpu as ref
from cuda_qr_tpu.ops import qrcp as rq
from cuda_qr_tpu_torch import (MIXED_CONFIG, QRConfig, QRShapeError, check_qr, extract_r,
                               orgqr, qr_pivoted)
from cuda_qr_tpu_torch.ops import gemm as gemm_mod, qrcp as pq
from cuda_qr_tpu_torch.ops.select_kernel import select_pivots_kernel
from cuda_qr_tpu_torch.utils.geometry import round_up
from cuda_qr_tpu_torch.utils.interop import config_from_reference, packed_from_numpy

from torch_threads import one_thread  # noqa: F401  (autouse: one intra-op thread)

EPS32 = float(np.finfo(np.float32).eps)


def ref_config(nb):
    return ref.QRConfig(dtype=jnp.float32, panel_width=nb, scan_stages=2)


def ref_omega(m, nb):
    """The reference's sketch for an m-row input at panel width nb."""
    m_pad = round_up(m, nb)
    l = pq.sketch_rows(m_pad, nb)
    om = jax.random.normal(jax.random.key(12), (l, m_pad), dtype=jnp.float32)
    return np.array(om / jnp.sqrt(jnp.asarray(l, jnp.float32)))


def both(A, nb, num_panels=None):
    """(jpvt, Q, R) of qrcp_blocked + orgqr in each package, R = [R11 R12].

    The reference's factors are carried across and expanded by this
    package's orgqr, which tests/test_torch_blocked.py holds to the
    reference's orgqr on carried factors (and which spares a JAX compile).
    """
    m = A.shape[0]
    rcfg = ref_config(nb)
    cfg = config_from_reference(rcfg, device="cpu")
    rf, rj, rR12 = rq.qrcp_blocked(jnp.asarray(A), rcfg, num_panels=num_panels)
    rf = packed_from_numpy(*(np.asarray(x) for x in rf), device="cpu")
    kb = rf.packed.shape[1]
    rQ = orgqr(rf, m, kb, cfg).numpy()
    rR = np.concatenate([extract_r(rf, kb).numpy(), np.asarray(rR12)], 1)
    f, j, R12 = pq.qrcp_blocked(A, cfg, num_panels=num_panels, omega=ref_omega(m, nb))
    Q, R = orgqr(f, m, kb, cfg), torch.cat([extract_r(f, kb), R12], 1)
    return (np.asarray(rj), rQ, rR), (j.numpy(), Q.numpy(), R.numpy())


def assert_close_to_reference(A, r, p):
    (rj, rQ, rR), (j, Q, R) = r, p
    np.testing.assert_array_equal(j, rj)
    assert np.abs(Q - rQ).max() <= 1e-4
    assert np.abs(R - rR).max() <= 1e-4 * np.abs(A).max()


@pytest.mark.parametrize("m,n,nb", [(96, 64, 16), (130, 70, 16), (64, 64, 32),
                                    (160, 128, 32)])   # (160, 128, 32): B3-eligible
def test_qrcp_matches_reference(rng, m, n, nb):
    A = rng.standard_normal((m, n)).astype(np.float32)
    r, p = both(A, nb)
    assert_close_to_reference(A, r, p)
    rj, rQ, rR = r
    j, Q, R = p
    assert sorted(j.tolist()) == list(range(round_up(n, nb)))
    assert (j[n:] >= n).all()                     # pad columns sort last
    ref_chk = check_qr(A[:, rj[:n]], rQ[:, :n], rR[:n, :n])
    chk = check_qr(A[:, j[:n]], Q[:, :n], R[:n, :n])
    assert chk.residual_ok and chk.r_triangular == 0.0
    assert chk.orthogonality < max(4 * n * EPS32, 2 * ref_chk.orthogonality)


def test_truncated_matches_reference(rng):
    A = rng.standard_normal((160, 96)).astype(np.float32)
    r, p = both(A, 16, num_panels=2)
    assert p[1].shape == (160, 32) and p[2].shape == (32, 96)
    assert_close_to_reference(A, r, p)


@pytest.mark.parametrize("rk", [40, 20])
def test_rank_deficient_zero_columns_sort_last(rng, rk):
    """8 zero columns after a rank-rk block.  rk = 40: the nonzero columns
    are independent and the zero columns stay exactly zero, so every pivot
    is decided (ties in index order) and jpvt must be identical.  rk = 20:
    past position rk the remaining nonzero columns have norms at rounding
    level, where any other summation order picks another order; there the
    pivots must agree as a set, and the zero columns still sort last."""
    m, n = 80, 48
    B = rng.standard_normal((m, rk)).astype(np.float32)
    C = rng.standard_normal((rk, n - 8)).astype(np.float32)
    A = np.concatenate([B @ C, np.zeros((m, 8), np.float32)], axis=1)
    r, p = both(A, 16)
    (rj, rQ, rR), (j, Q, R) = r, p
    if rk == n - 8:
        assert_close_to_reference(A, r, p)
    else:
        np.testing.assert_array_equal(j[:rk], rj[:rk])
        assert set(j[rk:n - 8].tolist()) == set(rj[rk:n - 8].tolist())
        np.testing.assert_array_equal(j[n - 8:], rj[n - 8:])
        assert np.abs(Q[:, :rk] - rQ[:, :rk]).max() <= 1e-4
        assert np.abs(R[:rk, :rk] - rR[:rk, :rk]).max() <= 1e-4 * np.abs(A).max()
    np.testing.assert_array_equal(j[n - 8:], np.arange(n - 8, n))
    assert check_qr(A[:, j[:n]], Q[:, :n], R[:n, :n]).residual < 2000 * n * EPS32
    d = np.abs(np.diagonal(R))
    assert d[rk:].max() < 1e-3 * d[0]


def test_qr_pivoted_truncated_matches_reference(rng):
    m, n, nb, rank = 130, 70, 16, 40
    A = rng.standard_normal((m, n)).astype(np.float32)
    rQ, rR, rp = ref.qr_pivoted(A, ref_config(nb), rank=rank)
    Q, R, piv = qr_pivoted(A, config_from_reference(ref_config(nb), device="cpu"), rank=rank,
                           omega=ref_omega(m, nb))
    assert Q.shape == (m, rank) and R.shape == (rank, n) and piv.shape == (n,)
    np.testing.assert_array_equal(piv.numpy(), np.asarray(rp))
    assert np.abs(Q.numpy() - np.asarray(rQ)).max() <= 1e-4
    assert np.abs(R.numpy() - np.asarray(rR)).max() <= 1e-4 * np.abs(A).max()


def test_default_sketch_is_seeded_and_rank_revealing(rng):
    """Without omega the port draws its own sketch (seed 12): the result is
    reproducible and rank-revealing (|R_kk| tracks sigma_k, as the
    reference's test_qrcp_pivot_quality requires)."""
    n = 96
    U, _ = np.linalg.qr(rng.standard_normal((128, n)))
    V, _ = np.linalg.qr(rng.standard_normal((n, n)))
    s = 0.8 ** np.arange(n)
    A = ((U * s) @ V.T).astype(np.float32)
    cfg = QRConfig(panel_width=16, device="cpu")
    Q, R, piv = qr_pivoted(A, cfg)
    Q2, R2, piv2 = qr_pivoted(torch.from_numpy(A), cfg)
    assert torch.equal(piv, piv2) and torch.equal(R, R2)
    assert check_qr(A[:, piv.numpy()], Q, R).residual < 200 * n * EPS32
    ratio = np.abs(np.diagonal(R.numpy()))[: n - 16] / s[: n - 16]
    assert ratio.max() < 30 and ratio.min() > 1 / 30


def test_select_kernel_switch_and_no_launch_on_cpu(rng):
    A = rng.standard_normal((160, 128)).astype(np.float32)
    cfg = QRConfig(panel_width=32, device="cpu")
    before = select_pivots_kernel.launches
    on = qr_pivoted(A, cfg)
    off = qr_pivoted(A, cfg.replace(use_select_kernel=False))
    assert select_pivots_kernel.launches == before
    for a, b in zip(on, off):
        assert torch.equal(a, b)


def test_mixed_config_asks_for_no_tf32(rng, monkeypatch):
    """The reference runs every QRCP GEMM, the trailing update included, at
    ``precision`` (cuda_qr_tpu/ops/qrcp.py:194-196), so MIXED_CONFIG's
    trailing TF32 must never reach the pivoted factorization."""
    asked = []
    real = gemm_mod._product

    def record(a, b, mode):
        asked.append(mode)
        return real(a, b, mode)

    monkeypatch.setattr(gemm_mod, "_product", record)   # every GEMM's one product call
    A = rng.standard_normal((96, 64)).astype(np.float32)
    cfg = MIXED_CONFIG.replace(panel_width=16, device="cpu")
    pq.qrcp_blocked(A, cfg)
    assert asked and "tf32" not in asked
    assert set(asked) == {"ieee"}


def test_input_not_modified_and_bf16_storage(rng):
    A = torch.from_numpy(rng.standard_normal((96, 64)).astype(np.float32))
    A0 = A.clone()
    Q, R, piv = qr_pivoted(A, QRConfig(panel_width=16, dtype=torch.bfloat16, device="cpu"))
    assert torch.equal(A, A0)
    assert sorted(piv.tolist()) == list(range(64))
    chk = check_qr(A[:, piv], Q.float(), R.float())
    assert chk.residual < 3e-2 and np.isfinite(chk.orthogonality)


def test_wide_and_bad_rank_raise(rng):
    cfg = QRConfig(panel_width=16, device="cpu")
    with pytest.raises(QRShapeError):
        qr_pivoted(rng.standard_normal((16, 32)).astype(np.float32), cfg)
    with pytest.raises(QRShapeError):
        qr_pivoted(rng.standard_normal((32, 16)).astype(np.float32), cfg, rank=17)
    with pytest.raises(QRShapeError):
        pq.qrcp_blocked(np.zeros((32, 16), np.float32), cfg, omega=np.zeros((3, 32), np.float32))


def test_complex_takes_the_plain_selection(rng, monkeypatch):
    """Complex input never reaches the select kernel's wrapper, also where
    the tile is eligible for a real input (160 x 128 at nb = 32), and gives
    the reference's pivots and factors with its complex sketch."""
    from cuda_qr_tpu_torch.ops import select_kernel
    monkeypatch.setattr(select_kernel, "select_pivots_kernel", lambda *a: pytest.fail("kernel B3"))
    m, n, nb = 160, 128, 32
    A = (rng.standard_normal((m, n)) + 1j * rng.standard_normal((m, n))).astype(np.complex64)
    l = pq.sketch_rows(m, nb)
    om = jax.random.normal(jax.random.key(12), (l, m), dtype=jnp.complex64)
    om = np.array(om / jnp.sqrt(jnp.asarray(l, jnp.complex64)))
    Q, R, piv = qr_pivoted(A, QRConfig(panel_width=nb, device="cpu"), omega=om)
    rQ, rR, rpiv = ref.qr_pivoted(A, ref_config(nb))
    np.testing.assert_array_equal(piv.numpy(), np.asarray(rpiv))
    assert np.abs(Q.numpy() - np.asarray(rQ)).max() <= 1e-4
    assert np.abs(R.numpy() - np.asarray(rR)).max() <= 1e-4 * np.abs(A).max()
