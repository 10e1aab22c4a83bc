"""CholeskyQR2 panel factorizations of the PyTorch port against the JAX
reference.  Packed factors are compared only under the same panel_method
(the basis-kernel panel stores a dense, non-LAPACK V block).

fp64 agreement 1e-10: the same algorithm with other summation orders, and
CholeskyQR2 squares the panel's condition number.  fp32 1e-4 for the same
reason.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cuda_qr_tpu.ops import fast_panel as ref
from cuda_qr_tpu.utils.config import QRConfig as RefConfig
from cuda_qr_tpu_torch.ops import fast_panel as port
from cuda_qr_tpu_torch.ops import smalllinalg
from cuda_qr_tpu_torch.ops.householder import geqr2
from cuda_qr_tpu_torch.utils.config import QRConfig

from torch_threads import one_thread  # noqa: F401  (autouse: one intra-op thread)

CASES = {"f64": (np.float64, 1e-10), "f32": (np.float32, 1e-4)}


def configs(dt):
    if dt == np.float64:
        return RefConfig(dtype=jnp.float64), QRConfig(dtype=torch.float64)
    return RefConfig(dtype=jnp.float32), QRConfig(dtype=torch.float32)


def close(a, b, tol):
    b = np.asarray(b)
    assert np.abs(a.numpy() - b).max() <= tol * max(1.0, np.abs(b).max())


@pytest.mark.parametrize("m,nb,off,case", [(96, 32, 0, "f64"), (256, 32, 128, "f64"),
                                           (128, 32, 32, "f32")])
def test_cholqr2bk_matches_reference(rng, m, nb, off, case):
    dt, tol = CASES[case]
    rcfg, cfg = configs(dt)
    A = rng.standard_normal((m, nb)).astype(dt)
    r = jax.jit(lambda a, o: ref.panel_factor_cholqr2bk(a, o, rcfg))(jnp.asarray(A), off)
    p = port.panel_factor_cholqr2bk(torch.from_numpy(A), off, cfg)
    for a, b in zip(p, r):     # packed, tau, T, VJ
        close(a, b, tol)
    assert torch.equal(p[0][:off], torch.from_numpy(A[:off]))


@pytest.mark.parametrize("m,nb,off", [(96, 32, 0), (96, 32, 16)])
def test_cholqr2hr_matches_reference(rng, m, nb, off):
    rcfg, cfg = configs(np.float64)
    A = rng.standard_normal((m, nb))
    r = jax.jit(lambda a, o: ref.panel_factor_cholqr2hr(a, o, rcfg))(jnp.asarray(A), off)
    p = port.panel_factor_cholqr2hr(torch.from_numpy(A), off, cfg)
    for a, b in zip(p, r):     # packed, tau, T
        close(a, b, 1e-10)
    # the reconstruction is a valid Householder representation of A
    packed, tau, T = (x.numpy() for x in p)
    V = np.tril(packed[off:], -1) + np.eye(m - off, nb)
    E = np.eye(m - off, nb)
    Qh = E - V @ (T @ (V.T @ E))
    assert np.abs(Qh.T @ Qh - np.eye(nb)).max() < 1e-13
    assert np.abs(Qh @ np.triu(packed[off:off + nb]) - A[off:]).max() < 1e-12


@pytest.mark.parametrize("method", ["cholqr2_bk", "cholqr2_hr"])
def test_rank_deficient_panel_falls_back(rng, method):
    A = np.zeros((64, 16))
    A[:, 0] = rng.standard_normal(64)
    fn = getattr(port, "panel_factor_" + method.replace("_", ""))
    packed = fn(torch.from_numpy(A), 0, QRConfig(dtype=torch.float64))[0]
    assert torch.isfinite(packed).all()
    assert abs(float(packed[0, 0])) == pytest.approx(np.linalg.norm(A[:, 0]), rel=1e-12)


@pytest.mark.parametrize("method", ["cholqr2_bk", "cholqr2_hr"])
def test_illconditioned_panel_takes_householder(rng, method):
    """cond(X) ~ 1e4 in fp32 loses orthogonality without NaNs; only the
    emax gate catches it and routes the panel to geqr2."""
    m, nb = 256, 32
    U, _ = np.linalg.qr(rng.standard_normal((m, nb)))
    V, _ = np.linalg.qr(rng.standard_normal((nb, nb)))
    A = ((U * np.logspace(0, -4, nb)) @ V.T).astype(np.float32)
    fn = getattr(port, "panel_factor_" + method.replace("_", ""))
    before = smalllinalg.host_syncs
    packed = fn(torch.from_numpy(A), 0, QRConfig())[0]
    assert smalllinalg.host_syncs > before
    expect, _ = geqr2(torch.from_numpy(A))
    assert torch.equal(packed, expect)


def test_bf16_panel_upcasts(rng):
    A = torch.from_numpy(rng.standard_normal((128, 32)).astype(np.float32))
    packed, tau, T, VJ = port.panel_factor_cholqr2bk(A.bfloat16(), 0, QRConfig())
    assert packed.dtype == torch.bfloat16 and T.dtype == torch.float32
    assert torch.isfinite(packed.float()).all()
