"""The CUDA kernels and the port's main path on an NVIDIA GPU.

Needs a card: every test here is marked ``cuda`` and skips without one.  On
a machine with a card and without JAX (tests/conftest.py imports JAX):

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Each kernel is held against its plain PyTorch version on the same device.
float32 1e-4 relative: other summation orders, and L^{-1} amplifies by
cond(G); float64 1e-10.
"""

import numpy as np
import pytest
import torch

import cuda_qr_tpu_torch as ct
from cuda_qr_tpu_torch.ops.chol_kernel import chol_with_inv_kernel
from cuda_qr_tpu_torch.ops.geqrt import geqrt_base, geqrt_base_plain
from cuda_qr_tpu_torch.ops.smalllinalg import cholesky_with_inv

pytestmark = pytest.mark.cuda
TOLS = {torch.float32: 1e-4, torch.float64: 1e-10}


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def rel(a, b):
    return float((a - b).abs().max() / b.abs().max())


@pytest.mark.parametrize("nb,dtype", [(16, torch.float32), (100, torch.float32),
                                      (128, torch.float32), (512, torch.float32),
                                      (128, torch.float64), (300, torch.float64)])
def test_chol_inv_kernel_matches_plain(dev, nb, dtype):
    rng = np.random.default_rng(nb)
    B = rng.standard_normal((nb, nb))
    G = torch.from_numpy(B @ B.T + nb * np.eye(nb)).to(dev, dtype)
    before = chol_with_inv_kernel.launches
    L, Li = chol_with_inv_kernel(G)
    Lp, Lip = cholesky_with_inv(G)
    assert chol_with_inv_kernel.launches == before + 1
    assert rel(L, Lp) < TOLS[dtype] and rel(Li, Lip) < TOLS[dtype]
    assert torch.equal(torch.triu(L, 1), torch.zeros_like(L))


def test_chol_inv_kernel_non_pd_and_rejects(dev):
    L, Li = chol_with_inv_kernel(-torch.eye(32, device=dev))
    assert not torch.isfinite(L).all()
    with pytest.raises(TypeError):
        chol_with_inv_kernel(torch.eye(32, device=dev, dtype=torch.float16))
    with pytest.raises(ValueError):
        chol_with_inv_kernel(torch.eye(513, device=dev))


@pytest.mark.parametrize("m,w,off,dtype", [(256, 32, 0, torch.float32),
                                           (4096, 32, 40, torch.float32),
                                           (1000, 77, 3, torch.float32),
                                           (2048, 32, 0, torch.float64)])
def test_geqrt_kernel_matches_plain(dev, m, w, off, dtype):
    P = torch.from_numpy(np.random.default_rng(m).standard_normal((m, w))).to(dev, dtype)
    P[:, 2] = 0
    before = geqrt_base.launches
    got = geqrt_base(P, off)
    want = geqrt_base_plain(P, off)
    assert geqrt_base.launches == before + 1
    for a, b in zip(got, want):
        assert torch.isfinite(a).all() and rel(a, b) < TOLS[dtype]


@pytest.mark.parametrize("method", ["cholqr2_bk", "cholqr2_hr", "geqrt"])
def test_qr_on_the_card(dev, method):
    A = torch.from_numpy(np.random.default_rng(12).standard_normal(
        (1024, 768), dtype=np.float32)).to(dev)
    cfg = ct.QRConfig(panel_method=method, device="cuda")
    launches = chol_with_inv_kernel.launches + geqrt_base.launches
    Q, R = ct.qr(A, cfg)
    assert Q.device == A.device
    assert chol_with_inv_kernel.launches + geqrt_base.launches > launches
    assert ct.check_qr_device(A, Q, R).ok
    assert ct.check_qr(A, Q, R).ok
