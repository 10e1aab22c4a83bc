"""Kernel B1 (chol_inv) on the CPU: its plain PyTorch version against the
reference's Pallas kernel in interpret mode, and the wrapper's routing.

The CUDA kernel itself runs only on a card (tests/test_torch_cuda.py and
chip_smoke.py).  float32: the two compute L and L^{-1} in different orders
(right-looking blocks vs 2-way recursion); 1e-5 relative covers rounding
times the modest cond(G) of these inputs.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cuda_qr_tpu.ops import pallas_chol
from cuda_qr_tpu_torch.ops import chol_kernel
from cuda_qr_tpu_torch.ops.chol_kernel import chol_with_inv_kernel, supported

from torch_threads import one_thread  # noqa: F401  (autouse: one intra-op thread)

TOL32 = 1e-5


def spd(rng, nb):
    B = rng.standard_normal((nb, 2 * nb)).astype(np.float32)
    return B @ B.T / (2 * nb)


@pytest.mark.parametrize("nb", [16, 32, 64])
def test_plain_matches_pallas_interpret(rng, nb):
    G = spd(rng, nb)
    rL, rLi = pallas_chol.chol_with_inv_pallas(jnp.asarray(G), interpret=True)
    L, Li = chol_with_inv_kernel(torch.from_numpy(G))
    rL, rLi = np.asarray(rL), np.asarray(rLi)
    assert np.abs(L.numpy() - rL).max() <= TOL32 * np.abs(rL).max()
    assert np.abs(Li.numpy() - rLi).max() <= TOL32 * np.abs(rLi).max()
    assert np.abs(np.triu(L.numpy(), 1)).max() == 0.0


def test_not_pd_gives_nonfinite_like_reference():
    G = -np.eye(32, dtype=np.float32)
    rL, _ = pallas_chol.chol_with_inv_pallas(jnp.asarray(G), interpret=True)
    L, _ = chol_with_inv_kernel(torch.from_numpy(G))
    assert not np.isfinite(np.asarray(rL)).all()
    assert not torch.isfinite(L).all()


@pytest.mark.parametrize("nb,dtype", [(16, np.float32), (128, np.float32),
                                      (512, np.float32), (24, np.float32),
                                      (1024, np.float32), (128, np.float64)])
def test_supported_mirrors_reference_gate(nb, dtype):
    tdt = torch.float32 if dtype == np.float32 else torch.float64
    assert supported((nb, nb), tdt) == pallas_chol.supported((nb, nb), jnp.dtype(dtype))


def test_cpu_stack_and_no_launch(rng):
    G = np.stack([spd(rng, 32) for _ in range(3)])
    before = chol_with_inv_kernel.launches
    L, Li = chol_with_inv_kernel(torch.from_numpy(G))
    assert chol_with_inv_kernel.launches == before
    for b in range(3):
        Lb, Lib = chol_kernel.cholesky_with_inv(torch.from_numpy(G[b]))
        assert torch.equal(L[b], Lb) and torch.equal(Li[b], Lib)


def test_non_cpu_tensor_never_takes_the_plain_version():
    """Only a CPU tensor takes the plain version; any other device goes to
    the kernel or raises."""
    with pytest.raises(ValueError, match="unsupported device"):
        chol_with_inv_kernel(torch.empty((16, 16), device="meta"))
