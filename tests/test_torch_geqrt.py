"""Kernel B2 (geqrt) on the CPU: its plain PyTorch version against the
reference's Pallas kernel in interpret mode, the recursive panel, and the
wrapper's routing and validation.

float32 tolerances are the reference's own for the same comparison
(tests/test_geqrt.py: 2e-5 base, 5e-5 recursive).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cuda_qr_tpu.ops.geqrt import _geqrt_pallas, _geqrt_recursive
from cuda_qr_tpu.utils.config import QRConfig as RefConfig
from cuda_qr_tpu_torch.ops import geqrt as port
from cuda_qr_tpu_torch.utils.config import QRConfig

REF = RefConfig(use_pallas=True, interpret=True)


def close(a, b, tol):
    np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=tol)


@pytest.mark.parametrize("m,w,off", [(64, 16, 0), (96, 16, 32), (128, 32, 96)])
def test_base_matches_pallas_interpret(rng, m, w, off):
    A = rng.standard_normal((m, w)).astype(np.float32)
    rp, rtau, rT = jax.jit(lambda a, o: _geqrt_pallas(a, o, REF))(jnp.asarray(A), off)
    before = port.geqrt_base.launches
    packed, tau, T = port.geqrt_base(torch.from_numpy(A), off)
    assert port.geqrt_base.launches == before   # CPU: plain version
    close(packed, rp, 2e-5)
    assert torch.equal(packed[:off], torch.from_numpy(A[:off]))
    close(tau, rtau, 1e-5)
    close(T, rT, 2e-5)


def test_zero_columns(rng):
    A = np.zeros((64, 16), np.float32)
    A[:, 3] = rng.standard_normal(64)
    rp, rtau, rT = jax.jit(lambda a, o: _geqrt_pallas(a, o, REF))(jnp.asarray(A), 0)
    packed, tau, T = port.geqrt_base(torch.from_numpy(A), 0)
    assert torch.isfinite(packed).all() and torch.isfinite(T).all()
    close(packed, rp, 2e-5)
    close(tau, rtau, 1e-5)
    assert float(tau[0]) == 0.0


@pytest.mark.parametrize("base", [8, 16])
def test_recursive_matches_reference(rng, base):
    m, nb, off = 96, 32, 16
    A = rng.standard_normal((m, nb)).astype(np.float32)
    rcfg = REF.replace(panel_base=base)
    rp, rtau, rT = jax.jit(lambda a, o: _geqrt_recursive(a, o, rcfg))(jnp.asarray(A), off)
    packed, tau, T = port._geqrt_recursive(torch.from_numpy(A), off,
                                           QRConfig(panel_base=base))
    close(packed, rp, 5e-5)
    close(tau, rtau, 5e-5)
    close(T, rT, 5e-5)


def test_geqrt_panel_bf16(rng):
    A = rng.standard_normal((64, 16)).astype(np.float32)
    packed, tau, T = port.geqrt_panel(torch.from_numpy(A).bfloat16(), 0, QRConfig())
    assert packed.dtype == torch.bfloat16 and tau.dtype == torch.float32
    assert torch.isfinite(packed.float()).all()


@pytest.mark.parametrize("m,w,off", [(64, 16, 60), (300, 129, 0), (64, 16, -1)])
def test_base_rejects_what_the_kernel_does_not_take(m, w, off):
    with pytest.raises(ValueError):
        port.geqrt_base(torch.zeros((m, w)), off)


def test_non_cpu_tensor_never_takes_the_plain_version():
    with pytest.raises(ValueError, match="unsupported device"):
        port.geqrt_base(torch.empty((64, 16), device="meta"), 0)
