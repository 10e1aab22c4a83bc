"""Kernel B2 (geqrt) on the CPU: its plain PyTorch version against the
reference's Pallas kernel in interpret mode, the recursive panel, the batch
grid's plain version against per-panel geqr2 + larft, and the wrappers'
routing and validation.

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
from cuda_qr_tpu_torch.ops.householder import geqr2, larft, unpack_v
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


@pytest.mark.parametrize("L,m,w,off,dtype", [(5, 64, 16, 0, np.float32),
                                             (3, 100, 30, 7, np.float64),
                                             (4, 40, 40, 0, np.float64)])
def test_batched_plain_matches_per_panel_geqr2_larft(rng, L, m, w, off, dtype):
    """The batch grid's plain version is geqr2 + larft of each panel; one
    panel is all zeros and another has a zero column."""
    P = rng.standard_normal((L, m, w)).astype(dtype)
    P[1] = 0.0
    P[2, :, 3] = 0.0
    before = port.geqrt_batched.launches
    packed, tau, T = port.geqrt_batched(torch.from_numpy(P), off)
    assert port.geqrt_batched.launches == before   # CPU: plain version
    tol = 2e-5 if dtype == np.float32 else 1e-12
    for b in range(L):
        lo, tb = geqr2(torch.from_numpy(P[b, off:]))
        Tb = larft(unpack_v(lo), tb)
        close(packed[b, off:], lo.numpy(), tol)
        assert torch.equal(packed[b, :off], torch.from_numpy(P[b, :off]))
        close(tau[b], tb.numpy(), tol)
        close(T[b], Tb.numpy(), tol)
    assert float(tau[1].abs().max()) == 0.0 and float(tau[2, 3]) == 0.0


def test_batched_plain_matches_pallas_interpret(rng):
    P = rng.standard_normal((3, 64, 16)).astype(np.float32)
    packed, tau, T = port.geqrt_batched_plain(torch.from_numpy(P), 8)
    for b in range(3):
        rp, rtau, rT = jax.jit(lambda a, o: _geqrt_pallas(a, o, REF))(jnp.asarray(P[b]), 8)
        close(packed[b], rp, 2e-5)
        close(tau[b], rtau, 1e-5)
        close(T[b], rT, 2e-5)


@pytest.mark.parametrize("shape,off", [((2, 64, 16), 60), ((2, 300, 129), 0),
                                       ((2, 64, 16), -1), ((2, 64, 0), 0)])
def test_batched_rejects_what_the_kernel_does_not_take(shape, off):
    with pytest.raises(ValueError):
        port.geqrt_batched(torch.zeros(shape), off)


def test_batched_gate_and_non_cpu_tensor():
    assert port.supported((1024, 1024, 128), torch.float32)
    assert port.supported((8, 2048, 77), torch.float64)
    assert not port.supported((2, 64, 129), torch.float32)
    assert not port.supported((2, 16, 32), torch.float32)
    assert not port.supported((2, 64, 16), torch.bfloat16)
    with pytest.raises(ValueError, match="unsupported device"):
        port.geqrt_batched(torch.empty((2, 64, 16), device="meta"), 0)
