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

from torch_threads import one_thread  # noqa: F401  (autouse: one intra-op thread)

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


@pytest.mark.parametrize("m,w", [(256, 32), (512, 128)])
def test_base_T_as_accurate_as_reference_kernel(m, w):
    """float32 T of the plain version against a float64 larft of its own V
    and tau, no further off than the reference's kernel's T (interpret
    mode) from its own: 1.1x, geometric mean over seeds 0-3.  T's rounding
    is its Gram's, which the kernels sum from partial sums."""
    def err(packed, tau, Tm):
        V = np.tril(np.asarray(packed, np.float64), -1) + np.eye(m, w)
        G, tau = V.T @ V, np.asarray(tau, np.float64)
        T64 = np.zeros((w, w))
        for j in range(w):
            T64[:j, j] = -tau[j] * T64[:j, :j] @ G[:j, j]
            T64[j, j] = tau[j]
        return np.linalg.norm(np.asarray(Tm, np.float64) - T64) / np.linalg.norm(T64)

    kernel = jax.jit(lambda a: _geqrt_pallas(a, 0, REF))
    ratios = []
    for seed in range(4):
        A = np.random.default_rng(seed).standard_normal((m, w)).astype(np.float32)
        packed, tau, T = port.geqrt_base(torch.from_numpy(A), 0)
        ratios.append(err(packed.numpy(), tau.numpy(), T.numpy())
                      / err(*kernel(jnp.asarray(A))))
    assert np.exp(np.log(ratios).mean()) <= 1.1, ratios


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


@pytest.mark.parametrize("m,w,off,dtype,kb,resident,body", [
    (1024, 128, 0, torch.float32, 32, False, "subpanel"),  # TSQR leaf: four sub-panels
    (256, 128, 0, torch.float32, 32, True, "resident"),    # TSQR node: held whole
    (256, 128, 0, torch.float64, 32, False, "subpanel"),   # float64 does not fit whole
    (397, 128, 0, torch.float32, 32, True, "resident"),    # the last m held whole ...
    (398, 128, 0, torch.float32, 32, False, "subpanel"),   # ... and the first not
    (1553, 128, 0, torch.float32, 32, False, "subpanel"),  # the last m at kb = 32 ...
    (1554, 128, 0, torch.float32, 16, False, "subpanel"),  # ... and the first at kb = 16
    (8192, 32, 0, torch.float32, 4, False, "subpanel"),    # the tallest width that fits
    (8192, 32, 40, torch.float64, 0, False, "stream"),     # too tall: streaming body
    (2048, 77, 3, torch.float64, 8, False, "subpanel"),    # w not a multiple of kb
    (64, 20, 0, torch.float32, 20, True, "resident"),      # w < 32: one sub-panel of w
])
def test_plan_at_the_edges(m, w, off, dtype, kb, resident, body):
    p = port.plan(m, w, off, dtype)
    assert (p.kb, p.resident) == (kb, resident) and port.body(m, w, off, dtype) == body
    assert (p.slices >= 1) == (kb > 0)


def layout_words(rows, w, kb, ldp, slices):
    """The kernel's shared-memory layout (csrc/geqrt.cu), in elements."""
    return rows * ldp + 2 * port.KB * (port.KB + 1) + slices * kb * w + port.KB + port.RED_WORDS


@pytest.mark.parametrize("dtype,size", [(torch.float32, 4), (torch.float64, 8)])
def test_plan_is_the_widest_that_fits(dtype, size):
    """Over a grid of shapes: the chosen layout fits the budget with its
    slices (one more slice would not, unless at the cap), residency is taken
    whenever it fits, and every wider sub-panel does not fit."""
    for m in (16, 100, 256, 397, 398, 1000, 1553, 1554, 3000, 5000, 8192, 12000, 20000):
        for w in (1, 3, 4, 16, 31, 32, 33, 64, 77, 100, 128):
            for off in (0, 5):
                if off + w > m:
                    continue
                rows, top = m - off, min(w, port.KB)
                p = port.plan(m, w, off, dtype)
                fits = [size * layout_words(rows, w, k, ldp, 1) <= port.SMEM_BUDGET
                        for k, ldp in [(top, w + 1)]
                        + [(k, k + 1) for k in (top, 16, 8, 4) if k <= top]]
                if p.resident:
                    assert fits[0] and p.kb == top
                else:
                    assert not fits[0]
                if p.kb:
                    ldp = w + 1 if p.resident else p.kb + 1
                    assert size * layout_words(rows, w, p.kb, ldp, p.slices) <= port.SMEM_BUDGET
                    assert (p.slices == port.MAX_SLICES or size * layout_words(
                        rows, w, p.kb, ldp, p.slices + 1) > port.SMEM_BUDGET)
                    assert p.kb in (top, 16, 8, 4) and p.kb <= top
                    assert not p.resident or p.kb == top
                else:
                    assert not any(fits)


def test_batched_returns_contiguous_stack(rng):
    P = torch.from_numpy(rng.standard_normal((3, 48, 16)))
    packed, tau, T = port.geqrt_batched(P, 0)
    assert packed.is_contiguous() and tau.is_contiguous() and T.is_contiguous()
    assert packed.shape == (3, 48, 16) and T.shape == (3, 16, 16)
