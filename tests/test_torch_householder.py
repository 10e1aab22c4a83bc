"""Householder core of the PyTorch port against the JAX reference (fp64).

Same numpy input through ``cuda_qr_tpu.ops.householder`` and
``cuda_qr_tpu_torch.ops.householder``; both implement the same arithmetic,
so they agree to 1e-12 (summation order only).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cuda_qr_tpu.ops import householder as ref
from cuda_qr_tpu_torch.ops import householder as port

from torch_threads import one_thread  # noqa: F401  (autouse: one intra-op thread)

TOL = 1e-12


def T(x):
    return torch.from_numpy(np.array(x))


def close(a, b, tol=TOL):
    a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    np.testing.assert_allclose(a, np.asarray(b), rtol=0, atol=tol)


@pytest.mark.parametrize("d", [0, 3, 9])
def test_make_reflector(rng, d):
    col = rng.standard_normal(10)
    v, tau, beta = port.make_reflector(T(col), d)
    rv, rtau, rbeta = ref.make_reflector(jnp.asarray(col), d)
    close(v, rv)
    close(tau, rtau)
    close(beta, rbeta)


def test_make_reflector_zero_column():
    col = np.zeros(8)
    v, tau, beta = port.make_reflector(T(col), 2)
    rv, rtau, rbeta = ref.make_reflector(jnp.asarray(col), 2)
    assert float(tau) == 0.0 and np.all(np.isfinite(v.numpy()))
    close(v, rv)
    close(beta, rbeta)


def test_make_reflector_scaled_norm_no_overflow():
    """The max-abs scaled norm keeps 1e30-sized float32 columns finite."""
    col = np.full(16, 1e30, np.float32)
    v, tau, beta = port.make_reflector(T(col), 0)
    assert np.isfinite(float(beta)) and np.isfinite(float(tau))
    np.testing.assert_allclose(float(beta), -4e30, rtol=1e-6)


@pytest.mark.parametrize("m,n,off", [(40, 12, 0), (40, 12, 7), (24, 24, 0)])
def test_geqr2(rng, m, n, off):
    A = rng.standard_normal((m, n))
    packed, tau = port.geqr2(T(A), off)
    rpacked, rtau = ref.geqr2(jnp.asarray(A), row_offset=off)
    close(packed, rpacked)
    close(tau, rtau)


def test_larft_larfb(rng):
    A = rng.standard_normal((48, 16))
    B = rng.standard_normal((48, 5))
    packed, tau = ref.geqr2(jnp.asarray(A))
    V = np.asarray(ref.unpack_v(packed))
    close(port.unpack_v(T(np.asarray(packed))), V)
    close(port.unpack_r(T(np.asarray(packed))), ref.unpack_r(packed))
    Tm = port.larft(T(V), T(np.asarray(tau)))
    rT = ref.larft(jnp.asarray(V), tau)
    close(Tm, rT)
    for transpose in (True, False):
        close(port.larfb(T(B), T(V), Tm, transpose=transpose),
              ref.larfb(jnp.asarray(B), jnp.asarray(V), rT, transpose=transpose))


def test_merge_wy(rng):
    A = rng.standard_normal((40, 16))
    packed, tau = ref.geqr2(jnp.asarray(A))
    V = np.asarray(ref.unpack_v(packed))
    Tm = np.asarray(ref.larft(jnp.asarray(V), tau))
    V1, V2, T1 = V[:, :8], V[:, 8:], Tm[:8, :8]
    T2 = Tm[8:, 8:]
    merged = port.merge_wy(T(V1), T(T1), T(V2), T(T2))
    close(merged, ref.merge_wy(*map(jnp.asarray, (V1, T1, V2, T2))))
    close(merged, Tm)   # merging the halves of one panel gives its larft T


def test_panel_v_unit_vj(rng):
    P = rng.standard_normal((32, 8))
    VJ = rng.standard_normal((8, 8))
    close(port.panel_v(T(P), 8, T(VJ)), ref.panel_v(jnp.asarray(P), 8, jnp.asarray(VJ)))
    close(port.unit_vj(T(P), 8, 8), ref.unit_vj(jnp.asarray(P), 8, 8))
