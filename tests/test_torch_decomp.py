"""The PyTorch port's LQ / RQ / QL and ``qr_multiply`` against the JAX
reference on the same input, in every mode, at the reference tests' shapes
(square, tall, wide, off the panel grid).

Both packages reduce each member onto their blocked QR with the same
panels, so the factors agree directly: float64 1e-10 and float32 1e-4,
relative to max|A| (triangular factors, products) or 1 (orthogonal
factors).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cuda_qr_tpu as ref
import cuda_qr_tpu_torch as ct
from cuda_qr_tpu_torch.utils.interop import config_from_reference

from torch_threads import one_thread  # noqa: F401  (autouse: one intra-op thread)

RCFG = ref.QRConfig(panel_width=16, dtype=jnp.float64, use_pallas=False, scan_stages=1)
CFG = config_from_reference(RCFG, device="cpu")
SHAPES = [(48, 48), (96, 40), (40, 96), (130, 50)]


def close(a, b, tol):
    a = a.detach().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    b = np.asarray(b)
    assert a.shape == b.shape
    assert np.abs(a.astype(np.float64) - b.astype(np.float64)).max() <= tol


def both(port_fn, ref_fn, A, *args, **kw):
    got = port_fn(A, *args, config=CFG, **kw)
    want = ref_fn(jnp.asarray(A), *args, config=RCFG, **kw)
    if not isinstance(got, tuple):
        got, want = (got,), (want,)
    return got, want


@pytest.mark.parametrize("name", ["lq", "rq", "ql"])
@pytest.mark.parametrize("shape", SHAPES)
def test_reduced_matches_reference(rng, name, shape):
    A = rng.standard_normal(shape)
    got, want = both(getattr(ct, name), getattr(ref, name), A)
    for a, b in zip(got, want):
        close(a, b, 1e-10 * np.abs(A).max())
    first, second = got
    np.testing.assert_allclose((first @ second).numpy(), A, atol=1e-12 * np.abs(A).max() * 100)


@pytest.mark.parametrize("name,mode", [("lq", "complete"), ("lq", "l"), ("rq", "complete"),
                                       ("rq", "r"), ("ql", "complete"), ("ql", "l")])
@pytest.mark.parametrize("shape", [(96, 40), (40, 96)])
def test_other_modes_match_reference(rng, name, mode, shape):
    A = rng.standard_normal(shape)
    got, want = both(getattr(ct, name), getattr(ref, name), A, mode=mode)
    for a, b in zip(got, want):
        close(a, b, 1e-10 * np.abs(A).max())


def test_triangular_and_orthogonal_float32(rng):
    rcfg = RCFG.replace(dtype=jnp.float32)
    cfg = config_from_reference(rcfg, device="cpu")
    A = rng.standard_normal((130, 50)).astype(np.float32)
    for name, lower in (("lq", True), ("rq", False), ("ql", True)):
        got = getattr(ct, name)(A, config=cfg)
        want = getattr(ref, name)(jnp.asarray(A), config=rcfg)
        for a, b in zip(got, want):
            close(a, b, 1e-4 * np.abs(A).max())
        T, Q = (got[1], got[0]) if name == "ql" else got
        k = min(A.shape)
        tri = torch.triu(T, 1) if lower else torch.tril(T, T.shape[1] - T.shape[0] - 1)
        assert float(tri.abs().max()) == 0.0
        G = Q.mT @ Q if name == "ql" else Q @ Q.mT
        assert float((G - torch.eye(k)).norm()) < 4 * k * float(torch.finfo(torch.float32).eps)


@pytest.mark.parametrize("mode,transpose", [("left", False), ("left", True),
                                            ("right", False), ("right", True)])
@pytest.mark.parametrize("shape", [(96, 40), (40, 96)])
def test_qr_multiply_matches_reference(rng, mode, transpose, shape):
    m, n = shape
    k = min(m, n)
    rows = {("left", False): k, ("left", True): m}.get((mode, transpose), 3)
    cols = {("right", False): m, ("right", True): k}.get((mode, transpose), 5)
    A = rng.standard_normal(shape)
    C = rng.standard_normal((rows, cols))
    (out, R), (rout, rR) = both(ct.qr_multiply, ref.qr_multiply, A, C,
                                mode=mode, transpose=transpose)
    close(out, rout, 1e-10 * np.abs(C).max())
    close(R, rR, 1e-10 * np.abs(A).max())
    Q = ct.qr(A, CFG)[0]
    Qop = Q.mT if transpose else Q
    want = Qop @ torch.from_numpy(C) if mode == "left" else torch.from_numpy(C) @ Qop
    close(out, want.numpy(), 1e-12 * np.abs(C).max() * 100)


def test_qr_multiply_vector_and_errors(rng):
    A = rng.standard_normal((96, 40))
    c = rng.standard_normal(40)
    (out, _), (rout, _) = both(ct.qr_multiply, ref.qr_multiply, A, c)
    assert out.shape == (96,)
    close(out, rout, 1e-10 * np.abs(c).max())
    with pytest.raises(ct.QRShapeError):
        ct.qr_multiply(A, rng.standard_normal((41, 2)), config=CFG)
    with pytest.raises(ct.QRShapeError):
        ct.qr_multiply(A, c, mode="middle", config=CFG)
    Z = torch.complex(torch.ones((8, 16)), torch.arange(128.0).reshape(8, 16))
    L, Q = ct.lq(Z, config=CFG)             # complex input works (conjugate transposes)
    assert L.dtype == torch.complex64
    assert float((L @ Q - Z).abs().max()) < 1e-3
