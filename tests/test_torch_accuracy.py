"""Accuracy parity of the port's real factorizations with the reference.

Agreement of values is not agreement of accuracy: a Q can match the
reference's to 1e-4 and still be twice as far from orthogonal.  Each case
runs the same seeded float32 input through the JAX reference, at its
default ``scan_stages`` (4), and through the port on the CPU, and holds the
port's orthogonality ||Q^T Q - I||_F and residual ||A - Q R|| / ||A|| (for
``lstsq``, the forward error against float64 ``numpy.linalg.lstsq``) to
1.1x the reference's: the geometric mean over seeds 0-3, with no seed
above 1.5x.

The panel grouping sets how many reflectors orgqr/ormqr merge into one, and
so Q's rounding, and it depends on the panel count k, not on n: the panels
here are 32 columns wide, and k = 2, 4, 8 covers stages of one and two
panels.  Pallas kernels are not interpreted: the reference runs its
CholeskyQR2 panels on its plain Cholesky (``use_chol_kernel=False``) and
TSQR on its plain path; its geqrt panels run its geqrt kernel in interpret
mode, as its own tests do.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cuda_qr_tpu as ref
import cuda_qr_tpu_torch as ct
from cuda_qr_tpu_torch.ops import qrcp as pq
from cuda_qr_tpu_torch.utils.geometry import round_up
from cuda_qr_tpu_torch.utils.interop import config_from_reference, packed_from_numpy

NB = 32
SEEDS = (0, 1, 2, 3)
MEAN_RATIO = 1.1
SEED_RATIO = 1.5
# The residual of a k = 8 factor with an accurate panel (the reference's
# geqrt kernel, CholeskyQR2 + reconstruction) carries the summation order of
# the CPU BLAS in one trailing GEMM, V^T B with V 256 x 64 and B 256 x 192:
# there MKL's float32 product is 1.77x as far from the exact one as XLA's,
# and at 128, 192 and 512 rows the two are equal.  The reference's own
# panels inside the port's driver keep the gap (tests/accuracy_report.py
# gemm, k8; ROADMAP.md Queue C, C8).  Orthogonality is held to MEAN_RATIO
# there too.
RESIDUAL_RATIO = {"qr-geqrt-k8": 1.2, "qr-cholqr2_hr-k8": 1.2}
METHODS = ("geqr2", "geqrt", "cholqr2_bk", "cholqr2_hr")


def ref_config(method="geqr2", **kw):
    return ref.QRConfig(dtype=jnp.float32, panel_width=NB, panel_method=method,
                        use_pallas=method != "geqr2", use_chol_kernel=False, **kw)


def port_config(rcfg):
    return config_from_reference(rcfg, device="cpu")


def gaussian(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def f64(x):
    x = x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
    return x.astype(np.float64)


def orth(Q):
    """||Q^T Q - I||_F over the last two axes, in float64, summed over a batch."""
    Q = f64(Q)
    G = np.swapaxes(Q, -1, -2) @ Q - np.eye(Q.shape[-1])
    return float(np.linalg.norm(G.reshape(-1)))


def resid(A, Q, R):
    A = f64(A)
    return float(np.linalg.norm((A - f64(Q) @ f64(R)).reshape(-1)) / np.linalg.norm(A))


def qr_metrics(A, Q, R):
    return orth(Q), resid(A, Q, R)


# -- cases: each maps a seed to (reference metrics, port metrics)

def case_qr(method, k, trailing_precision=None):
    rcfg = ref_config(method, trailing_precision=trailing_precision)
    cfg = port_config(rcfg)

    def run(seed):
        A = gaussian(seed, k * NB, k * NB)
        return (qr_metrics(A, *ref.qr(jnp.asarray(A), rcfg)),
                qr_metrics(A, *ct.qr(A, cfg)))
    return run


def case_orgqr(k):
    """The reference's own packed factors through each package's orgqr."""
    rcfg = ref_config()
    cfg = port_config(rcfg)

    def run(seed):
        n = k * NB
        A = gaussian(seed, n, n)
        rfac = ref.qr_blocked(jnp.asarray(A), rcfg)
        R = np.asarray(ref.extract_r(rfac, n))
        fac = packed_from_numpy(*(np.asarray(x) for x in rfac), device="cpu")
        return (qr_metrics(A, ref.orgqr(rfac, n, n, rcfg), R),
                qr_metrics(A, ct.orgqr(fac, n, n, cfg), R))
    return run


def case_lstsq(k):
    rcfg = ref_config()
    cfg = port_config(rcfg)

    def run(seed):
        A, b = gaussian(seed, 2 * k * NB, k * NB), gaussian(seed + 100, 2 * k * NB, 2)
        x64 = np.linalg.lstsq(f64(A), f64(b), rcond=None)[0]

        def fwd(x):
            return (float(np.linalg.norm(f64(x) - x64) / np.linalg.norm(x64)),)
        return fwd(ref.lstsq(jnp.asarray(A), jnp.asarray(b), rcfg).x), fwd(ct.lstsq(A, b, cfg).x)
    return run


def case_decomp(name, k):
    """lq and rq of a wide k*NB x 2k*NB input (A = L Q, Q's rows orthonormal),
    ql of the tall transpose (A = Q L)."""
    rcfg = ref_config()
    cfg = port_config(rcfg)
    rfn, pfn = getattr(ref, name), getattr(ct, name)

    def metrics(A, X, Y):
        Q = Y.T if name in ("lq", "rq") else X
        return orth(Q), resid(A, X, Y)

    def run(seed):
        A = gaussian(seed, k * NB, 2 * k * NB)
        if name == "ql":
            A = np.ascontiguousarray(A.T)
        return metrics(A, *rfn(jnp.asarray(A), rcfg)), metrics(A, *pfn(A, cfg))
    return run


def case_qr_pivoted(k):
    """qr_pivoted with the reference's sketch handed to the port (``omega=``),
    so both pick the same pivots."""
    rcfg = ref_config("cholqr2_bk")
    cfg = port_config(rcfg)

    def run(seed):
        m, n = 2 * k * NB, k * NB
        A = gaussian(seed, m, n)
        m_pad = round_up(m, NB)
        l = pq.sketch_rows(m_pad, NB)
        om = jax.random.normal(jax.random.key(12), (l, m_pad), dtype=jnp.float32)
        omega = np.array(om / jnp.sqrt(jnp.asarray(l, jnp.float32)))
        rQ, rR, rp = ref.qr_pivoted(jnp.asarray(A), rcfg)
        Q, R, p = ct.qr_pivoted(A, cfg, omega=omega)
        np.testing.assert_array_equal(p.numpy(), np.asarray(rp))
        return qr_metrics(A[:, np.asarray(rp)], rQ, rR), qr_metrics(A[:, p.numpy()], Q, R)
    return run


def case_tsqr(leaf):
    rcfg = ref.QRConfig(dtype=jnp.float32, use_pallas=False, block_rows=512, tsqr_leaf=leaf)
    cfg = port_config(rcfg).replace(use_kernels=True)

    def run(seed):
        A = gaussian(seed, 4096, NB)
        return qr_metrics(A, *ref.tsqr(jnp.asarray(A), rcfg)), qr_metrics(A, *ct.tsqr(A, cfg))
    return run


def case_qr_batched():
    rcfg = ref.QRConfig(dtype=jnp.float32, use_pallas=False)
    cfg = port_config(rcfg).replace(use_kernels=True)

    def run(seed):
        A = gaussian(seed, 16, 4 * NB, NB)
        return (qr_metrics(A, *ref.qr_batched(jnp.asarray(A), rcfg)),
                qr_metrics(A, *ct.qr_batched(A, cfg)))
    return run


CASES = {
    **{f"qr-{method}-k{k}": (case_qr, method, k) for method in METHODS for k in (2, 4, 8)},
    # MIXED_CONFIG's panels and trailing precision: the reference's HIGH,
    # the port's "high" (3xTF32; three float32 passes on the CPU)
    "qr-mixed-k4": (case_qr, "cholqr2_bk", 4, jax.lax.Precision.HIGH),
    **{f"orgqr-carried-k{k}": (case_orgqr, k) for k in (2, 4, 8)},
    "lstsq-k4": (case_lstsq, 4),
    **{f"{name}-k4": (case_decomp, name, 4) for name in ("lq", "rq", "ql")},
    "qr_pivoted-k4": (case_qr_pivoted, 4),
    **{f"tsqr-{leaf}": (case_tsqr, leaf) for leaf in ("householder", "cholqr2")},
    "qr_batched": (case_qr_batched,),
}


@pytest.mark.parametrize("case", list(CASES))
def test_as_accurate_as_reference(case):
    make, *args = CASES[case]
    run = make(*args)
    pairs = [run(seed) for seed in SEEDS]
    ref_vals = np.array([r for r, _ in pairs])
    port_vals = np.array([p for _, p in pairs])
    assert np.isfinite(port_vals).all() and (ref_vals > 0).all()
    ratios = port_vals / ref_vals
    mean = np.exp(np.log(ratios).mean(0))
    bound = np.full(mean.shape, MEAN_RATIO)
    bound[1:] = RESIDUAL_RATIO.get(case, MEAN_RATIO)
    assert (mean <= bound).all() and (ratios <= SEED_RATIO).all(), (
        f"port/reference per metric: geometric mean {mean}, per seed {ratios.tolist()}")
