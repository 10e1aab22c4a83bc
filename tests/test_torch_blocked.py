"""The slice as a whole: qr_blocked + orgqr + extract_r of the PyTorch port
against the JAX reference on the same input, and factors carried across.

Tolerances: Q and R agree to 1e-10 * max|A| in fp64 and 1e-4 in fp32
(CholeskyQR2 panels square the panel's condition number); both packages
must pass check_qr's n*eps / 4n*eps gates.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cuda_qr_tpu as ref
from cuda_qr_tpu_torch import check_qr, extract_r, orgqr, ormqr, qr_blocked
from cuda_qr_tpu_torch.utils.config import MIXED_CONFIG, QRConfig
from cuda_qr_tpu_torch.utils.interop import config_from_reference, packed_from_numpy

from torch_threads import one_thread  # noqa: F401  (autouse: one intra-op thread)

METHODS = ["cholqr2_bk", "cholqr2_hr", "geqrt", "geqr2"]
DTYPES = {"f64": (np.float64, jnp.float64, 1e-10), "f32": (np.float32, jnp.float32, 1e-4)}


def ref_config(jdt, method, nb=32):
    return ref.QRConfig(dtype=jdt, panel_width=nb, panel_method=method,
                        use_pallas=method != "geqr2", scan_stages=1)


def factor_both(A, rcfg):
    m, n = A.shape
    rfac = ref.qr_blocked(jnp.asarray(A), rcfg)
    rQ, rR = ref.orgqr(rfac, m, n, rcfg), ref.extract_r(rfac, n)
    cfg = config_from_reference(rcfg, device="cpu")
    fac = qr_blocked(A, cfg)
    return (rfac, np.asarray(rQ), np.asarray(rR)), (fac, orgqr(fac, m, n, cfg),
                                                     extract_r(fac, n)), cfg


@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("dt", ["f64", "f32"])
def test_factor_and_q_match_reference(rng, method, dt):
    ndt, jdt, tol = DTYPES[dt]
    m, n = 256, 96
    A = rng.standard_normal((m, n)).astype(ndt)
    (rfac, rQ, rR), (fac, Q, R), _ = factor_both(A, ref_config(jdt, method))
    assert ref.check_qr(A, rQ, rR).ok
    assert check_qr(A, Q, R).ok
    scale = np.abs(A).max()
    assert np.abs(Q.numpy() - rQ).max() <= tol
    assert np.abs(R.numpy() - rR).max() <= tol * scale
    assert np.abs(fac.packed.numpy() - np.asarray(rfac.packed)).max() <= tol * scale


@pytest.mark.parametrize("dt", ["f64", "f32"])
def test_padded_shape_matches_reference(rng, dt):
    """300 x 130 pads to the 32-column grid (5 panels, a short last group)."""
    ndt, jdt, tol = DTYPES[dt]
    A = rng.standard_normal((300, 130)).astype(ndt)
    (_, rQ, rR), (fac, Q, R), _ = factor_both(A, ref_config(jdt, "cholqr2_bk"))
    assert fac.packed.shape == (320, 160) and fac.Ts.shape == (5, 32, 32)
    assert check_qr(A, Q, R).ok
    assert np.abs(Q.numpy() - rQ).max() <= tol
    assert np.abs(R.numpy() - rR).max() <= tol * np.abs(A).max()


def test_carried_factors_give_reference_orgqr_ormqr(rng):
    m, n = 200, 96
    A = rng.standard_normal((m, n))
    B = rng.standard_normal((m, 7))
    rcfg = ref_config(jnp.float64, "cholqr2_bk")
    rfac = ref.qr_blocked(jnp.asarray(A), rcfg)
    fac = packed_from_numpy(*(np.asarray(x) for x in rfac), device="cpu")
    cfg = config_from_reference(rcfg, device="cpu")
    np.testing.assert_allclose(orgqr(fac, m, n, cfg).numpy(),
                               np.asarray(ref.orgqr(rfac, m, n, rcfg)), atol=1e-12)
    np.testing.assert_array_equal(extract_r(fac, n).numpy(),
                                  np.asarray(ref.extract_r(rfac, n)))
    for transpose in (True, False):
        np.testing.assert_allclose(
            ormqr(fac, torch.from_numpy(B), transpose, cfg).numpy(),
            np.asarray(ref.ormqr(rfac, jnp.asarray(B), transpose, rcfg)), atol=1e-12)


@pytest.mark.parametrize("lookahead,aggregate", [(1, 1), (2, 3), (3, 4), (8, 8)])
def test_grouping_does_not_change_the_result(rng, lookahead, aggregate):
    """Lookahead groups and orgqr aggregation of any width (a width that is
    no power of two groups by the largest one below it) are the same
    operator."""
    A = torch.from_numpy(rng.standard_normal((160, 160)))
    base = QRConfig(dtype=torch.float64, panel_width=32, device="cpu")
    cfg = base.replace(factor_lookahead=lookahead, apply_aggregate=aggregate)
    f0, f1 = qr_blocked(A, base), qr_blocked(A, cfg)
    assert torch.allclose(f0.packed, f1.packed, atol=1e-12)
    assert torch.allclose(orgqr(f0, 160, 160, base), orgqr(f1, 160, 160, cfg), atol=1e-12)
    B = torch.from_numpy(rng.standard_normal((160, 3)))
    assert torch.allclose(ormqr(f1, ormqr(f1, B, True, cfg), False, cfg), B, atol=1e-12)


def reference_groups(k, width, stages=4):
    """The reference's panel groups, written out from its default schedule:
    stages at round(s*k/stages) (``cuda_qr_tpu/ops/blocked.py:151-152,
    432-434, 493-495``), and in a stage of kg panels, groups of
    ``_group_width(kg, width)`` (:211, :438, :505)."""
    from cuda_qr_tpu.ops.blocked import _group_width
    stages = max(1, min(stages, k))
    bounds = [round(s * k / stages) for s in range(stages + 1)]
    groups = []
    for ks, ke in zip(bounds[:-1], bounds[1:]):
        kg = ke - ks
        g = _group_width(kg, width)
        groups += [(ks + j * g, ks + (j + 1) * g) for j in range(kg // g)]
    return groups


@pytest.mark.parametrize("width", [1, 2, 4, 8])
def test_groups_are_the_reference_schedule(width):
    """The port's panel groups (factor, orgqr and ormqr) are the reference's
    at its default scan_stages, for every panel count up to 70."""
    from cuda_qr_tpu_torch.ops.blocked import _groups
    for k in range(1, 71):
        assert _groups(k, width, 4) == reference_groups(k, width), (k, width)
    assert _groups(12, 4, 4) == [(i, i + 1) for i in range(12)]   # stages of 3: no merge
    assert _groups(2, 4, 4) == [(0, 1), (1, 2)]


@pytest.mark.parametrize("width", [1, 2, 4])
def test_groups_unchanged_from_sixteen_panels(width):
    """At 16, 32 and 64 panels (8192^2 at nb = 128 is 64) the groups are the
    chunks of ``width`` the port formed before it grouped by stages."""
    from cuda_qr_tpu_torch.ops.blocked import _groups
    for k in (16, 32, 64):
        assert _groups(k, width, 4) == [(i0, i0 + width) for i0 in range(0, k, width)]


def test_config_from_reference_carries_scan_stages():
    assert config_from_reference(ref.QRConfig(scan_stages=2)).scan_stages == 2
    assert config_from_reference(ref.QRConfig()).scan_stages == QRConfig().scan_stages == 4


def test_config_from_reference():
    cfg = config_from_reference(ref.MIXED_CONFIG.replace(use_pallas=False, panel_width=64))
    assert cfg == MIXED_CONFIG.replace(use_kernels=False, panel_width=64)
    assert config_from_reference(ref.QRConfig(dtype=jnp.bfloat16)).dtype == torch.bfloat16
    with pytest.raises(ValueError):
        config_from_reference(ref.QRConfig(dtype=jnp.float16))


def test_bf16_storage(rng):
    A = rng.standard_normal((128, 64)).astype(np.float32)
    cfg = QRConfig(dtype=torch.bfloat16, panel_width=32, device="cpu")
    fac = qr_blocked(A, cfg)
    assert fac.packed.dtype == torch.bfloat16 and fac.Ts.dtype == torch.float32
    Q, R = orgqr(fac, 128, 64, cfg), extract_r(fac, 64)
    chk = check_qr(A, Q.float(), R.float())
    assert chk.residual < 3e-2 and np.isfinite(chk.orthogonality)


def test_input_is_not_modified_and_stays_on_its_device(rng):
    A = torch.from_numpy(rng.standard_normal((64, 64)))
    A0 = A.clone()
    fac = qr_blocked(A, QRConfig(dtype=torch.float64, panel_width=32, device="cpu"))
    assert torch.equal(A, A0) and fac.packed.device == A.device


def test_wide_input_raises():
    from cuda_qr_tpu_torch import QRShapeError
    with pytest.raises(QRShapeError):
        qr_blocked(np.zeros((8, 16)), QRConfig(device="cpu"))
