"""The port's copy of the C99 sliding-panel oracle (``cuda_qr_tpu_torch/oracle``)
against the reference's (``cuda_qr_tpu/oracle``).

The C sources are the same, so the packed factors and taus must be
identical bit for bit (three shapes, both dtypes' paths through float64
input).  Beside that, the reference's own oracle tests: the golden 6x4 taus
printed by the source paper's qr.c (5e-7, its print precision), the validity
envelope in both dtypes (residual below n x 1e-13 in float64 and n x 1e-5
in float32, orthogonality 10x that), the misaligned-size rejections, the
zero-column guard, the standalone harness's JSON, BASELINE config 1, and the
oracle's R against the port's float64 ``qr_blocked`` after sign
normalization (1e-11 absolute).
"""

import ctypes
import json
import subprocess

import numpy as np
import pytest
import torch

from cuda_qr_tpu.oracle import binding as ref_binding
from cuda_qr_tpu_torch import QRConfig, extract_r, qr_blocked
from cuda_qr_tpu_torch.oracle import binding
from cuda_qr_tpu_torch.utils.geometry import PanelGrid

from torch_threads import one_thread  # noqa: F401  (autouse: one intra-op thread)

# Printed by the source paper's host oracle (qr.c:302) for its fixed 6x4 problem.
REFERENCE_TAUS_6x4 = [1.105875, 1.437911, 1.556454, 1.382508,
                      1.629178, 1.088601, 2.000000, 2.000000]


def reference_input_6x4():
    """The source's matrix: srand(12), column-major rand()/RAND_MAX fill
    (qr.c:468-473), through libc so the stream matches."""
    libc = ctypes.CDLL("libc.so.6")
    libc.srand(12)
    vals = [libc.rand() / 2147483647 for _ in range(24)]
    return np.array(vals).reshape((4, 6)).T


def test_golden_taus_6x4():
    A = reference_input_6x4()
    packed, tau = binding.mmqr(A.copy(), 4, 2)
    np.testing.assert_allclose(tau, REFERENCE_TAUS_6x4, atol=5e-7)
    resid, orth = binding.qr_check(A, *binding.explicit_qr(packed, tau, 4, 2))
    assert resid < 1e-14 and orth < 1e-14


@pytest.mark.parametrize("m,n,pr,pc", [
    (6, 4, 4, 2), (12, 8, 8, 4), (64, 16, 8, 4), (64, 32, 16, 8),
    (244, 64, 64, 4), (160, 128, 64, 16),
])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_oracle_envelope(rng, m, n, pr, pc, dtype):
    A = rng.standard_normal((m, n)).astype(dtype)
    resid, orth = binding.factor_and_check(A, pr, pc)
    tol = 1e-13 if dtype == np.float64 else 1e-5
    assert resid < tol * n, (m, n, resid)
    assert orth < tol * n * 10, (m, n, orth)


@pytest.mark.parametrize("m,n,pr,pc", [
    (30, 8, 8, 4),    # misaligned m
    (64, 13, 8, 4),   # misaligned n
    (6, 4, 8, 4),     # m < pr
    (16, 20, 8, 4),   # n > m
])
def test_oracle_rejects_misaligned(rng, m, n, pr, pc):
    with pytest.raises(ValueError, match="misaligned"):
        binding.mmqr(rng.standard_normal((m, n)), pr, pc)


def test_oracle_zero_column_guard():
    A = np.zeros((8, 4))
    A[:, 2] = np.arange(8, dtype=np.float64)
    packed, tau = binding.mmqr(A.copy(), 4, 2)
    assert np.all(np.isfinite(packed)) and np.all(np.isfinite(tau))


@pytest.mark.parametrize("m,n,pr,pc,dtype", [(64, 32, 16, 8, np.float64),
                                             (244, 64, 64, 4, np.float64),
                                             (160, 128, 64, 16, np.float32)])
def test_oracle_bit_identical_to_reference(rng, m, n, pr, pc, dtype):
    A = rng.standard_normal((m, n)).astype(dtype)
    packed, tau = binding.mmqr(A, pr, pc)
    rpacked, rtau = ref_binding.mmqr(A, pr, pc)
    assert packed.dtype == rpacked.dtype and np.array_equal(packed, rpacked)
    assert np.array_equal(tau, rtau)
    Q, R = binding.explicit_qr(packed, tau, pr, pc)
    rQ, rR = ref_binding.explicit_qr(rpacked, rtau, pr, pc)
    assert np.array_equal(Q, rQ) and np.array_equal(R, rR)
    assert binding.qr_check(A.astype(dtype), Q, R) == ref_binding.qr_check(A.astype(dtype), rQ, rR)
    grid = PanelGrid(m, n, pr, pc)
    assert binding.panel_dims(m, n, pr, pc) == (grid.row_panels, grid.col_panels)
    assert tau.size == grid.tau_len


def _signnorm(R):
    d = np.sign(np.diag(R))
    return R * np.where(d == 0, 1, d)[:, None]


@pytest.mark.parametrize("m,n,pr,pc", [(64, 32, 16, 8), (96, 32, 32, 16)])
def test_oracle_r_matches_qr_blocked(rng, m, n, pr, pc):
    """The sliding-panel oracle and the full-height blocked factorization
    give the same R up to the diagonal sign matrix."""
    A = rng.standard_normal((m, n))
    packed, _ = binding.mmqr(A.copy(), pr, pc)
    cfg = QRConfig(panel_width=16, dtype=torch.float64, device="cpu")
    R = extract_r(qr_blocked(A, cfg), n).numpy()
    np.testing.assert_allclose(_signnorm(np.triu(packed[:n])), _signnorm(R), atol=1e-11)


def test_oracle_main_harness_json():
    out = subprocess.run([str(binding.main_binary()), "64", "32", "16", "8"], check=True,
                         capture_output=True, text=True)
    rec = json.loads(out.stdout)
    assert rec["residual"] < 1e-13 and rec["m"] == 64 and rec["pc"] == 8


def test_oracle_baseline_config1():
    """BASELINE config 1: 1024^2 float64 on the oracle (sliding panel 64 x 16)."""
    A = np.random.default_rng(12).standard_normal((1024, 1024))
    resid, orth = binding.factor_and_check(A, 64, 16)
    assert resid < 1024 * 2.3e-16 * 20, resid
    assert orth < 1024 * 2.3e-16 * 200, orth


def test_oracle_builds_outside_the_package():
    lib = binding.library_path()
    assert lib.exists() and binding.ORACLE_BUILD_DIR in lib.parents
    assert not list(binding._DIR.glob("*.so"))
